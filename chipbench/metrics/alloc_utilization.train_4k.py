"""PyTorch's caching allocator under starcoder2-15b-4l's train step: peak
allocated over peak reserved, over the whole run, in %. Its own name
because that cell reports its peak per layer (``peak_reserved_gib.train_4k``)."""


def read(record, profile):
    if record["kind"] != "train" or not record["peak_reserved"]:
        return None
    return record["peak_allocated"] / record["peak_reserved"] * 100
