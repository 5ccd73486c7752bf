"""PyTorch's caching allocator under the train step: peak allocated over
peak reserved, over the whole run, in %."""


def read(record, profile):
    if record["kind"] != "train" or not record["peak_reserved"]:
        return None
    return record["peak_allocated"] / record["peak_reserved"] * 100
