"""``torch.cuda.max_memory_reserved`` over the whole run, set-up included,
in GiB, on starcoder2-15b-4l's train step. A per-layer metric there: the
caching allocator picks among free blocks of one size by address, and the
addresses differ from process to process, so the step's peak takes one of a
few values at random, too far apart for an end-to-end bound (PERF.md)."""


def read(record, profile):
    if record["kind"] != "train":
        return None
    return record["peak_reserved"] / 2**30
