"""``torch.cuda.max_memory_reserved`` over the whole run, set-up included,
in GiB: what the job holds of the card (the paper's metric). Read before
the reference runs."""


def read(record, profile):
    return record["peak_reserved"] / 2**30
