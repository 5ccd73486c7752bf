"""Process start to the first timed step (host clock): imports, weights,
state, warm-up, graph capture and the first steps."""


def read(record, profile):
    return record["setup_s"]
