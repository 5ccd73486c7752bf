"""Device operations (kernels and copies) a training step runs, counted in
the profiler's trace of the graph's replays."""


def read(record, profile):
    if record["kind"] != "train" or profile is None:
        return None
    return profile["device_ops_count"] / profile["steps"]
