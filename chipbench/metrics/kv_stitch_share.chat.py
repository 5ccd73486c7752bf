"""Share of the KV lake's allocations over the traced stretch that stitched
(S3, S4 of GMLake's Algorithm 1) among all that were served (S1-S4), from
the program's ``kv.S*`` counters, in %. None where the program counts
none."""


def read(record, profile):
    if record["kind"] != "closed_loop":
        return None
    try:
        from repro_torch.utils import tracing
    except ImportError:
        return None
    counters = tracing.snapshot()["counters"]
    served = sum(counters.get(f"kv.S{i}", 0) for i in range(1, 5))
    if not served:
        return None
    return (counters.get("kv.S3", 0) + counters.get("kv.S4", 0)) / served * 100
