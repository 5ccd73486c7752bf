"""The decode step's least time (every weight read once and each running
sequence's valid K and V read once, over 3.35 TB/s, or its FLOPs over the
bf16 peak if larger; ``harness.flops``) over its measured time, summed
over the window's steps, in %."""


def read(record, profile):
    spans = record.get("window_spans", {}).get("engine.decode")
    if record["kind"] != "closed_loop" or not spans:
        return None
    return sum(record["decode_least_s"]) / sum(spans) * 100
