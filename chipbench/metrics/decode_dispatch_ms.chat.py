"""The program's ``model.decode`` spans over the traced stretch, averaged:
the host's dispatch of one batched decode step, which ends before any wait
for the device, in ms. None where the program has no such spans.

Read in the profiled stretch, where the profiler records every operator
the host dispatches: about twice the dispatch time under
``tracing.enable()`` alone. Set against ``decode_ms.chat`` (the
unprofiled window), it overstates the host's share of the decode."""


def read(record, profile):
    if record["kind"] != "closed_loop":
        return None
    try:
        from repro_torch.utils import tracing
    except ImportError:
        return None
    names = tracing.snapshot()["names"]
    if not names.get("serve.step", {}).get("count"):
        return None
    decode = names.get("model.decode")
    if not decode or not decode["count"]:
        return None
    return decode["total_ms"] / decode["count"]
