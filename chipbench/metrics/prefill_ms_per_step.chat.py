"""The program's ``serve.prefill`` spans (one a request, from its prefill
call through the host's read of its first token) summed over the traced
stretch and divided by its ``serve.step`` spans, in ms. None where the
program has no such spans.

Read in the profiled stretch: where the prefill is host-bound (one-token
tiles at prime prompt lengths) the profiler's cost on each dispatched
operator inflates it, about 3x against ``tracing.enable()`` alone."""


def read(record, profile):
    if record["kind"] != "closed_loop":
        return None
    try:
        from repro_torch.utils import tracing
    except ImportError:
        return None
    names = tracing.snapshot()["names"]
    steps = names.get("serve.step", {}).get("count")
    if not steps:
        return None
    return names.get("serve.prefill", {}).get("total_ms", 0.0) / steps
