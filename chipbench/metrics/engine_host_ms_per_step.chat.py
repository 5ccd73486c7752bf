"""Self time of the program's ``serve.step`` and ``serve.admit`` spans (each
span's duration less what its child spans cover: the engine's own Python
and dispatch around admission, prefill, decode, sampling and the KV lake)
over the traced stretch, divided by its ``serve.step`` spans, in ms. None
where the program has no such spans. The ``serve.decode`` child keeps the
decode call, and the benchmark's synchronised ``engine.decode`` wrapper
around it, out of ``serve.step``'s self time.

An upper bound on the engine's host work: the stretch is profiled, and the
profiler slows the host's Python 4-5x against the same spans under
``tracing.enable()`` alone; and the benchmark's ``engine.admit`` wrapper
synchronises the device after ``_admit`` returns, inside ``serve.step``,
so that wait is counted here too."""


def read(record, profile):
    if record["kind"] != "closed_loop":
        return None
    try:
        from repro_torch.utils import tracing
    except ImportError:
        return None
    names = tracing.snapshot()["names"]
    step = names.get("serve.step")
    if not step or not step["count"]:
        return None
    admit = names.get("serve.admit", {}).get("self_ms", 0.0)
    return (step["self_ms"] + admit) / step["count"]
