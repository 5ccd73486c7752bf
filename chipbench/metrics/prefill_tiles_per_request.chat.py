"""The program's ``attn.fwd_tiles`` counter (one for each (q block, kv
block) tile the blocked attention's forward runs) over its
``serve.admitted`` counter, over the traced stretch: the tiles a prefill
runs. None where the program counts no admission."""


def read(record, profile):
    if record["kind"] != "closed_loop":
        return None
    try:
        from repro_torch.utils import tracing
    except ImportError:
        return None
    counters = tracing.snapshot()["counters"]
    admitted = counters.get("serve.admitted")
    if not admitted:
        return None
    return counters.get("attn.fwd_tiles", 0) / admitted
