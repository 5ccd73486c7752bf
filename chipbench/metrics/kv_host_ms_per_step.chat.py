"""Host clock in the KV lake's ``add_sequence``, ``append_tokens`` and
``free_sequence``, summed over the window and divided by its steps, in ms."""

NAMES = ("kv.add_sequence", "kv.append_tokens", "kv.free_sequence")


def read(record, profile):
    if record["kind"] != "closed_loop" or not record["steps"]:
        return None
    spans = record["window_spans"]
    if not any(spans.get(n) for n in NAMES):
        return None
    return sum(sum(spans.get(n, ())) for n in NAMES) / record["steps"] * 1e3
