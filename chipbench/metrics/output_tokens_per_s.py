"""Tokens emitted in the window (each admitted request's first token from
its prefill, and one a running request each decode step) over the
window's seconds (host clock)."""


def read(record, profile):
    if record["kind"] != "closed_loop":
        return None
    return record["output_tokens"] / record["window_s"]
