"""Host clock around the engine's batched decode-step call, ending in a
synchronisation, averaged over the window's steps, in ms."""


def read(record, profile):
    spans = record.get("window_spans", {}).get("engine.decode")
    if record["kind"] != "closed_loop" or not spans:
        return None
    return sum(spans) / len(spans) * 1e3
