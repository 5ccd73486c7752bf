"""Host clock around the engine's ``_admit`` (admission and one prefill
per admitted request, ending in a synchronisation), summed over the
window and divided by its steps, in ms."""


def read(record, profile):
    if record["kind"] != "closed_loop" or not record["steps"]:
        return None
    spans = record["window_spans"].get("engine.admit")
    if not spans:
        return None
    return sum(spans) / record["steps"] * 1e3
