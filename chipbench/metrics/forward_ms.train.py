"""Device time of the train step's ``train.forward`` phase a graph replay,
in ms: the program's timing events at the phase's boundaries inside the
graph, read for each replay of the traced stretch, summed and divided by
the replays (``graph.replay``). None where the program records none."""


def read(record, profile):
    if record["kind"] != "train":
        return None
    try:
        from repro_torch.utils import tracing
    except ImportError:
        return None
    names = tracing.snapshot()["names"]
    replays = names.get("graph.replay", {}).get("count")
    if not replays:
        return None
    return names.get("train.forward", {}).get("device_ms", 0.0) / replays
