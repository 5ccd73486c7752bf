"""Requests decoded a step over the engine's ``max_batch``, averaged over
the window's steps, in %."""


def read(record, profile):
    occ = record.get("occupancy") if record["kind"] == "closed_loop" else None
    if not occ:
        return None
    return sum(occ) / len(occ) * 100
