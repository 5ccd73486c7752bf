"""Share of the traced stretch of engine steps in which no device
operation ran, in %."""


def read(record, profile):
    if record["kind"] != "closed_loop" or profile is None:
        return None
    return (1 - profile["busy_s"] / profile["window_s"]) * 100
