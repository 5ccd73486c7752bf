"""Share of the traced stretch of training steps in which no device
operation ran, in %."""


def read(record, profile):
    if record["kind"] != "train" or profile is None:
        return None
    return (1 - profile["busy_s"] / profile["window_s"]) * 100
