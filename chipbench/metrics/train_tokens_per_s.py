"""Input positions of every training step completed in the window over
the window's seconds (host clock, the card synchronised after each step).
A position is a decoder token, plus an encoder frame for audio."""


def read(record, profile):
    if record["kind"] != "train":
        return None
    return record["positions"] / record["window_s"]
