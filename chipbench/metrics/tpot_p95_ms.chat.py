"""95th percentile (linear interpolation) over every request that finished
in the window of (finish - first token) / (output tokens - 1), in ms on
the host clock. A per-layer metric: the engine's step is paced by the
host, and its runs spread too widely for an end-to-end bound (PERF.md)."""

import numpy as np


def read(record, profile):
    if record["kind"] != "closed_loop" or not record["tpot_s"]:
        return None
    return float(np.percentile(record["tpot_s"], 95)) * 1e3
