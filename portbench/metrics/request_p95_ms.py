"""The 95th percentile of the latency of all the window's requests (host
clock from the call to the synchronise after it), in ms."""

import numpy as np


def read(s):
    if not s["latencies_s"]:
        return None
    return float(np.percentile(np.asarray(s["latencies_s"]), 95)) * 1e3
