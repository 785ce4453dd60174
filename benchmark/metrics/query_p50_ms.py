"""The median latency of the traced run's queries, in milliseconds."""

import numpy as np


def read(run):
    lat = run.window.latencies_s
    return 1e3 * float(np.median(lat)) if lat else None
