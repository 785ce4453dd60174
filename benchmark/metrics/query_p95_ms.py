"""The 95th percentile of every answered query's latency, from its call to
its answer in host memory, in milliseconds."""

import numpy as np


def read(run):
    lat = run.window.latencies_s
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
