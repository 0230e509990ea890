"""95th percentile of the query latency, submit to answer, in the traced
run of a cell whose card is idle most of the window: the host's tail."""
import numpy as np


def read(run):
    lat = run.latencies_ms()
    return float(np.percentile(lat, 95)) if lat else None
