"""The 95th percentile, over every call of the window, of a call's
latency: its host events handed over to its detections in host
memory."""
import numpy as np


def read(run):
    lat = run.driver.latencies
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3
