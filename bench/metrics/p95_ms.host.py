"""p95_ms.host: p95_ms where the host paces the tail (the device idles at
least half of the traced window); read in the traced run."""
import numpy as np


def read(ctx):
    lat = ctx.query_latencies_ms()
    return float(np.percentile(lat, 95)) if lat.size else None
