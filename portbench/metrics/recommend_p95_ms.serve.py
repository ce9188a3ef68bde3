"""95th percentile of the answered queries' latency, due time to answer,
on the harness's clock: the serving cell's tail.  A per-layer metric, not
an end-to-end one: on the shared host of the H100 it was measured on, its
spread between runs of one code (28-42%) is wider than any bound the
benchmark may set (PERF.md)."""

import numpy as np


def read(rec):
    lat = rec.counters["latency_s"]
    return float(np.percentile(lat, 95)) * 1e3 if len(lat) else None
