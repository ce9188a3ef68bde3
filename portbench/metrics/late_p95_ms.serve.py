"""95th percentile of how late the caller handed a query to the server:
the server answers inside ``submit``, so a query that falls due while a
dispatch runs waits in front of it."""

import numpy as np


def read(rec):
    late = rec.counters["late_s"]
    return float(np.percentile(late, 95)) * 1e3 if len(late) else None
