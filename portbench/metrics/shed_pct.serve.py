"""Queries admission shed (predicted to miss the SLO, or displaced by fair
shedding), as a share of those offered."""


def read(rec):
    q = rec.counters["queries"]
    return 100.0 * rec.counters["shed"] / q if q else None
