"""Queries the result cache answered (serving/admission.py ResultCache),
as a share of those offered."""


def read(rec):
    q = rec.counters["queries"]
    return 100.0 * rec.counters["cached"] / q if q else None
