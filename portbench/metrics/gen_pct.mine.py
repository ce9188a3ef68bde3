"""Candidate generation's share of mine(): host seconds in the ``mine.gen``
spans (core/phases.py) over those in ``mine.run`` (core/drivers.py)."""


def read(rec):
    run = rec.span_seconds("mine.run")
    return 100.0 * rec.span_seconds("mine.gen") / run if run > 0 else None
