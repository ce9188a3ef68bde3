"""Placing the database on the device, as a share of mine(): the
``mine.scatter`` span over ``mine.run`` (core/drivers.py)."""


def read(rec):
    run = rec.span_seconds("mine.run")
    return 100.0 * rec.span_seconds("mine.scatter") / run if run > 0 else None
