"""The Apriori prune's share of mine(): host seconds in the ``mine.prune``
spans (core/candidates.py ``prune``) over those in ``mine.run``
(core/drivers.py).  None where no ``mine.prune`` span was recorded."""


def read(rec):
    part = [t1 - t0 for n, t0, t1, _ in rec.spans if n == "mine.prune"]
    run = rec.span_seconds("mine.run")
    return 100.0 * sum(part) / run if part and run > 0 else None
