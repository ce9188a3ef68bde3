"""The join's share of mine(): host seconds in the ``mine.join`` spans
(core/candidates.py: ``join`` under ``apriori_gen`` and ``non_apriori_gen``,
and ``SpecJoin.resolve``) over those in ``mine.run`` (core/drivers.py).
None where no ``mine.join`` span was recorded."""


def read(rec):
    part = [t1 - t0 for n, t0, t1, _ in rec.spans if n == "mine.join"]
    run = rec.span_seconds("mine.run")
    return 100.0 * sum(part) / run if part and run > 0 else None
