"""Writing the cost model's JSON store, as a share of mine(): seconds in
the ``costmodel.save`` spans (costmodel/model.py ``CostModel.observe``, once
an observation) over those in ``mine.run``.  None where no
``costmodel.save`` span was recorded."""


def read(rec):
    part = [t1 - t0 for n, t0, t1, _ in rec.spans if n == "costmodel.save"]
    run = rec.span_seconds("mine.run")
    return 100.0 * sum(part) / run if part and run > 0 else None
