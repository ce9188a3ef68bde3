"""Writing the cost model's JSON store, in ms a dispatch: the
``costmodel.save`` spans (costmodel/model.py ``CostModel.observe``, once a
dispatch's cost is observed) over the count of ``serve.engine_dispatch``
spans.  None where no ``costmodel.save`` span was recorded."""


def read(rec):
    part = [t1 - t0 for n, t0, t1, _ in rec.spans if n == "costmodel.save"]
    n = sum(1 for s in rec.spans if s[0] == "serve.engine_dispatch")
    return 1e3 * sum(part) / n if part and n else None
