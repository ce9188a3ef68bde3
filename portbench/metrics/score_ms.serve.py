"""Enqueuing a dispatch's device work: the ``serve.score`` span of
serving/rules_engine.py (the baskets' upload, the scoring kernel and
``stable_top_k``, as launched), in ms a dispatch (over the count of
``serve.engine_dispatch`` spans).  None where no ``serve.score`` span was
recorded."""


def read(rec):
    part = [t1 - t0 for n, t0, t1, _ in rec.spans if n == "serve.score"]
    n = sum(1 for s in rec.spans if s[0] == "serve.engine_dispatch")
    return 1e3 * sum(part) / n if part and n else None
