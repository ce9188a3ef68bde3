"""Turning a dispatch's top-k into recommendations on the host: the
``serve.decode`` span of serving/rules_engine.py, in ms a dispatch (over
the count of ``serve.engine_dispatch`` spans).  None where no
``serve.decode`` span was recorded."""


def read(rec):
    part = [t1 - t0 for n, t0, t1, _ in rec.spans if n == "serve.decode"]
    n = sum(1 for s in rec.spans if s[0] == "serve.engine_dispatch")
    return 1e3 * sum(part) / n if part and n else None
