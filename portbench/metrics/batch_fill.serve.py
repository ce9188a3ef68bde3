"""Mean queries a dispatch (``n_queries`` of the ``serve.dispatch`` spans):
how full admission's micro-batches run."""


def read(rec):
    n = [a["n_queries"] for name, _, _, a in rec.spans
         if name == "serve.dispatch"]
    return sum(n) / len(n) if n else None
