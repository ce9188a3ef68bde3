"""Mean time of one serving dispatch: the ``cost_s`` of the server's
``serve.dispatch`` spans (serving/admission.py), the host clock around
``RuleServeEngine.serve``, which ends with the answers on the host."""


def read(rec):
    cost = [a["cost_s"] for n, _, _, a in rec.spans if n == "serve.dispatch"]
    return 1e3 * sum(cost) / len(cost) if cost else None
