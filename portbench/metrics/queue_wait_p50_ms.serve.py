"""Median time a query waited in the server's queue, on the server's real
clock: every value of the ``wait_s`` attribute of the ``serve.batch`` spans
(serving/admission.py: the clock at its group's start less the query's
stamp at ``submit``).  None where no span carries ``wait_s``."""

import numpy as np


def read(rec):
    waits = [w for n, _, _, a in rec.spans if n == "serve.batch"
             for w in a.get("wait_s", ())]
    return float(np.median(waits)) * 1e3 if waits else None
