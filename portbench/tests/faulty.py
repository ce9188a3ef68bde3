"""Faults planted under the timed path, for test_portbench_faults.py.  Each
patches the port in the process that runs it; ``no_exchange_worker`` is a
mesh worker that leaves out the exchange between cards."""

from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def count_altered():
    """One candidate's count off by one where the kernel produces it."""
    from repro_torch.core import mapreduce
    orig = mapreduce.local_counts

    def local_counts(db, payload, impl):
        out = orig(db, payload, impl).clone()
        out[0] += 1
        return out
    return patched(mapreduce, "local_counts", local_counts)


def half_the_rows():
    """Counts over the first half of the transactions, doubled."""
    from repro_torch.core import mapreduce
    orig = mapreduce.local_counts

    def local_counts(db, payload, impl):
        return 2 * orig(db[:db.shape[0] // 2], payload, impl)
    return patched(mapreduce, "local_counts", local_counts)


def phases_unchanged():
    """Every phase after the first job returns the levels as they were."""
    from repro_torch.core import drivers
    from repro_torch.core.phases import PhaseResult

    def run_phase(runtime, db, n_txns, prev, k_prev, *a, **kw):
        return PhaseResult(k_prev + 1, 0, [], 0.0, 0.0, 0.0, [], {}, False)
    return patched(drivers, "run_phase", run_phase)


def answer_altered():
    """Each answer's first recommendation scored one ulp higher."""
    from repro_torch.serving import rules_engine
    orig = rules_engine.RuleServeEngine._decode

    def _decode(self, state, vals, idx, k):
        out = orig(self, state, vals, idx, k)
        for recs in out:
            if recs:
                r = recs[0]
                recs[0] = rules_engine.Recommendation(
                    r.consequent, r.confidence, r.lift,
                    float(np.nextafter(np.float32(r.score), np.float32(9))))
        return out
    return patched(rules_engine.RuleServeEngine, "_decode", _decode)


def half_the_queries():
    """A dispatch scores the first half of its queries and gives the rest
    the same answers, in turn."""
    from repro_torch.serving import rules_engine
    orig = rules_engine.RuleServeEngine._dispatch

    def _dispatch(self, state, packed, k):
        h = max(packed.shape[0] // 2, 1)
        vals, idx = orig(self, state, packed[:h], k)
        reps = -(-packed.shape[0] // h)
        return (np.tile(vals, (reps, 1))[:packed.shape[0]],
                np.tile(idx, (reps, 1))[:packed.shape[0]])
    return patched(rules_engine.RuleServeEngine, "_dispatch", _dispatch)


def dispatch_unchanged():
    """A dispatch hands back its no-match state: every score -inf."""
    from repro_torch.serving import rules_engine
    orig = rules_engine.RuleServeEngine._dispatch

    def _dispatch(self, state, packed, k):
        vals, idx = orig(self, state, packed, k)
        return np.full_like(vals, -np.inf), idx
    return patched(rules_engine.RuleServeEngine, "_dispatch", _dispatch)


def no_exchange_worker(rank, spec, out):
    """A mesh worker whose counting jobs leave out the exchange of partial
    counts: in place of the ``all_reduce`` every card takes card 0's own
    counts (a broadcast, so the processes stay in step)."""
    import torch.distributed as dist

    from portbench.drivers.mine_mesh import worker
    from repro_torch.core import mapreduce

    def _reduce(self, vec):
        if self.mesh.size == 1:
            return vec, None
        dist.broadcast(vec, 0)
        return vec[:-1], vec[-1]
    mapreduce.MapReduceRuntime._reduce = _reduce
    worker(rank, spec, out)
