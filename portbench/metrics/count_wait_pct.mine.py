"""The host's wait on its counting jobs, as a share of mine(): seconds in
the ``mine.count_wait`` spans (core/phases.py ``wait_count``: the job's
event, then the copy of its results back) over those in ``mine.run``.
None where no ``mine.count_wait`` span was recorded."""


def read(rec):
    part = [t1 - t0 for n, t0, t1, _ in rec.spans if n == "mine.count_wait"]
    run = rec.span_seconds("mine.run")
    return 100.0 * sum(part) / run if part and run > 0 else None
