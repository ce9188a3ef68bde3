"""Counting jobs a mine (``RuntimeStats.dispatches``): the MapReduce jobs
the paper's pass combining saves; on a mesh each one ends in an
``all_reduce``."""


def read(rec):
    m = rec.counters.get("mines", 0)
    return rec.counters["dispatches"] / m if m else None
