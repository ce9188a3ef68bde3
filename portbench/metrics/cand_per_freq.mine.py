"""Rows the counting kernels counted (``RuntimeStats.rows_counted``, bucket
padding included) for each frequent itemset found: the pass-combining trade
of un-pruned candidates against jobs saved."""


def read(rec):
    f = rec.counters.get("frequent", 0)
    return rec.counters["rows_counted"] / f if f else None
