"""What the mining drivers share: the inputs of a mining cell, one call of
the port's ``mine()``, what a traced window's spans say about the counting
jobs, and the check against the reference."""

from __future__ import annotations

import numpy as np

from portbench.data.generators import generate, pack
from portbench.reference import apriori


def inputs(config: dict, seed: int):
    """The configuration's rows (the same in every run), in an order drawn
    from ``seed``: ``(rows (T, I) bool, packed (T, W) uint32)``.  Every seed
    mines the same itemsets; only the order of the rows, and so which rows
    each card of a mesh holds, changes with it."""
    rows = generate(config["dataset"])
    rows = rows[np.random.default_rng(seed).permutation(rows.shape[0])]
    return rows, pack(rows)


def mine_once(db: np.ndarray, config: dict, runtime):
    """One ``mine()`` of the whole database on ``runtime``, as a user calls
    it; returns the port's MiningResult (its levels are on the host)."""
    from repro_torch.core.drivers import mine
    m = config["mine"]
    return mine(db_masks=db, n_items=n_items(config), min_sup=m["min_sup"],
                algorithm=m["algorithm"], runtime=runtime)


def n_items(config: dict) -> int:
    d = config["dataset"]
    return int(d["n_items"]) if "n_items" in d else int(sum(d["value_counts"]))


def frequent(levels: dict) -> int:
    return int(sum(np.asarray(m).shape[0] for m, _ in levels.values()))


def count_jobs(spans: list, n_items_: int) -> list:
    """``("count", C, T, n_items)`` for every counting job in the spans:
    ``C`` the job's candidates before bucket padding, ``T`` its mine's
    transactions."""
    jobs, n_txns = [], None
    for name, _, _, attrs in sorted(spans, key=lambda s: s[1]):
        if name == "mine.run":
            n_txns = int(attrs["n_txns"])
        elif name == "mine.count" and n_txns is not None:
            jobs.append(("count", int(attrs["n_candidates"]), n_txns,
                         n_items_))
    return jobs


def reference(rows: np.ndarray, config: dict) -> dict:
    """The reference's levels for the cell, canonical."""
    lv = apriori.apriori(rows, config["mine"]["min_sup"])
    k_items = rows.shape[1]
    return apriori.canonical({k: (apriori.pack_itemsets(its, k_items), c)
                              for k, (its, c) in lv.items()})


def check(results: list, want: dict) -> int:
    """Itemsets wrong over every mine's levels."""
    return sum(apriori.mismatches(apriori.canonical(lv), want)
               for lv in results)
