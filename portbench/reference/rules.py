"""Plain association rules and top-k recommendations: the serving reference.

The semantics the served answers are held to, written out here without the
port:

* rules ``A => B`` for every split of every frequent itemset of size >= 2
  into two non-empty parts, kept when ``conf = sup(A ∪ B) / sup(A)`` meets
  ``min_conf`` (``conf + 1e-12 >= min_conf``, in float64 from the integer
  counts);
* rule order: confidence descending, then lift descending, ties in
  enumeration order — levels by size, itemsets by bitmask value, and the
  splits of a k-itemset by the k-bit number whose bit j puts its j-th
  smallest item in the antecedent (1 … 2^k − 2);
* float32 metrics: ``conf = u / a``, ``lift = conf * (n / c)``, ``score =
  conf * lift``, with ``u, a, c, n`` the float32 counts;
* a basket's answer: its tenant's rules whose antecedent it holds and whose
  consequent it does not, ranked by score descending and rule index
  ascending; of the first ``min(top_k * overfetch, rules in the arena)``
  of them, each consequent's first, up to ``top_k``.
"""

from __future__ import annotations

import numpy as np
import torch

from .apriori import pack_itemsets


def rules(levels: dict, n_txns: int, n_items: int, min_conf: float,
          score_dtype=torch.float32) -> dict:
    """The rule set of one mined result (``apriori``'s levels) as arrays in
    rank order: ``ante``/``cons`` (R, W) uint32 masks, ``union``/``ante_n``/
    ``cons_n`` int64 counts, and float32 ``score`` computed in ``score_dtype``
    (the control's knob; float32 is the configuration's)."""
    count = {}
    for its, cnt in levels.values():
        for row, c in zip(its.tolist(), np.asarray(cnt).tolist()):
            count[tuple(row)] = int(c)
    ante, cons, union, a_n, c_n = [], [], [], [], []
    for k in sorted(levels):
        if k < 2:
            continue
        its, cnt = levels[k]
        for row, u in zip(its.tolist(), np.asarray(cnt).tolist()):
            for s in range(1, (1 << k) - 1):
                a = tuple(row[j] for j in range(k) if s >> j & 1)
                b = tuple(row[j] for j in range(k) if not s >> j & 1)
                na = count[a]
                if u / na + 1e-12 >= min_conf:
                    ante.append(a)
                    cons.append(b)
                    union.append(int(u))
                    a_n.append(na)
                    c_n.append(count[b])
    union = np.array(union, np.int64)
    a_n = np.array(a_n, np.int64)
    c_n = np.array(c_n, np.int64)
    conf64 = union / a_n
    lift64 = conf64 * n_txns / c_n
    order = np.lexsort((-lift64, -conf64))
    u, a, c = (torch.from_numpy(x[order]).to(score_dtype)
               for x in (union, a_n, c_n))
    n = torch.tensor(float(n_txns), dtype=score_dtype)
    conf = u / a
    lift = conf * (n / c)
    return {
        "ante": _masks([ante[i] for i in order], n_items),
        "cons": _masks([cons[i] for i in order], n_items),
        "union": union[order], "ante_n": a_n[order], "cons_n": c_n[order],
        "score": (conf * lift).to(torch.float32).numpy(),
    }


def _masks(sets: list, n_items: int) -> np.ndarray:
    out = np.zeros((len(sets), -(-n_items // 32)), np.uint32)
    for k in {len(s) for s in sets}:
        rows = [i for i, s in enumerate(sets) if len(s) == k]
        out[rows] = pack_itemsets(np.array([sets[i] for i in rows], np.int64),
                                  n_items)
    return out


def recommend(ruleset: dict, baskets: list, n_items: int, top_k: int,
              fetch: int, device="cpu", block: int = 1024) -> list:
    """Each basket's answer as a list of ``(consequent items, float32
    score)``; ``fetch`` is how many ranked rules the answer is drawn from."""
    R = ruleset["ante"].shape[0]
    if R == 0:
        return [[] for _ in baskets]
    dev = torch.device(device)
    ante = torch.from_numpy(ruleset["ante"].view(np.int32)).to(dev)
    cons = torch.from_numpy(ruleset["cons"].view(np.int32)).to(dev)
    score = torch.from_numpy(ruleset["score"]).to(dev)
    cons_items = [tuple(np.nonzero(row)[0].tolist()) for row in np.unpackbits(
        ruleset["cons"].view(np.uint8), axis=1, bitorder="little")]
    packed = np.zeros((len(baskets), ruleset["ante"].shape[1]), np.uint32)
    for q, b in enumerate(baskets):
        for it in b:
            packed[q, it // 32] |= np.uint32(1 << (it % 32))
    take = min(fetch, R)
    out = []
    for s in range(0, len(baskets), block):
        q = torch.from_numpy(packed[s:s + block].view(np.int32)).to(dev)
        held = ((ante[None] & q[:, None]) == ante[None]).all(-1)
        novel = ((cons[None] & q[:, None]) != cons[None]).any(-1)
        sc = torch.where(held & novel, score[None],
                         torch.tensor(float("-inf"), device=dev))
        vals, idx = torch.sort(sc, dim=1, descending=True, stable=True)
        vals = vals[:, :take].cpu().numpy()
        idx = idx[:, :take].cpu().numpy()
        for v_row, i_row in zip(vals, idx):
            recs, seen = [], set()
            for v, i in zip(v_row, i_row):
                if np.isneginf(v) or len(recs) >= top_k:
                    break
                c = cons_items[i]
                if c not in seen:
                    seen.add(c)
                    recs.append((c, float(v)))
            out.append(recs)
    return out
