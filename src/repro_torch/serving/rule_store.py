"""RuleStore: a tenant registry of versioned RuleSets packed into one
device-resident arena (DESIGN.md §12) — the port of the JAX package's
``serving/rule_store.py``.

All tenants' rules live in **one packed arena** (row-concatenated
``(R_total, W)`` bitmask arrays plus per-tenant row offsets and a tenant-id
column), so a single fused ``rule_scores`` dispatch scores a mixed-tenant
query batch.

**Tenant isolation is a bitset trick, not a new kernel.**  Each tenant gets
one *tag bit* — an extra item id past the shared catalog (item
``n_items_base + slot``).  Every rule antecedent in the arena carries its
tenant's tag bit, and every packed query basket carries exactly its own
tenant's tag bit, so the unchanged containment test ``ante ⊆ basket`` can
only fire for same-tenant rules.  Consequent masks carry no tag bits, so
the novelty filter and host decode are untouched.  A single-tenant store
skips the tag bits entirely.

**Atomic versioned swaps**: everything derived from the registry — the
arena tensors on the device, float64 metric columns and offsets — is
bundled into one immutable :class:`ArenaState`, rebuilt on
:meth:`RuleStore.swap_rules` and published with a single reference
assignment.  A serve call captures the state once, so in-flight
mixed-tenant queries never observe a torn table; each tenant's version
counter keys the result cache, so a swap invalidates that tenant's cached
answers atomically.  Unchanged tenants' packed blocks are reused across
rebuilds, so a swap costs O(changed tenant) host work plus one concatenate
and one upload.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.core.bitset import (WORD_BITS, n_words, to_device_words,
                                     unpack_itemsets)
from repro_torch.core.mapreduce import resolve_device
from repro_torch.core.rules import RuleSet

DEFAULT_TENANT = "default"


def _pack_block(rules: RuleSet, W: int, tag: int | None) -> tuple:
    """One tenant's (ante, cons) masks widened to arena width ``W`` words,
    with the tenant tag bit OR-ed into every antecedent (``tag`` is the
    arena-wide item id of the tenant's tag bit; None = untagged arena)."""
    R = len(rules)
    w_t = rules.ante_masks.shape[1] if R else 0
    ante = np.zeros((R, W), np.uint32)
    cons = np.zeros((R, W), np.uint32)
    if R:
        ante[:, :w_t] = rules.ante_masks
        cons[:, :w_t] = rules.cons_masks
        if tag is not None:
            ante[:, tag // WORD_BITS] |= np.uint32(1 << (tag % WORD_BITS))
    return ante, cons


class ArenaState:
    """Immutable snapshot of the whole registry — the unit of atomic publish.

    Provides everything a serve dispatch needs: the packed arena on the
    device (``d_ante``/``d_cons`` as int32 views of the uint32 words,
    ``d_scores`` float32), per-tenant offsets/versions, exact float64 metric
    columns in arena row order, the lazy consequent-decode cache and the
    scoring family resolved per padded query count (``plans``, filled by
    the engine, so a swap resolves again).
    """

    def __init__(self, entries: dict, device: torch.device):
        self.device = device
        self.tenants = tuple(entries)
        self.tagged = len(self.tenants) > 1
        self.n_items_base = max(
            [e.rules.n_items for e in entries.values()], default=1)
        self.n_items = self.n_items_base + (
            len(self.tenants) if self.tagged else 0)
        self.W = n_words(max(self.n_items, 1))
        self.versions = {t: e.version for t, e in entries.items()}
        self.rulesets = {t: e.rules for t, e in entries.items()}
        self.slots = {t: (self.n_items_base + i if self.tagged else None)
                      for i, t in enumerate(self.tenants)}

        antes, conss, scores, confs, lifts, tids = [], [], [], [], [], []
        self.offsets: dict[str, int] = {}
        off = 0
        for i, (t, e) in enumerate(entries.items()):
            a, c = e.packed(self.W, self.slots[t])
            conf64, lift64 = e.metrics()
            self.offsets[t] = off
            off += len(e.rules)
            antes.append(a)
            conss.append(c)
            scores.append(e.rules.score)
            confs.append(conf64)
            lifts.append(lift64)
            tids.append(np.full(len(e.rules), i, np.int32))
        z = np.zeros((0, self.W), np.uint32)
        self.ante_masks = np.concatenate(antes, axis=0) if antes else z
        self.cons_masks = np.concatenate(conss, axis=0) if conss else z
        self.tenant_ids = (np.concatenate(tids)
                           if tids else np.zeros(0, np.int32))
        self.conf64 = (np.concatenate(confs)
                       if confs else np.zeros(0, np.float64))
        self.lift64 = (np.concatenate(lifts)
                       if lifts else np.zeros(0, np.float64))
        self.d_ante = to_device_words(self.ante_masks, device)
        self.d_cons = to_device_words(self.cons_masks, device)
        self.d_scores = torch.from_numpy(np.ascontiguousarray(
            np.concatenate(scores) if scores else np.zeros(0),
            dtype=np.float32)).to(device)
        self.cons_cache: dict[int, tuple] = {}
        self.plans: dict[int, str] = {}

    def __len__(self) -> int:
        return self.ante_masks.shape[0]

    @property
    def rules(self) -> RuleSet:
        """The sole tenant's RuleSet (single-tenant compatibility surface)."""
        if len(self.tenants) != 1:
            raise ValueError(
                f"store holds {len(self.tenants)} tenants; address one by "
                f"name instead of .rules")
        return self.rulesets[self.tenants[0]]

    def tenant_of(self, r: int) -> str:
        return self.tenants[int(self.tenant_ids[r])]

    def cons_tuple(self, r: int) -> tuple:
        """Lazy host decode of one rule's consequent (tag bits never appear
        in consequent masks, so arena rows decode like tenant-local ones)."""
        if r not in self.cons_cache:
            self.cons_cache[r] = unpack_itemsets(
                self.cons_masks[r:r + 1])[0]
        return self.cons_cache[r]

    def pack(self, pairs) -> np.ndarray:
        """(tenant, basket) pairs → (Q, W) uint32 arena bitsets.

        Items are clipped to the query's own tenant catalog (ids ≥ that
        tenant's ``n_items`` are ignored, exactly as a per-tenant engine
        would), then the tenant's tag bit is OR-ed in so only its rules can
        fire.  Unknown tenants raise — admission happens upstream.
        """
        out = np.zeros((len(pairs), self.W), np.uint32)
        for q, (tenant, basket) in enumerate(pairs):
            if tenant not in self.rulesets:
                raise KeyError(f"unknown tenant {tenant!r}; "
                               f"registered: {list(self.tenants)}")
            n_it = self.rulesets[tenant].n_items
            row = out[q]
            for it in basket:
                if 0 <= it < n_it:
                    row[it // WORD_BITS] |= np.uint32(1 << (it % WORD_BITS))
            slot = self.slots[tenant]
            if slot is not None:
                row[slot // WORD_BITS] |= np.uint32(1 << (slot % WORD_BITS))
        return out


class _Entry:
    """One tenant's registry slot: RuleSet, version, and per-geometry caches
    (packed blocks + metric columns survive *other* tenants' swaps)."""

    def __init__(self, rules: RuleSet, version: int = 0):
        self.rules = rules
        self.version = version
        self._packed: dict = {}
        self._metrics = None

    def packed(self, W: int, tag: int | None):
        key = (W, tag)
        if key not in self._packed:
            self._packed = {key: _pack_block(self.rules, W, tag)}
        return self._packed[key]

    def metrics(self):
        if self._metrics is None:
            _, conf64, lift64, _ = self.rules.exact_metrics()
            self._metrics = (conf64, lift64)
        return self._metrics


class RuleStore:
    """The tenant registry.  Mutations (register/swap) rebuild an
    :class:`ArenaState` and publish it atomically; reads just take
    :attr:`state` — no lock on the serve path.

    Args:
      rules: single-tenant convenience — registers one RuleSet under
        :data:`DEFAULT_TENANT`.
      tenants: ``{tenant_name: RuleSet}`` initial registry (insertion order
        fixes arena row order and tag-slot assignment).
      device: where the arena lives — "cuda" (default; raises without a
        card) or "cpu".
    """

    def __init__(self, rules: RuleSet | None = None, *,
                 tenants: dict | None = None, device="cuda"):
        if (rules is None) == (tenants is None):
            raise ValueError("pass exactly one of rules= or tenants=")
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        init = tenants if tenants is not None else {DEFAULT_TENANT: rules}
        self._entries = {t: _Entry(rs) for t, rs in init.items()}
        self._state = ArenaState(self._entries, self.device)

    @property
    def state(self) -> ArenaState:
        return self._state

    @property
    def tenants(self) -> tuple:
        return self._state.tenants

    def version(self, tenant: str) -> int:
        return self._state.versions[tenant]

    def ruleset(self, tenant: str = DEFAULT_TENANT) -> RuleSet:
        return self._state.rulesets[tenant]

    def swap_rules(self, tenant: str, rules: RuleSet,
                   warm=None) -> ArenaState:
        """Atomically replace (or register) one tenant's RuleSet.

        The complete successor :class:`ArenaState` is built first —
        ``warm(state)``, when given, runs dispatches against it so the first
        post-swap dispatch pays no kernel build or first launch — and only
        then published with one reference assignment.  Readers that captured
        the old state keep a complete old table; the tenant's version counter
        bumps, which is what invalidates its cached results.
        """
        with self._lock:
            prev = self._entries.get(tenant)
            entry = _Entry(rules, (prev.version + 1) if prev else 0)
            entries = dict(self._entries)
            entries[tenant] = entry
            state = ArenaState(entries, self.device)
            if warm is not None:
                warm(state)
            self._entries = entries
            self._state = state
        return state
