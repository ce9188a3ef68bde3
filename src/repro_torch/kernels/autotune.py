"""Cross-family autotune plans for the counting kernels (DESIGN.md §5, §10):
the port of the JAX package's ``kernels/autotune.py``.

The fastest counting family — popcount or matmul, horizontal or vertical —
depends on the card and on the job's shape regime (candidate rows ×
transaction rows/words).  On first use per ``(device, kind, shape-bucket)``
key, :func:`tuned_plan` times every family of its kind with the hand-written
kernels on synthetic data and caches the winner:

* in-process (dict) — so a mining run tunes each bucket at most once;
* on disk (JSON at ``~/.cache/repro_torch/autotune.json``, override with
  ``REPRO_TORCH_AUTOTUNE_CACHE``) — so later processes skip the sweep.  The
  port never reads or writes the reference's ``~/.cache/repro/`` store.

``REPRO_TORCH_AUTOTUNE=0`` disables timing, and so does a CPU device: there
the wrappers run the kernels' plain versions, whose times say nothing about
the kernels (the reference never times interpret-mode Pallas, for the same
reason).  :func:`tuned_plan` then returns None and callers take their static
fallback.

Cache format::

    {"cuda:NVIDIA-H100-80GB-HBM3/plan/count/C4096/T262144/W6/k4":
         {"impl": "jnp", "family": "jnp", "blocks": {}, "timed_us": {...}}}

Keys lead with ``costmodel.measure.device_key``, so a cache written on one
card never pins a plan on another.  Shape buckets are next-pow2 of the
candidate/transaction extents, so a whole run touches a handful of keys.

Two parts of the reference are left out:

* the migration of legacy keys written without a device: the port never
  wrote such keys;
* block sweeps: the hand-written kernels choose their own tiles from the
  shape and no wrapper takes a block size, so :data:`CONFIGS` is empty and
  :func:`tuned_blocks` returns ``{}`` untimed.  Its signature and key format
  stay, so a kernel that exposes a tile can add its configs.

No fallback hides a kernel: a sweep skips a family only for
:data:`SHAPE_ERRORS`, the errors the wrappers' own checks raise.  A failed
``nvcc`` build, a failed launch or a CUDA error reaches the caller.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.costmodel.measure import cache_dir, device_key, time_once

# block configs per family, timed by tuned_blocks: none of the port's
# wrappers takes a block size yet
CONFIGS: dict[str, list[dict]] = {}

PLAN_FAMILIES = {
    "count": ("jnp", "matmul", "vertical", "vertical_matmul"),
    "delta": ("delta_jnp", "delta_matmul"),
    "rules": ("rules_jnp", "rules_matmul"),
}
PLAN_BASELINES = {"count": "jnp", "delta": "delta_jnp", "rules": "rules_jnp"}

# skip (never the baseline / predicted winner) families the calibrated cost
# model prices more than this factor above the predicted best — pure pruning
# of the timing sweep, not a substitute for measuring the finalists
PLAN_PRICE_SKIP = 8.0

# the wrappers' own input checks (kernels.support_count.check_words and the
# like); anything else — a build, launch or CUDA error — propagates
SHAPE_ERRORS = (ValueError, TypeError)

# caps on the synthetic timing shapes: tuning must stay ≪ one counting job
_CAP_C = 4096
_CAP_T_ROWS = 8192     # horizontal: transaction rows
_CAP_T_WORDS = 2048    # vertical: transaction words (= 64k transactions)

# Cross-family plan sweeps time one config per family and persist the winner
# forever, so they can afford (nearly) true candidate extents: families
# scale differently past the cap, so a C=16384 plan timed at C=4096 can pick
# the wrong layout.
_PLAN_CAP_C = 16384

_memory_cache: dict = {}


def cache_path() -> str:
    env = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    if env:
        return env
    return os.path.join(cache_dir(), "autotune.json")


def _load_disk() -> dict:
    try:
        with open(cache_path()) as f:
            out = json.load(f)
        return out if isinstance(out, dict) else {}
    except (OSError, ValueError):
        return {}


def _save_disk(store: dict) -> None:
    path = cache_path()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(store, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # cache is best-effort; in-process dict still holds the winner


def _bucket(n: int) -> int:
    """Next power of two ≥ n (≥ 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def _device(device) -> torch.device:
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device)


def _can_time(device: torch.device) -> bool:
    """Only a card runs the kernels; the CPU runs their plain versions."""
    return device.type == "cuda"


def _disabled() -> bool:
    return os.environ.get("REPRO_TORCH_AUTOTUNE", "1") == "0"


def _words(rng, shape, device) -> torch.Tensor:
    """Random uint32 words as the int32 tensor the kernels take."""
    w = rng.integers(0, 2**32, shape, dtype=np.uint32)
    return torch.from_numpy(w.view(np.int32)).to(device)


def _candidate_runner(impl: str, C: int, T: int, W: int, kmax: int,
                      cap_c: int = _CAP_C, device=None):
    """Synthetic inputs of the bucketed shape on ``device`` (drawn as the
    reference draws them) → ``make(cfg)``, a callable running family
    ``impl``'s wrapper on them."""
    device = _device(device)
    rng = np.random.default_rng(0)
    if impl in ("jnp", "matmul"):
        from .support_count import support_count, support_count_matmul
        fn = support_count_matmul if impl == "matmul" else support_count
        C = min(C, cap_c)
        T = min(T, _CAP_T_ROWS)
        cands, txns = _words(rng, (C, W), device), _words(rng, (T, W), device)
        return lambda cfg: (lambda: fn(cands, txns))
    if impl in ("vertical", "vertical_matmul"):
        from .vertical_count import vertical_count, vertical_count_matmul
        fn = vertical_count_matmul if impl == "vertical_matmul" \
            else vertical_count
        C = min(C, cap_c)
        Tw = min(T, _CAP_T_WORDS)
        n_items = max(W * 32 - 1, 1)
        vdb = rng.integers(0, 2**32, (n_items + 1, Tw), dtype=np.uint32)
        vdb[-1] = 0xFFFFFFFF                      # valid-transaction mask row
        vdb = torch.from_numpy(vdb.view(np.int32)).to(device)
        idx = np.full((C, kmax), n_items, np.int32)
        for j in range(kmax):
            idx[:, j] = rng.integers(0, n_items, C)
        idx = torch.from_numpy(idx).to(device)
        return lambda cfg: (lambda: fn(vdb, idx))
    if impl in ("delta_jnp", "delta_matmul"):
        from .delta_count import delta_count_matmul, delta_count_popcount
        fn = delta_count_matmul if impl == "delta_matmul" \
            else delta_count_popcount
        C = min(C, cap_c)
        T = min(T, _CAP_T_ROWS)       # slab rows (added + evicted)
        cands, txns = _words(rng, (C, W), device), _words(rng, (T, W), device)
        signs = torch.from_numpy(
            rng.choice(np.array([-1, 1], np.int32), T)).to(device)
        return lambda cfg: (lambda: fn(cands, txns, signs))
    if impl in ("rules_jnp", "rules_matmul"):
        from .rule_match import rule_scores, rule_scores_matmul
        fn = rule_scores_matmul if impl == "rules_matmul" else rule_scores
        R = min(C, cap_c)             # rules play the candidate role
        Q = min(T, _CAP_T_ROWS)       # baskets play the transaction role
        antes = rng.integers(0, 2**32, (R, W), dtype=np.uint32)
        cons = rng.integers(0, 2**32, (R, W), dtype=np.uint32) & ~antes
        scores = torch.from_numpy(rng.random(R, dtype=np.float32)).to(device)
        antes = torch.from_numpy(antes.view(np.int32)).to(device)
        cons = torch.from_numpy(cons.view(np.int32)).to(device)
        baskets = _words(rng, (Q, W), device)
        return lambda cfg: (lambda: fn(antes, cons, scores, baskets))
    raise ValueError(f"unknown impl {impl!r}")


def tuned_blocks(impl: str, *, C: int, T: int, W: int = 1, kmax: int = 1,
                 device=None) -> dict:
    """Best block config for a counting job of the given shape bucket.

    Args:
      impl: a family name ("jnp", "vertical_matmul", "rules_jnp", ...).
      C:    padded candidate rows.
      T:    transaction rows (horizontal impls) or words (vertical impls).
      W:    words per bitmask (horizontal) / of the item axis (vertical).
      kmax: items per candidate (vertical impls only).
      device: the torch device (default: the card when one is present).

    Returns a dict of keyword block sizes for the counting call: ``{}``
    untimed for a family without :data:`CONFIGS` (all of the port's today),
    on the CPU, and under ``REPRO_TORCH_AUTOTUNE=0``.
    """
    device = _device(device)
    if impl not in CONFIGS or not _can_time(device) or _disabled():
        return {}
    key = f"{device_key(device)}/{impl}/C{_bucket(C)}/T{_bucket(T)}/W{W}/k{kmax}"
    if key in _memory_cache:
        return dict(_memory_cache[key])
    disk = _load_disk()
    if key in disk:
        _memory_cache[key] = dict(disk[key])
        return dict(disk[key])

    make = _candidate_runner(impl, _bucket(C), _bucket(T), W, kmax,
                             device=device)
    best_cfg, best_t = CONFIGS[impl][0], float("inf")
    for cfg in CONFIGS[impl]:
        try:
            t = time_once(make(cfg))
        except SHAPE_ERRORS:    # a config can be invalid for exotic shapes
            continue
        if t < best_t:
            best_cfg, best_t = cfg, t
    _memory_cache[key] = dict(best_cfg)
    disk[key] = dict(best_cfg)
    _save_disk(disk)
    return dict(best_cfg)


def _family_shape(kind: str, family: str, C: int, T: int):
    """Per-family (C, T) timing shape: vertical families take transaction
    *words*, everything else rows; rules' T axis is query baskets."""
    if kind == "count" and family.startswith("vertical"):
        return C, max((T + 31) // 32, 1)
    return C, T


def _strip_family(kind: str, family: str) -> str:
    """Family key → the wrapper-level impl name callers dispatch on."""
    for prefix in ("delta_", "rules_"):
        if family.startswith(prefix):
            return family[len(prefix):]
    return family


def tuned_plan(kind: str, *, C: int, T: int, W: int = 1, kmax: int = 1,
               device=None) -> dict | None:
    """Cross-family winner for one shape bucket (DESIGN.md §10).

    Args:
      kind: "count" (mining support counts — horizontal *and* vertical
            families compete), "delta" (streaming slabs), "rules" (serving).
      C:    candidate/rule rows.
      T:    transaction/basket *rows* (vertical families are timed at the
            equivalent word count internally).
      W:    words per bitmask.
      kmax: items per candidate (the vertical gather width).
      device: the torch device (default: the card when one is present).

    Returns ``{"impl": <wrapper impl name>, "family": <family key>,
    "blocks": {...}, "timed_us": {family: µs}}`` — the measured argmin over
    every eligible family, with the popcount baseline always timed — or None
    on the CPU or under ``REPRO_TORCH_AUTOTUNE=0`` (callers fall back to
    their static default).  Winners are cached in-process and on disk under
    ``{device}/plan/...`` keys.  A calibrated cost model prunes families
    priced ≥ ``PLAN_PRICE_SKIP``× the predicted best from the sweep (never
    the baseline or the predicted winner).
    """
    if _disabled():
        return None
    if kind not in PLAN_FAMILIES:
        raise ValueError(f"unknown plan kind {kind!r}; "
                         f"options: {tuple(PLAN_FAMILIES)}")
    device = _device(device)
    if not _can_time(device):
        return None
    families = PLAN_FAMILIES[kind]
    baseline = PLAN_BASELINES[kind]
    dev = device_key(device)
    key = f"{dev}/plan/{kind}/C{_bucket(C)}/T{_bucket(T)}/W{W}/k{kmax}"
    if key in _memory_cache:
        return dict(_memory_cache[key])
    disk = _load_disk()
    if key in disk:
        _memory_cache[key] = dict(disk[key])
        return dict(disk[key])

    # cost-model pruning: families the calibrated fits price far above the
    # predicted best are skipped (timing still decides among the finalists)
    from repro_torch.costmodel.model import default_model
    from repro_torch.roofline import count_job_ops
    mdl = default_model()
    predicted: dict[str, float] = {}
    for fam in families:
        p = mdl.predict(f"{dev}/{_strip_family(kind, fam)}/count",
                        count_job_ops(C, T, W))
        if p is not None and p > 0:
            predicted[fam] = p
    keep = set(families)
    if len(predicted) >= 2:
        pbest_fam = min(predicted, key=predicted.get)
        pbest = predicted[pbest_fam]
        keep = {f for f in families
                if f == baseline or f == pbest_fam
                or predicted.get(f, 0.0) < PLAN_PRICE_SKIP * pbest}

    timed_us: dict[str, float] = {}
    best_fam, best_blocks, best_t = None, None, float("inf")
    for fam in families:
        if fam not in keep:
            continue
        fc, ft = _family_shape(kind, fam, C, T)
        blocks = tuned_blocks(fam, C=fc, T=ft, W=W, kmax=kmax, device=device)
        try:
            make = _candidate_runner(fam, _bucket(fc), _bucket(ft), W, kmax,
                                     cap_c=_PLAN_CAP_C, device=device)
            t = time_once(make(blocks))
        except SHAPE_ERRORS:    # a family can refuse an exotic shape
            continue
        timed_us[fam] = t * 1e6
        if t < best_t:
            best_fam, best_blocks, best_t = fam, blocks, t
    if best_fam is None:        # every family refused: fall back to baseline
        fc, ft = _family_shape(kind, baseline, C, T)
        best_fam = baseline
        best_blocks = tuned_blocks(baseline, C=fc, T=ft, W=W, kmax=kmax,
                                   device=device)
    plan = {"impl": _strip_family(kind, best_fam), "family": best_fam,
            "blocks": dict(best_blocks), "timed_us": timed_us}
    _memory_cache[key] = dict(plan)
    disk[key] = dict(plan)
    _save_disk(disk)
    return dict(plan)
