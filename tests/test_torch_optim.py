"""The port's AdamW (``repro_torch/optim``) against the JAX package's, on
the CPU: the schedule, one update after another on equal parameters and
gradients (float32 and bf16 parameters, compression on and off), the
int8 compression's scale per reference leaf, and its error feedback.

Tolerances, each beside its assert: the schedule is equal bit for bit;
an update is float32 arithmetic in the reference's order, but XLA may fuse
a multiply and an add, so float32 parameters and moments are held to 1e-6
of their largest magnitude (measured: at most 2.4e-7), the error buffer
(a difference of near-equal values) to 1e-6 of the largest gradient, bf16
parameters to one bf16 ulp of their largest magnitude (2^-8; measured:
one ulp where a float32 difference crosses a rounding boundary).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as RefConfig
from repro.optim import adamw as ref_adamw
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.convert import (STACKS, leaf_groups, reference_leaves,
                                       to_torch)
from repro_torch.optim import AdamWConfig, adamw

SHAPES = {"a": (5, 7), "b": (3,), "c": (2, 4, 6)}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _rel(want, got: torch.Tensor, scale=None) -> float:
    """max |want - got| over max |scale| (``want`` by default)."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    scale = want if scale is None else np.asarray(scale, np.float32)
    return float(np.abs(want - _np(got)).max() / (np.abs(scale).max() + 1e-30))


@pytest.mark.parametrize("step", [0, 5, 10, 57, 100])
def test_schedule_equals_the_reference(step):
    kw = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    want = np.asarray(ref_adamw.schedule(RefConfig(**kw), jnp.asarray(step)))
    got = adamw.schedule(AdamWConfig(**kw), torch.tensor(step))
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()      # bit for bit


def test_adamw_schedule():
    """The reference's test_adamw_schedule, on the port."""
    opt = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    assert float(adamw.schedule(opt, 5)) == 0.5
    assert abs(float(adamw.schedule(opt, 10)) - 1.0) < 1e-6
    assert abs(float(adamw.schedule(opt, 100)) - 0.1) < 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compress", [False, True])
def test_apply_updates_matches_the_reference(dtype, compress):
    """Four updates from equal parameters and gradients (bf16 gradients
    for bf16 parameters, as a bf16 model's backward gives), the clipping
    norm crossed on the way: parameters, m, v, err, step and the metrics
    against the reference's jitted ``apply_updates``."""
    rng = np.random.default_rng(0)
    kw = dict(lr=3e-2, warmup_steps=2, total_steps=10, compress=compress,
              clip_norm=2.0)
    ref_cfg, cfg = RefConfig(**kw), AdamWConfig(**kw)
    jdt = jnp.dtype(dtype)
    ref_p = {k: jnp.asarray(rng.normal(size=s), jdt)
             for k, s in SHAPES.items()}
    params = {k: to_torch(np.asarray(v)).clone() for k, v in ref_p.items()}
    ref_state = ref_adamw.init_state(ref_p, ref_cfg)
    state = adamw.init_state(params, cfg)
    update = jax.jit(lambda p, g, s: ref_adamw.apply_updates(p, g, s,
                                                             ref_cfg))
    ids = {k: id(v) for k, v in params.items()}
    float_tol = 1e-6
    param_tol = float_tol if dtype == "float32" else 2.0 ** -8
    for it in range(4):
        g = {k: jnp.asarray(rng.normal(size=s) * (0.5 + it), jdt)
             for k, s in SHAPES.items()}
        ref_p, ref_state, ref_m = update(ref_p, g, ref_state)
        params, state, metrics = adamw.apply_updates(
            params, {k: to_torch(np.asarray(v)) for k, v in g.items()},
            state, cfg)
        assert {k: id(v) for k, v in params.items()} == ids   # in place
        assert int(state["step"]) == int(ref_state["step"]) == it + 1
        for k in SHAPES:
            assert params[k].dtype == getattr(torch, dtype)
            assert _rel(ref_p[k], params[k]) <= param_tol, (it, k)
            for key in ("m", "v"):
                assert _rel(ref_state[key][k], state[key][k]) <= float_tol
            if compress:
                assert _rel(ref_state["err"][k], state["err"][k],
                            g[k].astype(jnp.float32)) <= float_tol
        for key in ("grad_norm", "lr"):
            assert abs(float(ref_m[key]) - float(metrics[key])) <= (
                float_tol * abs(float(ref_m[key])))


def test_a_missing_gradient_counts_as_zeros():
    """A parameter the loss did not reach (no ``.grad``) decays like one
    whose gradient is zeros."""
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1)
    runs = []
    for grad in (None, torch.zeros(4)):
        params = {"w": torch.ones(4), "u": torch.full((2,), 2.0)}
        state = adamw.init_state(params, cfg)
        adamw.apply_updates(params, {"w": grad, "u": torch.ones(2)}, state,
                            cfg)
        runs.append(params)
    assert torch.equal(runs[0]["w"], runs[1]["w"])
    assert torch.equal(runs[0]["u"], runs[1]["u"])
    assert float(runs[0]["w"][0]) < 1.0           # weight decay applied


def test_global_norm_matches_the_reference():
    rng = np.random.default_rng(1)
    tree = {k: rng.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}
    want = float(ref_adamw.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(adamw.global_norm(torch.as_tensor(v) for v in tree.values()))
    assert abs(want - got) <= 1e-6 * want


def _stacked_grads(model, rng):
    """Per-layer gradients whose largest |g| differs from layer to layer,
    as the reference's stacked leaves (numpy) and as the port's by name."""
    grads, ref = {}, {}
    for path, names in reference_leaves(model).items():
        shape = model.get_parameter(names[0]).shape
        parts = [rng.normal(size=shape).astype(np.float32) * (1 + 3 * i)
                 for i in range(len(names))]
        for name, part in zip(names, parts):
            grads[name] = torch.as_tensor(part)
        node = ref
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(parts) if path[0] in STACKS else parts[0]
    return grads, ref


@pytest.mark.parametrize("arch", ["smollm-135m", "whisper-small"])
def test_compression_scale_is_one_per_reference_leaf(arch):
    """``compress_grads`` with ``leaf_groups`` gives the reference's
    dequantized gradients and error buffers on the stacked tree bit for
    bit; one scale a layer (each parameter its own group) would not."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    model = build_model(cfg, device="cpu", seed=None)
    grads, ref_grads = _stacked_grads(model, np.random.default_rng(2))
    ref_err = jax.tree.map(jnp.zeros_like, ref_grads)
    want, want_err = ref_adamw.compress_grads(
        jax.tree.map(jnp.asarray, ref_grads), ref_err)
    leaves = reference_leaves(model)

    def port(groups):
        err = {n: torch.zeros_like(g) for n, g in grads.items()}
        deq, err = adamw.compress_grads(grads, err, groups)
        return deq, err

    def equal(deq, err):
        for path, names in leaves.items():
            w, we = want, want_err
            for key in path:
                w, we = w[key], we[key]
            stack = torch.stack if path[0] in STACKS else lambda t: t[0]
            if not (np.array_equal(np.asarray(w),
                                   stack([deq[n] for n in names]).numpy())
                    and np.array_equal(np.asarray(we),
                                       stack([err[n] for n in names]).numpy())):
                return False
        return True

    assert equal(*port(leaf_groups(model)))
    assert any(len(names) > 1 for names in leaves.values())
    assert not equal(*port(None))


def test_compress_grads_error_feedback():
    """The reference's test_compress_grads_error_feedback, on the port:
    error feedback keeps the long-run average unbiased (its tolerance)."""
    g = {"w": torch.as_tensor(np.random.default_rng(0).normal(size=(64,)),
                              dtype=torch.float32)}
    e = {"w": torch.zeros(64)}
    total, raw = torch.zeros(64), torch.zeros(64)
    for _ in range(50):
        deq, e = adamw.compress_grads(g, e)
        total = total + deq["w"]
        raw = raw + g["w"]
    np.testing.assert_allclose(total.numpy(), raw.numpy(), rtol=1e-2,
                               atol=1e-2)
