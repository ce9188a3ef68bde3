"""The port's MoE FFN (``repro_torch/models/moe.py``) and the MoE decoders
(granite-moe-3b-a800m, qwen3-moe-30b-a3b; experts padded 8 → 16 in their
smoke configs) against the JAX package's, on the CPU.

The reference's parameters are carried into the port and the same numpy
inputs go through both.  Tolerances, relative to the largest |value| of
the reference's output: 1e-4 in float32 against the compiled reference,
0.03 in bf16 against the reference run op by op (``test_torch_models``'s
``check_family`` says why); measured on the CPU at most 8.3e-7 and 0.
Routing hazards (module docstring of ``moe.py``) each have a case: ties in
the router, capacity drops, the combine order, padded experts.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models import moe as ref_moe
from repro.serving import ServeEngine as RefServeEngine
from repro_torch import configs
from repro_torch.models import build_model, moe
from repro_torch.models.convert import to_torch
from repro_torch.serving import ServeEngine
from test_torch_models import (BF16_TOL, F32_TOL, _rel, carried_pair,
                               check_family)

MOE_ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-30b-a3b"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_family_matches_reference(arch, dtype):
    """Prefill logits and KV caches, 4 decode steps (routed prefill, dense
    decode) and the caches after them."""
    check_family(arch, dtype)


# -- the layer ---------------------------------------------------------------------


def _layer(arch="qwen3-moe-30b-a3b", dtype="float32", key=3, **overrides):
    """(reference config, reference params, port config, port MoE module)
    holding the same parameters."""
    kw = dict(dtype=dtype, **overrides)
    rcfg = dataclasses.replace(ref_configs.get_config(arch, smoke=True), **kw)
    pcfg = dataclasses.replace(configs.get_config(arch, smoke=True), **kw)
    params, _ = ref_moe.moe_init(jax.random.PRNGKey(key), rcfg)
    layer = moe.MoE(pcfg, "cpu")
    with torch.no_grad():
        for name, arr in params.items():
            getattr(layer, name).copy_(to_torch(np.asarray(arr)))
    return rcfg, params, pcfg, layer


def _x(shape, dtype, seed=0, positive=False):
    arr = np.random.default_rng(seed).standard_normal(shape)
    arr = np.abs(arr) if positive else arr
    x = jnp.asarray(arr, dtype)
    return x, to_torch(np.asarray(x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_forced_onto_one_expert_drops_like_the_reference(dtype):
    """Every token's logits favour expert 0 and tie over the rest, so top-2
    takes experts 0 and 1 (the tie lowest index first) for all 40 tokens:
    capacity 8 an expert drops 64 of 80 assignments.  Output and aux equal
    the reference's."""
    rcfg, params, pcfg, layer = _layer(dtype=dtype)
    router = np.zeros(layer.router.shape, np.float32)
    router[:, 0] = 1.0
    params = dict(params, router=jnp.asarray(router))
    layer.router.data.copy_(torch.from_numpy(router))
    x, px = _x((4, 10, pcfg.d_model), dtype, positive=True)
    assert moe.capacity(pcfg, 40) == 8
    assert moe.n_dropped(layer, px, pcfg) == 2 * (40 - 8)
    want, want_aux = ref_moe.moe_apply(params, x, rcfg, None)
    got, aux = moe.moe_apply(layer, px, pcfg)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert got.dtype == px.dtype and _rel(want, got) <= tol
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5, 16.0])
def test_routed_and_dense_layer_match_reference(dtype, capacity_factor):
    """Random routing of 21 tokens over 8 real experts of 16: the routed
    path at three capacities (4 slots an expert at 1.25 and at 0.5 drop,
    44 at 16 drop nothing) and the dense decode path."""
    rcfg, params, pcfg, layer = _layer(dtype=dtype,
                                       capacity_factor=capacity_factor)
    x, px = _x((3, 7, pcfg.d_model), dtype, seed=1)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    with jax.disable_jit(dtype != "float32"):
        want, want_aux = jax.jit(ref_moe.moe_apply, static_argnums=(2, 3))(
            params, x, rcfg, None)
        dense = ref_moe.moe_apply_dense(params, x, rcfg, None)[0]
    got, aux = moe.moe_apply(layer, px, pcfg)
    assert _rel(want, got) <= tol
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * abs(float(want_aux))
    assert _rel(dense, moe.moe_apply_dense(layer, px, pcfg)) <= tol
    drops = moe.n_dropped(layer, px, pcfg)
    assert (drops == 0) == (capacity_factor == 16.0)


def test_tied_router_picks_like_lax_top_k():
    """Probabilities with many exact ties: the picked experts and their
    weights equal ``lax.top_k``'s, lowest index first."""
    rng = np.random.default_rng(4)
    probs = rng.integers(0, 4, (64, 16)).astype(np.float32) / 8
    w, idx = jax.lax.top_k(jnp.asarray(probs), 5)
    pw, pidx = moe._top_k(torch.from_numpy(probs), 5)
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(pw.numpy(), np.asarray(w))
    # through the layer: repeated router columns tie experts 0-2, 3-5 and
    # 6-7 exactly, in both packages; top-2 takes the first two of a group
    rcfg, params, pcfg, layer = _layer()
    router = np.asarray(params["router"]).copy()
    router[:, :8] = router[:, [0, 0, 0, 3, 3, 3, 6, 6]]
    params = dict(params, router=jnp.asarray(router))
    layer.router.data.copy_(torch.from_numpy(router))
    x, px = _x((2, 9, pcfg.d_model), "float32", seed=2)
    _, _, pick = moe._route(layer, px.reshape(-1, pcfg.d_model), pcfg)
    logits = np.asarray(x.reshape(-1, pcfg.d_model)) @ router
    want = np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(
        np.where(np.arange(16) >= pcfg.n_experts, -np.inf, logits))),
        pcfg.top_k)[1])
    np.testing.assert_array_equal(pick.numpy(), want)
    pick = pick.numpy()
    assert (pick[:, 0] % 3 == 0).all() and (pick[:, 1] == pick[:, 0] + 1).all()
    assert _rel(ref_moe.moe_apply(params, x, rcfg, None)[0],
                moe.moe_apply(layer, px, pcfg)[0]) <= F32_TOL
    assert _rel(ref_moe.moe_apply_dense(params, x, rcfg, None)[0],
                moe.moe_apply_dense(layer, px, pcfg)) <= F32_TOL


def test_padded_experts_are_never_picked():
    """granite-moe-3b-a800m pads 40 experts to 48: the padded ones get
    probability exactly 0 and no assignment, however the router leans."""
    cfg = dataclasses.replace(configs.get_config("granite-moe-3b-a800m"),
                              d_model=32, moe_d_ff=16, dtype="float32")
    assert cfg.n_experts == 40 and cfg.experts_padded == 48
    layer = moe.MoE(cfg, "cpu")
    layer.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        layer.router[:, 40:] = 100.0          # padded columns lean hardest
    x = torch.randn(5, 6, 32, generator=torch.Generator().manual_seed(1))
    probs, _, idx = moe._route(layer, x.reshape(-1, 32), cfg)
    assert (probs[:, 40:] == 0).all() and (idx < 40).all()
    assert probs[:, :40].sum(-1).sub(1).abs().max() < 1e-5


def test_capacity_counts_the_padded_experts():
    """``max(4, ceil4(ceil(cf · T · k / E_pad)))``: granite's 100 tokens at
    top-8 over 48 padded experts get 24 slots (28 if it used the 40 real
    ones), and no expert gets fewer than 4."""
    cfg = configs.get_config("granite-moe-3b-a800m")
    assert moe.capacity(cfg, 100) == 24
    assert moe.capacity(cfg, 1) == 4
    assert moe.capacity(dataclasses.replace(cfg, capacity_factor=16.0),
                        512) == 1368


@pytest.mark.parametrize("arch", MOE_ARCHS + ["jamba-v0.1-52b"])
def test_routed_prefill_equals_dense_decode_without_drops(arch):
    """``tests/test_models.py::test_moe_parity_high_capacity`` on the
    port: at capacity_factor 16 nothing drops, so prefill(S) + 2 decode
    steps (dense) equals prefill(S + 2) (routed) within 0.05."""
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              capacity_factor=16.0)
    model = build_model(cfg, device="cpu", seed=1)
    B, S, extra = 2, 12, 2
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S + extra)), dtype=torch.long)
    full, _ = model.prefill({"tokens": toks}, S + extra)
    cur, caches = model.prefill({"tokens": toks[:, :S]}, S + extra)
    for t in range(extra):
        cur, caches = model.decode_step(caches, toks[:, S + t][:, None],
                                        torch.full((B,), S + t,
                                                   dtype=torch.long))
    err = float((cur - full).abs().max())
    assert err / (float(full.abs().max()) + 1e-9) < 0.05


def test_init_draws_the_reference_distributions():
    model = build_model("qwen3-moe-30b-a3b", smoke=True, device="cpu",
                        seed=0)
    cfg = model.cfg
    layer = model.decoder.blocks[0].moe
    assert layer.router.dtype == torch.float32
    assert layer.w_gate.dtype == torch.bfloat16
    for w, fan_in in ((layer.router, cfg.d_model),
                      (layer.w_gate, cfg.d_model), (layer.w_up, cfg.d_model),
                      (layer.w_down, cfg.moe_d_ff)):
        assert abs(float(w.float().std()) * np.sqrt(fan_in) - 1) < 0.05
    assert not torch.equal(model.decoder.blocks[0].moe.w_up,
                           model.decoder.blocks[1].moe.w_up)


def test_chip_smoke_pins_every_router_pick():
    """``chip_smoke.py`` holds a MoE config's bf16 prefill/decode parity
    with the router's picks pinned through ``moe._top_k``: replaying a
    prefill's own picks moves no logit and counts no difference, other
    picks are counted and move the logits, and the parity check restores
    the config it swaps."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = dataclasses.replace(
        configs.get_config("granite-moe-3b-a800m", smoke=True),
        dtype="float32")
    model = build_model(cfg, device="cpu", seed=0)
    full = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 12))
    batch = {"tokens": torch.as_tensor(full[:, :8])}
    with smoke.RouteLog() as log:
        want, _ = model.prefill(batch, 8)
    with smoke.RouteLog(lambda call: log.picks[call]) as same:
        got, _ = model.prefill(batch, 8)
    assert torch.equal(got, want)
    assert (same.differs, same.rows) == (0, 2 * 8 * len(log.picks))
    k = cfg.top_k
    with smoke.RouteLog(lambda call: torch.arange(k).expand(16, k)) as other:
        moved, _ = model.prefill(batch, 8)
    V = cfg.vocab_size
    assert other.differs > 0
    assert _rel(want[:, :V].numpy(), moved[:, :V]) > 0.01
    err, differs, rows = smoke.prefill_decode_parity(model, full, 8, {})
    assert model.cfg is cfg and model.cfg.capacity_factor != 16.0
    assert err < F32_TOL and differs == 0 and rows == 2 * 12 * len(log.picks)


# -- serving ------------------------------------------------------------------------


@pytest.mark.parametrize("algo", ["spc", "optimized_vfpc"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_tokens_equal_reference_engine(arch, algo):
    """float32, ragged right-padded prompts (the pads compete for
    capacity in both packages): the port's ServeEngine gives the reference
    engine's tokens."""
    ref, params, port = carried_pair(arch, "float32")
    lens = np.array([8, 5, 8, 3], np.int32)
    prompts = np.random.default_rng(0).integers(
        1, port.cfg.vocab_size, (4, 8)).astype(np.int32)
    for i, n in enumerate(lens):
        prompts[i, n:] = 0
    want, _ = RefServeEngine(ref, params, cache_len=24,
                             algorithm=algo).generate(
        prompts, prompt_lens=lens, max_new_tokens=12)
    got, _ = ServeEngine(port, cache_len=24, algorithm=algo).generate(
        prompts, prompt_lens=lens, max_new_tokens=12)
    np.testing.assert_array_equal(got, want)
