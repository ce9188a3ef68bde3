"""The port's Mamba-2 SSD mixer (``repro_torch/models/ssm.py``) and the SSM
and hybrid decoders (mamba2-370m; jamba-v0.1-52b, period 4 in its smoke
config: three SSM layers and one attention layer, MoE on odd layers)
against the JAX package's, on the CPU.

Tolerances as ``test_torch_moe.py``'s: 1e-4 in float32 against the
compiled reference, 0.03 in bf16 against the reference run op by op
(measured on the CPU at most 9.7e-7 and 1.0e-6, the bf16 one in the
float32 SSM states); the SSD scans 2e-5 (float32 throughout).  The caches are compared through the
period mapping (``test_torch_models.reference_caches``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models import ssm as ref_ssm
from repro.serving import ServeEngine as RefServeEngine
from repro_torch import configs
from repro_torch.models import build_model, ssm
from repro_torch.models.convert import to_torch
from repro_torch.models.transformer import pattern_period
from repro_torch.serving import ServeEngine
from test_torch_models import (F32_TOL, _rel, carried_pair, check_family,
                               reference_caches)

SSM_ARCHS = ["mamba2-370m", "jamba-v0.1-52b"]
SSD_TOL = 2e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_family_matches_reference(arch, dtype):
    """Prefill logits, the conv states, SSM states (and jamba's KV caches)
    through the period mapping, 4 decode steps and the caches after."""
    check_family(arch, dtype)


def test_jamba_full_pattern_maps_onto_the_reference_period():
    """jamba-v0.1-52b: period 8 (attention at 3, MoE on odd layers); the
    16 layers the card holds are two periods, layer i at sub{i % 8} slice
    i // 8, and its caches stack the 2 attention and 14 SSM layers."""
    cfg = dataclasses.replace(configs.get_config("jamba-v0.1-52b"),
                              n_layers=16)
    assert pattern_period(cfg) == 8
    kinds = [(cfg.layer_kind(i), cfg.ffn_kind(i)) for i in range(16)]
    assert [i for i, k in enumerate(kinds) if k[0] == "attn"] == [3, 11]
    assert [i for i, k in enumerate(kinds) if k[1] == "moe"] == list(
        range(1, 16, 2))
    small = dataclasses.replace(cfg, d_model=64, n_heads=4, n_kv_heads=2,
                                head_dim=16, d_ff=32, moe_d_ff=32,
                                vocab_size=256, dtype="float32")
    model = build_model(small, device="cpu", seed=0)
    assert model.decoder.slot[3] == 0 and model.decoder.slot[11] == 1
    assert model.decoder.slot[12] == 10
    caches = model.empty_caches(2, 8)
    assert caches["k"].shape[0] == 2 and caches["state"].shape[0] == 14


# -- SSD ------------------------------------------------------------------------


def _ssd_inputs(B, S, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, P)).astype(np.float32),
            rng.uniform(0.001, 0.1, (B, S, H)).astype(np.float32),
            -rng.uniform(1, 8, (H,)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32),
            rng.normal(size=(H,)).astype(np.float32))


@pytest.mark.parametrize("S,chunk", [(64, 8), (64, 16), (64, 64), (64, 13),
                                     (61, 16), (300, 256)])
def test_ssd_chunked_matches_reference(S, chunk):
    """Chunks 8, 16, 64 and 13 (shrunk to 8, a divisor of 64), a prime S
    (chunks of 1) and 300 at the default 256 (chunks of 150): the output
    and final state equal the reference's ``ssd_chunked`` at its chunking,
    and the port's own oracle."""
    args = _ssd_inputs(2, S, 3, 8, 16)
    y_ref, h_ref = ref_ssm.ssd_chunked(*map(jnp.asarray, args), chunk)
    y, h = ssm.ssd_chunked(*map(torch.from_numpy, args), chunk)
    assert _rel(y_ref, y) <= SSD_TOL and _rel(h_ref, h) <= SSD_TOL
    oracle = ssm.ssd_reference(*map(torch.from_numpy, args))
    assert _rel(ref_ssm.ssd_reference(*map(jnp.asarray, args)),
                oracle) <= SSD_TOL
    assert float((y - oracle).abs().max()) <= 2e-4 * float(oracle.abs().max())


def test_chunk_length_follows_the_reference_rule():
    assert [ssm._chunk_len(S, 256) for S in (64, 256, 257, 300, 512, 61)] \
        == [64, 256, 1, 150, 256, 61]
    assert ssm._chunk_len(64, 13) == 8 and ssm._chunk_len(61, 16) == 1


def test_ssd_state_continuation():
    """h_final of the first half fed through ``h0`` gives the whole pass."""
    x, dt, A, Bm, Cm, D = map(torch.from_numpy, _ssd_inputs(1, 32, 2, 4, 8, 1))
    y_full, h_full = ssm.ssd_chunked(x, dt, A, Bm, Cm, D, 8)
    y1, h1 = ssm.ssd_chunked(x[:, :16], dt[:, :16], A, Bm[:, :16],
                             Cm[:, :16], D, 8)
    y2, h2 = ssm.ssd_chunked(x[:, 16:], dt[:, 16:], A, Bm[:, 16:],
                             Cm[:, 16:], D, 8, h0=h1)
    assert _rel(y_full.numpy(), torch.cat([y1, y2], 1)) <= SSD_TOL
    assert _rel(h_full.numpy(), h2) <= SSD_TOL
    r = ref_ssm.ssd_chunked(*(jnp.asarray(t.numpy()[:, 16:]) if t.dim() > 1
                              else jnp.asarray(t.numpy())
                              for t in (x, dt, A, Bm, Cm, D)), 8,
                            h0=jnp.asarray(h1.numpy()))
    assert _rel(r[0], y2) <= SSD_TOL and _rel(r[1], h2) <= SSD_TOL


def test_softplus_matches_jax_without_a_threshold():
    """``logaddexp(x, 0)``, within an ulp of XLA's (measured on the CPU
    8.6e-8 relative), across ``F.softplus``'s threshold of 20."""
    x = np.array([-40, -5, -1e-3, 0, 1e-3, 3, 19.5, 20, 20.5, 40, 90],
                 np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(ssm._softplus(torch.from_numpy(x)).numpy(),
                               want, rtol=2.4e-7, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_and_conv_step_match_reference(dtype):
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.normal(size=(2, 9, 5)), dtype)
    w = jnp.asarray(rng.normal(size=(4, 5)), dtype)
    pu, pw = to_torch(np.asarray(u)), to_torch(np.asarray(w))
    got = ssm._causal_conv(pu, pw)
    with jax.disable_jit():
        want = ref_ssm._causal_conv(u, w)
    assert _rel(want, got) == 0.0
    state = jnp.asarray(rng.normal(size=(2, 3, 5)), dtype)
    pstate = to_torch(np.asarray(state)).clone()
    with jax.disable_jit():
        y, new = ref_ssm._conv_step(u[:, 0], state, w)
    assert _rel(y, ssm._conv_step(pu[:, 0], pstate, pw)) == 0.0
    assert _rel(new, pstate) == 0.0         # the state, shifted in place


# -- the mixer ---------------------------------------------------------------------


def _mixer(dtype="float32", arch="mamba2-370m"):
    kw = dict(dtype=dtype)
    rcfg = dataclasses.replace(ref_configs.get_config(arch, smoke=True), **kw)
    pcfg = dataclasses.replace(configs.get_config(arch, smoke=True), **kw)
    params, _ = ref_ssm.ssm_init(jax.random.PRNGKey(4), rcfg)
    layer = ssm.SSM(pcfg, "cpu")
    with torch.no_grad():
        for name, arr in params.items():
            getattr(layer, name).copy_(to_torch(np.asarray(arr)))
    return rcfg, params, pcfg, layer


@pytest.mark.parametrize("chunk", [256, 5])
def test_ssm_apply_and_decode_match_reference(chunk):
    """The mixer's prefill (output, conv states, state) at the default
    chunk and at chunks of 5 (a 15-token prompt), then 3 decode steps."""
    rcfg, params, pcfg, layer = _mixer()
    x = np.random.default_rng(5).normal(size=(2, 18, pcfg.d_model)).astype(
        np.float32)
    out, (conv, h) = ref_ssm.ssm_apply(params, jnp.asarray(x[:, :15]), rcfg,
                                       None, chunk=chunk, return_state=True)
    pout, (pconv, ph) = ssm.ssm_apply(layer, torch.from_numpy(x[:, :15]),
                                      pcfg, chunk=chunk, return_state=True)
    assert _rel(out, pout) <= F32_TOL and _rel(h, ph) <= F32_TOL
    for name in ("x", "B", "C"):
        assert _rel(conv[name], pconv[name]) <= F32_TOL
    pconv = {k: v.clone() for k, v in pconv.items()}
    for t in range(15, 18):
        xt = x[:, t:t + 1]
        out, conv, h = ref_ssm.ssm_decode(params, jnp.asarray(xt), rcfg,
                                          None, conv, h)
        pout = ssm.ssm_decode(layer, torch.from_numpy(xt), pcfg, pconv, ph)
        assert _rel(out, pout) <= F32_TOL and _rel(h, ph) <= F32_TOL
        for name in ("x", "B", "C"):
            assert _rel(conv[name], pconv[name]) <= F32_TOL


def test_init_draws_the_reference_distributions():
    """dt_bias: softplus in [1e-3, 1e-1]; A_log: log U(1, 16); D_skip and
    out_norm ones; float32 where the reference keeps float32."""
    model = build_model("mamba2-370m", smoke=True, device="cpu", seed=0)
    layer = model.decoder.blocks[0].ssm
    for name in ("dt_bias", "A_log", "D_skip"):
        assert getattr(layer, name).dtype == torch.float32
    assert layer.w_x.dtype == torch.bfloat16
    dt = ssm._softplus(layer.dt_bias)
    assert (dt >= 1e-3 * 0.999).all() and (dt <= 1e-1 * 1.001).all()
    A = layer.A_log.exp()
    assert (A >= 1).all() and (A <= 16).all()
    assert (layer.D_skip == 1).all() and (layer.out_norm == 1).all()
    assert not torch.equal(layer.A_log,
                           model.decoder.blocks[1].ssm.A_log)


# -- ragged prompts and serving ----------------------------------------------------


def _ragged(vocab, seed=0):
    lens = np.array([8, 5, 8, 3], np.int32)
    prompts = np.random.default_rng(seed).integers(
        1, vocab, (4, 8)).astype(np.int32)
    for i, n in enumerate(lens):
        prompts[i, n:] = 0
    return prompts, lens


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ragged_prefill_state_includes_the_pads_as_the_reference(arch):
    """The reference runs the SSM over a ragged row's right-padding, so its
    state after prefill includes the pad tokens; the port keeps that: the
    states equal the reference's, and a short row's state differs from
    the one its unpadded prompt gives."""
    ref, params, port = carried_pair(arch, "float32")
    prompts, lens = _ragged(port.cfg.vocab_size)
    last = lens - 1
    _, rc = ref.prefill(params, {"tokens": jnp.asarray(prompts)}, 16,
                        last_pos=jnp.asarray(last))
    _, pc = port.prefill({"tokens": torch.as_tensor(prompts,
                                                    dtype=torch.long)}, 16,
                         last_pos=torch.as_tensor(last, dtype=torch.long))
    want = reference_caches(port, rc)
    for key in ("state", "conv_x"):
        assert _rel(want[key], pc[key]) <= F32_TOL
    _, alone = port.prefill({"tokens": torch.as_tensor(
        prompts[3:, :3], dtype=torch.long)}, 16)
    assert not torch.allclose(alone["state"][:, 0], pc["state"][:, 3],
                              rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("algo", ["spc", "optimized_vfpc"])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_engine_tokens_equal_reference_engine(arch, algo):
    """float32, ragged right-padded prompts: the port's ServeEngine gives
    the reference engine's tokens."""
    ref, params, port = carried_pair(arch, "float32")
    prompts, lens = _ragged(port.cfg.vocab_size)
    want, _ = RefServeEngine(ref, params, cache_len=24,
                             algorithm=algo).generate(
        prompts, prompt_lens=lens, max_new_tokens=12)
    got, _ = ServeEngine(port, cache_len=24, algorithm=algo).generate(
        prompts, prompt_lens=lens, max_new_tokens=12)
    np.testing.assert_array_equal(got, want)


def test_ssm_prefill_decode_parity():
    """``tests/test_models.py::test_prefill_decode_parity`` for mamba2 on
    the port: prefill(12) + 4 decode steps equals prefill(16) within 0.05."""
    model = build_model("mamba2-370m", smoke=True, device="cpu", seed=1)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, (2, 16)), dtype=torch.long)
    full, _ = model.prefill({"tokens": toks}, 16)
    cur, caches = model.prefill({"tokens": toks[:, :12]}, 16)
    for t in range(12, 16):
        cur, caches = model.decode_step(caches, toks[:, t:t + 1],
                                        torch.full((2,), t, dtype=torch.long))
    err = float((cur - full).abs().max())
    assert err / (float(full.abs().max()) + 1e-9) < 0.05
