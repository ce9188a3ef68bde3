"""The port's encoder-decoder (``repro_torch/models/encdec.py``,
whisper-small) and the vision-stub decoder (internvl2-76b) against the JAX
package's, on the CPU, with the frontend stubs' embeddings from a numpy
seed; and ``ServeEngine``'s ``extra_batch`` and the serve CLI for both.

Tolerances as ``test_torch_moe.py``'s: 1e-4 in float32 against the
compiled reference, 0.03 in bf16 against the reference run op by op
(measured on the CPU at most 1.2e-6, and 0.0116 (whisper-small) and
0.0025 (internvl2-76b) in bf16: op by op is not bit for bit here).
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models import layers as ref_layers
from repro.serving import ServeEngine as RefServeEngine
from repro_torch import configs
from repro_torch.launch import serve as port_cli
from repro_torch.models import build_model, layers
from repro_torch.models.convert import to_torch
from repro_torch.serving import ServeEngine
from test_torch_lm_serving import _shape
from test_torch_models import (F32_TOL, _rel, _t, carried_pair, check_family,
                               frontend_inputs)

FRONTEND_ARCHS = ["whisper-small", "internvl2-76b"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_frontend_family_matches_reference(arch, dtype):
    """Prefill logits (the encoder over frame embeddings, or vision
    embeddings over the first positions), the self- and cross-attention
    caches, 4 decode steps and the caches after them."""
    check_family(arch, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_learned_position_decoder_matches_reference(dtype):
    """A decoder-only config with ``use_rope=False`` takes the reference's
    learned ``pos_embed``: added over the prompt at prefill and at each
    decode step's position."""
    check_family("smollm-135m", dtype, use_rope=False)


@pytest.mark.parametrize("causal,rope", [(False, False), (True, False),
                                         (False, True)])
def test_attention_apply_cross_and_encoder_forms_match_reference(causal,
                                                                 rope):
    """``attention_apply`` with keys and values from another sequence
    (cross attention: 7 queries over 11 encoder positions), and its
    non-causal and RoPE-less forms."""
    kw = dict(dtype="float32")
    rcfg = dataclasses.replace(ref_configs.get_config("qwen3-14b",
                                                      smoke=True), **kw)
    pcfg = dataclasses.replace(configs.get_config("qwen3-14b", smoke=True),
                               **kw)
    params, _ = ref_layers.attention_init(jax.random.PRNGKey(0), rcfg)
    att = layers.Attention(pcfg, "cpu")
    with torch.no_grad():
        for name, arr in params.items():
            getattr(att, name).copy_(to_torch(np.asarray(arr)))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, pcfg.d_model)).astype(np.float32)
    kv = rng.normal(size=(2, 11, pcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7), (2, 7)).astype(np.int32)
    kpos = np.broadcast_to(np.arange(11), (2, 11)).astype(np.int32)
    kv_x, kv_pos = (None, None) if causal else (kv, kpos)
    want, (k, v) = ref_layers.attention_apply(
        params, jnp.asarray(x), rcfg, None, jnp.asarray(pos), causal=causal,
        kv_x=None if kv_x is None else jnp.asarray(kv_x),
        kv_positions=None if kv_pos is None else jnp.asarray(kv_pos),
        rope=rope)
    got, (pk, pv) = layers.attention_apply(
        att, _t(x), pcfg, _t(pos, torch.long), causal=causal,
        kv_x=None if kv_x is None else _t(kv_x),
        kv_positions=None if kv_pos is None else _t(kv_pos, torch.long),
        rope=rope)
    for a, b in ((want, got), (k, pk), (v, pv)):
        assert _rel(a, b) <= F32_TOL


def test_cross_attention_takes_no_qk_norm():
    cfg = configs.get_config("qwen3-14b", smoke=True)
    assert cfg.qk_norm
    assert not hasattr(layers.Attention(cfg, "cpu", cross=True), "q_norm")
    model = build_model("whisper-small", smoke=True, device="cpu", seed=0)
    blk = model.encdec.dec_blocks[0]
    assert {n for n, _ in blk.cross.named_parameters()} == {"wq", "wk", "wv",
                                                             "wo"}


def test_vision_embeds_overwrite_the_first_positions():
    """The stub embeddings replace the token embeddings of the first
    n_frontend_tokens positions: the tokens there no longer matter."""
    model = build_model("internvl2-76b", smoke=True, device="cpu", seed=0)
    cfg = model.cfg
    fe = _t(frontend_inputs(cfg, 2)["vision_embeds"])
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (2, 12)), dtype=torch.long)
    other = toks.clone()
    other[:, :cfg.n_frontend_tokens] = 7
    a, _ = model.prefill({"tokens": toks, "vision_embeds": fe}, 12)
    b, _ = model.prefill({"tokens": other, "vision_embeds": fe}, 12)
    c, _ = model.prefill({"tokens": other}, 12)
    assert torch.equal(a, b) and not torch.equal(b, c)


def test_encdec_prefill_needs_frame_embeddings():
    model = build_model("whisper-small", smoke=True, device="cpu", seed=0)
    with pytest.raises(KeyError, match="frame_embeds"):
        model.prefill({"tokens": torch.ones((1, 4), dtype=torch.long)}, 8)


def test_init_learned_positions_start_at_zero():
    model = build_model("whisper-small", smoke=True, device="cpu", seed=0)
    net = model.encdec
    assert net.dec_pos.shape == (model.cfg.max_seq_len, model.cfg.d_model)
    assert not net.dec_pos.any() and not net.enc_pos.any()
    assert not torch.equal(net.enc_blocks[0].attn.wq, net.dec_blocks[0].attn.wq)


# -- serving ------------------------------------------------------------------------


@pytest.mark.parametrize("algo", ["spc", "optimized_vfpc"])
@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_engine_tokens_equal_reference_engine(arch, algo):
    """float32, ragged right-padded prompts, the frontend embeddings passed
    through ``extra_batch`` (numpy to the reference, torch to the port)."""
    ref, params, port = carried_pair(arch, "float32")
    cfg = port.cfg
    lens = np.array([12, 9, 12, 10], np.int32)
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab_size, (4, 12)).astype(np.int32)
    for i, n in enumerate(lens):
        prompts[i, n:] = 0
    extra = frontend_inputs(cfg, 4)
    want, _ = RefServeEngine(ref, params, cache_len=28,
                             algorithm=algo).generate(
        prompts, prompt_lens=lens, max_new_tokens=12,
        extra_batch={k: jnp.asarray(v) for k, v in extra.items()})
    got, _ = ServeEngine(port, cache_len=28, algorithm=algo).generate(
        prompts, prompt_lens=lens, max_new_tokens=12,
        extra_batch={k: _t(v) for k, v in extra.items()})
    np.testing.assert_array_equal(got, want)


def test_serve_cli_serves_the_vlm_like_the_reference(capsys, monkeypatch):
    """The reference CLI serves internvl2-76b text-only (it builds no
    vision embeddings); so does the port's, with the same lines."""
    from repro.launch import serve as ref_cli
    argv = ["--arch", "internvl2-76b", "--smoke", "--max-new", "10",
            "--batch", "2", "--algorithm", "fpc"]
    port_cli.main(argv + ["--device", "cpu"])
    port = _shape(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve", *argv])
    ref_cli.main()
    assert port == _shape(capsys.readouterr().out)


def test_serve_cli_refuses_the_encdec_like_the_reference(capsys,
                                                         monkeypatch):
    """Neither CLI builds frame embeddings: the reference fails on the
    missing key inside prefill, the port before building a model, with a
    usage error that says what is missing."""
    from repro.launch import serve as ref_cli
    argv = ["--arch", "whisper-small", "--smoke", "--max-new", "4"]
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve", *argv])
    with pytest.raises(KeyError, match="frame_embeds"):
        ref_cli.main()
    with pytest.raises(SystemExit) as exc:
        port_cli.main(argv + ["--device", "cpu"])
    assert exc.value.code == 2
    assert "frame embeddings" in capsys.readouterr().err
