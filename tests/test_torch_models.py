"""The port's models (``repro_torch/models``) against the JAX package's,
on the CPU at smoke sizes: the dense decoder here, and the helpers that
``test_torch_moe.py``, ``test_torch_ssm.py`` and ``test_torch_encdec.py``
hold the other families with.

The reference's parameters are carried into the port with
``load_reference_params``, and the same numpy inputs go through both.
Tolerances, relative to the largest |value| of the reference's output:

* float32: 1e-4 (measured: at most 1.4e-6 for the logits and 1.1e-6 for
  the caches over the archs and steps below);
* bf16: ``BF16_TOL`` = 0.03 (measured: at most 0.0133 for the logits and
  0.0097 for the caches).  Run op by op (``jax.disable_jit``) the
  reference gives the port's bf16 numbers bit for bit on these configs,
  bar one logit a bf16 ulp apart in one decode step; the gap comes from
  XLA fusing the compiled reference's elementwise chains in float32.
  :func:`check_family` therefore holds the MoE, SSM, hybrid and
  encoder-decoder families in bf16 against the reference run op by op:
  a router's top-k turns a one-ulp difference at a near tie into another
  expert, and against the compiled reference one decode step of
  qwen3-moe-30b-a3b's smoke config lies far outside the tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models import build_model as ref_build_model
from repro.models import layers as ref_layers
from repro_torch import configs
from repro_torch.models import Model, build_model, load_reference_params
from repro_torch.models import layers
from repro_torch.models.convert import reference_shapes, to_torch
from repro_torch.models.transformer import CONV_KEYS, pattern_period

F32_TOL, BF16_TOL = 1e-4, 0.03
B, S, EXTRA = 2, 12, 4
# arch, q_head_pad_group override (0: the smoke config's), attention chunks
CASES = [("smollm-135m", 0, None), ("qwen3-14b", 0, None),
         ("qwen3-14b", 6, None), ("qwen3-14b", 6, (4, 8)),
         ("codeqwen1.5-7b", 0, None), ("starcoder2-15b", 0, None)]


def _cfgs(arch, dtype="bfloat16", pad=0, chunks=None, **overrides):
    kw = {"dtype": dtype, **overrides}
    if pad:
        kw["q_head_pad_group"] = pad
    if chunks:
        kw.update(attn_q_chunk=chunks[0], attn_kv_chunk=chunks[1])
    return (dataclasses.replace(ref_configs.get_config(arch, smoke=True), **kw),
            dataclasses.replace(configs.get_config(arch, smoke=True), **kw))


def carried_pair(arch, dtype="bfloat16", pad=0, chunks=None, key=1,
                 **overrides):
    """(reference model, its params, the port model holding them);
    ``overrides`` replace smoke-config fields in both.  The learned
    position tables, zeros at init, are drawn small and random, so they
    take part."""
    rcfg, pcfg = _cfgs(arch, dtype, pad, chunks, **overrides)
    ref = ref_build_model(rcfg)
    params = ref.init(jax.random.PRNGKey(key))
    for i, name in enumerate(("pos_embed", "dec_pos", "enc_pos")):
        if name in params:
            params[name] = (0.02 * jax.random.normal(
                jax.random.PRNGKey(key + 100 + i), params[name].shape)
            ).astype(params[name].dtype)
    port = build_model(pcfg, device="cpu", seed=None)
    load_reference_params(port, jax.tree.map(np.asarray, params))
    return ref, params, port


def _rel(ref, got) -> float:
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    got = got.float().numpy()
    return float(np.max(np.abs(ref - got)) / (np.max(np.abs(ref)) + 1e-9))


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def frontend_inputs(cfg, B: int, seed: int = 5) -> dict:
    """The frontend stubs' inputs as float32 numpy, from a seed:
    ``vision_embeds`` (B, n_frontend_tokens, D) for the VLM,
    ``frame_embeds`` (B, enc_seq, D) for the encoder-decoder, else none."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "vision_stub":
        shape, key = (B, cfg.n_frontend_tokens, cfg.d_model), "vision_embeds"
    elif cfg.frontend == "audio_stub":
        shape, key = (B, cfg.enc_seq, cfg.d_model), "frame_embeds"
    else:
        return {}
    return {key: (0.5 * rng.standard_normal(shape)).astype(np.float32)}


def reference_caches(port, rcache) -> dict:
    """The reference's decode caches in the port's layout, float32 numpy:
    a decoder's layer i is slice i // P of ``sub{i % P}`` (P the pattern
    period), stacked by kind in layer order; an encoder-decoder's keys are
    the port's."""
    cfg = port.cfg
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa: E731
    if cfg.is_encoder_decoder:
        return {key: f32(val) for key, val in rcache.items()}
    P = pattern_period(cfg)
    out: dict = {}
    for i in range(cfg.n_layers):
        sub = rcache[f"sub{i % P}"]
        if cfg.layer_kind(i) == "attn":
            leaves = {"k": sub["k"], "v": sub["v"]}
        else:
            leaves = {key: sub["conv"][name] for key, name in CONV_KEYS.items()}
            leaves["state"] = sub["state"]
        for key, arr in leaves.items():
            out.setdefault(key, []).append(f32(arr[i // P]))
    return {key: np.stack(arrs) for key, arrs in out.items()}


def check_family(arch, dtype, B=B, S=S, extra=EXTRA, seed=2, **overrides):
    """Prefill logits and caches, then ``extra`` teacher-forced decode steps
    and the caches after them, held against the reference: compiled in
    float32 (1e-4), run op by op in bf16 (0.03; module docstring).
    Returns the largest relative error seen."""
    ref, params, port = carried_pair(arch, dtype, **overrides)
    cfg = port.cfg
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    V = cfg.vocab_size
    toks = np.random.default_rng(seed).integers(
        0, V, (B, S + extra)).astype(np.int32)
    fe = frontend_inputs(cfg, B)
    worst = 0.0

    def close(want, got, what):
        nonlocal worst
        err = _rel(want, got)
        worst = max(worst, err)
        assert err <= tol, (arch, dtype, what, err)

    def caches_close(rc, pc, when):
        want = reference_caches(port, rc)
        assert set(want) == set(pc), (set(want), set(pc))
        for key, arr in want.items():
            assert tuple(pc[key].shape) == arr.shape, key
            close(arr, pc[key], f"{key} {when}")

    with jax.disable_jit(dtype != "float32"):
        prefill = jax.jit(ref.prefill, static_argnums=2)
        step = jax.jit(ref.decode_step)
        rl, rc = prefill(params, {"tokens": jnp.asarray(toks[:, :S]),
                                  **{k: jnp.asarray(v) for k, v in fe.items()}},
                         S + extra)
        pl, pc = port.prefill({"tokens": _t(toks[:, :S], torch.long),
                               **{k: _t(v) for k, v in fe.items()}}, S + extra)
        assert pl.shape == (B, cfg.vocab_padded)
        close(rl[:, :V], pl[:, :V], "prefill logits")
        caches_close(rc, pc, "after prefill")
        for t in range(extra):
            tok = toks[:, S + t][:, None]
            rl, rc = step(params, rc, jnp.asarray(tok),
                          jnp.full((B,), S + t, jnp.int32))
            pl, pc = port.decode_step(pc, _t(tok, torch.long),
                                      torch.full((B,), S + t,
                                                 dtype=torch.long))
            close(rl[:, :V], pl[:, :V], f"decode step {t}")
        caches_close(rc, pc, "after decode")
    return worst


# -- configs -------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ref_configs.ARCH_IDS))
def test_config_fields_and_param_counts_equal(arch):
    for smoke in (False, True):
        ref = ref_configs.get_config(arch, smoke=smoke)
        port = configs.get_config(arch, smoke=smoke)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        for prop in ("resolved_head_dim", "padded_heads", "vocab_padded",
                     "experts_padded"):
            assert getattr(port, prop) == getattr(ref, prop)
        kinds = [(c.layer_kind(i), c.ffn_kind(i))
                 for c in (port, ref) for i in range(ref.n_layers)]
        assert kinds[:ref.n_layers] == kinds[ref.n_layers:]


def test_shapes_and_arch_tables_equal():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert configs.ARCH_NAMES == ref_configs.ARCH_NAMES
    assert configs.SUBQUADRATIC_ARCHS == ref_configs.SUBQUADRATIC_ARCHS
    assert ({k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()}
            == {k: dataclasses.asdict(v)
                for k, v in ref_configs.SHAPES.items()})
    for arch in configs.ARCH_IDS:
        for shape in configs.SHAPES:
            assert (configs.cell_is_runnable(arch, shape)
                    == ref_configs.cell_is_runnable(arch, shape))


# -- layers --------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_head_rmsnorm_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(2, 5, 3, 16)) * 3, dtype)
    scale = jnp.asarray(1 + 0.1 * rng.normal(size=16), dtype)
    px, pscale = to_torch(np.asarray(x)), to_torch(np.asarray(scale))
    norm = layers.RMSNorm(dataclasses.replace(
        configs.get_config("smollm-135m", smoke=True), dtype=dtype,
        d_model=16), "cpu")
    norm.scale.data.copy_(pscale)
    want = ref_layers.rmsnorm({"scale": scale}, x, 1e-6)
    got = layers.rmsnorm(norm, px, 1e-6)
    assert got.dtype == px.dtype
    tol = F32_TOL if dtype == "float32" else 0.0
    assert _rel(want, got) <= tol
    want = ref_layers.head_rmsnorm(scale, x, 1e-6)
    assert _rel(want, layers.head_rmsnorm(pscale, px, 1e-6)) <= tol


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(theta):
    hd = 16
    freqs = layers.rope_frequencies(hd, theta)
    want = np.asarray(jnp.asarray(ref_layers.rope_frequencies(hd, theta),
                                  jnp.float32))
    np.testing.assert_array_equal(freqs.numpy(), want)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, hd)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    ref = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = layers.apply_rope(_t(x), _t(pos, torch.long), freqs)
    assert _rel(ref, got) <= 1e-5
    # split-half, not interleaved: position 0 is the identity
    np.testing.assert_array_equal(
        layers.apply_rope(_t(x), torch.zeros(2, 7, dtype=torch.long),
                          freqs).numpy(), x)


@pytest.mark.parametrize("cfg_pad", [(5, 1, 0), (5, 1, 6), (4, 2, 0)])
def test_head_mask_matches_reference(cfg_pad):
    n_heads, n_kv, pad = cfg_pad
    cfg = dataclasses.replace(configs.get_config("qwen3-14b", smoke=True),
                              n_heads=n_heads, n_kv_heads=n_kv,
                              q_head_pad_group=pad)
    ref = dataclasses.replace(ref_configs.get_config("qwen3-14b", smoke=True),
                              n_heads=n_heads, n_kv_heads=n_kv,
                              q_head_pad_group=pad)
    np.testing.assert_array_equal(layers.head_mask(cfg).numpy(),
                                  np.asarray(ref_layers.head_mask(ref)))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunks", [(512, 1024), (4, 8), (3, 5), (16, 4)])
def test_chunked_attention_matches_reference(chunks, causal):
    """Chunks smaller than S (and sizes that do not divide it, so the
    divisor search shrinks them): the causal mask holds across chunks."""
    rng = np.random.default_rng(2)
    Bq, Sq, Hq, Hkv, hd = 2, 16, 6, 2, 8
    q = rng.normal(size=(Bq, Sq, Hq, hd)).astype(np.float32)
    k = rng.normal(size=(Bq, Sq, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(Bq, Sq, Hkv, hd)).astype(np.float32)
    want = ref_layers.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), Hkv, causal,
        q_chunk=chunks[0], kv_chunk=chunks[1])
    got = layers.chunked_attention(_t(q), _t(k), _t(v), Hkv, causal,
                                   q_chunk=chunks[0], kv_chunk=chunks[1])
    assert _rel(want, got) <= 1e-5
    # causal: row i sees keys ≤ i only, whatever the chunking
    if causal:
        v2 = v.copy()
        v2[:, 9:] += 100.0
        got2 = layers.chunked_attention(_t(q), _t(k), _t(v2), Hkv, causal,
                                        q_chunk=chunks[0], kv_chunk=chunks[1])
        np.testing.assert_array_equal(got2[:, :9].numpy(), got[:, :9].numpy())


def test_chunked_attention_q_offset_matches_reference():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, 4, 2, 8)).astype(np.float32)
    k = rng.normal(size=(1, 12, 1, 8)).astype(np.float32)
    v = rng.normal(size=(1, 12, 1, 8)).astype(np.float32)
    want = ref_layers.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), 1, True, q_chunk=2,
                                        kv_chunk=4, q_offset=8)
    got = layers.chunked_attention(_t(q), _t(k), _t(v), 1, True, q_chunk=2,
                                   kv_chunk=4, q_offset=8)
    assert _rel(want, got) <= 1e-5


# -- the model -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,pad,chunks", CASES)
def test_prefill_and_decode_match_reference(arch, pad, chunks, dtype):
    """Prefill logits and caches, then 4 teacher-forced decode steps."""
    ref, params, port = carried_pair(arch, dtype, pad, chunks)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    cfg = port.cfg
    V = cfg.vocab_size
    toks = np.random.default_rng(2).integers(
        0, V, (B, S + EXTRA)).astype(np.int32)
    rl, rc = jax.jit(ref.prefill, static_argnums=2)(
        params, {"tokens": jnp.asarray(toks[:, :S])}, S + EXTRA)
    pl, pc = port.prefill({"tokens": _t(toks[:, :S], torch.long)}, S + EXTRA)
    assert pl.shape == (B, cfg.vocab_padded) and pl.dtype == torch.float32
    assert _rel(rl[:, :V], pl[:, :V]) <= tol
    assert (pl[:, V:] == -1e30).all()
    for name in ("k", "v"):
        assert pc[name].shape == rc["sub0"][name].shape
        assert _rel(rc["sub0"][name], pc[name]) <= tol
        assert not pc[name][:, :, S:].any()           # zero padding
    ref_step = jax.jit(ref.decode_step)
    for t in range(EXTRA):
        tok = toks[:, S + t][:, None]
        rl, rc = ref_step(params, rc, jnp.asarray(tok),
                          jnp.full((B,), S + t, jnp.int32))
        pl, pc = port.decode_step(pc, _t(tok, torch.long),
                                  torch.full((B,), S + t, dtype=torch.long))
        assert _rel(rl[:, :V], pl[:, :V]) <= tol, t
    for name in ("k", "v"):
        assert _rel(rc["sub0"][name], pc[name]) <= tol


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-14b"])
def test_last_pos_selects_each_rows_prompt_end(arch):
    ref, params, port = carried_pair(arch, "float32")
    toks = np.random.default_rng(4).integers(
        1, port.cfg.vocab_size, (3, 10)).astype(np.int32)
    last = np.array([9, 4, 0], np.int32)
    rl, _ = ref.prefill(params, {"tokens": jnp.asarray(toks)}, cache_len=16,
                        last_pos=jnp.asarray(last))
    pl, _ = port.prefill({"tokens": _t(toks, torch.long)}, 16,
                         last_pos=_t(last, torch.long))
    assert _rel(rl, pl) <= F32_TOL


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-14b", "codeqwen1.5-7b"])
def test_prefill_decode_parity(arch):
    """The port's own prefill(S) + decode steps == prefill(S+extra) at the
    last position, the reference's bound (tests/test_models.py)."""
    model = build_model(arch, smoke=True, device="cpu", seed=1)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, (B, S + EXTRA)), dtype=torch.long)
    full, _ = model.prefill({"tokens": toks}, S + EXTRA)
    cur, caches = model.prefill({"tokens": toks[:, :S]}, S + EXTRA)
    for t in range(EXTRA):
        cur, caches = model.decode_step(caches, toks[:, S + t][:, None],
                                        torch.full((B,), S + t,
                                                   dtype=torch.long))
    err = float((cur - full).abs().max())
    assert err / (float(full.abs().max()) + 1e-9) < 0.05


def test_padded_heads_inactive():
    """Group-padded q heads (qwen3-14b pads 5 to 6 a KV head) must not
    affect outputs: their weights are masked everywhere."""
    _, pcfg = _cfgs("qwen3-14b", "float32", pad=6)
    assert pcfg.padded_heads == 6 and pcfg.n_heads == 5
    model = build_model(pcfg, device="cpu", seed=3)
    toks = torch.as_tensor([[5, 9, 2, 7]], dtype=torch.long)
    before, _ = model.prefill({"tokens": toks}, 8)
    with torch.no_grad():
        for blk in model.decoder.blocks:
            blk.attn.wq[:, 5].normal_()
            blk.attn.wo[5].normal_()
    after, _ = model.prefill({"tokens": toks}, 8)
    assert torch.equal(before, after)
    full = configs.get_config("qwen3-14b")
    assert full.padded_heads == 48 and full.n_heads == 40


# -- carrying the reference's parameters across ----------------------------------


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-14b"])
def test_bf16_carry_is_bit_exact(arch):
    _, params, port = carried_pair(arch, "bfloat16", pad=6 if arch ==
                                   "qwen3-14b" else 0)
    tree = jax.tree.map(np.asarray, params)
    dec = port.decoder
    np.testing.assert_array_equal(
        dec.embed.table.view(torch.int16).numpy(),
        tree["embed"]["table"].view(np.int16))
    stacked = tree["blocks"]["sub0"]
    for i, blk in enumerate(dec.blocks):
        for name, p in blk.named_parameters():
            leaf = stacked
            for key in name.split("."):
                leaf = leaf[key]
            assert p.dtype == torch.bfloat16
            np.testing.assert_array_equal(p.view(torch.int16).numpy(),
                                          leaf[i].view(np.int16))
    assert set(reference_shapes(port)) == {
        tuple(k.key for k in path)
        for path, _ in jax.tree_util.tree_leaves_with_path(tree)}


def _tree(arch="smollm-135m", dtype="float32"):
    ref, params, port = carried_pair(arch, dtype)
    return jax.tree.map(np.asarray, params), port


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "dtype",
                                   "float16", "hybrid_missing_sub3",
                                   "bf16_router"])
def test_carry_raises_on_a_tree_that_does_not_match(fault):
    arch, dtype = {"hybrid_missing_sub3": ("jamba-v0.1-52b", "float32"),
                   "bf16_router": ("qwen3-moe-30b-a3b", "bfloat16")}.get(
        fault, ("smollm-135m", "float32"))
    tree, port = _tree(arch, dtype)
    before = port.net.embed.table.clone()
    if fault == "missing":
        del tree["blocks"]["sub0"]["mlp"]["w_up"]
        err = KeyError
    elif fault == "extra":
        tree["out_head"] = np.zeros((48, 512), np.float32)   # tied model
        err = KeyError
    elif fault == "shape":
        tree["blocks"]["sub0"]["attn"]["wq"] = \
            tree["blocks"]["sub0"]["attn"]["wq"][:1]
        err = ValueError
    elif fault == "dtype":        # bf16 leaf, float32 model
        tree["final_norm"]["scale"] = np.asarray(
            jnp.asarray(tree["final_norm"]["scale"], jnp.bfloat16))
        err = ValueError
    elif fault == "float16":      # no config stores float16
        tree["final_norm"]["scale"] = \
            tree["final_norm"]["scale"].astype(np.float16)
        err = TypeError
    elif fault == "hybrid_missing_sub3":   # the period's attention layer
        assert port.cfg.layer_kind(3) == "attn"
        del tree["blocks"]["sub3"]["attn"]["wk"]
        err = KeyError
    else:                         # the float32 router of a bf16 model
        router = tree["blocks"]["sub0"]["moe"]["router"]
        assert router.dtype == np.float32
        tree["blocks"]["sub0"]["moe"]["router"] = np.asarray(
            jnp.asarray(router, jnp.bfloat16))
        err = ValueError
    tree["embed"]["table"] = np.asarray(
        jnp.asarray(tree["embed"]["table"]) + 1)
    with pytest.raises(err):
        load_reference_params(port, tree)
    assert torch.equal(port.net.embed.table, before)   # nothing copied


# -- construction ------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ref_configs.ARCH_IDS))
def test_every_arch_builds_serves_and_stores_the_reference_shapes(arch):
    """Every arch's smoke model builds on the CPU, runs a prefill and a
    decode step with finite logits, and stores exactly the reference
    tree's leaves in their shapes (the reference's ``abstract_params``)."""
    model = build_model(arch, smoke=True, device="cpu", seed=0)
    cfg = model.cfg
    shapes, _ = ref_build_model(ref_configs.get_config(
        arch, smoke=True)).abstract_params()
    want = {tuple(k.key for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    assert reference_shapes(model) == want
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (2, 6)), dtype=torch.long)
    batch = {"tokens": toks, **{k: _t(v) for k, v in
                                frontend_inputs(cfg, 2).items()}}
    logits, caches = model.prefill(batch, 8)
    logits2, _ = model.decode_step(caches, toks[:, :1],
                                   torch.full((2,), 6, dtype=torch.long))
    for lg in (logits, logits2):
        assert lg.shape == (2, cfg.vocab_padded)
        assert torch.isfinite(lg[:, :cfg.vocab_size]).all()


def test_init_is_seeded_and_per_layer():
    a = build_model("qwen3-14b", smoke=True, device="cpu", seed=7)
    b = build_model("qwen3-14b", smoke=True, device="cpu", seed=7)
    c = build_model("qwen3-14b", smoke=True, device="cpu", seed=8)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        assert pa.dtype == torch.bfloat16
        if "norm" not in name:
            assert not torch.equal(pa, pc), name
    blk = a.decoder.blocks
    assert not torch.equal(blk[0].attn.wq, blk[1].attn.wq)
    assert torch.equal(blk[0].attn.q_norm, torch.ones_like(blk[0].attn.q_norm))
    assert a.weight_bytes() == 2 * sum(p.numel() for p in a.parameters())
    # the stored wq/wo hold the padded heads; param_count() the real ones
    cfg = a.cfg
    assert isinstance(a, Model) and a.decoder.out_head.shape == (
        cfg.d_model, cfg.vocab_padded)


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("smollm-135m", smoke=True)
