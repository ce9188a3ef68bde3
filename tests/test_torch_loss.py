"""The port's training loss and its backward (``Model.loss``,
``transformer.decoder_loss``, remat) against the JAX package's, on the CPU
at smoke sizes.

The reference's parameters are carried into the port
(``test_torch_models.carried_pair``), the same numpy batch goes through
``jax.value_and_grad(model.loss)`` and ``Model.loss(...).backward()``, and
each port gradient is stacked as the reference stacks its leaf.
Tolerances, the loss relative to its value and each gradient relative to
its leaf's largest |gradient|:

* float32, every arch in ``configs/``: loss 1e-5, gradients 1e-4
  (measured: at most 1.4e-7 and 3.7e-6).

bf16 and the remat policies are held in ``test_torch_loss_bf16.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models import transformer as ref_transformer
from repro_torch.models import transformer
from repro_torch.models.convert import STACKS, reference_leaves

from test_torch_models import carried_pair, frontend_inputs

F32_LOSS_TOL, F32_GRAD_TOL = 1e-5, 1e-4


def _batch(cfg, seed: int = 3, B: int = 2, S: int = 8) -> dict:
    """tokens and labels (B, S + the VLM's frontend tokens) and the
    frontend stubs' inputs, as numpy."""
    S += cfg.n_frontend_tokens
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            **frontend_inputs(cfg, B)}


def _port_loss(port, batch: dict):
    """(loss, aux, grads by name) of the port model on a numpy batch."""
    port.requires_grad_(True)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    for key in ("tokens", "labels"):
        tb[key] = tb[key].long()
    loss, metrics = port.loss(tb)
    loss.backward()
    return (loss.item(), metrics["aux"].item(),
            {n: p.grad for n, p in port.named_parameters()})


def check_loss_and_grads(arch, dtype, loss_tol, grad_tol, **overrides):
    """The port's loss, aux loss and every gradient against the
    reference's."""
    ref, params, port = carried_pair(arch, dtype, jit_init=True, **overrides)
    batch = _batch(port.cfg)
    fn = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))
    args = (params, jax.tree.map(jnp.asarray, batch))
    if dtype != "float32":
        fn = fn.lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})
    (ref_loss, ref_metrics), ref_grads = fn(*args)
    loss, aux, grads = _port_loss(port, batch)
    loss_err = abs(loss - float(ref_loss)) / abs(float(ref_loss))
    assert loss_err <= loss_tol, (arch, dtype, loss, float(ref_loss))
    assert abs(aux - float(ref_metrics["aux"])) <= loss_tol * max(abs(aux),
                                                                  1.0)
    for path, names in reference_leaves(port).items():
        want = ref_grads
        for key in path:
            want = want[key]
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))
        got = torch.stack([grads[n].float() for n in names])
        got = (got if path[0] in STACKS else got[0]).numpy()
        err = float(np.abs(want - got).max() / (np.abs(want).max() + 1e-30))
        assert err <= grad_tol, (arch, dtype, "/".join(path), err)


@pytest.mark.parametrize("arch", sorted(ref_configs.ARCH_IDS))
def test_loss_and_grads_match_the_reference_float32(arch):
    check_loss_and_grads(arch, "float32", F32_LOSS_TOL, F32_GRAD_TOL)


@pytest.fixture(scope="module")
def granite():
    """granite-moe-3b-a800m's smoke config, float32: vocab 515 padded to
    768."""
    return carried_pair("granite-moe-3b-a800m", "float32", jit_init=True)


@pytest.mark.parametrize("S,chunk", [(12, 5), (600, 512), (7, 512)])
def test_decoder_loss_at_any_length_and_a_padded_vocab(granite, S, chunk):
    """``decoder_loss`` where ``chunk`` does not divide S (the divisor
    search: chunks of 4 for S = 12 at 5, of 300 for S = 600 at 512) and
    with a padded vocab (the pads masked to -1e30), against the
    reference's; loss and the gradients of x and the head (1e-5)."""
    ref, params, port = granite
    port.zero_grad(set_to_none=True)
    cfg = port.cfg
    assert cfg.vocab_padded > cfg.vocab_size
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)

    def ref_loss(p, x):
        return ref_transformer.decoder_loss(p, x, jnp.asarray(labels),
                                            ref.cfg, None, chunk=chunk)

    want, (gp, gx) = jax.value_and_grad(ref_loss, argnums=(0, 1))(
        params, jnp.asarray(x))
    port.requires_grad_(True)
    tx = torch.tensor(x, requires_grad=True)
    got = transformer.decoder_loss(port.net, tx, torch.as_tensor(labels),
                                   chunk=chunk)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * float(want)
    head = port.net.out_head.grad if not cfg.tie_embeddings else \
        port.net.embed.table.grad
    want_head = gp["out_head"] if not cfg.tie_embeddings else \
        gp["embed"]["table"]
    for w, g in ((gx, tx.grad), (want_head, head)):
        w = np.asarray(w)
        assert np.abs(w - g.numpy()).max() <= 1e-5 * np.abs(w).max()


def test_loss_keeps_every_moe_layer_aux():
    """The training forward returns the sum of every MoE layer's
    load-balancing loss (the serving forward drops it), and the loss adds
    ``AUX_LOSS_WEIGHT`` of it to the cross-entropy."""
    from repro_torch.models.model import AUX_LOSS_WEIGHT
    _, _, port = carried_pair("jamba-v0.1-52b", "float32", jit_init=True)
    cfg = port.cfg
    n_moe = sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.n_layers))
    assert n_moe >= 2
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg).items()}
    batch = {**batch, "tokens": batch["tokens"].long(),
             "labels": batch["labels"].long()}
    with torch.no_grad():
        loss, metrics = port.loss(batch)
        _, aux = transformer.decoder_forward(port.decoder, batch["tokens"])
    assert float(metrics["aux"]) == float(aux) > 0
    assert float(loss) == pytest.approx(
        float(metrics["ce"]) + AUX_LOSS_WEIGHT * float(aux), rel=1e-6)


def test_ssd_backward_stays_finite_where_the_references_is_nan():
    """One full-width SSD chunk (L = 256, A down to -16, dt up to 0.1, as
    mamba2-370m's init draws them): the reference's gradients of dt and A
    are NaN — it takes exp of the whole segment-sum tile, which overflows
    above the diagonal, and masks after, so backward meets 0 · inf.  The
    port's forward equals the reference's (1e-5) and its gradients are
    finite and equal the naive recurrence's (``ssd_reference``, 1e-4 of
    each gradient's largest magnitude)."""
    from repro.models.ssm import ssd_chunked as ref_ssd
    from repro_torch.models.ssm import ssd_chunked, ssd_reference
    rng = np.random.default_rng(0)
    B, S, H, P, N = 1, 256, 2, 4, 8
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.05, 0.1, size=(B, S, H)).astype(np.float32)
    A = np.array([-16.0, -8.0], np.float32)
    Bm, Cm = (rng.normal(size=(B, S, N)).astype(np.float32)
              for _ in range(2))
    D = np.ones(H, np.float32)

    def ref_loss(dt, A):
        y, _ = ref_ssd(jnp.asarray(x), dt, A, jnp.asarray(Bm),
                       jnp.asarray(Cm), jnp.asarray(D), 256)
        return (y ** 2).sum(), y

    (_, ref_y), ref_g = jax.value_and_grad(ref_loss, argnums=(0, 1),
                                           has_aux=True)(jnp.asarray(dt),
                                                         jnp.asarray(A))
    assert not all(np.isfinite(np.asarray(g)).all() for g in ref_g)
    grads = []
    for fn in (lambda *a: ssd_chunked(*a, 256)[0], ssd_reference):
        tdt, tA = (torch.tensor(v, requires_grad=True) for v in (dt, A))
        y = fn(torch.tensor(x), tdt, tA, torch.tensor(Bm), torch.tensor(Cm),
               torch.tensor(D))
        (y ** 2).sum().backward()
        grads.append((y.detach().numpy(), tdt.grad, tA.grad))
    (y, *chunked), (_, *naive) = grads
    ref_y = np.asarray(ref_y)
    assert np.abs(y - ref_y).max() <= 1e-5 * np.abs(ref_y).max()
    for got, want in zip(chunked, naive):
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max())
