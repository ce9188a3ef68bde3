"""The port's training loss and its backward in bf16, and under each
remat policy, against the JAX package's on the CPU at smoke sizes (float32
over every arch: ``test_torch_loss.py``, whose helpers these use).

bf16, one arch of each family: the reference is compiled with XLA's
excess precision off (``xla_allow_excess_precision=False``), so that every
op rounds to bf16 as it does run op by op — XLA otherwise keeps fused
chains in float32 (``test_torch_models.py``'s docstring) — at a tenth of
the op-by-op run's time.  Tolerances: the loss 2e-3 of its value, each
gradient 0.05 of its leaf's largest |gradient| (measured: the loss equal
to the bit for the MoE config, at most 1.1e-4 elsewhere; gradients at
most 0.027, a few bf16 ulps from sums taken in another order).
"""

import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_loss import _batch, _port_loss, check_loss_and_grads
from test_torch_models import carried_pair

BF16_LOSS_TOL, BF16_GRAD_TOL = 2e-3, 0.05
FAMILY_ARCHS = ["smollm-135m", "granite-moe-3b-a800m", "mamba2-370m",
                "jamba-v0.1-52b", "whisper-small", "internvl2-76b"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_grads_match_the_reference_bf16(arch):
    check_loss_and_grads(arch, "bfloat16", BF16_LOSS_TOL, BF16_GRAD_TOL)


class _CountMM(TorchDispatchMode):
    """Counts the ``aten.mm`` products run, recomputed ones included."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def _remat_run(port, batch) -> tuple:
    """(loss, grads, bytes autograd saved outside any checkpoint, mm
    products run) of one loss and its backward."""
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), \
            _CountMM() as count:
        loss, _, grads = _port_loss(port, batch)
    return (loss, {n: g.clone() for n, g in grads.items()}, sum(saved),
            count.mm)


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-370m",
                                  "whisper-small"])
def test_remat_policies_give_equal_loss_and_grads(arch):
    """``cfg.remat`` off, on (``full``) and on with ``dots``: the same loss
    and gradients bit for bit (remat changes memory, not numbers).  Off
    saves the most for backward; ``full`` runs the blocks' products again
    in backward, ``dots`` keeps them (the reference's encoder-decoder
    blocks take no policy: there ``dots`` is ``full``)."""
    _, _, port = carried_pair(arch, "float32", jit_init=True)
    cfg, runs = port.cfg, {}
    for remat, policy in ((False, "full"), (True, "dots"), (True, "full")):
        port.net.cfg = dataclasses.replace(cfg, remat=remat,
                                           remat_policy=policy)
        port.zero_grad(set_to_none=True)
        runs[remat, policy] = _remat_run(port, _batch(cfg))
    base_loss, base_grads, _, _ = runs[False, "full"]
    for loss, grads, _, _ in runs.values():
        assert loss == base_loss
        assert all(torch.equal(grads[n], base_grads[n]) for n in grads)
    (_, _, off, off_mm), (_, _, dots, dots_mm), (_, _, full, full_mm) = \
        runs.values()
    assert off > dots == full
    if arch == "whisper-small":
        assert off_mm < dots_mm == full_mm
    else:
        assert off_mm == dots_mm < full_mm
