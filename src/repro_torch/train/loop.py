"""Training loop with paper-policy *fused-step phases*: the port's copy of the
JAX package's ``train/loop.py``, on one device or a mesh.

The paper combines several Apriori passes into one MapReduce job to amortize
per-job scheduling overhead.  The training-loop analogue: one phase executes
``npass`` complete optimizer steps over a stacked batch, uploaded once, with
no host sync inside — the losses stay on the device and one copy reads them
at the phase's end, which is the port's counterpart of the reference's
single ``lax.scan`` dispatch.  The same Policy objects from
:mod:`repro_torch.core.policy` choose ``npass`` per phase (SPC = classic
1-step dispatch; VFPC/ETDPC adapt it).

"Skipped pruning" at this layer: the per-step NaN/metric host check is hoisted
out of the fused steps and performed once per phase (the phase-end support
filter).  A NaN'd phase is re-run from the phase-start checkpoint — integrity
comes from phase idempotence, exactly like the paper's job re-execution.

The state is the reference's ``{"params", "opt"}``: ``params`` the model's
own parameters by name (so the model trains in place) and ``opt`` the
AdamW state (``optim.adamw``).  Checkpoints hold it in the reference's
layout and format (``convert.state_to_reference``, ``checkpoint``).

Sharding: with ``mesh`` and ``rules`` the model's parameters are DTensors
placed by their logical axes (built so, or placed by ``Model.shard`` here),
the optimizer state is placed like them (:func:`state_shardings`), every
process of the mesh runs the same loop on the same token batches (the
model places them by the input axes), and checkpoints are written from the
mesh and restored onto any mesh.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

import torch.distributed as dist

from repro_torch import sharding
from repro_torch.core.policy import ALGORITHMS, PhaseStats
from repro_torch.models import convert
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as ckpt_lib

# the per-step metrics a phase returns, each an (npass,) device tensor
METRICS = ("loss", "ce", "aux", "grad_norm", "lr")


def place_model(model, mesh, rules) -> None:
    """Put ``model`` on ``mesh`` (placing its parameters if it is not there
    yet); with no mesh, leave it as it is.  Rules without a mesh are the
    default profile's and need none."""
    if mesh is not None:
        model.shard(mesh, rules)


def state_shardings(model, opt_cfg: adamw.AdamWConfig, mesh, rules) -> dict:
    """The placements of the ``{params, opt}`` state on ``mesh``
    (shape-aware): the parameters' by their logical axes, the moments
    like their parameters, ``step`` replicated."""
    from repro_torch.models.model import param_axes
    shapes = {n: p.shape for n, p in model.named_parameters()}
    p_axes = param_axes(model)
    params = {n: sharding.sharding_for(mesh, ax, rules, tuple(shapes[n]))
              for n, ax in p_axes.items()}
    o_axes = adamw.state_axes(p_axes, opt_cfg)
    opt = {key: dict(params) for key in o_axes if key != "step"}
    opt["step"] = sharding.sharding_for(mesh, (), rules, ())
    return {"params": params, "opt": opt}


def _upload(val, device: torch.device) -> torch.Tensor:
    """One copy to ``device``, from pinned memory where it goes to a card,
    so it does not wait for the host."""
    t = torch.as_tensor(val)
    if device.type == "cuda" and not t.is_cuda:
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def make_train_step(model, opt_cfg: adamw.AdamWConfig, mesh=None, rules=None,
                    npass: int = 1):
    """Build the fused train phase: (state, batches[npass]) → (state,
    metrics).  ``batches``: ``tokens`` and ``labels`` (npass, B, S) and any
    frontend embeddings (npass, B, n, D), arrays or tensors.  The state is
    updated in place (the reference donates it); ``metrics`` maps each of
    :data:`METRICS` to an (npass,) tensor on the model's device.  With a
    mesh the model is placed on it (``Model.shard``) and every process of
    the mesh calls the phase with the same batches."""
    place_model(model, mesh, rules)
    groups = convert.leaf_groups(model) if opt_cfg.compress else None

    def phase(state, batches):
        batches = {k: _upload(v, model.device) for k, v in batches.items()}
        for key in ("tokens", "labels"):
            batches[key] = batches[key].long()
        params = state["params"]
        rows = []
        for i in range(npass):
            for p in params.values():
                p.grad = None
            loss, metrics = model.loss({k: v[i] for k, v in batches.items()})
            loss.backward()
            _, _, om = adamw.apply_updates(
                params, {n: p.grad for n, p in params.items()}, state["opt"],
                opt_cfg, groups)
            rows.append(torch.stack([loss.detach(), metrics["ce"].detach(),
                                     metrics["aux"].detach(),
                                     om["grad_norm"], om["lr"]]))
        for p in params.values():
            p.grad = None
        out = torch.stack(rows)
        return state, {name: out[:, j] for j, name in enumerate(METRICS)}

    return phase


def init_train_state(model, opt_cfg: adamw.AdamWConfig, seed: int | None = 0,
                     mesh=None, rules=None) -> dict:
    """``{"params", "opt"}`` for ``model``, its weights drawn from ``seed``
    (None keeps them, e.g. after ``load_reference_params``) and made
    trainable; the optimizer state zeroed beside them.  With a mesh the
    model is placed on it first, so the state is sharded by
    :func:`state_shardings` (a seed draws each parameter whole and keeps
    the shard: the unsharded numbers)."""
    place_model(model, mesh, rules)
    if seed is not None:
        model.init(seed)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    return {"params": params, "opt": adamw.init_state(params, opt_cfg)}


@dataclasses.dataclass
class TrainPhaseRecord:
    phase_idx: int
    npass: int
    steps: tuple
    elapsed: float
    mean_loss: float
    renan: bool = False


class TrainLoop:
    """The host loop: policy-controlled fused phases + checkpoint/restart."""

    def __init__(self, model, pipeline, opt_cfg=None, algorithm: str = "vfpc",
                 mesh=None, rules=None, checkpoint_dir: str | None = None,
                 ckpt_every_phases: int = 4, max_npass: int = 8,
                 policy_kwargs: dict | None = None):
        place_model(model, mesh, rules)
        self.model = model
        self.pipeline = pipeline
        self.opt_cfg = opt_cfg or adamw.AdamWConfig()
        policy_cls, self.optimized = ALGORITHMS[algorithm]
        self.policy = policy_cls(**(policy_kwargs or {}))
        self.algorithm = algorithm
        self.checkpoint_dir = checkpoint_dir
        self.ckpt_every = ckpt_every_phases
        self.max_npass = max_npass
        self.records: list[TrainPhaseRecord] = []
        self.history: list[PhaseStats] = []

    def _stack_batches(self, npass: int) -> dict:
        toks, labs = [], []
        for _ in range(npass):
            t, l = self.pipeline.next_batch()
            toks.append(t)
            labs.append(l)
        batch = {"tokens": np.stack(toks), "labels": np.stack(labs)}
        cfg, B = self.model.cfg, toks[0].shape[0]
        stub = {"vision_stub": ("vision_embeds", cfg.n_frontend_tokens),
                "audio_stub": ("frame_embeds", cfg.enc_seq)}.get(cfg.frontend)
        if stub is not None:    # the stubs' inputs: zeros, in bf16
            key, n = stub
            batch[key] = torch.zeros((npass, B, n, cfg.d_model),
                                     dtype=torch.bfloat16,
                                     device=self.model.device)
        return batch

    def run(self, state, total_steps: int):
        """Run until ``total_steps`` optimizer steps. Returns (state, records)."""
        self.restore_data_cursor()
        done = int(state["opt"]["step"])
        phase_idx = len(self.records)
        while done < total_steps:
            prev = self.history[-1] if self.history else None
            prev2 = self.history[-2] if len(self.history) > 1 else None
            mode, val = self.policy.decide(prev, prev2)
            if mode == "width":
                npass = int(val)
            else:  # budget α → do-while semantics (see serving engine)
                npass = int(np.floor(val)) + 1
            npass = max(1, min(npass, self.max_npass, total_steps - done))

            batches = self._stack_batches(npass)
            fn = make_train_step(self.model, self.opt_cfg, npass=npass)
            t0 = time.perf_counter()
            state, metrics = fn(state, batches)
            losses = metrics["loss"].cpu().numpy()     # the phase's one read
            elapsed = time.perf_counter() - t0

            renan = False
            if not np.isfinite(losses).all():
                # phase-end integrity check failed → restore and re-run single
                renan = True
                if self.checkpoint_dir:
                    state = self.restore_or(state)
            else:
                done += npass
            tokens = npass * batches["tokens"].shape[1] * batches["tokens"].shape[2]
            self.history.append(PhaseStats(tokens, tokens // max(npass, 1), elapsed))
            self.records.append(TrainPhaseRecord(
                phase_idx, npass, (done - npass, done), elapsed,
                float(losses.mean()), renan))
            phase_idx += 1
            if self.checkpoint_dir and phase_idx % self.ckpt_every == 0:
                self._save(state, done)
        if self.checkpoint_dir:
            self._save(state, done)
        return state, self.records

    def _save(self, state, done: int):
        """Checkpoint model/opt state + the data-pipeline cursor, so a restart
        continues the token stream instead of replaying it.  On a mesh
        every process saves (the leaves are gathered) and process 0
        writes."""
        ckpt_lib.save_checkpoint(self.checkpoint_dir, done,
                                 convert.state_to_reference(self.model, state))
        sharded = self.model.ctx.on
        if not sharded or dist.get_rank() == 0:
            with open(os.path.join(self.checkpoint_dir, "data_state.json"),
                      "w") as f:
                json.dump({"data_step": int(getattr(self.pipeline, "_step",
                                                    0)),
                           "opt_step": done}, f)
        if sharded:
            dist.barrier()

    def restore_data_cursor(self):
        """Fast-forward the pipeline to the checkpointed position (no-op if
        no checkpoint or the pipeline has already advanced)."""
        path = os.path.join(self.checkpoint_dir or "", "data_state.json")
        if self.checkpoint_dir and os.path.exists(path) \
                and getattr(self.pipeline, "_step", 0) == 0:
            with open(path) as f:
                self.pipeline._step = json.load(f)["data_step"]

    def restore_or(self, state):
        """The newest checkpoint, copied into ``state`` (the model's
        parameters and the optimizer state) in place, each process its
        shards on a mesh; ``state`` as it is where there is none."""
        tree, _ = ckpt_lib.load_checkpoint(self.checkpoint_dir)
        if tree is not None:
            convert.load_reference_state(self.model, tree, state)
        return state
