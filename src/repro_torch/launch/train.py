"""CLI: train an assigned architecture (reduced or full config), on the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --smoke --steps 50 --seq-len 128 --batch 8 --algorithm vfpc \
      --ckpt ckpt/ [--device cpu]

The reference CLI's flags and output: random weights from seed 0 (nothing
is downloaded), the synthetic token stream, one line a phase and a ``final
loss`` line.  With ``--ckpt`` it resumes from the newest checkpoint there,
the JAX package's or its own (``resumed from step N``); resumed with no
step left, it says so (the reference CLI raises ``IndexError``).
``--device cuda`` (the default) needs a card and raises without one.

``--mesh`` shards over every process of the group: run it under
``torchrun --nproc-per-node N`` (one process a card; ``--device cpu``
gives a ``gloo`` group of CPU processes).  The mesh is ``(N, 1)`` on the
axes ``(data, model)`` under the default rules: the reference's
``make_local_mesh()`` is 1-D over ``data``, which the rules' ``model``
entries cannot resolve, so the port names the model axis with size 1.
Process 0 prints; every process checkpoints (process 0 writes).
"""

from __future__ import annotations

import argparse

import contextlib
import io

from repro_torch import sharding
from repro_torch.core.policy import ALGORITHMS
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch.mesh import (init_distributed, init_single_process,
                                     make_lm_mesh, shutdown_distributed)
from repro_torch.models import build_model
from repro_torch.models.convert import load_reference_state
from repro_torch.optim import AdamWConfig
from repro_torch.train import (TrainLoop, init_train_state, load_checkpoint,
                               restore_elastic)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--algorithm", default="vfpc", choices=sorted(ALGORITHMS),
                    help="fused-phase width policy (paper technique)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--mesh", action="store_true",
                    help="shard over all local devices")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the card) or cpu")
    args = ap.parse_args(argv)
    mesh = rules = None
    quiet = contextlib.nullcontext()
    if args.mesh:
        if not init_distributed(device=args.device):
            init_single_process(args.device)
        mesh = make_lm_mesh(device=args.device)
        rules = sharding.make_rules()
        import torch.distributed as dist
        if dist.is_initialized() and dist.get_rank() != 0:
            quiet = contextlib.redirect_stdout(io.StringIO())
    try:
        with quiet:
            _run(args, mesh, rules)
    finally:
        if args.mesh:
            shutdown_distributed()


def _run(args, mesh, rules):
    model = build_model(args.arch, smoke=args.smoke, device=args.device,
                        seed=None, mesh=mesh, rules=rules)
    cfg = model.cfg
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                         global_batch=args.batch)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps, compress=args.compress_grads)

    state = None
    if args.ckpt:
        if mesh is not None:
            state, step = restore_elastic(args.ckpt, model, opt, mesh, rules)
        else:
            tree, step = load_checkpoint(args.ckpt)
            if tree is not None:
                state = init_train_state(model, opt, seed=None)
                load_reference_state(model, tree, state)
        if state is not None:
            print(f"resumed from step {step}")
    if state is None:
        state = init_train_state(model, opt, seed=0)

    loop = TrainLoop(model, pipe, opt, algorithm=args.algorithm, mesh=mesh,
                     rules=rules, checkpoint_dir=args.ckpt)
    state, records = loop.run(state, args.steps)
    for r in records:
        print(f"phase {r.phase_idx:3d} npass={r.npass} steps={r.steps} "
              f"loss={r.mean_loss:.4f} {r.elapsed:.2f}s")
    if not records:     # resumed at --steps (the reference CLI raises here)
        print(f"no steps left: step {int(state['opt']['step'])} of "
              f"{args.steps} done")
        return
    print(f"final loss {records[-1].mean_loss:.4f} over {len(records)} phases "
          f"({sum(r.npass for r in records)} steps)")


if __name__ == "__main__":
    main()
