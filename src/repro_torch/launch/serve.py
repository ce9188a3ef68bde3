"""CLI: serve a model with paper-policy multi-step decode fusion, on the port.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      [--smoke] --batch 8 --prompt-len 16 --max-new 64 \
      --algorithm optimized_vfpc [--device cpu]

Random weights from ``--seed`` (nothing is downloaded), random prompts from
the same seed, greedy decode through :class:`repro_torch.serving.ServeEngine`;
prints the reference CLI's summary and per-phase lines.  ``--device cuda``
(the default) needs a card and raises without one.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.policy import ALGORITHMS
from repro_torch.launch.cliopts import add_policy_args, policy_kwargs_from_args
from repro_torch.models import build_model
from repro_torch.serving import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--algorithm", default="optimized_vfpc",
                    choices=sorted(ALGORITHMS))
    ap.add_argument("--eos-id", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the card) or cpu")
    add_policy_args(ap)
    args = ap.parse_args(argv)

    model = build_model(args.arch, smoke=args.smoke, device=args.device,
                        seed=args.seed)
    cfg = model.cfg
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(1, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)

    eng = ServeEngine(model,
                      cache_len=args.prompt_len + args.max_new + 8,
                      algorithm=args.algorithm,
                      policy_kwargs=policy_kwargs_from_args(
                          args, args.algorithm),
                      latency_budget_ms=args.latency_budget_ms)
    toks, records = eng.generate(prompts, max_new_tokens=args.max_new,
                                 eos_id=args.eos_id)
    total_t = sum(r.elapsed for r in records)
    total_tok = sum(r.tokens_emitted for r in records)
    print(f"algorithm={args.algorithm} dispatches={len(records)} "
          f"tokens={total_tok} wasted={sum(r.wasted_tokens for r in records)} "
          f"decode_time={total_t:.3f}s ({total_tok/max(total_t,1e-9):.1f} tok/s)")
    for r in records:
        print(f"  phase {r.phase_idx:3d} npass={r.npass:2d} "
              f"active={r.active_before} {r.elapsed*1e3:.1f} ms")
    print("first row tokens:", toks[0][:24].tolist())


if __name__ == "__main__":
    main()
