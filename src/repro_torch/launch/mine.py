"""CLI: frequent-itemset mining with the paper's algorithms, on the port.

  PYTHONPATH=src python -m repro_torch.launch.mine --dataset mushroom \
      --min-sup 0.3 --algorithm optimized_vfpc [--device cpu] \
      [--input file.txt] [--checkpoint-dir ckpt/] \
      [--n-data-shards 4 --n-cand-shards 2 --cells-per-process 8]

Several processes (one card each, or gloo on the CPU) run the same command
under ``torchrun --nproc-per-node N``, or with ``--coordinator host:port
--num-processes N --process-id i`` each.

``--device cuda`` (the default) needs a card and raises without one; there
``--impl auto`` (the default) first times the four counting families on the
card (``kernels/autotune.py``) and prints the winner.
``--json-out``, ``--trace-out`` and ``--metrics-out`` write the JAX
package's formats.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.core import ALGORITHMS, IMPLS, mine
from repro_torch.data import dataset_by_name, load_transactions
from repro_torch.launch.cliopts import (add_mesh_args, add_obs_args,
                                        add_policy_args,
                                        policy_kwargs_from_args,
                                        runtime_from_args, tracer_from_args,
                                        write_obs_outputs)
from repro_torch.launch.mesh import shutdown_distributed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="mushroom",
                    help="named synthetic dataset (c20d10k/c20d200k/chess/"
                         "mushroom)")
    ap.add_argument("--input", default=None, help="FIMI-format transaction file")
    ap.add_argument("--min-sup", type=float, default=0.3)
    ap.add_argument("--algorithm", default="optimized_vfpc",
                    choices=sorted(ALGORITHMS))
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--impl", default="auto", choices=("auto", *IMPLS),
                    help="counting family (auto: the autotuner's plan "
                         "winner on a card, vertical on the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (hand-written kernels) or cpu "
                         "(their plain versions)")
    ap.add_argument("--json-out", default=None)
    add_policy_args(ap)
    add_mesh_args(ap)
    add_obs_args(ap)
    args = ap.parse_args(argv)
    tracer = tracer_from_args(args)

    if args.input:
        txns, n_items = load_transactions(args.input)
    else:
        txns, n_items = dataset_by_name(args.dataset, seed=args.seed,
                                        scale=args.scale)
    runtime, mesh_kwargs = runtime_from_args(args, impl=args.impl)
    try:
        res = mine(txns, n_items=n_items, min_sup=args.min_sup,
                   algorithm=args.algorithm, runtime=runtime,
                   policy_kwargs=policy_kwargs_from_args(args, args.algorithm),
                   checkpoint_dir=args.checkpoint_dir, **mesh_kwargs)
    finally:
        shutdown_distributed()

    mesh = runtime.mesh
    print(f"algorithm={res.algorithm} min_sup={res.min_sup} "
          f"n_txns={res.n_txns} n_items={res.n_items}")
    print(f"mesh={runtime.mesh_split[0]}x{runtime.mesh_split[1]} "
          f"(data x cand) impl={runtime.impl} "
          f"repartitions={res.repartitions} retries={res.retries}")
    print(f"device={runtime.device} process {mesh.rank} of {mesh.world}, "
          f"{mesh.cells_per_process} cells a process")
    if args.impl == "auto":
        print(f"auto: counting family {runtime.impl}")
    print(f"phases={res.n_phases} dispatches={res.dispatches} "
          f"total={res.total_seconds:.2f}s")
    for ph in res.phases:
        ks = f"k={ph.k_start}..{ph.k_start + ph.npass - 1}"
        print(f"  phase {ks:10s} width={ph.npass} cands={ph.candidate_counts} "
              f"freq={ph.frequent_counts} {ph.elapsed_seconds:.3f}s "
              f"(gen {ph.gen_seconds:.3f} count {ph.count_seconds:.3f})")
    sizes = {k: int(v[0].shape[0]) for k, v in sorted(res.levels.items())}
    print("frequent itemsets per level:", sizes)
    if args.json_out and mesh.rank == 0:
        with open(args.json_out, "w") as f:
            json.dump({"levels": sizes, "phases": res.n_phases,
                       "total_seconds": res.total_seconds,
                       "dispatches": res.dispatches,
                       "decisions": res.decisions}, f, indent=2)
    write_obs_outputs(args, tracer)


if __name__ == "__main__":
    main()
