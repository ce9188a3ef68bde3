"""Shared CLI plumbing for policy hyperparameters, multi-tenant serving,
observability and mesh flags (the port's copy of the JAX package's
``launch/cliopts.py``).

Every launch CLI that picks a pass-combining algorithm exposes the same knob
set (the paper's β thresholds, the measured policy's width ceiling, the
serving latency budget) through :func:`add_policy_args`, and
:func:`policy_kwargs_from_args` filters the provided values down to what the
selected policy's constructor actually accepts — ``--beta1`` silently applies
to ETDPC and is dropped for SPC, so one flag vocabulary serves all eight
algorithms without per-CLI special cases.
"""

from __future__ import annotations

import argparse
import inspect

from repro_torch.core.policy import ALGORITHMS

# CLI flag (dest) → Policy-constructor kwarg
_POLICY_DESTS = {
    "time_scale": "time_scale",
    "beta": "beta",
    "beta1": "beta1",
    "beta2": "beta2",
    "alpha_fast": "alpha_fast",
    "fpc_npass": "npass",
    "max_width": "max_width",
}


def add_policy_args(ap: argparse.ArgumentParser) -> None:
    """Attach the uniform policy/controller hyperparameter group.

    All default to None = "use the policy's own default"; only explicitly
    set flags reach the constructor.
    """
    g = ap.add_argument_group(
        "policy hyperparameters",
        "apply to whichever --algorithm is selected; flags a policy does "
        "not accept are ignored (DESIGN.md §9)")
    g.add_argument("--time-scale", type=float, default=None,
                   help="β-threshold rescale for DPC/ETDPC/measured "
                        "(paper seconds → this runtime; default 1e-3)")
    g.add_argument("--beta", type=float, default=None,
                   help="DPC absolute elapsed-time threshold (paper: 60s)")
    g.add_argument("--beta1", type=float, default=None,
                   help="ETDPC first threshold (paper: 40s)")
    g.add_argument("--beta2", type=float, default=None,
                   help="ETDPC second threshold (paper: 60s)")
    g.add_argument("--alpha-fast", type=float, default=None,
                   help="DPC fast-phase candidate-budget multiplier")
    g.add_argument("--fpc-npass", type=int, default=None,
                   help="FPC fixed pass width")
    g.add_argument("--max-width", type=int, default=None,
                   help="measured policy: widest phase the cost model may "
                        "pick")
    g.add_argument("--latency-budget-ms", type=float, default=None,
                   help="measured serving fusion: per-dispatch latency "
                        "budget (unset = fuse maximally)")


def policy_kwargs_from_args(args: argparse.Namespace,
                            algorithm: str) -> dict:
    """The subset of set flags the ``algorithm``'s Policy accepts."""
    policy_cls, _ = ALGORITHMS[algorithm]
    accepted = inspect.signature(policy_cls.__init__).parameters
    out = {}
    for dest, kwarg in _POLICY_DESTS.items():
        val = getattr(args, dest, None)
        if val is not None and kwarg in accepted:
            out[kwarg] = val
    return out


def add_serving_args(ap: argparse.ArgumentParser) -> None:
    """Attach the multi-tenant / SLO serving knob group (DESIGN.md §12)."""
    g = ap.add_argument_group(
        "multi-tenant serving",
        "tenant registry, SLO admission and result caching (DESIGN.md §12)")
    g.add_argument("--tenants", type=int, default=1,
                   help="serve N tenants through one packed arena (the "
                        "transaction stream is round-robin split and mined "
                        "per tenant; 1 = single-tenant, PR 5 layout)")
    g.add_argument("--rate-qps", type=float, default=None,
                   help="open-loop mode: offer queries at this rate against "
                        "a virtual arrival clock and report sustained "
                        "qps / p99 / shed rate (unset = closed-loop replay)")
    g.add_argument("--latency-slo-ms", type=float, default=None,
                   help="admission target: shed queries whose predicted "
                        "sojourn (backlog + dispatch) misses this SLO")
    g.add_argument("--cache-size", type=int, default=256,
                   help="LRU result-cache entries (0 disables caching)")
    g.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="open-loop: dispatch a partial batch once its oldest "
                        "query has waited this long")
    g.add_argument("--no-fair-shedding", action="store_true",
                   help="shed arrivals in order instead of displacing "
                        "over-share tenants' queued queries")


def add_obs_args(ap: argparse.ArgumentParser) -> None:
    """Attach the unified observability flag group (DESIGN.md §13)."""
    g = ap.add_argument_group(
        "observability",
        "unified tracing + metrics (DESIGN.md §13); disabled flags cost "
        "nothing (no-op span fast path)")
    g.add_argument("--trace-out", default=None,
                   help="write a Chrome-trace-event JSON of this run "
                        "(open in ui.perfetto.dev)")
    g.add_argument("--metrics-out", default=None,
                   help="write the versioned metrics-registry snapshot")


def tracer_from_args(args: argparse.Namespace):
    """Install (and return) a live tracer when ``--trace-out`` was given;
    otherwise leave the zero-overhead NULL_TRACER active."""
    from repro_torch.obs.trace import NULL_TRACER, Tracer, set_tracer
    if getattr(args, "trace_out", None):
        return set_tracer(Tracer())
    return NULL_TRACER


def write_obs_outputs(args: argparse.Namespace, tracer=None) -> None:
    """Flush ``--trace-out`` / ``--metrics-out`` files at the end of a run."""
    import json

    if getattr(args, "trace_out", None) and tracer is not None \
            and tracer.enabled:
        tracer.export(args.trace_out)
        print(f"trace: {len(tracer.spans)} spans + {len(tracer.events)} "
              f"events -> {args.trace_out} (open in ui.perfetto.dev)")
    if getattr(args, "metrics_out", None):
        from repro_torch.obs.metrics import get_registry
        snap = get_registry().snapshot()
        with open(args.metrics_out, "w") as f:
            json.dump(snap, f, indent=2)
        n = (len(snap["counters"]) + len(snap["gauges"])
             + len(snap["histograms"]))
        print(f"metrics: {n} series (schema v{snap['schema_version']}) "
              f"-> {args.metrics_out}")


def add_mesh_args(ap: argparse.ArgumentParser) -> None:
    """Attach the uniform mesh / distributed-launch knob group (§11).

    The same flags drive one process with several cells on its device
    (``--cells-per-process``, the stand-in for the reference's forced host
    device count) and runs of several processes, one card each (every
    process passes identical flags; the coordinator triple may instead come
    from ``torchrun``'s MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK /
    LOCAL_RANK).
    """
    g = ap.add_argument_group(
        "mesh / distributed",
        "2-D (data, cand) mining mesh + elastic repartitioning "
        "(DESIGN.md §11)")
    g.add_argument("--n-data-shards", type=int, default=None,
                   help="transaction shards (default: cells / cand shards)")
    g.add_argument("--n-cand-shards", type=int, default=1,
                   help="candidate shards (2-D decomposition; 1 replicates "
                        "candidates as in the paper)")
    g.add_argument("--cells-per-process", type=int, default=1,
                   help="mesh cells this process holds, all on its one "
                        "device (one process drives one card)")
    g.add_argument("--no-elastic", action="store_true",
                   help="pin the initial mesh split (skip per-level "
                        "cost-model repartitioning)")
    g.add_argument("--max-retries", type=int, default=2,
                   help="per-phase counting-job retries after a shard "
                        "failure (rescatter + re-dispatch)")
    g.add_argument("--balance-shards", choices=("auto", "on", "off"),
                   default="auto",
                   help="LPT width-balance the transaction shards: 'auto' "
                        "lets the cost model enable it when predicted "
                        "straggler waste exceeds the re-pack cost")
    g.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (or an init URL) for a "
                        "torch.distributed run (unset = single-process)")
    g.add_argument("--num-processes", type=int, default=None,
                   help="total torch.distributed processes")
    g.add_argument("--process-id", type=int, default=None,
                   help="this worker's torch.distributed rank")
    g.add_argument("--dist-timeout", type=float, default=None,
                   help="seconds any collective may wait before the run "
                        "fails, e.g. on a process whose card was lost "
                        "(default: torch.distributed's 30 minutes)")


def runtime_from_args(args: argparse.Namespace, impl: str | None = None):
    """Build the (runtime, extra mine() kwargs) the mesh flags describe.

    Calls :func:`repro_torch.launch.mesh.init_distributed` first (no-op
    without a coordinator), then lays the 2-D mining mesh over every
    process's cells on ``args.device``.
    """
    from repro_torch.core.mapreduce import MapReduceRuntime
    from repro_torch.launch.mesh import init_distributed, make_mining_mesh

    device = getattr(args, "device", "cuda")
    init_distributed(getattr(args, "coordinator", None),
                     getattr(args, "num_processes", None),
                     getattr(args, "process_id", None), device=device,
                     timeout=getattr(args, "dist_timeout", None))
    n_cand = getattr(args, "n_cand_shards", 1) or 1
    mesh = make_mining_mesh(getattr(args, "n_data_shards", None), n_cand,
                            getattr(args, "cells_per_process", 1) or 1,
                            device=device)
    runtime = MapReduceRuntime(
        mesh=mesh, impl=impl, cand_axis="cand" if n_cand > 1 else None)
    balance = {"auto": None, "on": True, "off": False}[
        getattr(args, "balance_shards", "auto")]
    mine_kwargs = dict(elastic=not getattr(args, "no_elastic", False),
                       max_retries=getattr(args, "max_retries", 2),
                       balance_shards_by_width=balance)
    return runtime, mine_kwargs
