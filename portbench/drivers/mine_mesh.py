"""The paper's cluster: ``mine()`` on a mining mesh of one process a card.

This process starts ``processes`` workers (``spawn``), joins none of them
to a card itself, and prints the result.  Each worker takes card ``rank``,
joins one process group over ``nccl`` (``gloo`` on the CPU) at a free
localhost port, lays the ``(n_data, n_cand)`` mesh over the group with
``cells_per_process`` cells each (``launch/mesh.make_mining_mesh``, as the
mining CLI does under ``torchrun``), and mines the whole database back to
back: every counting job ends in an ``all_reduce`` of the counts across the
cards.  Process 0 keeps the clock and, after each mine, broadcasts whether
the window goes on, so every process runs the same mines.  Process 0's
levels of every mine are held against the reference's.
"""

from __future__ import annotations

import datetime
import socket
import time

from portbench.harness import env
from portbench.harness.result import Outcome
from portbench.harness.window import Record, Window

from . import mining

JOIN_S = 120.0     # a collective that waits longer has lost a process


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker(rank: int, spec: dict, out) -> None:
    """One process of the mesh; sends its part of the result on ``out``."""
    import os

    # a cost-model file of its own: the port saves its fits on every job
    model = os.environ["REPRO_TORCH_COSTMODEL_CACHE"].replace(
        ".json", f".rank{rank}.json")
    if os.path.exists(model):
        os.remove(model)
    os.environ["REPRO_TORCH_COSTMODEL_CACHE"] = model
    import torch
    import torch.distributed as dist
    from repro_torch.core.mapreduce import MapReduceRuntime
    from repro_torch.launch.mesh import make_mining_mesh

    tr, config = spec["traffic"], spec["config"]
    world = tr["processes"]
    if spec["device"] == "cuda":
        torch.cuda.set_device(rank)
        dev, backend = torch.device("cuda", rank), "nccl"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:"
                            f"{spec['port']}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=JOIN_S))
    try:
        mesh = make_mining_mesh(tr["n_data"], tr["n_cand"],
                                tr["cells_per_process"], device=dev)
        rows, db = mining.inputs(config, spec["seed"])
        cand_axis = "cand" if tr["n_cand"] > 1 else None

        def one():
            rt = MapReduceRuntime(mesh=mesh, impl=config["mine"]["impl"],
                                  cand_axis=cand_axis)
            return mining.mine_once(db, config, rt), rt

        for _ in range(tr["warmup_mines"]):
            one()
        flag = torch.ones(1, dtype=torch.int32, device=dev)
        dist.barrier()
        win = Window(dev, spec["trace"])
        t0 = win.open()
        results, dispatches, rows_counted = [], 0, 0
        while True:
            res, rt = one()
            if rank == 0:
                results.append(res.levels)
                flag.fill_(int(time.perf_counter() - t0 < spec["seconds"]))
            dispatches += res.dispatches
            rows_counted += rt.stats.rows_counted
            n = len(results)
            dist.broadcast(flag, 0)
            if not int(flag.item()):
                break
        win.close()
        part = {"rank": rank, "t0": t0, "window_s": win.seconds,
                "peak": (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else 0),
                "dispatches": dispatches, "rows_counted": rows_counted,
                "levels": results if rank == 0 else None, "n": n,
                "loaded": env.forbidden_modules()}
        if spec["trace"]:
            part["chip"] = win.chip()
            part["spans"] = win.spans() if rank == 0 else None
        out.send(part)
    finally:
        out.close()
        dist.destroy_process_group()


def launch(spec: dict, target) -> list:
    """Start the workers, collect one part from each over a pipe of its
    own, and wait for all of them to end; raise if any failed."""
    import multiprocessing as mp
    from multiprocessing.connection import wait
    ctx = mp.get_context("spawn")
    procs, conns = [], []
    for r in range(spec["traffic"]["processes"]):
        recv, send = ctx.Pipe(duplex=False)
        p = ctx.Process(target=target, args=(r, spec, send))
        p.start()
        send.close()
        procs.append(p)
        conns.append(recv)
    parts = {}
    try:
        while len(parts) < len(procs):
            waiting = [c for i, c in enumerate(conns) if i not in parts]
            ready = wait(waiting, timeout=5.0)
            for c in ready:
                i = conns.index(c)
                try:
                    parts[i] = c.recv()
                except EOFError:
                    raise RuntimeError(f"mesh process {i} ended with exit "
                                       f"code {procs[i].exitcode}") from None
            if not ready and any(p.exitcode not in (None, 0) for p in procs):
                raise RuntimeError("a mesh process failed: exit codes "
                                   f"{[p.exitcode for p in procs]}")
    finally:
        for c in conns:
            c.close()
        for p in procs:
            p.join(timeout=JOIN_S if len(parts) < len(procs) else 60.0)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        _stop_resource_tracker()
    if any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"mesh processes ended with "
                           f"{[p.exitcode for p in procs]}")
    return [parts[i] for i in range(len(procs))]


def _stop_resource_tracker() -> None:
    """End the helper process ``spawn`` starts beside the workers, and wait
    for it, so the run leaves no process behind."""
    from multiprocessing import resource_tracker
    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()


def run(ctx) -> Outcome:
    spec = {"config": ctx.config, "traffic": ctx.traffic, "seed": ctx.seed,
            "seconds": ctx.seconds, "trace": ctx.trace, "device": ctx.device,
            "port": free_port()}
    parts = launch(spec, worker)
    loaded = sorted({m for p in parts for m in p["loaded"]})
    if loaded:
        raise RuntimeError(f"a mesh process loaded {', '.join(loaded)}")
    lead = parts[0]
    results = lead["levels"]
    record = None
    if ctx.trace:
        spans = lead["spans"]
        record = Record(
            spans=spans,
            counters={"mines": lead["n"], "dispatches": lead["dispatches"],
                      "rows_counted": lead["rows_counted"],
                      "frequent": sum(mining.frequent(lv) for lv in results)},
            chips=[p["chip"] for p in parts], window_s=lead["window_s"],
            work=mining.count_jobs(spans, mining.n_items(ctx.config)))
    rows, _ = mining.inputs(ctx.config, ctx.seed)
    want = mining.reference(rows, ctx.config)
    wrong = mining.check(results, want)
    return Outcome(
        metrics={"mine_s": lead["window_s"] / lead["n"]}, t_window=lead["t0"],
        checks={"itemsets_wrong": (wrong, 0)}, attempted=lead["n"], failed=0,
        memory_peak=max(p["peak"] for p in parts), record=record,
        notes=[f"mines {lead['n']} on {len(parts)} processes in "
               f"{lead['window_s']:.6f} s, process 0's levels held against "
               f"the reference's {mining.frequent(want)} itemsets"])
