"""Multi-pod dry run: every (architecture × input shape) on the single-pod
16×16 mesh and the 2×16×16 two-pod mesh, each step traced on fake tensors
over a fake process group — the port's counterpart of the JAX package's
``launch/dryrun.py``, in its CLI and its JSONL record schema, so
``repro_torch.launch.report`` reads either's records.

The reference lowers and compiles each step for 512 forced host devices
and reads XLA's memory, cost and collective analyses.  The port has no
compiler to ask; it runs the step instead, with nothing real in it:

* each mesh is traced in a process of its own (:func:`run_cells`), which
  joins a fake process group (``torch.testing._internal.distributed.
  fake_pg``, backend ``"fake"``) of the mesh's size as rank 0 — a process
  holds one default group, so the 256- and 512-rank meshes cannot share
  one — and touches no card;
* there it builds the model (and for training the AdamW state) as DTensor
  shards under ``FakeTensorMode``, so no memory is touched, and runs
  :func:`build_step`'s step on fake inputs under
  ``roofline.CollectiveTally``, which fills ``collectives_by_op``,
  ``collective_per_chip_bytes``, ``hlo_flops_raw`` (the products and
  attention only), ``hlo_bytes_raw`` (unfused eager traffic) and
  ``temp_bytes_per_dev``; ``out_bytes_per_dev`` is the bytes of the
  step's outputs' local shards and ``trace_s`` the trace's seconds
  (``compile_s`` stays null: there is no compiler);
* per-device argument bytes — parameters, optimizer state (training),
  caches (decode) and inputs — come from the specs of meta tensors
  (``reckon_bytes``: each leaf's shard under ``sharding.spec_for``, the
  stand-in for ``memory_analysis()``'s argument bytes);
* ``roofline`` is ``roofline.roofline_terms`` on the H100's constants,
  ``dominant`` over compute, memory and collectives.

Every cell runs at its full width and shape.  A cell takes one CPU core
seconds (decode) to minutes (train_4k) to most of an hour (prefill_32k:
the chunked attention's 2,048 tiles a layer, each op through DTensor and
the fake tensors), about seven core-hours for all 64; ``--arch``,
``--shape`` and ``--skip-existing`` split the run over processes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
      --mesh both --out results/dryrun.jsonl [--skip-existing]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch import sharding
from repro_torch.configs import (ARCH_IDS, SHAPES, cell_is_runnable,
                                 get_config)
from repro_torch.launch.mesh import PRODUCTION_MESHES
from repro_torch.models.layers import meta_params
from repro_torch.models.model import Model, param_axes
from repro_torch.roofline import roofline_terms, tally_step

# seconds a mesh's tracing process may take before it is stopped
TRACE_TIMEOUT_S = 4 * 3600


class AxisMesh:
    """A mesh as the spec logic reads it: axis names and sizes, no
    devices."""

    def __init__(self, shape: tuple, names: tuple):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))
        self.size = 1
        for s in shape:
            self.size *= s

    @property
    def name(self) -> str:
        return "x".join(str(self.shape[a]) for a in self.axis_names)


def _leaf_bytes(mesh, rules, axes, t) -> int:
    spec = sharding.spec_for(mesh, axes, rules, tuple(t.shape))
    return sharding.spec_bytes(tuple(t.shape), t.element_size(), mesh, spec)


def _tree_bytes(mesh, rules, axes_tree, tensors) -> int:
    if isinstance(axes_tree, tuple):
        return _leaf_bytes(mesh, rules, axes_tree, tensors)
    return sum(_tree_bytes(mesh, rules, axes_tree[k], tensors[k])
               for k in axes_tree)


def reckon_bytes(cfg, shape, mesh, rules) -> dict:
    """Per-device argument bytes of one step, by part."""
    with meta_params():
        model = Model(cfg, device="cpu")
    params = dict(model.named_parameters())
    axes = param_axes(model)
    param_b = sum(_leaf_bytes(mesh, rules, axes[n], p)
                  for n, p in params.items())
    opt_b = 0
    if shape.kind == "train":
        # AdamW's float32 m and v, placed like their parameters, and step
        opt_b = 2 * sum(_leaf_bytes(mesh, rules, axes[n], p.float())
                        for n, p in params.items()) + 4
    specs, in_axes = model.input_specs(shape), model.input_axes(shape)
    cache_b = _tree_bytes(mesh, rules, in_axes["caches"], specs["caches"]) \
        if "caches" in specs else 0
    input_b = sum(_tree_bytes(mesh, rules, in_axes[k], specs[k])
                  for k in specs if k != "caches")
    return {"param_bytes_per_dev": int(param_b),
            "opt_bytes_per_dev": int(opt_b),
            "cache_bytes_per_dev": int(cache_b),
            "input_bytes_per_dev": int(input_b),
            "arg_bytes_per_dev": int(param_b + opt_b + cache_b + input_b)}


# -- the step of each kind ----------------------------------------------------------

def _batch(model, B: int, S: int, lead: tuple = ()) -> dict:
    """Zero token ids (and the frontend stubs' zero embeddings) of a (B,
    S) batch on the model's device, with ``lead`` dimensions first."""
    cfg, dev = model.cfg, model.device
    out = {"tokens": torch.zeros(lead + (B, S), dtype=torch.long,
                                 device=dev)}
    stub = {"vision_stub": ("vision_embeds", cfg.n_frontend_tokens),
            "audio_stub": ("frame_embeds", cfg.enc_seq)}.get(cfg.frontend)
    if stub is not None:
        key, n = stub
        out[key] = torch.zeros(lead + (B, n, cfg.d_model),
                               dtype=torch.bfloat16, device=dev)
    return out


def build_step(model, shape, opt_cfg=None):
    """The step the reference's ``build_step`` jits, as a function of no
    arguments over inputs built here (zeros on the model's device, fake
    ones under ``FakeTensorMode``), at ``shape``'s global batch and
    sequence length:

    * train: ``TrainLoop``'s step at ``npass=1`` — ``Model.loss``, its
      backward under the config's remat, one AdamW update (``opt_cfg``,
      the default config unless given) with global-norm clipping — on the
      model's trainable parameters and a zeroed optimizer state;
    * prefill: ``Model.prefill(batch, seq_len)``;
    * decode: one ``decode_step`` on a ``seq_len`` cache, then
      ``sharded_greedy``; returns (next tokens (B, 1), caches).
    """
    from repro_torch.models.model import sharded_greedy
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        from repro_torch.optim import AdamWConfig
        from repro_torch.train import init_train_state, make_train_step
        opt_cfg = opt_cfg or AdamWConfig()
        state = init_train_state(model, opt_cfg, seed=None)
        phase = make_train_step(model, opt_cfg, npass=1)
        batches = _batch(model, B, S, lead=(1,))
        batches["labels"] = torch.zeros_like(batches["tokens"])
        return lambda: phase(state, batches)
    if shape.kind == "prefill":
        batch = _batch(model, B, S)
        return lambda: model.prefill(batch, S)
    if shape.kind != "decode":
        raise ValueError(shape.kind)
    caches = model.empty_caches(B, S)
    token = torch.zeros((B, 1), dtype=torch.long, device=model.device)
    pos = torch.full((B,), S - 1, dtype=torch.long, device=model.device)

    def serve_step():
        logits, new = model.decode_step(caches, token, pos)
        return sharded_greedy(logits, model.ctx)[:, None], new
    return serve_step


def _local_bytes(tree) -> int:
    """Bytes of a result's tensors (a DTensor's local shard), each storage
    once."""
    seen, n = set(), 0

    def walk(x):
        nonlocal n
        if isinstance(x, torch.Tensor):
            t = x.to_local() if sharding.is_dtensor(x) else x
            key = t.untyped_storage()._cdata
            if key not in seen:
                seen.add(key)
                n += t.untyped_storage().nbytes()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(tree)
    return n


def measure_step(model, shape, opt_cfg=None) -> dict:
    """:func:`build_step`'s step run once under ``roofline.
    CollectiveTally``: the tally's record (collectives by op, FLOPs,
    bytes, temp bytes, ``trace_s``) and ``out_bytes_per_dev``."""
    out, rec = tally_step(build_step(model, shape, opt_cfg))
    rec["out_bytes_per_dev"] = _local_bytes(out)
    return rec


# -- tracing in a fake process group --------------------------------------------------

def join_fake_group(world: int) -> None:
    """Make this process rank 0 of a fake process group of ``world``
    ranks (no peer, no network): collectives return at once, their
    outputs shaped as a real group's."""
    import torch.distributed as dist
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch.testing._internal.distributed.fake_pg "
            f"(the fake process group), which this torch lacks: {e}") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def trace_step(cfg, shape, mesh_shape: tuple, names: tuple, rules: dict,
               opt_cfg=None) -> dict:
    """Build ``cfg``'s model on a ``mesh_shape`` mesh of this process's
    fake group under ``FakeTensorMode`` and :func:`measure_step` it;
    adds ``build_s``, the seconds the fake model took."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import _device_mesh
    from repro_torch.models.model import build_model
    mesh = _device_mesh(tuple(mesh_shape), tuple(names), "cpu")
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = build_model(cfg, device="cpu", seed=None, mesh=mesh,
                            rules=rules)
        build_s = time.perf_counter() - t0
        rec = measure_step(model, shape, opt_cfg)
    rec["build_s"] = build_s
    return rec


def _fake_worker(world: int, jobs: list, conn) -> None:
    """The tracing process: join a fake group of ``world`` ranks, run each
    ``(fn, args)`` job, send ("ok", result) or ("err", traceback) for each
    as it ends."""
    import logging
    import warnings
    os.environ["CUDA_VISIBLE_DEVICES"] = ""      # this process has no card
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    warnings.filterwarnings("ignore")
    try:
        join_fake_group(world)
    except Exception:
        conn.send(("fatal", traceback.format_exc()))
        return
    for fn, args in jobs:
        try:
            conn.send(("ok", fn(*args)))
        except Exception:
            conn.send(("err", traceback.format_exc()))
    conn.close()


def in_fake_group(jobs: list, world: int, timeout: float = TRACE_TIMEOUT_S):
    """Yield ``fn(*args)`` for each ``(fn, args)`` of ``jobs`` (module-level
    functions), run in order in one spawned process that is rank 0 of a
    fake process group of ``world`` ranks.  A job that raises raises here
    with its traceback; the process is stopped when the generator ends."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_fake_worker, args=(world, jobs, child),
                       daemon=True)
    proc.start()
    child.close()
    deadline = time.monotonic() + timeout
    try:
        for _ in jobs:
            if not parent.poll(max(deadline - time.monotonic(), 0)):
                raise TimeoutError(f"tracing on {world} fake ranks outlived "
                                   f"{timeout} s")
            status, val = parent.recv()
            if status != "ok":
                raise RuntimeError(f"tracing on {world} fake ranks "
                                   f"failed:\n{val}")
            yield val
    except EOFError as e:
        raise RuntimeError(f"the tracing process died (exit "
                           f"{proc.exitcode})") from e
    finally:
        if proc.is_alive():
            proc.kill()
        proc.join()


# -- cells --------------------------------------------------------------------------

def _profile(profile: str, shape_name: str) -> str:
    if profile == "auto":
        return "long_context" if shape_name == "long_500k" else "default"
    return profile


def cell_record(arch: str, cfg, shape, mesh_shape: tuple, names: tuple,
                profile: str) -> dict:
    """The record of ``arch``'s cell: ``cfg`` at ``shape`` on the mesh,
    traced in this process (rank 0 of a fake group of the mesh's size)."""
    mesh = AxisMesh(mesh_shape, names)
    profile = _profile(profile, shape.name)
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh.name, "ok": False,
           "profile": profile}
    try:
        rules = sharding.make_rules(profile)
        t0 = time.perf_counter()
        rec.update(reckon_bytes(cfg, shape, mesh, rules))
        rec["reckon_s"] = time.perf_counter() - t0
        rec["compile_s"] = None
        rec.update(trace_step(cfg, shape, mesh_shape, names, rules))
        rec["roofline"] = roofline_terms(
            cfg, shape, mesh.size, rec["collective_per_chip_bytes"],
            rec["hlo_flops_raw"]).as_dict()
        rec["ok"] = True
    except Exception as e:  # a failing cell is a bug — record it loudly
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def run_cells(cells, mesh: AxisMesh, profile: str = "auto"):
    """Yield the record of each ``(arch, shape name)`` cell on ``mesh``,
    in order, as each is done: a skipped cell at once, the others traced
    in one process of a fake group of ``mesh.size`` ranks.  If that
    process cannot start its group, every cell it had fails with why."""
    names = mesh.axis_names
    shape = tuple(mesh.shape[a] for a in names)
    todo = []
    for arch, shape_name in cells:
        runnable, why = cell_is_runnable(arch, shape_name)
        if not runnable:
            yield {"arch": arch, "shape": shape_name, "mesh": mesh.name,
                   "ok": False, "profile": profile, "skipped": why}
        else:
            todo.append((arch, shape_name))
    jobs = [(cell_record, (arch, get_config(arch), SHAPES[s], shape, names,
                           profile)) for arch, s in todo]
    try:
        yield from in_fake_group(jobs, mesh.size)
    except RuntimeError as e:
        for arch, s in todo:
            yield {"arch": arch, "shape": s, "mesh": mesh.name, "ok": False,
                   "profile": profile, "error": str(e)}


def run_cell(arch: str, shape_name: str, mesh: AxisMesh,
             profile: str = "auto") -> dict:
    """One cell's record (:func:`run_cells`)."""
    return next(iter(run_cells([(arch, shape_name)], mesh, profile)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun.jsonl")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--profile", default="auto",
                    choices=["auto", "default", "decode", "long_context"],
                    help="sharding rules profile")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    pods = {"single": [False], "multi": [True],
            "both": [False, True]}[args.mesh]
    meshes = [AxisMesh(*PRODUCTION_MESHES[mp]) for mp in pods]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if args.skip_existing and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                if r.get("ok") or r.get("skipped"):
                    done.add((r["arch"], r["shape"], r["mesh"]))

    n_ok = n_fail = n_skip = 0
    for mesh in meshes:
        cells = [(a, s) for a in archs for s in shapes
                 if (a, s, mesh.name) not in done]
        for rec in run_cells(cells, mesh, args.profile):
            key = (rec["arch"], rec["shape"], rec["mesh"])
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            if rec.get("skipped"):
                n_skip += 1
                print(f"SKIP {key}: {rec['skipped']}", flush=True)
            elif rec["ok"]:
                n_ok += 1
                r = rec["roofline"]
                print(f"OK   {key}: trace={rec['trace_s']:.1f}s "
                      f"args={rec['arg_bytes_per_dev'] / 2**30:.2f}GiB/dev "
                      f"temp={rec['temp_bytes_per_dev'] / 2**30:.2f}GiB "
                      f"coll={rec['collective_counts']} "
                      f"terms(c/m/n)={r['compute_s']:.3e}/"
                      f"{r['memory_s']:.3e}/{r['collective_s']:.3e} "
                      f"dom={r['dominant']}", flush=True)
            else:
                n_fail += 1
                print(f"FAIL {key}: {rec['error']}", flush=True)
    print(f"done: ok={n_ok} fail={n_fail} skip={n_skip}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
