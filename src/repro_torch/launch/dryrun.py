"""Multi-pod dry run, analytic: every (architecture × input shape) on the
single-pod 16×16 mesh and the 2×16×16 two-pod mesh, with per-device bytes
and the roofline terms — the port's counterpart of the JAX package's
``launch/dryrun.py``, in its CLI and its JSONL record schema, so
``repro_torch.launch.report`` reads either's records.

The reference lowers and compiles each step for 512 forced host devices
and reads XLA's memory, cost and collective analyses.  The port has no
compiler to ask, so it reckons:

* per-device argument bytes — parameters, optimizer state (training) and
  caches (decode) — from the specs of meta tensors (``Model.
  abstract_params``, ``input_specs``): each leaf's shard under
  ``sharding.spec_for``, the stand-in for ``memory_analysis()``'s
  argument bytes (``arg_bytes_per_dev``, with its parts beside it);
* ``roofline`` from ``roofline.roofline_terms`` on the H100's constants.

``collective_per_chip_bytes`` is null and ``dominant`` is taken over
compute and memory only: the reference reads collectives from the
compiled HLO, and the port has none.  ``temp_bytes_per_dev``,
``compile_s`` and ``hlo_flops_raw`` are null for the same reason.  No
device is touched; the meshes are named shapes only.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \
      --mesh both --out results/dryrun.jsonl [--skip-existing]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch import sharding
from repro_torch.configs import ARCH_IDS, SHAPES, cell_is_runnable, get_config
from repro_torch.launch.mesh import PRODUCTION_MESHES
from repro_torch.models.layers import meta_params
from repro_torch.models.model import Model, param_axes
from repro_torch.roofline import roofline_terms


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


def run_cell(arch: str, shape_name: str, mesh: AxisMesh,
             profile: str = "auto") -> dict:
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh.name, "ok": False,
           "profile": profile}
    runnable, why = cell_is_runnable(arch, shape_name)
    if not runnable:
        rec["skipped"] = why
        return rec
    try:
        if profile == "auto":
            profile = "long_context" if shape_name == "long_500k" \
                else "default"
            rec["profile"] = profile
        rules = sharding.make_rules(profile)
        t0 = time.perf_counter()
        rec.update(reckon_bytes(cfg, shape, mesh, rules))
        rec["reckon_s"] = time.perf_counter() - t0
        rec["compile_s"] = None
        rec["temp_bytes_per_dev"] = None
        rec["out_bytes_per_dev"] = None
        rec["hlo_flops_raw"] = None
        rec["hlo_bytes_raw"] = None
        rec["collectives_by_op"] = {}
        rec["collective_per_chip_bytes"] = None
        rec["roofline"] = roofline_terms(cfg, shape, mesh.size, None,
                                         None).as_dict()
        rec["ok"] = True
    except Exception as e:  # a failing cell is a bug — record it loudly
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


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
    for arch in archs:
        for shape_name in shapes:
            for mesh in meshes:
                key = (arch, shape_name, mesh.name)
                if key in done:
                    continue
                rec = run_cell(arch, shape_name, mesh, profile=args.profile)
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                if rec.get("skipped"):
                    n_skip += 1
                    print(f"SKIP {key}: {rec['skipped']}", flush=True)
                elif rec["ok"]:
                    n_ok += 1
                    r = rec["roofline"]
                    print(f"OK   {key}: args="
                          f"{rec['arg_bytes_per_dev'] / 2**30:.2f}GiB/dev "
                          f"terms(c/m)={r['compute_s']:.3e}/"
                          f"{r['memory_s']:.3e} dom={r['dominant']}",
                          flush=True)
                else:
                    n_fail += 1
                    print(f"FAIL {key}: {rec['error']}", flush=True)
    print(f"done: ok={n_ok} fail={n_fail} skip={n_skip}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
