"""The port's logical-axis sharding against the reference's, with no device:
the rule resolution (``tests/test_sharding.py``'s cases), the spec of every
parameter, optimizer-state leaf, cache leaf and input of every arch under
every profile on four meshes, the analytic roofline, and the dry run."""

import functools
import json

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro import roofline as ref_roofline
from repro import sharding as ref_sharding
from repro.configs import get_config as ref_config
from repro.models.model import Model as RefModel
from repro.optim import adamw as ref_adamw
from repro_torch import roofline, sharding
from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeConfig,
                                 cell_is_runnable, get_config)
from repro_torch.models import convert
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig, state_axes


class FakeMesh:
    """Minimal mesh stand-in with controllable axis sizes."""
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _p(spec) -> P:
    return P(*spec)


# -- tests/test_sharding.py's cases, against the port ------------------------------

def test_spec_basic():
    spec = sharding.spec_for(FakeMesh({"data": 1}), ("batch", "seq"),
                             sharding.make_rules(), (4, 16))
    assert _p(spec) == P("data", None)


def test_divisibility_fallback():
    spec = sharding.spec_for(FakeMesh({"data": 1}), ("x",), {"x": "data"},
                             (7,))
    assert _p(spec) == P("data")


def test_fallback_replicates_non_divisible():
    mesh = FakeMesh({"data": 16, "model": 16})
    rules = {"heads": "model", "embed": "data"}
    assert _p(sharding.spec_for(mesh, ("embed", "heads"), rules,
                                (576, 9))) == P("data", None)
    assert _p(sharding.spec_for(mesh, ("embed", "heads"), rules,
                                (576, 48))) == P("data", "model")


def test_candidate_list_prefers_first_divisible():
    mesh = FakeMesh({"data": 16, "model": 16})
    rules = {"b": [("data", "model"), "data"], "m": "model"}
    assert _p(sharding.spec_for(mesh, ("b", None, "m"), rules,
                                (256, 4096, 8192))) == \
        P(("data", "model"), None, None)
    assert _p(sharding.spec_for(mesh, ("b", None, "m"), rules,
                                (32, 4096, 8192))) == P("data", None, "model")


def test_conflict_avoidance():
    mesh = FakeMesh({"data": 16, "model": 16})
    rules = {"a": "model", "b": "model"}
    assert _p(sharding.spec_for(mesh, ("a", "b"), rules, (16, 16))) == \
        P("model", None)


def test_pod_folding():
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16})
    rules = {"batch": "data", "mlp": "model"}
    assert _p(sharding.spec_for(mesh, ("batch", "mlp"), rules,
                                (256, 512))) == P(("pod", "data"), "model")


def test_long_context_profile():
    rules = sharding.make_rules("long_context")
    mesh = FakeMesh({"data": 16, "model": 16})
    spec = sharding.spec_for(
        mesh, ("cache_batch", "kv_seq", "kv_heads", "head_dim"), rules,
        (1, 524288, 8, 128))
    assert _p(spec) == P(None, "data", None, None)


def test_unknown_axis_raises():
    with pytest.raises(KeyError):
        sharding.spec_for(FakeMesh({"data": 1}), ("nope",), {"x": None},
                          (4,))


def test_rule_tables_are_the_reference_s():
    for profile in ("default", "decode", "long_context"):
        assert sharding.make_rules(profile) == ref_sharding.make_rules(profile)
    with pytest.raises(ValueError):
        sharding.make_rules("nope")


def test_placements_and_bytes():
    """A spec's placements (a tuple entry shards one tensor dimension over
    both mesh axes, major to minor) and the bytes a process holds."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeMesh({"pod": 2, "data": 4, "model": 8})
    assert sharding.placements_for(mesh, (("pod", "data"), None, "model")) \
        == [Shard(0), Shard(0), Shard(2)]
    assert sharding.placements_for(mesh, (None,)) == \
        [Replicate(), Replicate(), Replicate()]
    with pytest.raises(ValueError):
        sharding.placements_for(mesh, (("data", "pod"),))
    assert sharding.spec_bytes((16, 3, 64), 2, mesh,
                               (("pod", "data"), None, "model")) == \
        2 * 2 * 3 * 8


# -- every arch, profile and mesh: the port's specs are the reference's -----------

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4}, "1x4": {"data": 1, "model": 4}}
PROFILES = ("default", "decode", "long_context")


@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    model = RefModel(ref_config(arch))
    shapes, axes = model.abstract_params()
    return model, shapes, axes


@functools.lru_cache(maxsize=None)
def _port(arch: str):
    params, axes = Model.abstract_params(get_config(arch))
    from repro_torch.models.layers import meta_params
    with meta_params():
        model = Model(get_config(arch), device="cpu")
    return model, params, axes


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_parameter_and_optimizer_specs_match(arch):
    ref_model, ref_shapes, ref_axes = _reference(arch)
    model, params, axes = _port(arch)
    leaves = convert.reference_leaves(model)
    assert set(params) == {n for names in leaves.values() for n in names}
    opt = AdamWConfig(compress=True)
    assert state_axes(axes, opt)["step"] == \
        ref_adamw.state_axes(ref_axes, opt)["step"] == ()
    assert set(state_axes(axes, opt)) == set(ref_adamw.state_axes(ref_axes,
                                                                  opt))
    n = 0
    for mesh_shape in MESHES.values():
        mesh = FakeMesh(mesh_shape)
        for profile in PROFILES:
            rules = sharding.make_rules(profile)
            for path, names in leaves.items():
                r_axes, r_shape = _get(ref_axes, path), \
                    _get(ref_shapes, path).shape
                want = ref_sharding.spec_for(mesh, r_axes, rules, r_shape)
                stacked = path[0] in convert.STACKS
                if stacked:
                    assert r_axes[0] == "layers" and want[0] is None
                    want = tuple(want)[1:]
                for name in names:
                    got = sharding.spec_for(mesh, axes[name], rules,
                                            tuple(params[name].shape))
                    assert _p(got) == P(*want), (path, name, profile)
                    # the moments (float32, same shape) take the same spec
                    o_axes = state_axes(axes, opt)["m"][name]
                    assert sharding.spec_for(mesh, o_axes, rules,
                                             tuple(params[name].shape)) == got
                    n += 1
    assert n > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_input_specs_match(arch):
    ref_model, _, _ = _reference(arch)
    model, _, _ = _port(arch)
    cfg = ref_model.cfg
    for shape in SHAPES.values():
        ref_specs = ref_model.input_specs(shape)
        ref_in = ref_model.input_axes(shape)
        specs, in_axes = model.input_specs(shape), model.input_axes(shape)
        assert set(specs) == set(ref_specs) == set(in_axes)
        for mesh_shape in MESHES.values():
            mesh = FakeMesh(mesh_shape)
            for profile in PROFILES:
                rules = sharding.make_rules(profile)
                for key in specs:
                    if key == "caches":
                        continue
                    assert tuple(specs[key].shape) == \
                        tuple(ref_specs[key].shape)
                    assert _p(sharding.spec_for(
                        mesh, in_axes[key], rules, tuple(specs[key].shape))) \
                        == ref_sharding.spec_for(mesh, ref_in[key], rules,
                                                 ref_specs[key].shape)
                if "caches" not in specs:
                    continue
                caches, c_axes = specs["caches"], in_axes["caches"]
                for key, leaf in caches.items():
                    for r_axes, r_leaf in _ref_cache_leaves(
                            cfg, key, ref_in["caches"], ref_specs["caches"]):
                        assert tuple(leaf.shape[1:]) == \
                            tuple(r_leaf.shape[1:])
                        want = ref_sharding.spec_for(mesh, r_axes, rules,
                                                     r_leaf.shape)
                        got = sharding.spec_for(mesh, c_axes[key], rules,
                                                tuple(leaf.shape))
                        assert got[0] is None and want[0] is None
                        assert _p(got[1:]) == P(*tuple(want)[1:]), \
                            (key, profile, mesh_shape)


def _ref_cache_leaves(cfg, key, ref_axes, ref_specs):
    """The reference's cache leaves a port cache key stands for: its
    ``sub{j}`` leaves of that kind (stacked by period) or, for the
    encoder-decoder, the leaf of the same name."""
    if cfg.is_encoder_decoder:
        return [(ref_axes[key], ref_specs[key])]
    conv = {"conv_x": "x", "conv_B": "B", "conv_C": "C"}
    out = []
    for sub, axes in ref_axes.items():
        if key in ("k", "v") and key in axes:
            out.append((axes[key], ref_specs[sub][key]))
        elif key in conv and "conv" in axes:
            out.append((axes["conv"][conv[key]],
                        ref_specs[sub]["conv"][conv[key]]))
        elif key == "state" and "state" in axes:
            out.append((axes["state"], ref_specs[sub]["state"]))
    assert out, key
    return out


# -- the analytic roofline ----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_flops_and_bytes_match(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for shape in SHAPES.values():
        assert roofline.analytic_flops(cfg, shape) == \
            ref_roofline.analytic_flops(rcfg, shape)
        for chips in (256, 512):
            assert roofline.analytic_bytes(cfg, shape, chips) == \
                ref_roofline.analytic_bytes(rcfg, shape, chips)
            got = roofline.roofline_terms(cfg, shape, chips, 3.5e8, 1e15,
                                          hw=ref_roofline.HW)
            want = ref_roofline.roofline_terms(rcfg, shape, chips, 3.5e8,
                                               1e15)
            assert got.as_dict() == want.as_dict()


def test_roofline_without_collectives_uses_the_h100():
    cfg, shape = get_config("qwen3-14b"), SHAPES["train_4k"]
    t = roofline.roofline_terms(cfg, shape, 256, None)
    fl = roofline.analytic_flops(cfg, shape)["total_flops"]
    assert t.collective_s is None and t.dominant in ("compute", "memory")
    assert t.compute_s == fl / (256 * 989e12)
    assert roofline.HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                           "link_bw": 450e9}
    row = roofline.predicted_vs_achieved(2.0, 4.0)
    assert row == ref_roofline.predicted_vs_achieved(2.0, 4.0)


# -- the dry run ----------------------------------------------------------------------

# the smoke configs at shapes whose batch splits over 32 data processes
# (the two-pod mesh's pod × data)
SMOKE_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 64, 32, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 128, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 128, 32, "decode"),
    "long_500k": ShapeConfig("long_500k", 1024, 1, "decode"),
}


def test_dryrun_single_pod_reads_back(tmp_path, capsys):
    """Every cell of the 16x16 mesh traced on a fake group of 256 ranks
    (``dryrun.cell_record``) — the smoke configs at :data:`SMOKE_SHAPES`,
    so tier-1 stays short (``test_dryrun_production_meshes_need_no_device``
    traces a full-width cell) — and read back by the report."""
    from repro_torch.launch import dryrun, report
    mesh = dryrun.AxisMesh(*dryrun.PRODUCTION_MESHES[False])
    shape = tuple(mesh.shape[a] for a in mesh.axis_names)
    rows, jobs = [], []
    for arch in ARCH_IDS:
        for s in SHAPES:
            runnable, why = cell_is_runnable(arch, s)
            if runnable:
                jobs.append((dryrun.cell_record, (
                    arch, get_config(arch, smoke=True), SMOKE_SHAPES[s],
                    shape, mesh.axis_names, "auto")))
            else:
                rows.append({"arch": arch, "shape": s, "mesh": mesh.name,
                             "ok": False, "profile": "auto", "skipped": why})
    rows += dryrun.in_fake_group(jobs, mesh.size)
    out = tmp_path / "dry.jsonl"
    out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(rows) == len(ARCH_IDS) * len(SHAPES)
    ok = [r for r in rows if r.get("ok")]
    assert ok and all(r["mesh"] == "16x16" for r in rows)
    for r in ok:
        assert r["collective_per_chip_bytes"] > 0
        assert sum(r["collectives_by_op"].values()) == \
            r["collective_per_chip_bytes"]
        for key in ("hlo_flops_raw", "hlo_bytes_raw", "temp_bytes_per_dev",
                    "out_bytes_per_dev", "trace_s"):
            assert isinstance(r[key], (int, float)), key
        t = r["roofline"]
        terms = {k: t[k + "_s"] for k in ("compute", "memory", "collective")}
        assert t["collective_s"] > 0 and \
            t["dominant"] == max(terms, key=terms.get)
    assert not [r for r in rows if not r.get("ok") and not r.get("skipped")]
    # the bytes are the specs': qwen3-14b's parameters split over model
    cell = next(r for r in ok if r["arch"] == "qwen3-14b"
                and r["shape"] == "train_4k")
    params, axes = Model.abstract_params(get_config("qwen3-14b",
                                                    smoke=True))
    whole = sum(p.numel() * p.element_size() for p in params.values())
    assert cell["param_bytes_per_dev"] < whole
    assert cell["opt_bytes_per_dev"] == 2 * 2 * cell["param_bytes_per_dev"] \
        + 4
    capsys.readouterr()
    report.main([str(out)])
    text = capsys.readouterr().out
    assert f"{len(ok)} ok" in text and \
        "| qwen3-14b | train_4k | 16x16 | ok |" in text
    assert "hillclimb candidates: worst-fraction=" in text
    coll = max(ok, key=lambda r: r["roofline"]["collective_s"]
               / max(r["roofline"]["compute_s"], 1e-12))
    assert f"most-collective={(coll['arch'], coll['shape'], '16x16')}" in text


def test_dryrun_production_meshes_need_no_device():
    """qwen3-14b's decode_32k at full width on both production meshes,
    each traced in a process of a fake group of 256 or 512 ranks."""
    from repro_torch.launch import dryrun
    for multi in (False, True):
        mesh = dryrun.AxisMesh(*dryrun.PRODUCTION_MESHES[multi])
        rec = dryrun.run_cell("qwen3-14b", "decode_32k", mesh)
        assert rec["ok"], rec.get("error")
        assert rec["mesh"] == ("2x16x16" if multi else "16x16")
        assert rec["arg_bytes_per_dev"] == rec["param_bytes_per_dev"] + \
            rec["cache_bytes_per_dev"] + rec["input_bytes_per_dev"]
        assert rec["collective_per_chip_bytes"] > 0 and \
            rec["hlo_flops_raw"] > 0 and rec["temp_bytes_per_dev"] > 0
        assert rec["compile_s"] is None and rec["trace_s"] > 0


def test_tree_specs_match_the_reference():
    mesh = FakeMesh({"data": 2, "model": 4})
    rules = sharding.make_rules()
    axes = {"a": ("embed", "mlp"), "b": {"c": ("vocab", None)}}
    shapes = {"a": np.zeros((8, 12)), "b": {"c": np.zeros((6, 3))}}
    got = sharding.tree_specs(mesh, axes, rules, shapes)
    want = ref_sharding.tree_specs(mesh, axes, rules, shapes)
    assert _p(got["a"]) == want["a"] and _p(got["b"]["c"]) == want["b"]["c"]
    assert _p(sharding.tree_specs(mesh, axes, rules)["b"]["c"]) == \
        ref_sharding.tree_specs(mesh, axes, rules)["b"]["c"]
    pl = sharding.tree_shardings(mesh, axes, rules, shapes)
    assert pl["a"] == sharding.placements_for(mesh, got["a"])


def test_production_meshes_need_their_process_count():
    from repro_torch.launch import mesh
    assert mesh.PRODUCTION_MESHES[False] == ((16, 16), ("data", "model"))
    assert mesh.PRODUCTION_MESHES[True] == ((2, 16, 16),
                                           ("pod", "data", "model"))
    with pytest.raises(ValueError, match="needs 256 processes"):
        mesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 processes"):
        mesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="needs 8 processes"):
        mesh.make_lm_mesh(2, 4, device="cpu")
