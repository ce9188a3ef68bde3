"""The dry run's traced half: ``roofline.CollectiveTally`` against the
reference's byte convention on a fake process group; the three steps of
``chip_smoke.py``'s phase 14 at smoke size (qwen3-14b's decode on (1, 4)
under the decode profile, granite-moe-3b-a800m's expert-parallel prefill
on (1, 4), smollm-135m's training step on (2, 2)) traced on a fake group
against the same steps run in four ``gloo`` processes, by op, bytes and
FLOPs, exactly; and the reference's compiled steps beside the port's
traced ones (GSPMD and the port's Megatron-style regions choose other
collectives, so only their presence is held)."""

import dataclasses
import functools
import json

import numpy as np
import pytest

from repro.roofline import _comm_factor as ref_comm_factor
from repro_torch import roofline
from repro_torch.configs import ShapeConfig
from torch_spawn import reference_output, run_gloo, start_reference

FAMILIES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")

# (arch, step shape, mesh, profile, dtype): phase 14's steps at smoke size,
# the EP prefill in float32 at capacity 8 as phase 13 runs it
STEPS = {
    "decode": ("qwen3-14b", ShapeConfig("decode", 16, 4, "decode"), (1, 4),
               "decode", None),
    "ep_prefill": ("granite-moe-3b-a800m",
                   ShapeConfig("prefill", 16, 4, "prefill"), (1, 4),
                   "default", "float32"),
    "train": ("smollm-135m", ShapeConfig("train", 16, 4, "train"), (2, 2),
              "default", None),
}


def _config(arch, dtype):
    from repro_torch.configs import get_config
    cfg = get_config(arch, smoke=True)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype, capacity_factor=8.0)
    return cfg


def test_comm_factor_is_the_references():
    for op in FAMILIES + ("collective-permute", "broadcast"):
        for g in range(1, 513):
            assert roofline._comm_factor(op, g) == ref_comm_factor(op, g)


def _byte_probe():
    """Collectives of known shapes on a fake group of 8, in its own
    functional and c10d forms, over the whole group and over the (2, 4)
    mesh's sub-groups."""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    world = dist.group.WORLD
    x = torch.zeros(8, 16)                          # 512 bytes
    out = {}
    with roofline.CollectiveTally() as t:
        funcol.all_gather_tensor(x, 0, world).wait()
        funcol.all_reduce(x, "sum", world).wait()
        funcol.reduce_scatter_tensor(x, "sum", 0, world).wait()
        funcol.all_to_all_single(x, None, None, world).wait()
        dist.all_reduce(x)
        dist.all_gather_into_tensor(torch.zeros(64, 16), x)
        dist.all_to_all_single(torch.zeros(8, 16), x)
        dist.reduce_scatter_tensor(torch.zeros(1, 16), x)
    out["world"] = (dict(t.by_op), dict(t.counts))
    with roofline.CollectiveTally() as t:
        funcol.all_gather_tensor(x, 0, mesh.get_group("model")).wait()
    with roofline.CollectiveTally() as u:
        funcol.all_gather_tensor(x, 0, mesh.get_group("data")).wait()
    out["sub"] = (dict(t.by_op), dict(u.by_op))
    return out


def test_tally_counts_bytes_as_the_reference():
    from repro_torch.launch.dryrun import in_fake_group
    [got] = in_fake_group([(_byte_probe, ())], 8)
    by_op, counts = got["world"]
    f = functools.partial(ref_comm_factor, g=8)
    b = 512
    assert counts == {"all-gather": 2, "all-reduce": 2, "reduce-scatter": 2,
                      "all-to-all": 2}
    assert by_op == pytest.approx({
        "all-gather": 2 * 8 * b * f("all-gather"),
        "all-reduce": 2 * b * f("all-reduce"),
        "reduce-scatter": 2 * (b // 8) * f("reduce-scatter"),
        "all-to-all": 2 * b * f("all-to-all")}, rel=0, abs=0)
    model, data = got["sub"]
    assert model == {"all-gather": 4 * b * ref_comm_factor("all-gather", 4)}
    assert data == {"all-gather": 2 * b * ref_comm_factor("all-gather", 2)}


def test_tally_flops_are_flop_counter_modes():
    """On plain tensors (no DTensor) the tally counts what
    ``FlopCounterMode`` counts, backward included."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    g = torch.Generator().manual_seed(0)
    w = torch.randn(32, 64, generator=g, requires_grad=True)
    x = torch.randn(4, 8, 32, generator=g)

    def step():
        y = torch.nn.functional.scaled_dot_product_attention(
            x @ w[:, :32], x @ w[:, 32:], x)
        (y.sum() + torch.bmm(x, x.transpose(1, 2)).sum()).backward()

    with FlopCounterMode(display=False) as fc:
        step()
    with roofline.CollectiveTally() as t:
        step()
    assert t.flops == fc.get_total_flops() > 0
    assert t.bytes_accessed > 0 and t.peak_bytes > 0 and not t.counts


def test_tally_leaves_dtensor_as_it_found_it():
    """The tally quiets DTensor's shape propagation while it is entered,
    and re-enters itself to decompose composite ops (inference mode sends
    einsum whole): its exit restores the propagation it found."""
    import torch
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    orig = ShardingPropagator._propagate_tensor_meta_non_cached
    a = torch.ones(4, 8)
    with torch.inference_mode(), roofline.CollectiveTally() as t:
        for _ in range(3):
            torch.einsum("ij,jk->ik", a, a.T)
        assert ShardingPropagator._propagate_tensor_meta_non_cached \
            is not orig
    assert ShardingPropagator._propagate_tensor_meta_non_cached is orig
    assert t.flops == 3 * 2 * 4 * 8 * 4


# -- traced equals real -----------------------------------------------------------

def _measure(model, shape):
    """The step's tally record and FlopCounterMode's count of the step run
    again (once more under the mode)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import dryrun
    rec = dryrun.measure_step(model, shape)
    with FlopCounterMode(display=False) as fc:
        dryrun.build_step(model, shape)()
    rec["flop_counter"] = fc.get_total_flops()
    return rec


def _trace_job(name, mesh_shape):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import sharding
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models import build_model
    arch, shape, _, profile, dtype = STEPS[name]
    mesh = make_lm_mesh(*mesh_shape, device="cpu")
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = build_model(_config(arch, dtype), device="cpu", seed=None,
                            mesh=mesh, rules=sharding.make_rules(profile))
        return _measure(model, shape)


def _real_worker(rank, world, names):
    from repro_torch import sharding
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models import build_model
    out = {}
    for name in names:
        arch, shape, mesh_shape, profile, dtype = STEPS[name]
        mesh = make_lm_mesh(*mesh_shape, device="cpu")
        model = build_model(_config(arch, dtype), device="cpu", seed=0,
                            mesh=mesh, rules=sharding.make_rules(profile))
        out[name] = _measure(model, shape)
    return out


MESHES = ((1, 4), (2, 2))


def _repeat_job():
    """The decode step traced twice on one model, first in its process:
    DTensor's shape propagation runs in the first only (it caches)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import sharding
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models import build_model
    arch, shape, mesh_shape, profile, dtype = STEPS["decode"]
    mesh = make_lm_mesh(*mesh_shape, device="cpu")
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = build_model(_config(arch, dtype), device="cpu", seed=None,
                            mesh=mesh, rules=sharding.make_rules(profile))
        return [dryrun.measure_step(model, shape) for _ in range(2)]


@functools.lru_cache(maxsize=None)
def _traced() -> dict:
    """Every step on both meshes, traced on one fake group of 4 after the
    repeat job (the reference's subprocess runs meanwhile)."""
    from repro_torch.launch.dryrun import in_fake_group
    _reference_proc()
    keys = ["repeat"] + [(n, m) for n in STEPS for m in MESHES]
    jobs = [(_repeat_job, ())] + [(_trace_job, k) for k in keys[1:]]
    return dict(zip(keys, in_fake_group(jobs, 4)))


def test_a_second_step_tallies_as_the_first():
    first, second = _traced()["repeat"]
    for rec in (first, second):
        rec.pop("trace_s")
    assert first == second and first["temp_bytes_per_dev"] > 0


@functools.lru_cache(maxsize=None)
def _real() -> list:
    return run_gloo(_real_worker, 4, tuple(STEPS))


@pytest.mark.parametrize("name", list(STEPS))
def test_traced_step_equals_the_real_one(name):
    want = _traced()[(name, STEPS[name][2])]
    assert want["collective_per_chip_bytes"] > 0 and want["hlo_flops_raw"] > 0
    assert sum(want["collectives_by_op"].values()) == \
        want["collective_per_chip_bytes"]
    if name == "ep_prefill":
        assert want["collective_counts"]["all-to-all"] > 0
    for rank, got in enumerate(_real()):
        got = got[name]
        for key in ("collectives_by_op", "collective_counts",
                    "collective_per_chip_bytes", "hlo_flops_raw",
                    "flop_counter", "out_bytes_per_dev"):
            assert got[key] == want[key], (rank, key)


# -- beside the reference's compiled steps -----------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_proc():
    """The reference's ``build_step`` of each step on both meshes,
    compiled on four host devices, started in a subprocess: collective
    bytes by op and FLOPs."""
    steps = {n: (a, (s.seq_len, s.global_batch, s.kind), p, d)
             for n, (a, s, _, p, d) in STEPS.items()}
    return start_reference(f"""
        import dataclasses, json
        import jax
        jax.devices()        # the device count is set before dryrun's import
        from repro import sharding
        from repro.compat import make_mesh
        from repro.configs import ShapeConfig, get_config
        from repro.launch.dryrun import build_step
        from repro.models import build_model
        from repro.roofline import parse_collectives
        res = {{}}
        for name, (arch, (S, B, kind), profile, dtype) in {steps!r}.items():
            cfg = get_config(arch, smoke=True)
            if dtype is not None:
                cfg = dataclasses.replace(cfg, dtype=dtype,
                                          capacity_factor=8.0)
            for shape in {MESHES!r}:
                mesh = make_mesh(shape, ("data", "model"))
                fn, ex, _, _ = build_step(build_model(cfg),
                                          ShapeConfig(name, S, B, kind), mesh,
                                          sharding.make_rules(profile))
                compiled = fn.lower(*ex).compile()
                coll = parse_collectives(compiled.as_text(), 4)
                ca = compiled.cost_analysis() or {{}}
                if isinstance(ca, list):
                    ca = ca[0]
                res[f"{{name}}|{{shape[0]}}x{{shape[1]}}"] = {{
                    "by_op": coll["by_op"], "flops": float(ca.get("flops", 0))}}
        print(json.dumps(res))
    """, n_devices=4)


@functools.lru_cache(maxsize=None)
def _reference() -> dict:
    out = reference_output(_reference_proc())
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("shape", MESHES, ids=["1x4", "2x2"])
@pytest.mark.parametrize("name", list(STEPS))
def test_collectives_beside_the_references(name, shape):
    port = _traced()[(name, shape)]
    ref = _reference()[f"{name}|{shape[0]}x{shape[1]}"]
    print(f"{name} on {shape}: reference by op "
          f"{ {k: round(v) for k, v in sorted(ref['by_op'].items())} }, "
          f"FLOPs {ref['flops']:.4g}; port by op "
          f"{port['collectives_by_op']} ({port['collective_counts']}), "
          f"FLOPs {port['hlo_flops_raw']:.4g}")
    # both split the model over 2 or 4 processes, so both communicate
    assert sum(ref["by_op"].values()) > 0 and ref["flops"] > 0
    assert port["collective_per_chip_bytes"] > 0 and \
        port["hlo_flops_raw"] > 0
    assert np.isfinite(port["temp_bytes_per_dev"]) and \
        port["out_bytes_per_dev"] > 0
