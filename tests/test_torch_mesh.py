"""The port's ``(data, cand)`` mining mesh against the JAX package's.

The reference runs the way ``tests/test_multidevice.py`` runs it: in a
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=N``
(8, or 16 for the narrow split), on the same packed inputs, writing its
levels, ``RuntimeStats`` and job outputs to a file.  The port runs here on
the CPU: one process holding every cell of the mesh on its device (the
stand-in for the forced host devices), and two processes joined by
``gloo`` through a file store, with a timeout.  Levels, counts, keep masks
and stats must be equal, bytes included; every answer also equals
``sequential_apriori``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.core import sequential_apriori as ref_sequential_apriori
from repro_torch.core import MapReduceRuntime, ShardedDB, mine
from repro_torch.core import sequential_apriori
from repro_torch.core.bitset import pack_itemsets, unpack_itemsets
from repro_torch.core.phases import bucket_pad
from repro_torch.costmodel import CostController
from repro_torch.costmodel.model import CostModel
from repro_torch.launch.mesh import (MiningMesh, init_distributed,
                                     make_local_mesh, make_mining_mesh)
from repro_torch.roofline import XFER_OPS_PER_BYTE, count_job_ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
FAMILIES = ["jnp", "matmul", "vertical", "vertical_matmul"]
N_ITEMS = 24
NO_STRAGGLERS = 1e9   # spec_factor that never re-dispatches a phase
TIMEOUT = 300         # seconds for each subprocess


def _txns(seed, n, n_items=N_ITEMS, random_widths=False):
    """``test_multidevice.py``'s datasets: patterned baskets, or baskets of
    2–13 random items (the skewed widths of its balance test)."""
    rng = np.random.default_rng(seed)
    if random_widths:
        return [sorted(rng.choice(n_items, rng.integers(2, 14),
                                  replace=False).tolist()) for _ in range(n)]
    base = rng.random((4, n_items)) < 0.4
    out = []
    for _ in range(n):
        pat = base[rng.integers(4)]
        row = np.where(rng.random(n_items) < 0.85, pat,
                       rng.random(n_items) < 0.1)
        out.append(np.nonzero(row)[0].tolist() or [0])
    return out


# name → (transactions, min_sup)
DATASETS = {
    "parity": (_txns(0, 160), 0.3),
    "families": (_txns(11, 160), 0.25),
    "narrow": (_txns(9, 96), 0.3),
    "repartition": (_txns(12, 200), 0.25),
    "retry": (_txns(13, 160), 0.25),
    "balanced": (_txns(6, 200, random_widths=True), 0.2),
}

REFERENCE = r'''
import json, sys
import numpy as np
import jax
from repro.compat import make_mesh
from repro.core import mine
from repro.core.mapreduce import MapReduceRuntime
from repro.core.phases import bucket_pad
from repro.costmodel import CostController
from repro.costmodel.model import CostModel
from repro.launch.mesh import make_mining_mesh

inputs, out, n_dev = sys.argv[1], sys.argv[2], int(sys.argv[3])
assert len(jax.devices()) == n_dev
data = np.load(inputs)
arrays, meta = {}, {}
N_ITEMS = 24


def db(name):
    return data[name], float(data[name + ".min_sup"])


def keep(case, res):
    for k, (m, c) in res.levels.items():
        arrays[f"{case}|{k}|masks"] = m
        arrays[f"{case}|{k}|counts"] = c


def ctl():
    return CostController(model=CostModel(persist=False))


def mesh(split):
    return make_mesh(split, ("data", "cand"))


if n_dev == 16:
    masks, sup = db("narrow")
    for impl in ["jnp", "matmul", "vertical", "vertical_matmul"]:
        rt = MapReduceRuntime(mesh=mesh((1, 16)), impl=impl,
                              cand_axis="cand", autotune=False)
        keep(f"narrow/{impl}", mine(db_masks=masks, n_items=N_ITEMS,
                                     min_sup=sup, algorithm="optimized_vfpc",
                                     runtime=rt))
else:
    masks, sup = db("parity")
    for algo in ["spc", "optimized_vfpc"]:
        keep(f"parity/{algo}", mine(db_masks=masks, n_items=N_ITEMS,
                                    min_sup=sup, algorithm=algo))
    masks, sup = db("families")
    for split in [(4, 2), (2, 4)]:
        for impl in ["jnp", "matmul", "vertical", "vertical_matmul"]:
            rt = MapReduceRuntime(mesh=mesh(split), impl=impl,
                                  cand_axis="cand")
            keep(f"families/{split[0]}x{split[1]}/{impl}",
                 mine(db_masks=masks, n_items=N_ITEMS, min_sup=sup,
                      algorithm="optimized_etdpc", runtime=rt,
                      elastic=False))
    masks, sup = db("repartition")
    for impl in ["jnp", "vertical"]:
        rt = MapReduceRuntime(mesh=make_mining_mesh(8, 1), impl=impl)
        c = ctl()
        script = iter([(2, 4), (4, 2)])
        c.choose_mesh = lambda *a, **k: next(script, None)
        res = mine(db_masks=masks, n_items=N_ITEMS, min_sup=sup,
                   algorithm="optimized_etdpc", runtime=rt, controller=c,
                   elastic=True)
        keep(f"repartition/{impl}", res)
        meta[f"repartition/{impl}"] = [res.repartitions, list(rt.mesh_split)]
    masks, sup = db("retry")
    calls = {"n": 0}

    def fail_twice(event, k):
        if event == "count_dispatch":
            calls["n"] += 1
            if calls["n"] in (2, 3):
                raise RuntimeError("injected shard failure")
    rt = MapReduceRuntime(mesh=make_mining_mesh(4, 2), impl="jnp",
                          cand_axis="cand")
    res = mine(db_masks=masks, n_items=N_ITEMS, min_sup=sup,
               algorithm="optimized_etdpc", runtime=rt, elastic=False,
               count_hook=fail_twice)
    keep("retry", res)
    meta["retry"] = res.retries
    masks, sup = db("balanced")
    keep("balanced", mine(db_masks=masks, n_items=N_ITEMS, min_sup=sup,
                          algorithm="vfpc", balance_shards_by_width=True))
    # RuntimeStats and job outputs on fixed splits: deterministic jobs
    masks, sup = db("parity")
    cands = np.asarray(data["cands"])
    n_valid = int(data["cands.n_valid"])
    for split, cand in [((8, 1), False), ((4, 2), True), ((2, 4), True)]:
        for impl in ["jnp", "vertical"]:
            case = f"stats/{split[0]}x{split[1]}/{impl}"
            rt = MapReduceRuntime(mesh=mesh(split), impl=impl,
                                  cand_axis="cand" if cand else None,
                                  autotune=False)
            res = mine(db_masks=masks, n_items=N_ITEMS, min_sup=sup,
                       algorithm="optimized_vfpc", runtime=rt,
                       controller=ctl(), elastic=False,
                       balance_shards_by_width=False,
                       spec_factor=1e9)
            keep(case, res)
            db_sh = rt.scatter_db(masks, n_items=N_ITEMS)
            arrays[case + "|plain"] = rt.phase_count(db_sh, cands)
            for with_counts in (True, False):
                k, c = rt.phase_count_filtered(db_sh, cands, 20.0,
                                               with_counts=with_counts,
                                               n_valid=n_valid)
                arrays[f"{case}|keep{with_counts}"] = k
                if c is not None:
                    arrays[f"{case}|counts{with_counts}"] = c
            meta[case] = {f: getattr(rt.stats, f) for f in (
                "dispatches", "compiles", "rows_counted", "fused_dispatches",
                "bytes_to_host", "repartitions")}
    # the mine CLI under 8 forced devices
    from repro.launch import mine as cli
    sys.argv = ["repro.launch.mine"] + json.loads(data["cli.argv"].tobytes())
    cli.main()
np.savez(out, **arrays)
with open(out + ".json", "w") as f:
    json.dump(meta, f)
'''

CLI_ARGS = ["--dataset", "mushroom", "--scale", "0.05", "--min-sup", "0.35",
            "--impl", "vertical", "--n-data-shards", "4", "--n-cand-shards",
            "2", "--no-elastic"]


def _run_reference(tmp, inputs, n_dev):
    out = str(tmp / f"reference{n_dev}.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n_dev}",
               REPRO_AUTOTUNE="0",
               REPRO_COSTMODEL_CACHE=str(tmp / "ref_costmodel.json"))
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE, inputs, out, str(n_dev)],
        capture_output=True, text=True, timeout=TIMEOUT, env=env,
        cwd=str(tmp))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(out + ".json") as f:
        meta = json.load(f)
    return dict(np.load(out)), meta, proc.stdout


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's results on 8 and 16 forced host devices."""
    tmp = tmp_path_factory.mktemp("mesh_reference")
    inputs = {}
    for name, (txns, sup) in DATASETS.items():
        inputs[name] = pack_itemsets(txns, N_ITEMS)
        inputs[name + ".min_sup"] = np.float64(sup)
    cands = bucket_pad(_stats_cands())
    inputs["cands"] = cands
    inputs["cands.n_valid"] = np.int64(_stats_cands().shape[0])
    inputs["cli.argv"] = np.frombuffer(json.dumps(
        CLI_ARGS + ["--json-out", str(tmp / "reference_cli.json")]).encode(),
        np.uint8)
    path = str(tmp / "inputs.npz")
    np.savez(path, **inputs)
    arrays, meta, stdout = _run_reference(tmp, path, 8)
    arrays16, _, _ = _run_reference(tmp, path, 16)
    arrays.update(arrays16)
    with open(tmp / "reference_cli.json") as f:
        cli_json = json.load(f)
    return {"arrays": arrays, "meta": meta, "cli_stdout": stdout,
            "cli_json": cli_json}


def _stats_cands():
    """Every 1-, 2- and 3-itemset over the first 9 items and some of the
    rest: 211 rows, padded to a 256-row bucket, with empty pad rows."""
    sets = [[i] for i in range(N_ITEMS)]
    sets += [[a, b] for a in range(9) for b in range(a + 1, 9)]
    sets += [[a, b, c] for a in range(9) for b in range(a + 1, 9)
             for c in range(b + 1, 9) if (a + b + c) % 2 == 0]
    sets += [[1, 3, 5, 7], [0, 2, 4, 6, 8]]
    return pack_itemsets(sets, N_ITEMS)


def _levels_of(arrays, case):
    out = {}
    for key, val in arrays.items():
        name, _, rest = key.partition("|")
        k, _, kind = rest.partition("|")
        if name == case and kind in ("masks", "counts"):
            out.setdefault(int(k), {})[kind] = val
    return {k: (v["masks"], v["counts"]) for k, v in out.items()}


def _assert_levels(res, arrays, case, oracle):
    want = _levels_of(arrays, case)
    assert want, case
    assert res.levels.keys() == want.keys(), case
    for k, (masks, counts) in want.items():
        got_m, got_c = res.levels[k]
        assert got_m.dtype == masks.dtype and got_c.dtype == counts.dtype
        assert got_m.tobytes() == masks.tobytes(), (case, k)
        assert got_c.tobytes() == counts.tobytes(), (case, k)
    assert res.itemsets() == oracle, case


def _mesh(split, cells=8):
    return make_mining_mesh(*split, cells_per_process=cells, device="cpu")


def _mine(name, runtime, **kw):
    txns, sup = DATASETS[name]
    return mine(db_masks=pack_itemsets(txns, N_ITEMS), n_items=N_ITEMS,
                min_sup=sup, runtime=runtime, **kw)


def _oracle(name):
    txns, sup = DATASETS[name]
    oracle = sequential_apriori(txns, sup)
    assert oracle == ref_sequential_apriori(txns, sup)
    return oracle


# -- levels on 8 and 16 cells ------------------------------------------------

@pytest.mark.parametrize("algo", ["spc", "optimized_vfpc"])
def test_parity_on_8_cells(reference, algo):
    rt = MapReduceRuntime(mesh=make_mining_mesh(cells_per_process=8,
                                                device="cpu"))
    assert rt.mesh_split == (8, 1) and len(rt.mesh.cells) == 8
    res = _mine("parity", rt, algorithm=algo)
    _assert_levels(res, reference["arrays"], f"parity/{algo}",
                   _oracle("parity"))


@pytest.mark.parametrize("impl", FAMILIES)
@pytest.mark.parametrize("split", [(4, 2), (2, 4)])
def test_2d_mesh_families(reference, split, impl):
    rt = MapReduceRuntime(mesh=_mesh(split), impl=impl, cand_axis="cand")
    res = _mine("families", rt, algorithm="optimized_etdpc", elastic=False)
    assert rt.mesh_split == split and res.repartitions == 0
    _assert_levels(res, reference["arrays"],
                   f"families/{split[0]}x{split[1]}/{impl}",
                   _oracle("families"))


@pytest.mark.parametrize("impl", FAMILIES)
def test_narrow_candidate_shards(reference, impl):
    """(1, 16): 256 bucket rows are padded to 512 = 32·16, so every shard's
    packed keep mask ends on a word boundary, and the empty padding rows —
    which pass the filter, a zero mask being a subset of every transaction
    — are masked by their global row offset."""
    rt = MapReduceRuntime(mesh=_mesh((1, 16), cells=16), impl=impl,
                          cand_axis="cand", autotune=False)
    res = _mine("narrow", rt, algorithm="optimized_vfpc")
    _assert_levels(res, reference["arrays"], f"narrow/{impl}",
                   _oracle("narrow"))


# -- elastic repartitioning, retries, balance --------------------------------

@pytest.mark.parametrize("impl", ["jnp", "vertical"])
def test_scripted_repartition(reference, impl):
    rt = MapReduceRuntime(mesh=_mesh((8, 1)), impl=impl)
    ctl = CostController(model=CostModel(persist=False), device="cpu")
    script = iter([(2, 4), (4, 2)])
    ctl.choose_mesh = lambda *a, **k: next(script, None)
    res = _mine("repartition", rt, algorithm="optimized_etdpc",
                controller=ctl, elastic=True)
    assert [res.repartitions, list(rt.mesh_split)] == \
        reference["meta"][f"repartition/{impl}"] == [2, [4, 2]]
    assert rt.cand_axis == "cand" and rt.stats.repartitions == 2
    _assert_levels(res, reference["arrays"], f"repartition/{impl}",
                   _oracle("repartition"))


def _fail_on(calls, failures):
    def hook(event, k):
        if event == "count_dispatch":
            calls["n"] += 1
            if calls["n"] in failures:
                raise RuntimeError("injected shard failure")
    return hook


def test_retry_after_two_injected_failures(reference):
    calls = {"n": 0}
    rt = MapReduceRuntime(mesh=_mesh((4, 2)), impl="jnp", cand_axis="cand")
    res = _mine("retry", rt, algorithm="optimized_etdpc", elastic=False,
                count_hook=_fail_on(calls, (2, 3)))
    assert res.retries == reference["meta"]["retry"] == 2
    _assert_levels(res, reference["arrays"], "retry", _oracle("retry"))


def test_failure_propagates_past_max_retries():
    rt = MapReduceRuntime(mesh=_mesh((4, 2)), impl="jnp", cand_axis="cand")

    def always_fail(event, k):
        if event == "count_dispatch":
            raise RuntimeError("dead shard")
    with pytest.raises(RuntimeError, match="dead shard"):
        _mine("retry", rt, elastic=False, count_hook=always_fail,
              max_retries=1)


def test_balanced_shards(reference):
    rt = MapReduceRuntime(mesh=_mesh((8, 1)))
    txns, _ = DATASETS["balanced"]
    res = _mine("balanced", rt, algorithm="vfpc",
                balance_shards_by_width=True)
    # the runtime holds the LPT-reordered rows, not the input's order
    assert not np.array_equal(rt._db_masks, pack_itemsets(txns, N_ITEMS))
    _assert_levels(res, reference["arrays"], "balanced", _oracle("balanced"))


# -- RuntimeStats and job outputs --------------------------------------------

STATS_FIELDS = ("dispatches", "compiles", "rows_counted", "fused_dispatches",
                "bytes_to_host", "repartitions")


@pytest.mark.parametrize("impl", ["jnp", "vertical"])
@pytest.mark.parametrize("split,cand", [((8, 1), False), ((4, 2), True),
                                        ((2, 4), True)])
def test_runtime_stats_and_job_outputs_equal_reference(reference, split, cand,
                                                       impl):
    """Same jobs, rows, bytes home and distinct job shapes as the
    reference's mesh on the same split; ``phase_count`` and
    ``phase_count_filtered`` return the same arrays."""
    case = f"stats/{split[0]}x{split[1]}/{impl}"
    arrays = reference["arrays"]
    rt = MapReduceRuntime(mesh=_mesh(split), impl=impl,
                          cand_axis="cand" if cand else None, autotune=False)
    res = _mine("parity", rt, algorithm="optimized_vfpc",
                controller=CostController(model=CostModel(persist=False),
                                          device="cpu"),
                elastic=False, balance_shards_by_width=False,
                spec_factor=NO_STRAGGLERS)
    _assert_levels(res, arrays, case, _oracle("parity"))
    db = rt.scatter_db(pack_itemsets(DATASETS["parity"][0], N_ITEMS),
                       n_items=N_ITEMS)
    assert isinstance(db, ShardedDB)
    assert sorted(db.shards) == list(range(split[0]))
    cands = bucket_pad(_stats_cands())
    n_valid = _stats_cands().shape[0]
    plain = rt.phase_count(db, cands)
    assert plain.dtype == arrays[case + "|plain"].dtype
    np.testing.assert_array_equal(plain, arrays[case + "|plain"])
    for with_counts in (True, False):
        keep, counts = rt.phase_count_filtered(db, cands, 20.0,
                                               with_counts=with_counts,
                                               n_valid=n_valid)
        np.testing.assert_array_equal(keep, arrays[f"{case}|keep{with_counts}"])
        if with_counts:
            np.testing.assert_array_equal(counts,
                                          arrays[f"{case}|countsTrue"])
        else:
            assert counts is None
    assert {f: getattr(rt.stats, f) for f in STATS_FIELDS} == \
        reference["meta"][case]


# -- the command line ---------------------------------------------------------

def test_cli_matches_reference_cli(reference, tmp_path, capsys):
    from repro_torch.launch import mine as port_cli
    out = str(tmp_path / "port.json")
    port_cli.main(CLI_ARGS + ["--cells-per-process", "8", "--device", "cpu",
                              "--json-out", out])
    stdout = capsys.readouterr().out
    with open(out) as f:
        got = json.load(f)
    want = reference["cli_json"]
    assert got["levels"] == want["levels"]
    assert got["dispatches"] == want["dispatches"]
    mesh_line = [ln for ln in stdout.splitlines() if ln.startswith("mesh=")]
    ref_line = [ln for ln in reference["cli_stdout"].splitlines()
                if ln.startswith("mesh=")]
    assert mesh_line == ref_line == [
        "mesh=4x2 (data x cand) impl=vertical repartitions=0 retries=0"]


# -- meshes -------------------------------------------------------------------

def test_mesh_cells_and_checks():
    mesh = make_mining_mesh(cells_per_process=8, n_cand=2, device="cpu")
    assert (mesh.n_data, mesh.n_cand, mesh.size) == (4, 2, 8)
    assert mesh.shape == {"data": 4, "cand": 2}
    assert mesh.cells[:3] == ((0, 0), (0, 1), (1, 0))   # data-major
    # process 1 of 2 holds the second contiguous block
    two = MiningMesh(4, 2, mesh.device, rank=1, world=2)
    assert two.cells == ((2, 0), (2, 1), (3, 0), (3, 1))
    assert two.reshaped(1, 8).cells == tuple((0, c) for c in range(4, 8))
    assert make_local_mesh(device="cpu").shape == {"data": 1, "cand": 1}
    with pytest.raises(ValueError, match="mesh split 3x2 != 8 devices"):
        make_mining_mesh(3, 2, cells_per_process=8, device="cpu")
    with pytest.raises(ValueError, match="3 candidate shards do not divide"):
        make_mining_mesh(None, 3, cells_per_process=8, device="cpu")
    with pytest.raises(ValueError, match="n_cand must be >= 1"):
        make_mining_mesh(8, 0, cells_per_process=8, device="cpu")
    with pytest.raises(ValueError, match="split 3x3 != 8 devices"):
        mesh.reshaped(3, 3)
    with pytest.raises(ValueError, match="cand_axis 'model' not in"):
        MapReduceRuntime(mesh=mesh, cand_axis="model")
    rt = MapReduceRuntime(mesh=mesh, impl="jnp", cand_axis="cand")
    assert not rt.can_repartition
    with pytest.raises(RuntimeError, match="scatter_db"):
        rt.repartition(8, 1)
    # no coordinator and no torchrun environment: single process
    assert init_distributed(num_processes=4) is False


def test_cells_on_two_cuda_devices_raise(monkeypatch):
    """One process drives one card: a mesh takes one device, and a card
    other than the process's current one is refused before anything
    launches (the process's kernels keep that card's limits)."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="one process drives one card"):
        make_mining_mesh(2, 1, cells_per_process=2, device="cuda:1")
    with pytest.raises(ValueError, match="one process drives one card"):
        make_local_mesh(device="cuda:1")
    mesh = make_mining_mesh(2, 1, cells_per_process=2, device="cuda:0")
    assert mesh.device == torch.device("cuda:0") and mesh.size == 2
    assert make_mining_mesh(1, 2, cells_per_process=2,
                            device="cuda").device == torch.device("cuda")


def test_mine_prices_a_device_by_its_cells():
    """The cells of one device count one after another: a one-process
    8-cell mine observes each job at the ops of all 8 cells — the one-cell
    ops of the whole database, plus the reduce's traffic — not at one
    cell's."""
    txns, sup = DATASETS["parity"]
    db = pack_itemsets(txns, N_ITEMS)
    n_txns, n_words = db.shape
    eight = CostController(CostModel(persist=False), device="cpu")
    seen = []
    observe = eight.observe_count

    def record(n, seconds, bytes_to_host=None):
        seen.append((n, bytes_to_host, eight._count_ops(n, bytes_to_host)))
        observe(n, seconds, bytes_to_host)
    eight.observe_count = record
    mine(db_masks=db, n_items=N_ITEMS, min_sup=sup, elastic=False,
         runtime=MapReduceRuntime(mesh=_mesh((8, 1)), impl="jnp"),
         controller=eight)
    one = CostController(CostModel(persist=False), device="cpu")
    one.set_count_context(n_txns=n_txns, n_words=n_words, impl="jnp")
    assert seen and n_txns % 8 == 0
    for n, b, ops in seen:
        psum = XFER_OPS_PER_BYTE * 2.0 * 7 / 8 * 4.125 * n
        assert ops == pytest.approx(one._count_ops(n, b) + psum, rel=1e-12)


@pytest.mark.parametrize("layout", [(8, 1, 8), (2, 4, 8), (4, 2, 4)])
def test_cell_layouts_share_one_fit(layout):
    """A card's times for jobs on ``cells`` cells of an ``(n_data, n_cand)``
    split, fed to the fit a one-cell controller shares, leave its
    predictions where they were (c20d200k's extents)."""
    n_data, n_cand, cells = layout
    model = CostModel(persist=False)
    one = CostController(model, device="cpu")
    many = CostController(model, device="cpu")
    one.set_count_context(n_txns=200_000, n_words=6, impl="jnp")
    many.set_count_context(n_txns=200_000, n_words=6, impl="jnp",
                           n_data_shards=n_data, n_cand_shards=n_cand,
                           cells_per_device=cells)
    jobs = (192, 1891, 37820, 700, 4000)

    def seconds(n, share=1.0):
        # the card's time for its ``share`` of the candidate-transaction
        # work: its cells' shards, counted in turn
        return 2e-4 + 1e-12 * share * count_job_ops(n, 200_000, 6)
    for n in jobs:
        one.observe_count(n, seconds(n))
    before = one.predict_count(10_000)
    for n in jobs:
        many.observe_count(n, seconds(n, cells / (n_data * n_cand)))
    assert one.predict_count(10_000) == pytest.approx(before, rel=0.02)


def test_cli_passes_the_collective_timeout(monkeypatch):
    """``--dist-timeout`` bounds every collective of a multi-process run;
    unset, torch.distributed's own default stands."""
    import argparse

    from repro_torch.launch import cliopts, mesh as mesh_mod
    seen = []
    monkeypatch.setattr(mesh_mod, "init_distributed",
                        lambda *a, **k: seen.append(k["timeout"]) or False)
    for argv, want in [(["--dist-timeout", "45"], 45.0), ([], None)]:
        ap = argparse.ArgumentParser()
        cliopts.add_mesh_args(ap)
        args = ap.parse_args(argv + ["--cells-per-process", "2"])
        args.device = "cpu"
        runtime, _ = cliopts.runtime_from_args(args, impl="jnp")
        assert runtime.mesh.size == 2 and seen[-1] == want


def test_replica_cells_count_nothing():
    """Without ``cand_axis`` the cand axis replicates candidates, as in the
    paper: cells of cand index > 0 hold no shard and the counts are the
    one-cell counts."""
    txns, sup = DATASETS["parity"]
    rt = MapReduceRuntime(mesh=_mesh((4, 2)), impl="jnp")
    assert rt.mesh_split == (4, 1)
    db = rt.scatter_db(pack_itemsets(txns, N_ITEMS), n_items=N_ITEMS)
    assert sorted(db.shards) == [0, 1, 2, 3]
    one = MapReduceRuntime(impl="jnp", device="cpu")
    cands = bucket_pad(_stats_cands())
    want = one.phase_count(one.scatter_db(pack_itemsets(txns, N_ITEMS),
                                          n_items=N_ITEMS), cands)
    np.testing.assert_array_equal(rt.phase_count(db, cands), want)


# -- two processes through gloo ------------------------------------------------

WORKER = r'''
import json, sys
import numpy as np
from repro_torch.core import MapReduceRuntime, mine
from repro_torch.launch.mesh import (init_distributed, make_mining_mesh,
                                     shutdown_distributed)

store, rank, inputs, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
init_distributed(store, 2, rank, device="cpu", timeout=60)
data = np.load(inputs)
db, sup = data["db"], float(data["min_sup"])
arrays, meta = {}, {}


def run(case, split, impl, patch=None, **kw):
    rt = MapReduceRuntime(mesh=make_mining_mesh(*split, cells_per_process=2,
                                                device="cpu"),
                          impl=impl, cand_axis="cand" if split[1] > 1 else None)
    if patch is not None:
        patch(rt)
    cells = [list(c) for c in rt.mesh.cells]
    res = mine(db_masks=db, n_items=24, min_sup=sup, runtime=rt, **kw)
    for k, (m, c) in res.levels.items():
        arrays[f"{case}|{k}|masks"] = m
        arrays[f"{case}|{k}|counts"] = c
    meta[case] = {"algorithm": kw["algorithm"], "impl": impl,
                  "retries": res.retries, "repartitions": res.repartitions,
                  "dispatches": res.dispatches, "split": list(rt.mesh_split),
                  "cells": cells}


for impl in ["jnp", "vertical"]:
    run(f"2x2/{impl}", (2, 2), impl, algorithm="optimized_vfpc")
    run(f"4x1/{impl}", (4, 1), impl, algorithm="optimized_vfpc")
# timing-priced widths and straggler checks, agreed from process 0
run("etdpc", (2, 2), "matmul", algorithm="optimized_etdpc")
run("balanced", (4, 1), "vertical_matmul", algorithm="vfpc",
    balance_shards_by_width=True)
# a failure on process 1 alone is retried on both
calls = {"n": 0}


def fail_here(event, k):
    if event == "count_dispatch" and rank == 1:
        calls["n"] += 1
        if calls["n"] in (2, 3):
            raise RuntimeError("injected shard failure")


run("retry", (2, 2), "jnp", algorithm="optimized_vfpc", count_hook=fail_here)


def flaky_cell(rt):
    # a cell of process 1 raises inside its second job: that process still
    # joins the reduce, with the failure flag set, so process 0 fails the
    # same job from the flag and both retry it
    count, seen = rt._count, {"n": 0}

    def count_or_fail(db, payload):
        seen["n"] += 1
        if rank == 1 and seen["n"] == 3:
            raise RuntimeError("injected cell failure")
        return count(db, payload)
    rt._count = count_or_fail


run("cell_failure", (4, 1), "vertical", patch=flaky_cell,
    algorithm="optimized_vfpc", elastic=False)


def flaky_pack(rt):
    # process 1 raises while it builds the payload of its second job, before
    # any cell counts: it joins the reduce all the same, with the flag set
    pack, seen = rt._padded_indices, {"n": 0}

    def pack_or_fail(masks):
        seen["n"] += 1
        if rank == 1 and seen["n"] == 2:
            raise RuntimeError("injected payload failure")
        return pack(masks)
    rt._padded_indices = pack_or_fail


run("payload_failure", (2, 2), "vertical", patch=flaky_pack,
    algorithm="optimized_vfpc", elastic=False)
# process 1 raises in the upload of the first phase's payload
import repro_torch.core.mapreduce as mapreduce
upload, armed = mapreduce.to_device_words, {"now": False, "done": False}


def upload_or_fail(arr, device):
    if armed["now"]:
        armed["now"] = False
        raise RuntimeError("injected upload failure")
    return upload(arr, device)


def arm_upload(event, k):
    if event == "phase_start" and rank == 1 and not armed["done"]:
        armed["now"] = armed["done"] = True


mapreduce.to_device_words = upload_or_fail
run("upload_failure", (4, 1), "jnp", algorithm="optimized_vfpc",
    elastic=False, count_hook=arm_upload)
mapreduce.to_device_words = upload
shutdown_distributed()
np.savez(out, **arrays)
with open(out + ".json", "w") as f:
    json.dump(meta, f)
'''


def test_two_processes_through_gloo(tmp_path):
    txns, sup = DATASETS["families"]
    db = pack_itemsets(txns, N_ITEMS)
    inputs = str(tmp_path / "inputs.npz")
    np.savez(inputs, db=db, min_sup=np.float64(sup))
    store = f"file://{tmp_path / 'store'}"
    env = dict(os.environ, PYTHONPATH=SRC,
               REPRO_TORCH_COSTMODEL_CACHE=str(tmp_path / "cm.json"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, store, str(rank), inputs,
         str(tmp_path / f"rank{rank}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in (0, 1)]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    assert "backend gloo (the default for cpu)" in outs[0]
    oracle = sequential_apriori(txns, sup)
    metas = []
    for rank in (0, 1):
        arrays = dict(np.load(tmp_path / f"rank{rank}.npz"))
        with open(tmp_path / f"rank{rank}.npz.json") as f:
            metas.append(json.load(f))
        for case, meta in metas[-1].items():
            # one process, one cell, the same algorithm and family
            one = mine(db_masks=db, n_items=N_ITEMS, min_sup=sup,
                       algorithm=meta["algorithm"],
                       runtime=MapReduceRuntime(impl=meta["impl"],
                                                device="cpu"))
            got = _levels_of(arrays, case)
            assert got.keys() == one.levels.keys(), case
            for k, (masks, counts) in one.levels.items():
                assert got[k][0].tobytes() == masks.tobytes(), (case, k)
                assert got[k][1].tobytes() == counts.tobytes(), (case, k)
            levels = {k: dict(zip(unpack_itemsets(m), (int(c) for c in cs)))
                      for k, (m, cs) in got.items()}
            assert levels == oracle, case
    for case in metas[0]:
        a, b = metas[0][case], metas[1][case]
        assert a["dispatches"] == b["dispatches"], case
        assert a["retries"] == b["retries"], case
        # the elastic split is process 0's choice on both
        assert a["split"] == b["split"], case
    assert metas[0]["retry"]["retries"] == 2
    for case in ("cell_failure", "payload_failure", "upload_failure"):
        assert metas[0][case]["retries"] == 1, case
    assert metas[0]["2x2/jnp"]["cells"] == [[0, 0], [0, 1]]
    assert metas[1]["2x2/jnp"]["cells"] == [[1, 0], [1, 1]]
    assert metas[1]["4x1/jnp"]["cells"] == [[2, 0], [3, 0]]
