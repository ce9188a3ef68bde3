"""The port's LM ``ServeEngine`` against the JAX package's, on the CPU.

Both engines serve the same numpy prompts with the same float32 smoke
weights (qwen3-14b with its GQA group padded from 5 to 6 heads, the
reference's parameters carried into the port).  Greedy tokens must be
equal for every algorithm, and the width-driven policies must schedule the
same phases.  The ``tests/test_serving.py`` checks then run on the port
alone, and the cost controller's ``kind`` is held against the reference's.
The reference engines are built once per module, so each compiles its
phases once.
"""

import dataclasses
import re
import sys

import jax
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.costmodel import CostController as RefController
from repro.costmodel.model import CostModel as RefCostModel
from repro.models import build_model as ref_build_model
from repro.serving import ServeEngine as RefServeEngine
from repro_torch import configs
from repro_torch.core.policy import ALGORITHMS
from repro_torch.costmodel import CostController, CostModel
from repro_torch.launch import serve as port_cli
from repro_torch.models import build_model, load_reference_params
from repro_torch.serving import ServeEngine, ServePhaseRecord

ALGOS = sorted(ALGORITHMS)
WIDTH_DRIVEN = ["fpc", "optimized_vfpc", "spc", "vfpc"]
CACHE_LEN, MAX_NEW = 32, 16
LENS = np.array([8, 5, 8, 3], np.int32)


def _port_controller():
    return CostController(CostModel(persist=False), device="cpu")


def _ref_controller():
    return RefController(RefCostModel(persist=False), backend="cpu")


@pytest.fixture(scope="module")
def carried():
    """float32 qwen3-14b smoke weights (padded heads) in both packages, and
    ragged right-padded prompts."""
    kw = dict(dtype="float32", q_head_pad_group=6)
    rcfg = dataclasses.replace(ref_configs.get_config("qwen3-14b", smoke=True),
                               **kw)
    ref = ref_build_model(rcfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = build_model(dataclasses.replace(
        configs.get_config("qwen3-14b", smoke=True), **kw),
        device="cpu", seed=None)
    load_reference_params(port, jax.tree.map(np.asarray, params))
    prompts = np.random.default_rng(0).integers(
        1, rcfg.vocab_size, (4, 8)).astype(np.int32)
    for i, n in enumerate(LENS):
        prompts[i, n:] = 0
    return ref, params, port, prompts


@pytest.fixture(scope="module")
def reference_runs(carried):
    """algorithm → (tokens, npass sequence) of the reference engine, each
    engine built and compiled once for the module."""
    ref, params, _, prompts = carried
    runs = {}

    def get(algo, eos_id=-1):
        if (algo, eos_id) not in runs:
            eng = RefServeEngine(
                ref, params, cache_len=CACHE_LEN, algorithm=algo,
                controller=_ref_controller() if algo == "measured" else None)
            out, recs = eng.generate(prompts, prompt_lens=LENS,
                                     max_new_tokens=MAX_NEW, eos_id=eos_id)
            runs[algo, eos_id] = (out, [r.npass for r in recs])
        return runs[algo, eos_id]
    return get


def _port_run(port, prompts, algo, eos_id=-1, **kw):
    eng = ServeEngine(port, cache_len=CACHE_LEN, algorithm=algo,
                      controller=_port_controller() if algo == "measured"
                      else None, **kw)
    out, recs = eng.generate(prompts, prompt_lens=LENS,
                             max_new_tokens=MAX_NEW, eos_id=eos_id)
    return out, recs


# -- against the reference -------------------------------------------------------


@pytest.mark.parametrize("algo", ALGOS)
def test_tokens_equal_reference_engine(carried, reference_runs, algo):
    _, _, port, prompts = carried
    want, _ = reference_runs(algo)
    got, recs = _port_run(port, prompts, algo)
    assert got.dtype == np.int32 and got.shape == (4, MAX_NEW)
    np.testing.assert_array_equal(got, want)
    assert all(isinstance(r, ServePhaseRecord) for r in recs)
    assert sum(r.npass for r in recs) == MAX_NEW - 1


@pytest.mark.parametrize("algo", WIDTH_DRIVEN)
def test_width_policies_schedule_the_reference_phases(carried,
                                                      reference_runs, algo):
    _, _, port, prompts = carried
    _, want = reference_runs(algo)
    _, recs = _port_run(port, prompts, algo)
    assert [r.npass for r in recs] == want


@pytest.mark.parametrize("algo", ["fpc", "optimized_vfpc"])
def test_eos_outputs_equal_reference_engine(carried, reference_runs, algo):
    """With an EOS that row 0 emits at step 3, the pruned and the optimized
    engine both give the reference's trimmed tokens."""
    _, _, port, prompts = carried
    eos_id = int(reference_runs("spc")[0][0, 3])
    want, _ = reference_runs(algo, eos_id)
    got, _ = _port_run(port, prompts, algo, eos_id=eos_id)
    np.testing.assert_array_equal(got, want)


# -- the reference's serving tests, on the port ----------------------------------


@pytest.fixture(scope="module")
def served():
    """``tests/test_serving.py``'s fixture: smollm-135m smoke, bf16, random
    weights, a (4, 8) prompt batch."""
    model = build_model("smollm-135m", smoke=True, device="cpu", seed=0)
    prompts = np.random.default_rng(0).integers(
        1, model.cfg.vocab_size, (4, 8)).astype(np.int32)
    return model, prompts


def _engine(model, algo, **kw):
    if algo == "measured":
        kw.setdefault("controller", _port_controller())
    return ServeEngine(model, cache_len=64, algorithm=algo, **kw)


@pytest.mark.parametrize("algo", ALGOS)
def test_all_policies_same_output(served, algo):
    model, prompts = served
    base, _ = _engine(model, "spc").generate(prompts, max_new_tokens=20,
                                             eos_id=-1)
    out, _ = _engine(model, algo).generate(prompts, max_new_tokens=20,
                                           eos_id=-1)
    np.testing.assert_array_equal(out, base)


def test_fused_policies_fewer_dispatches(served):
    model, prompts = served
    counts = {}
    for algo in ["spc", "fpc", "optimized_vfpc"]:
        _, recs = _engine(model, algo).generate(prompts, max_new_tokens=20,
                                                eos_id=-1)
        counts[algo] = len(recs)
    assert counts["fpc"] < counts["spc"]
    assert counts["optimized_vfpc"] < counts["spc"]


def test_eos_trimming_and_waste(served):
    """Optimized engines emit tokens past EOS ('un-pruned candidates') but the
    phase-end filter trims them — outputs identical to the pruned engine."""
    model, prompts = served
    ref, _ = _engine(model, "spc").generate(prompts, max_new_tokens=16,
                                            eos_id=-1)
    eos_id = int(ref[0, 3])  # forces row 0 to finish at step 3
    out_p, _ = _engine(model, "fpc").generate(prompts, max_new_tokens=16,
                                              eos_id=eos_id)
    out_o, recs_o = _engine(model, "optimized_vfpc").generate(
        prompts, max_new_tokens=16, eos_id=eos_id)
    np.testing.assert_array_equal(out_p, out_o)
    row0 = out_o[0]
    stop = np.argmax(row0 == eos_id)
    assert (row0[stop + 1:] == 0).all()
    assert sum(r.wasted_tokens for r in recs_o) > 0


def test_pipelined_dispatch_equivalence(served):
    """Depth-2 pipelined dispatch (EOS check lags one phase) is output-exact;
    it may only waste MORE post-EOS tokens, never change results."""
    model, prompts = served
    ref, _ = _engine(model, "spc").generate(prompts, max_new_tokens=16,
                                            eos_id=-1)
    eos_id = int(ref[0, 3])
    out_p, recs_p = _engine(model, "optimized_vfpc").generate(
        prompts, max_new_tokens=16, eos_id=eos_id)
    out_q, recs_q = _engine(model, "optimized_vfpc",
                            pipeline_depth=2).generate(
        prompts, max_new_tokens=16, eos_id=eos_id)
    np.testing.assert_array_equal(out_p, out_q)
    assert (sum(r.wasted_tokens for r in recs_q)
            >= sum(r.wasted_tokens for r in recs_p))


def test_ragged_prompts(served):
    """Continuous batching: right-padded ragged prompts decode correctly."""
    model, prompts = served
    lens = np.array([8, 5, 8, 3], np.int32)
    ragged = prompts.copy()
    for i, n in enumerate(lens):
        ragged[i, n:] = 0
    out, _ = _engine(model, "vfpc").generate(ragged, prompt_lens=lens,
                                             max_new_tokens=8, eos_id=-1)
    out2, _ = _engine(model, "vfpc").generate(prompts, max_new_tokens=8,
                                              eos_id=-1)
    np.testing.assert_array_equal(out[0], out2[0])
    np.testing.assert_array_equal(out[2], out2[2])


def test_phase_tokens_are_fresh_tensors(served):
    """Each phase's tokens live in a tensor of their own: a pipelined phase
    read after the next one was issued still holds its own tokens."""
    model, prompts = served
    eng = _engine(model, "fpc")
    logits, caches = model.prefill(
        {"tokens": torch.as_tensor(prompts, dtype=torch.long)}, 64)
    token = torch.argmax(logits, dim=-1)[:, None]
    pos = torch.full((4,), 8, dtype=torch.long)
    seen = torch.zeros(4, dtype=torch.bool)
    with torch.inference_mode():
        token, pos, seen, first = eng._multi_step(caches, token, pos, seen,
                                                  -1, 3, masked=True)
        kept = first.clone()
        _, _, _, second = eng._multi_step(caches, token, pos, seen, -1, 3,
                                          masked=True)
    assert first.shape == (3, 4) and torch.equal(first, kept)
    assert first.data_ptr() != second.data_ptr()


def _one_process_mesh_engine(rank, world, prompts):
    """The served model's tokens from an engine on a one-process ``gloo``
    mesh under the decode profile, and from one without a mesh."""
    from repro_torch import sharding
    from repro_torch.launch.mesh import make_lm_mesh
    out = []
    for mesh in (None, make_lm_mesh(1, 1, device="cpu")):
        model = build_model("smollm-135m", smoke=True, device="cpu", seed=0)
        eng = ServeEngine(model, cache_len=64, algorithm="optimized_vfpc",
                          mesh=mesh, rules=sharding.make_rules("decode"))
        out.append(eng.generate(prompts, max_new_tokens=12, eos_id=-1)[0])
    return out


def test_engine_checks_its_inputs(served):
    """``mesh`` and ``rules`` are taken: on a one-process mesh the engine
    gives the unsharded tokens, and rules without a mesh change nothing."""
    from torch_spawn import run_gloo
    model, prompts = served
    plain, sharded = run_gloo(_one_process_mesh_engine, 1, prompts)[0]
    assert np.array_equal(plain, sharded)
    base, _ = _engine(model, "spc").generate(prompts, max_new_tokens=12)
    ruled, _ = _engine(model, "spc", rules={}).generate(prompts,
                                                         max_new_tokens=12)
    assert np.array_equal(base, ruled)
    with pytest.raises(ValueError, match="cache_len"):
        _engine(model, "spc").generate(prompts, max_new_tokens=60)


# -- the cost controller's serving kinds -----------------------------------------


def test_serve_kinds_keep_their_fits_apart():
    """Decode timings calibrate the ``decode`` fit and leave rule serving's
    untouched; decisions are recorded as ``{kind}_fusion`` and backfilled
    by the next ``observe_serve`` — case for case as the reference."""
    port, ref = _port_controller(), _ref_controller()
    for c in (port, ref):
        assert c.serve_key() == c.serve_key("rule_serve")
        assert c.serve_key("decode").endswith("/decode/dispatch")
        assert c.choose_fusion(work_per_unit=8.0, queued=10, max_fuse=4,
                               kind="decode") is None
        c.observe_serve(8.0, 1, 0.002, kind="decode")
        c.observe_serve(8.0, 3, 0.004, kind="decode")
        assert c.model.n_samples(c.serve_key("rule_serve")) == 0
        assert c.choose_fusion(work_per_unit=1e4, queued=10,
                               max_fuse=4) is None
        admit, _ = c.should_admit(work=1e9, latency_slo_s=1e-9)
        assert admit                 # rule serving is still uncalibrated
    got = [port.choose_fusion(work_per_unit=8.0, queued=q, max_fuse=m,
                              latency_budget_s=b, kind="decode")
           for q, m, b in [(10, 4, None), (10, 8, 0.003), (2, 8, 1e-9)]]
    want = [ref.choose_fusion(work_per_unit=8.0, queued=q, max_fuse=m,
                              latency_budget_s=b, kind="decode")
            for q, m, b in [(10, 4, None), (10, 8, 0.003), (2, 8, 1e-9)]]
    assert got == want
    for c in (port, ref):
        c.observe_serve(8.0, got[-1], 0.0025, kind="decode")
        c.observe_serve(1e4, 2, 0.001)
        assert c.choose_fusion(work_per_unit=1e4, queued=5,
                               max_fuse=3) == 3
    rows = port.decision_rows(0)
    assert rows == ref.decision_rows(0)
    fusion = [r for r in rows if r["site"].endswith("_fusion")]
    assert [r["site"] for r in fusion] == ["decode_fusion"] * 3 + \
        ["rule_serve_fusion"]
    assert fusion[2]["measured"] == 0.0025 and fusion[3]["measured"] is None


def test_measured_engine_calibrates_the_decode_fit(served):
    model, prompts = served
    ctl = _port_controller()
    eng = ServeEngine(model, cache_len=64, algorithm="measured",
                      controller=ctl)
    _, recs = eng.generate(prompts, max_new_tokens=20, eos_id=-1)
    assert recs[0].npass == 1 and len(recs) == 2    # calibrate, then fuse
    assert ctl.model.n_samples(ctl.serve_key("decode")) == len(recs)
    assert ctl.model.n_samples(ctl.serve_key()) == 0
    sites = [d.site for d in ctl.decisions]
    assert sites == ["decode_fusion"]
    assert ctl.decisions[0].measured == recs[1].elapsed


# -- the command line ------------------------------------------------------------

_SUMMARY = re.compile(r"algorithm=(\S+) dispatches=(\d+) tokens=(\d+) "
                      r"wasted=(\d+) decode_time=\d+\.\d{3}s "
                      r"\(\d+\.\d tok/s\)")
_PHASE = re.compile(r"  phase +(\d+) npass= ?(\d+) active=(\d+) "
                    r"\d+\.\d ms")


def _shape(text):
    lines = text.strip().splitlines()
    summary = _SUMMARY.fullmatch(lines[0])
    phases = [_PHASE.fullmatch(line) for line in lines[1:-1]]
    assert summary and all(phases), text
    assert lines[-1].startswith("first row tokens: [")
    n_tokens = len(lines[-1].split("[")[1].split(","))
    return summary.groups(), [p.groups() for p in phases], n_tokens


@pytest.mark.parametrize("algo", ["vfpc", "spc"])
def test_serve_cli_prints_the_reference_lines(algo, capsys, monkeypatch):
    from repro.launch import serve as ref_cli
    argv = ["--smoke", "--max-new", "12", "--batch", "3", "--algorithm", algo]
    port_cli.main(argv + ["--device", "cpu"])
    port = _shape(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve", *argv])
    ref_cli.main()
    assert port == _shape(capsys.readouterr().out)


def test_serve_cli_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["--smoke"])
