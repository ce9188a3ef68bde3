"""The port's training (``repro_torch/{data/tokens,train,launch/train}``)
against the JAX package's, on the CPU at smoke sizes: the token pipeline,
the policy-fused ``TrainLoop`` beside the reference's, checkpoints written
by either package and read by the other, the train CLI beside the
reference CLI, and mirrors of every test in ``tests/test_train.py``.

Tolerances, each beside its assert: batches, ``npass`` sequences and
checkpoints are equal byte for byte; losses of a float32 ``TrainLoop``
within 1e-4 of the reference's, relative (measured: at most 1.5e-7 over
six steps); the bf16 CLI's losses within 0.01 (measured: at most 1.6e-5
of the printed 4-decimal losses, the reference compiled, which keeps
fused chains in float32); the mirrors keep the reference tests' own
bounds.
"""

import re
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data.tokens import TokenPipeline as RefPipeline
from repro.models import build_model as ref_build_model
from repro.optim import AdamWConfig as RefConfig
from repro.train import TrainLoop as RefLoop
from repro.train import init_train_state as ref_init_train_state
from repro.train import load_checkpoint as ref_load_checkpoint
from repro.train import save_checkpoint as ref_save_checkpoint
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import TokenPipeline
from repro_torch.models import build_model
from repro_torch.models.convert import (load_reference_params,
                                        load_reference_state,
                                        state_to_reference)
from repro_torch.optim import AdamWConfig
from repro_torch.train import (TrainLoop, all_steps, init_train_state,
                               load_checkpoint, make_train_step,
                               save_checkpoint)

ARCH = "smollm-135m"


def _setup(algorithm="vfpc", **opt_kw):
    """The reference tests' setup, on the port: smollm-135m's smoke config
    on the CPU, sequences of 32 in batches of 4."""
    cfg = get_config(ARCH, smoke=True)
    model = build_model(cfg, device="cpu", seed=None)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    opt = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=60, **opt_kw)
    return model, pipe, opt


def _tensors(state: dict) -> list:
    """Every tensor of a port training state, in a fixed order."""
    out = list(state["params"].values())
    for key in sorted(state["opt"]):
        val = state["opt"][key]
        out += list(val.values()) if isinstance(val, dict) else [val]
    return out


# -- the token pipeline ----------------------------------------------------------

@pytest.mark.parametrize("shard", [(0, 1), (1, 2), (3, 4)])
def test_token_pipeline_batches_equal_the_reference(shard):
    index, count = shard
    kw = dict(vocab_size=515, seq_len=24, global_batch=8, seed=7,
              shard_index=index, shard_count=count)
    ref, port = RefPipeline(**kw), TokenPipeline(**kw)
    assert port.local_batch == ref.local_batch == 8 // count
    for _ in range(4):
        (rt, rl), (pt, pl) = ref.next_batch(), port.next_batch()
        assert pt.dtype == rt.dtype == np.int32
        assert pt.tobytes() == rt.tobytes() and pl.tobytes() == rl.tobytes()
    assert port._step == ref._step == 4


# -- the loop against the reference's ---------------------------------------------

@pytest.mark.parametrize("arch,algorithm", [
    (ARCH, "spc"), (ARCH, "fpc"), ("whisper-small", "fpc"),
    ("internvl2-76b", "spc")])
def test_train_loop_matches_the_reference(arch, algorithm):
    """Port and reference TrainLoops from one float32 parameter tree over
    the same token stream (the frontend stubs fed zeros): the same npass
    sequence and steps, losses within 1e-4."""
    import dataclasses
    rcfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                               dtype="float32")
    ref = ref_build_model(rcfg)
    ropt = RefConfig(lr=1e-3, warmup_steps=2, total_steps=6)
    rstate = jax.jit(lambda k: ref_init_train_state(ref, ropt, k))(
        jax.random.PRNGKey(0))
    port = build_model(dataclasses.replace(get_config(arch, smoke=True),
                                           dtype="float32"),
                       device="cpu", seed=None)
    load_reference_params(port, jax.tree.map(np.asarray, rstate["params"]))
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6)
    pstate = init_train_state(port, opt, seed=None)
    kw = dict(vocab_size=rcfg.vocab_size, seq_len=16 + rcfg.n_frontend_tokens,
              global_batch=2)
    _, want = RefLoop(ref, RefPipeline(**kw), ropt,
                      algorithm=algorithm).run(rstate, 6)
    _, got = TrainLoop(port, TokenPipeline(**kw), opt,
                       algorithm=algorithm).run(pstate, 6)
    assert [(r.npass, r.steps) for r in got] == \
        [(r.npass, r.steps) for r in want]
    for r, p in zip(want, got):
        assert abs(p.mean_loss - r.mean_loss) <= 1e-4 * r.mean_loss


def _one_process_mesh_loop(rank, world):
    """TrainLoop records without a mesh and on a one-process ``gloo``
    mesh (``init_train_state(mesh=, rules=)`` placing the model)."""
    from repro_torch import sharding
    from repro_torch.launch.mesh import make_lm_mesh
    import dataclasses
    out = []
    for mesh in (None, make_lm_mesh(1, 1, device="cpu")):
        _, pipe, opt = _setup()
        model = build_model(dataclasses.replace(
            get_config(ARCH, smoke=True), dtype="float32"), device="cpu",
            seed=None)
        rules = sharding.make_rules() if mesh is not None else None
        state = init_train_state(model, opt, seed=0, mesh=mesh, rules=rules)
        _, recs = TrainLoop(model, pipe, opt, mesh=mesh,
                            rules=rules).run(state, 5)
        out.append([(r.npass, r.steps, r.mean_loss) for r in recs])
    return out


def test_train_loop_refuses_a_mesh():
    """The loop and the state take a mesh: on one process they give the
    unsharded records (float32: the sharded loss is the vocab-parallel
    form, ``m + log Σ exp``, which rounds apart from ``logsumexp``)."""
    from torch_spawn import run_gloo
    plain, sharded = run_gloo(_one_process_mesh_loop, 1)[0]
    assert [r[:2] for r in sharded] == [r[:2] for r in plain]
    for a, b in zip(plain, sharded):
        assert abs(a[2] - b[2]) <= 1e-5 * abs(a[2])


# -- checkpoints across the packages --------------------------------------------------

def _reference_state(arch: str, compress: bool):
    """A reference training state, every leaf random from a seed in its
    shape and dtype (bf16 parameters, float32 moments) and step 7."""
    ref = ref_build_model(ref_get_config(arch, smoke=True))
    shapes = jax.eval_shape(lambda k: ref_init_train_state(
        ref, RefConfig(compress=compress), k), jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    state = jax.tree.map(lambda x: jax.numpy.asarray(
        rng.normal(size=x.shape), x.dtype), shapes)
    state["opt"]["step"] = jax.numpy.asarray(7, jax.numpy.int32)
    return state, AdamWConfig(compress=compress)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "whisper-small"])
def test_checkpoints_load_across_the_packages(tmp_path, arch, compress):
    """The reference writes, the port loads it into a model and its
    optimizer state and writes it again: the same manifest, and the
    reference loads it with a template bit for bit.  A hybrid (blocks
    stacked under sub0..sub7, one slice each) and an encoder-decoder
    (enc_blocks and dec_blocks)."""
    import json
    state, opt = _reference_state(arch, compress)
    ref_save_checkpoint(str(tmp_path / "ref"), 7, state)
    tree, step = load_checkpoint(str(tmp_path / "ref"))
    assert step == 7
    model = build_model(get_config(arch, smoke=True), device="cpu", seed=None)
    pstate = init_train_state(model, opt, seed=None)
    load_reference_state(model, tree, pstate)
    assert int(pstate["opt"]["step"]) == 7
    save_checkpoint(str(tmp_path / "port"), 7,
                    state_to_reference(model, pstate))
    manifests = [json.loads((tmp_path / d / "step_7" / "manifest.json")
                            .read_text()) for d in ("ref", "port")]
    assert manifests[0] == manifests[1]
    back, step = ref_load_checkpoint(str(tmp_path / "port"), template=state)
    assert step == 7
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(back)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_state_layout_is_the_references(arch):
    """For every arch, the port's state in the reference's layout has the
    reference's leaves in its flatten order, with their shapes and
    dtypes (so the reference's ``load_checkpoint`` takes it)."""
    from repro_torch.train.checkpoint import _flatten, _meta
    ref = ref_build_model(ref_get_config(arch, smoke=True))
    shapes = jax.eval_shape(lambda k: ref_init_train_state(
        ref, RefConfig(compress=True), k), jax.random.PRNGKey(0))
    want = [("/".join(str(k.key) for k in kp), list(x.shape), str(x.dtype))
            for kp, x in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    model = build_model(get_config(arch, smoke=True), device="cpu", seed=None)
    state = init_train_state(model, AdamWConfig(compress=True), seed=None)
    got = [(path, *_meta(leaf)) for path, leaf in
           _flatten(state_to_reference(model, state))]
    assert got == want


# -- the CLI against the reference CLI ----------------------------------------------

def test_train_cli_matches_the_reference_cli(tmp_path, monkeypatch, capsys):
    """Both CLIs resume from one checkpoint the reference wrote at step 0
    (the port reading it across) and train 6 steps under vfpc: the same
    phase lines (npass, steps), losses within 0.01."""
    from repro.launch import train as ref_cli
    from repro_torch.launch import train as port_cli
    ref = ref_build_model(ref_get_config(ARCH, smoke=True))
    state = jax.jit(lambda k: ref_init_train_state(ref, RefConfig(), k))(
        jax.random.PRNGKey(0))
    ref_save_checkpoint(str(tmp_path / "ref"), 0, state)
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    argv = ["--arch", ARCH, "--smoke", "--steps", "6", "--seq-len", "32",
            "--batch", "4", "--algorithm", "vfpc"]
    monkeypatch.setattr(sys, "argv", ["repro.launch.train", *argv,
                                      "--ckpt", str(tmp_path / "ref")])
    ref_cli.main()
    want = capsys.readouterr().out.splitlines()
    port_cli.main(argv + ["--ckpt", str(tmp_path / "port"), "--device",
                          "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0] == "resumed from step 0"
    assert len(got) == len(want) and got[-1].startswith("final loss")

    def fields(line):
        return {k: v for k, v in (w.split("=", 1) for w in line.split()
                                  if "=" in w)}

    for w, g in zip(want[1:-1], got[1:-1]):
        fw, fg = fields(w), fields(g)
        assert (fg["npass"], fg["steps"]) == (fw["npass"], fw["steps"])
        assert abs(float(fg["loss"]) - float(fw["loss"])) <= \
            0.01 * float(fw["loss"])
    # resumed with no step left, the port says so (the reference raises)
    port_cli.main(argv + ["--ckpt", str(tmp_path / "port"), "--device",
                          "cpu"])
    assert capsys.readouterr().out.splitlines() == [
        "resumed from step 6", "no steps left: step 6 of 6 done"]
    # --mesh on one process: a one-process group, the unsharded answer
    port_cli.main(argv + ["--mesh", "--device", "cpu"])
    meshed = capsys.readouterr().out.splitlines()
    port_cli.main(argv + ["--device", "cpu"])
    plain = capsys.readouterr().out.splitlines()
    assert [re.sub(r"\S+s$", "", line) for line in meshed] == \
        [re.sub(r"\S+s$", "", line) for line in plain]


# -- mirrors of tests/test_train.py ----------------------------------------------------

def test_loss_decreases():
    model, pipe, opt = _setup()
    loop = TrainLoop(model, pipe, opt, algorithm="vfpc")
    state = init_train_state(model, opt, seed=0)
    state, recs = loop.run(state, total_steps=16)
    assert recs[-1].mean_loss < recs[0].mean_loss
    assert sum(r.npass for r in recs) == 16


def test_fused_phase_equals_sequential_steps():
    """npass=3 fused phase == 3 single-step phases, within the reference
    test's bound (2e-2; on the CPU they are equal bit for bit)."""
    model, pipe, opt = _setup()
    twin = build_model(model.cfg, device="cpu", seed=None)
    state3 = init_train_state(model, opt, seed=0)
    state1 = init_train_state(twin, opt, seed=0)
    b = [pipe.next_batch() for _ in range(3)]
    batch3 = {"tokens": np.stack([x[0] for x in b]),
              "labels": np.stack([x[1] for x in b])}
    fn1 = make_train_step(twin, opt, npass=1)
    fn3 = make_train_step(model, opt, npass=3)
    for i in range(3):
        state1, _ = fn1(state1, {"tokens": batch3["tokens"][i:i + 1],
                                 "labels": batch3["labels"][i:i + 1]})
    state3, metrics = fn3(state3, batch3)
    assert metrics["loss"].shape == (3,)
    for a, c in zip(_tensors(state1), _tensors(state3)):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   c.detach().float().numpy(),
                                   rtol=2e-2, atol=2e-2)
        assert torch.equal(a, c)


def test_checkpoint_roundtrip(tmp_path):
    model, pipe, opt = _setup()
    state = init_train_state(model, opt, seed=0)
    save_checkpoint(str(tmp_path), 7, state_to_reference(model, state))
    assert all_steps(str(tmp_path)) == [7]
    tree, step = load_checkpoint(str(tmp_path),
                                 template=state_to_reference(model, state))
    assert step == 7
    twin = build_model(model.cfg, device="cpu", seed=None)
    back = init_train_state(twin, opt, seed=None)
    load_reference_state(twin, tree, back)
    for a, b in zip(_tensors(state), _tensors(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_retention(tmp_path):
    model, pipe, opt = _setup()
    state = init_train_state(model, opt, seed=0)
    for s in [1, 2, 3, 4, 5]:
        save_checkpoint(str(tmp_path), s, state_to_reference(model, state),
                        keep=2)
    assert all_steps(str(tmp_path)) == [4, 5]


def test_restart_resumes_step_count(tmp_path):
    model, pipe, opt = _setup()
    d = str(tmp_path / "ck")
    loop = TrainLoop(model, pipe, opt, algorithm="spc", checkpoint_dir=d)
    state = init_train_state(model, opt, seed=0)
    state, _ = loop.run(state, total_steps=6)
    # "crash" and restart from disk
    tree, step = load_checkpoint(d)
    assert step == 6
    twin = build_model(model.cfg, device="cpu", seed=None)
    state2 = init_train_state(twin, opt, seed=None)
    load_reference_state(twin, tree, state2)
    loop2 = TrainLoop(twin, pipe, opt, algorithm="spc", checkpoint_dir=d)
    state2, recs2 = loop2.run(state2, total_steps=10)
    assert int(state2["opt"]["step"]) == 10


def test_gradient_compression_converges():
    model, pipe, opt = _setup(compress=True)
    loop = TrainLoop(model, pipe, opt, algorithm="fpc")
    state = init_train_state(model, opt, seed=0)
    assert "err" in state["opt"]
    state, recs = loop.run(state, total_steps=12)
    assert np.isfinite(recs[-1].mean_loss)
    assert recs[-1].mean_loss < recs[0].mean_loss


def test_data_pipeline_resume(tmp_path):
    """Restart continues the token stream rather than replaying it."""
    model, pipe, opt = _setup()
    d = str(tmp_path / "ck")
    loop = TrainLoop(model, pipe, opt, algorithm="spc", checkpoint_dir=d)
    state = init_train_state(model, opt, seed=0)
    state, _ = loop.run(state, total_steps=5)
    consumed = pipe._step
    assert consumed == 5
    # fresh process: new pipeline starts at 0; restore fast-forwards it
    pipe2 = TokenPipeline(vocab_size=model.cfg.vocab_size, seq_len=32,
                          global_batch=4)
    loop2 = TrainLoop(model, pipe2, opt, algorithm="spc", checkpoint_dir=d)
    loop2.restore_data_cursor()
    assert pipe2._step == consumed
    t_next, _ = pipe2.next_batch()
    pipe_ref = TokenPipeline(vocab_size=model.cfg.vocab_size, seq_len=32,
                             global_batch=4)
    for _ in range(consumed):
        pipe_ref.next_batch()
    t_want, _ = pipe_ref.next_batch()
    assert (t_next == t_want).all()


def test_nan_phase_recovery(tmp_path):
    """A NaN'd phase restores from checkpoint instead of corrupting state."""
    model, pipe, opt = _setup()
    d = str(tmp_path / "ck")
    loop = TrainLoop(model, pipe, opt, algorithm="spc", checkpoint_dir=d,
                     ckpt_every_phases=1)
    state = init_train_state(model, opt, seed=0)
    state, _ = loop.run(state, total_steps=3)
    # poison params → next phase NaNs → loop restores from disk
    with torch.no_grad():
        state["params"]["decoder.embed.table"].mul_(float("nan"))
    state2, recs = loop.run(state, total_steps=4)
    assert any(r.renan for r in recs)
    assert np.isfinite(recs[-1].mean_loss)
    assert torch.isfinite(state2["params"]["decoder.embed.table"]).all()
