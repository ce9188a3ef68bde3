"""Sharded LM serving and training across processes: four ``gloo`` CPU
processes on a (2, 2) mesh (two on (2, 1) for the elastic restore) against
the port's one-process run and the reference on four forced XLA host
devices.  The decode profile teacher-forced, two fused training steps
(smollm-135m against the port unsharded; granite-moe-3b-a800m, with
expert parallelism in its loss, against the reference sharded), each
process's parameter and optimizer bytes against its specs, ``TrainLoop``
across two phases, elastic restores and checkpoints across the packages
bit for bit, and the train CLI's ``--mesh`` in two processes."""

import dataclasses
import functools
import os
import re
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

from torch_spawn import SRC, free_port, run_gloo, run_reference

SMOLLM, GRANITE = "smollm-135m", "granite-moe-3b-a800m"
B, S, STEPS = 4, 8, 4              # decode: prompt of 8, 4 forced steps
TB, TS = 4, 16                     # training batches


@functools.lru_cache(maxsize=None)
def _dirs() -> dict:
    root = tempfile.mkdtemp(prefix="shard_lm_")
    out = {k: os.path.join(root, k) for k in
           ("ref", "ref_ckpt", "port_ckpt", "loop_ckpt", "ref_restored")}
    for d in out.values():
        os.makedirs(d)
    return out


_FLAT = """
def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = prefix + "/" + k if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, key))
        else:
            a = np.asarray(v)
            if a.dtype.name == "bfloat16":
                out[key + "@bf16"] = a.view(np.uint16)
            else:
                out[key] = a
    return out
"""
_FLAT8 = textwrap.indent(_FLAT, " " * 8)


@functools.lru_cache(maxsize=None)
def _reference() -> str:
    """Parameters, inputs and the reference's sharded results, and a
    sharded reference checkpoint, from one subprocess."""
    d = _dirs()
    run_reference(f"""
        import dataclasses, os
        import numpy as np, jax, jax.numpy as jnp
        from repro import sharding
        from repro.compat import make_mesh
        from repro.configs import get_config
        from repro.models import build_model
        from repro.models.model import ShardCtx
        from repro.optim import AdamWConfig
        from repro.train import (init_train_state, make_train_step,
                                 save_checkpoint)
{_FLAT8}
        out = {d["ref"]!r}
        mesh = make_mesh((2, 2), ("data", "model"))
        rng = np.random.default_rng(0)

        # the decode profile, teacher-forced, float32 and bf16
        cfg = dataclasses.replace(get_config({SMOLLM!r}, smoke=True),
                                  dtype="float32")
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        np.savez(os.path.join(out, "smollm_params.npz"), **flat(params))
        toks = rng.integers(1, cfg.vocab_size, ({B}, {S})).astype(np.int32)
        forced = rng.integers(1, cfg.vocab_size,
                              ({STEPS}, {B})).astype(np.int32)
        np.savez(os.path.join(out, "decode_inputs.npz"), toks=toks,
                 forced=forced)

        def rollout(model, params, ctx):
            lg, caches = model.prefill(params, {{"tokens": jnp.asarray(toks)}},
                                       cache_len={S + STEPS}, ctx=ctx)
            lgs = [np.asarray(lg, np.float32)]
            for t in range({STEPS}):
                lg, caches = model.decode_step(
                    params, caches, jnp.asarray(forced[t])[:, None],
                    jnp.full(({B},), {S} + t, jnp.int32), ctx)
                lgs.append(np.asarray(lg, np.float32))
            return np.stack(lgs)

        ctx = ShardCtx(mesh, sharding.make_rules("decode"))
        np.save(os.path.join(out, "decode_f32.npy"),
                rollout(model, params, ctx))
        mb = build_model(dataclasses.replace(cfg, dtype="bfloat16"))
        pb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
        np.save(os.path.join(out, "decode_bf16.npy"), rollout(mb, pb, ctx))

        # two fused training steps of granite-moe, sharded (EP in the loss)
        rules = sharding.make_rules()
        gcfg = dataclasses.replace(get_config({GRANITE!r}, smoke=True),
                                   dtype="float32")
        gm = build_model(gcfg)
        opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
        state = init_train_state(gm, opt, jax.random.PRNGKey(1), mesh, rules)
        np.savez(os.path.join(out, "granite_params.npz"),
                 **flat(state["params"]))
        gt = rng.integers(0, gcfg.vocab_size, (2, {TB}, {TS})).astype(np.int32)
        gl = rng.integers(0, gcfg.vocab_size, (2, {TB}, {TS})).astype(np.int32)
        np.savez(os.path.join(out, "granite_batches.npz"), tokens=gt, labels=gl)
        batches = {{"tokens": jnp.asarray(gt), "labels": jnp.asarray(gl)}}
        one, _ = make_train_step(gm, opt, mesh, rules, npass=1,
                                 donate=False)(
            state, {{k: v[:1] for k, v in batches.items()}})
        np.savez(os.path.join(out, "granite_after.npz"),
                 **flat(one["params"]))
        _, metrics = make_train_step(gm, opt, mesh, rules, npass=2,
                                     donate=False)(state, batches)
        np.save(os.path.join(out, "granite_loss.npy"),
                np.asarray(metrics["loss"]))

        # a sharded reference checkpoint (smoke dtype, bf16) for the port
        scfg = get_config({SMOLLM!r}, smoke=True)
        sm = build_model(scfg)
        sopt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
        st = init_train_state(sm, sopt, jax.random.PRNGKey(2), mesh, rules)
        st, _ = make_train_step(sm, sopt, mesh, rules, npass=1,
                                donate=False)(st, {{
            "tokens": jnp.asarray(gt[:1] % scfg.vocab_size),
            "labels": jnp.asarray(gl[:1] % scfg.vocab_size)}})
        save_checkpoint({d["ref_ckpt"]!r}, 1, st)
        np.savez(os.path.join(out, "ref_ckpt_state.npz"), **flat(st))
        print("REF_OK")
    """, n_devices=4)
    return d["ref"]


def _load_tree(path: str) -> dict:
    """A flattened npz → nested dict of numpy arrays / bf16 torch tensors."""
    import torch
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            arr = z[key]
            name = key
            if key.endswith("@bf16"):
                name = key[:-5]
                arr = torch.from_numpy(arr.view(np.int16).copy()).view(
                    torch.bfloat16)
            node = tree
            *parents, leaf = name.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = arr
    return tree


def _bits(t) -> np.ndarray:
    """A tensor's (a DTensor's gathered) bits as numpy."""
    import torch
    from repro_torch.sharding import is_dtensor
    t = t.full_tensor() if is_dtensor(t) else t
    t = t.detach().cpu().clone()       # a copy: the state trains on
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _state_bits(model, state) -> dict:
    """The state as the reference's flattened paths → bits."""
    from repro_torch.models import convert
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            elif isinstance(v, list):
                out[key] = np.stack([_bits(s) for s in v])
            else:
                out[key] = _bits(v)

    walk(convert.state_to_reference(model, state), "")
    return out


# -- the four-process (2, 2) run --------------------------------------------------------

def _mesh_worker(rank, world, ref_dir, dirs):
    """The sharded runs on (2, 2) in every process; the one-process
    baselines they are held against in rank 0 alone (None elsewhere)."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch import sharding
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models import build_model, convert
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (TrainLoop, init_train_state,
                                   make_train_step, restore_elastic,
                                   save_checkpoint)
    mesh = make_lm_mesh(2, 2, device="cpu")
    out = {}

    # the decode profile, teacher-forced
    params = _load_tree(os.path.join(ref_dir, "smollm_params.npz"))
    z = np.load(os.path.join(ref_dir, "decode_inputs.npz"))
    toks, forced = torch.from_numpy(z["toks"]).long(), \
        torch.from_numpy(z["forced"]).long()
    base = dataclasses.replace(get_config(SMOLLM, smoke=True),
                               dtype="float32")
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        tree = params if dtype == "float32" else _cast(params)
        rolls = []
        for mesh_, rules in ((None, None),
                             (mesh, sharding.make_rules("decode"))):
            if mesh_ is None and rank:      # one process: rank 0 alone
                rolls.append(None)
                continue
            m = build_model(cfg, device="cpu", seed=None, mesh=mesh_,
                            rules=rules)
            convert.load_reference_params(m, tree)
            lg, caches = m.prefill({"tokens": toks}, S + STEPS)
            lgs = [m.ctx.full(lg).float()]
            for t in range(STEPS):
                lg, caches = m.decode_step(caches, forced[t][:, None],
                                           torch.full((B,), S + t))
                lgs.append(m.ctx.full(lg).float())
            rolls.append(torch.stack(lgs).numpy())
        out[f"decode_{dtype}"] = rolls

    # two fused float32 steps of smollm: sharded against one process
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    g = np.load(os.path.join(ref_dir, "granite_batches.npz"))
    sb = {"tokens": g["tokens"] % base.vocab_size,
          "labels": g["labels"] % base.vocab_size}
    runs = []
    for mesh_ in (None, mesh):
        if mesh_ is None and rank:
            runs.append(None)
            continue
        m = build_model(base, device="cpu", seed=None, mesh=mesh_,
                        rules=sharding.make_rules() if mesh_ else None)
        convert.load_reference_params(m, params)
        st = init_train_state(m, opt, seed=None)
        st, met = make_train_step(m, opt, npass=2)(st, sb)
        runs.append((met["loss"].numpy(), {n: _bits(p) for n, p in
                                           st["params"].items()}))
        if mesh_ is not None:
            # each process's parameter and optimizer bytes are its specs'
            specs = m.param_specs()
            want = sum(sharding.spec_bytes(tuple(p.shape), p.element_size(),
                                           mesh, specs[n])
                       for n, p in st["params"].items())
            out["param_bytes"] = (m.weight_bytes(), want)
            out["opt_bytes"] = (
                sum(sharding.shard_bytes(t) for k in ("m", "v")
                    for t in st["opt"][k].values()),
                2 * sum(sharding.spec_bytes(tuple(p.shape), 4, mesh,
                                            specs[n])
                        for n, p in st["params"].items()))
            out["whole_bytes"] = sum(p.numel() * p.element_size()
                                     for p in st["params"].values())
            one = {k: v[:1] for k, v in sb.items()}
            with CommDebugMode() as comm:
                make_train_step(m, opt, npass=1)(st, one)
            out["comms"] = {str(k): int(v) for k, v in
                            comm.get_comm_counts().items()}
    out["smollm_train"] = runs

    # one step with int8 gradient compression (a scale per reference leaf)
    copt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                       compress=True)
    comp = []
    for mesh_ in (None, mesh):
        if mesh_ is None and rank:
            comp.append(None)
            continue
        m = build_model(base, device="cpu", seed=None, mesh=mesh_,
                        rules=sharding.make_rules() if mesh_ else None)
        convert.load_reference_params(m, params)
        st = init_train_state(m, copt, seed=None)
        st, met = make_train_step(m, copt, npass=1)(
            st, {k: v[:1] for k, v in sb.items()})
        comp.append((float(met["grad_norm"][0]), _state_bits(m, st)))
    out["compressed"] = comp

    # two fused float32 steps of granite-moe (EP), sharded
    gcfg = dataclasses.replace(get_config(GRANITE, smoke=True),
                               dtype="float32")
    gm = build_model(gcfg, device="cpu", seed=None, mesh=mesh,
                     rules=sharding.make_rules())
    convert.load_reference_params(
        gm, _load_tree(os.path.join(ref_dir, "granite_params.npz")))
    st = init_train_state(gm, opt, seed=None)
    st, _ = make_train_step(gm, opt, npass=1)(
        st, {"tokens": g["tokens"][:1], "labels": g["labels"][:1]})
    out["granite_params"] = _state_bits(gm, st)
    convert.load_reference_params(
        gm, _load_tree(os.path.join(ref_dir, "granite_params.npz")))
    st = init_train_state(gm, opt, seed=None)
    st, met = make_train_step(gm, opt, npass=2)(
        st, {"tokens": g["tokens"], "labels": g["labels"]})
    out["granite_loss"] = met["loss"].numpy()
    out["ep_dispatches"] = [blk.moe.ep_dispatches for blk in gm.net.blocks
                            if hasattr(blk, "moe")]

    # TrainLoop across two phases, against one process
    small = get_config(SMOLLM, smoke=True)
    lopt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    loops = []
    for mesh_, ck in ((None, None), (mesh, dirs["loop_ckpt"])):
        if mesh_ is None and rank:
            loops.append(None)
            continue
        rules = sharding.make_rules() if mesh_ else None
        recs = []
        for total in (3, 6):
            m = build_model(small, device="cpu", seed=None, mesh=mesh_,
                            rules=rules)
            pipe = TokenPipeline(vocab_size=small.vocab_size, seq_len=32,
                                 global_batch=4)
            loop = TrainLoop(m, pipe, lopt, algorithm="vfpc", mesh=mesh_,
                             rules=rules, checkpoint_dir=ck)
            if ck is None:
                if total == 3:
                    st = init_train_state(m, lopt, seed=0)
                    first = m
                else:          # one process: carry the state on
                    m = first
                    loop = TrainLoop(m, pipe, lopt, algorithm="vfpc")
                    pipe._step = 3
            else:
                st, _ = restore_elastic(ck, m, lopt)
                if st is None:
                    st = init_train_state(m, lopt, seed=0)
            st, r = loop.run(st, total)
            recs += [(x.npass, x.steps, x.mean_loss) for x in r]
        loops.append(recs)
    out["loops"] = loops

    # elastic: save from (2, 2) ...
    em = build_model(small, device="cpu", seed=0, mesh=mesh,
                     rules=sharding.make_rules())
    est = init_train_state(em, lopt, seed=None)
    est, _ = make_train_step(em, lopt, npass=1)(
        est, {k: v[:1] % small.vocab_size for k, v in g.items()})
    save_checkpoint(dirs["port_ckpt"], 1, convert.state_to_reference(em, est))
    out["saved"] = _state_bits(em, est)

    # ... and the reference's sharded checkpoint restored here
    rm = Model(small, device="cpu", ctx=sharding.ShardCtx(
        mesh, sharding.make_rules()))
    rst, step = restore_elastic(dirs["ref_ckpt"], rm, AdamWConfig())
    out["ref_restored"] = (step, _state_bits(rm, rst))
    return out


def _cast(tree):
    import torch
    return {k: _cast(v) if isinstance(v, dict) else
            torch.from_numpy(np.asarray(v)).to(torch.bfloat16)
            for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _mesh_run() -> dict:
    ref_dir = _reference()
    return run_gloo(_mesh_worker, 4, ref_dir, _dirs(), timeout=400)


def test_decode_profile_matches_one_process_and_the_reference():
    res = _mesh_run()
    ref = {"float32": np.load(os.path.join(_reference(), "decode_f32.npy")),
           "bfloat16": np.load(os.path.join(_reference(),
                                            "decode_bf16.npy"))}
    for r in res[1:]:                  # every process has the same logits
        for key in ("decode_float32", "decode_bfloat16"):
            assert np.array_equal(r[key][1], res[0][key][1])
    one, sharded = res[0]["decode_float32"]
    scale = np.abs(one).max()
    assert np.abs(sharded - one).max() <= 1e-4 * scale
    assert np.abs(sharded - ref["float32"]).max() <= 1e-4 * scale
    one, sharded = res[0]["decode_bfloat16"]
    assert np.abs(sharded - one).max() < 0.05
    assert np.abs(sharded - ref["bfloat16"]).max() < 0.05


def test_sharded_training_matches_one_process():
    (l0, p0), (l1, p1) = _mesh_run()[0]["smollm_train"]
    assert np.abs(l1 - l0).max() <= 1e-5
    for name, want in p0.items():
        assert np.abs(p1[name] - want).max() <= \
            1e-4 * max(np.abs(want).max(), 1e-12), name


def test_sharded_compressed_step_matches_one_process():
    """int8 compression on DTensors: the peaks and the norm reduced over
    the mesh, the error feedback kept per shard."""
    (n0, s0), (n1, s1) = _mesh_run()[0]["compressed"]
    assert abs(n1 - n0) <= 1e-5 * n0
    assert set(s0) == set(s1) and any(k.startswith("opt/err") for k in s0)
    for key, want in s0.items():
        scale = np.abs(want).max()
        if key.startswith("opt/err/"):
            # the residual g - deq(g) carries g's own rounding: held to
            # the dequantised gradient's size, 10 × m's after one step
            scale = 10 * np.abs(s0["opt/m/" + key[8:]]).max()
        assert np.abs(s1[key] - want).max() <= 1e-4 * max(scale, 1e-12), key


def test_ep_training_matches_the_reference_sharded():
    """Two fused steps' losses, and every parameter after the first step
    (at the second, a router near-tie may pick another expert for a token
    in one package and not the other, which moves a few of that token's
    elements by a fraction of the learning rate)."""
    res = _mesh_run()[0]
    ref = _reference()
    assert res["ep_dispatches"] and min(res["ep_dispatches"]) >= 3
    assert np.abs(res["granite_loss"] -
                  np.load(os.path.join(ref, "granite_loss.npy"))).max() \
        <= 1e-5
    with np.load(os.path.join(ref, "granite_after.npz")) as want:
        for key in want.files:
            got = res["granite_params"]["params/" + key]
            assert np.abs(got - want[key]).max() <= \
                1e-4 * max(np.abs(want[key]).max(), 1e-12), key


def test_each_process_holds_its_specs_bytes():
    res = _mesh_run()
    for r in res:
        held, want = r["param_bytes"]
        assert held == want and held < r["whole_bytes"]
        held, want = r["opt_bytes"]
        assert held == want


def test_one_step_communicates(capsys):
    comms = _mesh_run()[0]["comms"]
    with capsys.disabled():
        print(f"\ncollectives of one sharded step, by op: {comms}")
    assert sum(comms.values()) > 0


def test_train_loop_on_a_mesh_across_two_phases():
    one, sharded = _mesh_run()[0]["loops"]
    assert [(n, s) for n, s, _ in sharded] == [(n, s) for n, s, _ in one]
    assert sharded[-1][1][1] == 6
    for (_, _, a), (_, _, b) in zip(one, sharded):
        assert abs(a - b) <= 2e-2


# -- elastic restores and the reference's checkpoints ---------------------------------

def _restore_worker(rank, world, ckpt):
    from repro_torch import sharding
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import restore_elastic
    mesh = make_lm_mesh(2, 1, device="cpu")
    m = Model(get_config(SMOLLM, smoke=True), device="cpu",
              ctx=sharding.ShardCtx(mesh, sharding.make_rules()))
    st, step = restore_elastic(ckpt, m, AdamWConfig())
    return step, _state_bits(m, st), m.weight_bytes()


def test_elastic_restore_on_fewer_processes():
    saved = _mesh_run()[0]["saved"]
    res = run_gloo(_restore_worker, 2, _dirs()["port_ckpt"])
    for step, bits, _ in res:
        assert step == 1 and set(bits) == set(saved)
        for key, want in saved.items():
            assert np.array_equal(bits[key], want), key


def test_the_reference_restores_a_sharded_port_checkpoint():
    saved = _mesh_run()[0]["saved"]
    d = _dirs()
    run_reference(f"""
        import os, numpy as np, jax
        from repro import sharding
        from repro.compat import make_mesh
        from repro.configs import get_config
        from repro.models import build_model
        from repro.optim import AdamWConfig
        from repro.train import init_train_state
        from repro.train.elastic import restore_elastic
{_FLAT8}
        model = build_model(get_config({SMOLLM!r}, smoke=True))
        opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
        tmpl = jax.eval_shape(lambda k: init_train_state(model, opt, k),
                              jax.random.PRNGKey(0))
        mesh = make_mesh((2, 2), ("data", "model"))
        state, step = restore_elastic({d["port_ckpt"]!r}, model, opt, mesh,
                                      sharding.make_rules(), tmpl)
        assert step == 1
        np.savez(os.path.join({d["ref_restored"]!r}, "s.npz"),
                 **flat(jax.device_get(state)))
    """, n_devices=4)
    with np.load(os.path.join(d["ref_restored"], "s.npz")) as got:
        keys = {k.removesuffix("@bf16"): k for k in got.files}
        assert set(keys) == set(saved)
        for key, want in saved.items():
            arr = got[keys[key]]
            assert np.array_equal(arr.view(want.dtype) if arr.dtype.itemsize
                                  == want.dtype.itemsize else arr, want), key


def test_the_port_restores_a_sharded_reference_checkpoint():
    step, bits = _mesh_run()[0]["ref_restored"]
    assert step == 1
    with np.load(os.path.join(_reference(), "ref_ckpt_state.npz")) as want:
        keys = {k.removesuffix("@bf16"): k for k in want.files}
        assert set(keys) == set(bits)
        for key, got in bits.items():
            arr = want[keys[key]]
            assert np.array_equal(arr.view(got.dtype), got), key


# -- the train CLI under --mesh in two processes ----------------------------------------

def test_train_cli_mesh_in_two_processes(tmp_path):
    argv = ["--smoke", "--steps", "4", "--seq-len", "32", "--batch", "4",
            "--algorithm", "spc", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=SRC, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *argv, "--mesh",
         "--ckpt", str(tmp_path / "ck")],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=240)
            assert p.returncode == 0, o + e
            outs.append(o)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    one = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *argv], env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=240)
    assert one.returncode == 0, one.stderr

    def final(text):
        return float(re.search(r"final loss ([0-9.]+)", text).group(1))

    assert "final loss" not in outs[1]     # process 0 prints
    assert abs(final(outs[0]) - final(one.stdout)) <= 0.01 * final(one.stdout)
    assert os.path.exists(tmp_path / "ck" / "step_4" / "manifest.json")
