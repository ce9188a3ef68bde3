"""SSM caches on a mesh whose model axis divides the SSM channels but not
the heads: mamba2-370m's and jamba-v0.1-52b's smoke configs at d_model 48
(d_inner 96: 6 heads of 16) on (1, 4), four ``gloo`` CPU processes
against the reference on four forced XLA host devices.  The reference
places each cache leaf alone, so ``conv_x`` shards its 96 channels and
the state replicates its 6 heads; the port steps such a conv cache in the
state's layout and writes its shard back (``ssm._step_sharded``).  Prefill
and three teacher-forced decode steps, in float32, within 1e-4 of max
|logit| (the sharded float32 bound)."""

import dataclasses
import functools
import os
import tempfile

import numpy as np
import pytest

from torch_spawn import run_gloo, run_reference

ARCHS = ("mamba2-370m", "jamba-v0.1-52b")
D_MODEL = 48
B, S, STEPS = 4, 8, 3
TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _reference_dir() -> str:
    out = tempfile.mkdtemp(prefix="ref_ssm_")
    run_reference(f"""
        import dataclasses, os
        import numpy as np, jax, jax.numpy as jnp
        from repro import sharding
        from repro.compat import make_mesh
        from repro.configs import get_config
        from repro.models import build_model
        from repro.models.model import ShardCtx

        def flat(tree, prefix=""):
            res = {{}}
            for k, v in tree.items():
                key = prefix + "/" + k if prefix else k
                if isinstance(v, dict):
                    res.update(flat(v, key))
                else:
                    res[key] = np.asarray(v)
            return res

        out = {out!r}
        mesh = make_mesh((1, 4), ("data", "model"))
        ctx = ShardCtx(mesh, sharding.make_rules())
        rng = np.random.default_rng(0)
        for arch in {ARCHS!r}:
            cfg = dataclasses.replace(get_config(arch, smoke=True),
                                      dtype="float32", d_model={D_MODEL})
            model = build_model(cfg)
            params = model.init(jax.random.PRNGKey(0))
            toks = rng.integers(1, cfg.vocab_size, ({B}, {S})).astype(
                np.int32)
            forced = rng.integers(1, cfg.vocab_size,
                                  ({STEPS}, {B})).astype(np.int32)
            lg, caches = model.prefill(params, {{"tokens": jnp.asarray(toks)}},
                                       cache_len={S + STEPS}, ctx=ctx)
            lgs = [np.asarray(lg, np.float32)]
            for t in range({STEPS}):
                lg, caches = model.decode_step(
                    params, caches, jnp.asarray(forced[t])[:, None],
                    jnp.full(({B},), {S} + t, jnp.int32), ctx)
                lgs.append(np.asarray(lg, np.float32))
            np.savez(os.path.join(out, arch + "_params.npz"), **flat(params))
            np.savez(os.path.join(out, arch + ".npz"), toks=toks,
                     forced=forced, logits=np.stack(lgs))
    """, n_devices=4)
    return out


def _worker(rank, world, ref_dir):
    import torch
    from repro_torch import sharding
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models import build_model, convert
    from test_torch_shard_lm import _load_tree
    mesh = make_lm_mesh(1, world, device="cpu")
    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32", d_model=D_MODEL)
        m = build_model(cfg, device="cpu", seed=None, mesh=mesh,
                        rules=sharding.make_rules())
        convert.load_reference_params(
            m, _load_tree(os.path.join(ref_dir, arch + "_params.npz")))
        data = np.load(os.path.join(ref_dir, arch + ".npz"))
        toks = torch.as_tensor(data["toks"], dtype=torch.long)
        forced = torch.as_tensor(data["forced"], dtype=torch.long)
        lg, caches = m.prefill({"tokens": toks}, S + STEPS)
        lgs = [m.ctx.full(lg).float()]
        for t in range(STEPS):
            lg, caches = m.decode_step(caches, forced[t][:, None],
                                       torch.full((B,), S + t))
            lgs.append(m.ctx.full(lg).float())
        out[arch] = {"logits": torch.stack(lgs).numpy(),
                     "placements": {k: tuple(map(repr, v.placements))
                                    for k, v in caches.items()}}
    return out


@functools.lru_cache(maxsize=None)
def _port() -> list:
    return run_gloo(_worker, 4, _reference_dir())


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_heads_the_model_axis_does_not_divide(arch):
    got = _port()
    want = np.load(os.path.join(_reference_dir(), arch + ".npz"))["logits"]
    pl = got[0][arch]["placements"]
    # the layout the repair is for: channels sharded, heads replicated
    assert pl["conv_x"] == ("Shard(dim=1)", "Shard(dim=3)")
    assert pl["state"] == ("Shard(dim=1)", "Replicate()")
    for r in got:
        assert np.array_equal(r[arch]["logits"], got[0][arch]["logits"])
    scale = np.abs(want).max()
    assert np.abs(got[0][arch]["logits"] - want).max() <= TOL * scale
