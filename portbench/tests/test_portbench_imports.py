"""No run loads JAX or the JAX package ``repro``, judged by whole top-level
module names: ``repro_torch`` is the port and is allowed."""

import os
import subprocess
import sys
import types

from portbench.harness import env

RUN_ON_CPU = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
from portbench.tests.helpers import context, run
man, ctx = context("mine.mushroom", seconds=0.2)
assert run(man, ctx)["correct"]
man, ctx = context("serve.mushroom-4t", seconds=0.2)
assert run(man, ctx)["correct"]
from portbench.harness import env
import portbench.control, portbench.sweep
print("LOADED", env.forbidden_modules())
"""


def test_a_run_loads_neither_jax_nor_repro():
    code = RUN_ON_CPU.format(root=env.ROOT, src=os.path.join(env.ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=env.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout


def test_the_check_compares_whole_top_level_names(monkeypatch):
    for name in ("repro_torch_extra", "reprox", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not [m for m in env.forbidden_modules()
                if m.startswith(("repro_torch_extra", "reprox", "jaxtyping"))]
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert {"repro.core", "jax"} <= set(env.forbidden_modules())
