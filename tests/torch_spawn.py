"""Helpers for the port's multi-process tests: ``gloo`` CPU processes of the
port (spawned, joined under a timeout) and a subprocess of the reference
on forced XLA host devices.  A worker that fails or outlives its timeout
fails the test; nothing is left running."""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import textwrap
import traceback

import torch.multiprocessing as mp

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
# threads a spawned process computes with (TORCH_SPAWN_THREADS overrides)
WORKER_THREADS = int(os.environ.get("TORCH_SPAWN_THREADS", "2"))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(fn, rank, world, port, args, outdir):
    import torch
    import torch.distributed as dist
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    # a fixed thread count, whatever the machine: the CPU matmuls block,
    # and so round, by their threads, and a failure must reproduce
    torch.set_num_threads(WORKER_THREADS)
    try:
        dist.init_process_group("gloo", rank=rank, world_size=world)
        out = fn(rank, world, *args)
        with open(os.path.join(outdir, f"r{rank}.pkl"), "wb") as f:
            pickle.dump(("ok", out), f)
    except BaseException:
        with open(os.path.join(outdir, f"r{rank}.pkl"), "wb") as f:
            pickle.dump(("err", traceback.format_exc()), f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_gloo(fn, world: int, *args, timeout: float = 240.0) -> list:
    """``fn(rank, world, *args)`` in ``world`` spawned processes of one
    ``gloo`` group; returns the ranks' results in order.  ``fn`` must be a
    module-level function (it is pickled)."""
    ctx = mp.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory() as outdir:
        procs = [ctx.Process(target=_worker,
                             args=(fn, r, world, port, args, outdir))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout)
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            if hung:
                raise AssertionError(f"ranks {hung} outlived {timeout} s")
            out = []
            for r in range(world):
                path = os.path.join(outdir, f"r{r}.pkl")
                if not os.path.exists(path):
                    raise AssertionError(
                        f"rank {r} died (exit {procs[r].exitcode})")
                with open(path, "rb") as f:
                    status, val = pickle.load(f)
                if status != "ok":
                    raise AssertionError(f"rank {r} failed:\n{val}")
                out.append(val)
            return out
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5)


def start_reference(code: str, n_devices: int) -> subprocess.Popen:
    """Start ``code`` in a subprocess of the reference on ``n_devices``
    forced XLA host devices (:func:`reference_output` waits for it)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def reference_output(proc: subprocess.Popen, timeout: float = 300.0) -> str:
    """The stdout of a :func:`start_reference` subprocess, which must exit
    0 within ``timeout`` seconds (it is killed otherwise)."""
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out + "\n" + err
    return out


def run_reference(code: str, n_devices: int, timeout: float = 300.0) -> str:
    """Run ``code`` in a subprocess of the reference on ``n_devices``
    forced XLA host devices; returns its stdout."""
    return reference_output(start_reference(code, n_devices), timeout)
