"""Mining meshes and the multi-process launch, on ``torch.distributed``.

A :class:`MiningMesh` is the port's counterpart of the reference's 2-D
``(data, cand)`` device mesh (DESIGN.md §11): ``n_data × n_cand`` **cells**,
each counting one candidate shard against one transaction shard.  The cells
are numbered row-major (data-major), the order of the reference's
``make_mesh`` devices; a process holds an equal, contiguous block of them.

**One process drives one card.**  The CUDA kernels launch on the current
device's stream and keep per-process state (the SM count, the raised
shared-memory limits) for one card, so every cell of a process lies on that
process's one device.  Several cells on one device stand in for the
reference's ``--xla_force_host_platform_device_count`` (the CPU tests and a
one-card smoke run use them); several cards means several processes, one
card each — ``torchrun``'s layout, where :func:`init_distributed` selects
``LOCAL_RANK``'s card before anything launches.  A mesh takes one device,
and a card other than the process's current one raises.

The LM meshes (the reference's ``make_production_mesh`` and its
``make_mesh((data, model), ("data", "model"))``) are ``DeviceMesh``es over
the default process group, axes named as the reference names them, the
processes numbered as the reference numbers its devices (row-major): one
process drives one card here too.  ``make_lm_mesh`` builds an
``(n_data, n_model)`` mesh, ``make_data_mesh`` the reference's
``make_local_mesh(axis)`` as a 1-D mesh over every process, and
``make_production_mesh`` the 16×16 and 2×16×16 shapes; :func:`make_local_mesh`
stays mining's one-cell mesh.

Importing this module touches no device and starts no process group; the
functions do, when called.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import warnings

import torch
import torch.distributed as dist

from repro_torch.core.mapreduce import resolve_device

ONE_CARD_RULE = ("one process drives one card: all of a process's mesh cells "
                 "lie on its one device (run one process per card)")


@dataclasses.dataclass(frozen=True)
class MiningMesh:
    """``n_data × n_cand`` cells over the ``world`` processes of the
    default process group; this process (``rank``) holds cells
    ``rank·k … rank·k + k − 1`` (``k`` = ``cells_per_process``), all on
    ``device``."""
    n_data: int
    n_cand: int
    device: torch.device
    rank: int = 0
    world: int = 1

    def __post_init__(self):
        if self.n_data < 1 or self.n_cand < 1:
            raise ValueError(f"mesh split {self.n_data}x{self.n_cand} needs "
                             f"at least one shard on each axis")
        if self.size % self.world:
            raise ValueError(f"{self.size} cells do not split evenly over "
                             f"{self.world} processes")
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} outside a world of "
                             f"{self.world}")

    @property
    def size(self) -> int:
        return self.n_data * self.n_cand

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "cand": self.n_cand}

    @property
    def cells_per_process(self) -> int:
        return self.size // self.world

    @property
    def cells(self) -> tuple:
        """This process's cells as ``(data index, cand index)`` pairs."""
        k = self.cells_per_process
        return tuple(divmod(i, self.n_cand)
                     for i in range(self.rank * k, (self.rank + 1) * k))

    def reshaped(self, n_data: int, n_cand: int) -> "MiningMesh":
        """The same processes and device as an ``(n_data, n_cand)`` split."""
        if n_data * n_cand != self.size:
            raise ValueError(f"split {n_data}x{n_cand} != {self.size} devices")
        return dataclasses.replace(self, n_data=n_data, n_cand=n_cand)


def _process_device(device) -> torch.device:
    """``device`` as the device of this process's cells.  A card must be the
    process's own, the current one (``torch.cuda.set_device``, which
    :func:`init_distributed` calls): a process that named a second card
    would launch there with the first card's per-process kernel state, so
    that raises ValueError (the one-card rule)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        card = torch.cuda.current_device()
        if dev.index != card:
            raise ValueError(f"mesh device {dev} is not this process's card "
                             f"cuda:{card}: {ONE_CARD_RULE}")
    return dev


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def _device_mesh(shape: tuple, names: tuple, device):
    """A ``DeviceMesh`` of ``shape`` over the default group, on ``device``'s
    type; the group must hold exactly that many processes.  A cuda mesh
    over ``gloo`` warns: it is a test layout (several processes on one
    card), whose harness must route DTensor's gathers itself."""
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    world = _world()
    if world != n:
        raise ValueError(
            f"a {'x'.join(map(str, shape))} {names} mesh needs {n} processes "
            f"(one a card); the process group holds {world}")
    if not dist.is_initialized():
        raise RuntimeError("start the process group first "
                           "(init_distributed, or torchrun)")
    dev = resolve_device(device)
    if dev.type == "cuda" and dist.get_backend() == "gloo":
        warnings.warn(
            "a cuda mesh over gloo: DTensor's functional all-gather of card "
            "tensors over gloo has crashed the process (torch 2.11); use "
            "nccl, one card a process", RuntimeWarning, stacklevel=3)
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_lm_mesh(n_data: int | None = None, n_model: int = 1,
                 device="cuda"):
    """The ``(data, model)`` LM mesh over every process of the default
    group (the reference's ``make_mesh((n_data, n_model), ("data",
    "model"))``); ``n_data`` defaults to ``world // n_model``."""
    world = _world()
    if n_data is None:
        if world % n_model:
            raise ValueError(f"{n_model} model shards do not divide "
                             f"{world} processes")
        n_data = world // n_model
    return _device_mesh((n_data, n_model), ("data", "model"), device)


def make_data_mesh(axis: str = "data", device="cuda"):
    """A 1-D mesh over every process (the reference's
    ``make_local_mesh(axis)``)."""
    return _device_mesh((_world(),), (axis,), device)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """16×16 single-pod (256 processes) or 2×16×16 two-pod (512) mesh.

    Axes: (data, model) single-pod; (pod, data, model) multi-pod — the pod
    axis folds into data parallelism (``sharding.physical_axis``).  Raises
    with the count it needs unless the process group holds that many."""
    shape, names = PRODUCTION_MESHES[multi_pod]
    return _device_mesh(shape, names, device)


# multi_pod → (shape, axis names) of the reference's production meshes
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_local_mesh(device="cuda") -> MiningMesh:
    """One cell on ``device``, this process alone (no collectives) — the
    runtime's default mesh."""
    return MiningMesh(1, 1, _process_device(device))


def make_mining_mesh(n_data: int | None = None, n_cand: int = 1,
                     cells_per_process: int = 1,
                     device="cuda") -> MiningMesh:
    """2-D ``(data, cand)`` mining mesh over every process of the default
    group (DESIGN.md §11), ``cells_per_process`` cells each.

    ``n_data`` defaults to ``cells // n_cand``; the product must equal the
    total cell count.  ``n_cand == 1`` still builds the 2-D mesh — the
    runtime treats a size-1 cand axis as candidate replication, and the
    elastic repartitioner can widen it later.  ``device`` is this process's
    device, which holds all of its cells.
    """
    if cells_per_process < 1:
        raise ValueError(f"cells_per_process must be >= 1, got "
                         f"{cells_per_process}")
    if n_cand < 1:
        raise ValueError(f"n_cand must be >= 1, got {n_cand}")
    dev = _process_device(device)
    distributed = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if distributed else 1
    rank = dist.get_rank() if distributed else 0
    n_cells = world * cells_per_process
    if n_data is None:
        if n_cells % n_cand:
            raise ValueError(f"{n_cand} candidate shards do not divide "
                             f"{n_cells} devices")
        n_data = n_cells // n_cand
    if n_data * n_cand != n_cells:
        raise ValueError(f"mesh split {n_data}x{n_cand} != {n_cells} devices")
    return MiningMesh(n_data, n_cand, dev, rank=rank, world=world)


def _env_int(name: str) -> int | None:
    val = os.environ.get(name)
    return int(val) if val not in (None, "") else None


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None, *, device="cuda",
                     timeout: float | None = None) -> bool:
    """Join the process group of a multi-process mining run (DESIGN.md §11).

    Configuration comes from the arguments or, when unset, ``torchrun``'s
    environment: ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``
    and ``LOCAL_RANK``.  ``coordinator`` is ``host:port`` of process 0 or an
    init URL (``tcp://…``, ``file://…``).  With neither a coordinator nor
    more than one process this is a no-op returning False, so every CLI can
    call it unconditionally.

    ``backend=None`` picks ``nccl`` for ``device="cuda"`` and ``gloo`` for
    ``"cpu"``, and prints the choice; no backend is tried after another
    fails.  On a card the process first selects its card: the index of
    ``device`` when it names one (``"cuda:0"`` puts every process on card
    0, as a ``gloo`` run of several processes on one card needs), else
    ``LOCAL_RANK``, else ``process_id`` modulo the visible cards.  ``timeout`` (seconds) bounds
    every collective.  Returns True when the group is up.
    """
    if dist.is_available() and dist.is_initialized():
        return True
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE") or 0
    if process_id is None:
        process_id = _env_int("RANK") or 0
    if not coordinator or num_processes <= 1:
        return False
    dev = torch.device(device)
    why = "as given"
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        why = f"the default for {dev.type}"
    if dev.type == "cuda":
        local = dev.index if dev.index is not None else _env_int("LOCAL_RANK")
        if local is None:
            local = process_id % max(torch.cuda.device_count(), 1)
        torch.cuda.set_device(local)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    print(f"distributed: process {process_id} of {num_processes}, backend "
          f"{backend} ({why}), "
          f"init {url}", flush=True)
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id,
                            **kwargs)
    return True


def init_single_process(device="cuda", backend: str | None = None) -> bool:
    """A process group of this process alone (an in-memory store, no
    network), so a one-process run can build a mesh; ``nccl`` on a card
    and ``gloo`` on the CPU unless ``backend`` names one.  Returns False
    where a group is already up."""
    if dist.is_initialized():
        return False
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    return True


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
