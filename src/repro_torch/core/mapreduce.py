"""MapReduce runtime on a mesh of cells over torch devices.

Hadoop concept → this runtime (the reference's mapping, DESIGN.md §11):

* InputSplit            → equal transaction shards along the ``data`` axis
* Mapper + Combiner     → the support-count kernel of each cell over its
                          transaction shard (local sums never leave the device
                          uncombined)
* shuffle + Reducer     → the cells of one candidate shard summed on the
                          device, then one ``all_reduce`` across processes
* one MapReduce *job*   → one dispatch: every cell's kernel, then the reduce

The runtime counts dispatches: the paper's objective — minimizing the number
of scheduled jobs — maps to minimizing dispatches here.

Device-resident phase pipeline (DESIGN.md §4): a job can be dispatched

* **fused** — the ``count >= min_count`` filter runs on the device, so only a
  bit-packed keep mask (``C/8`` bytes) plus the filtered int32 counts cross
  back to the host;
* **async** — :meth:`MapReduceRuntime.phase_count_async` enqueues the job on
  the runtime's own CUDA stream, records an event and returns a
  :class:`CountFuture` at once; the host generates the next level's
  candidates while the card counts.

Meshes (DESIGN.md §11, :mod:`repro_torch.launch.mesh`): the runtime counts
on a 2-D ``(data, cand)`` mesh of cells — transaction shards along ``data``
and, with ``cand_axis``, candidate shards along ``cand``.  Each cell counts
its candidate shard against its transaction shard; the cells of a process
lie on its one device and share the runtime's stream.  The reduce over
``data`` sums a process's cells on the device, then one
``all_reduce(SUM)`` of the full-length count vector (each process fills the
candidate slices it counted, zeros elsewhere) gives every process the whole
result — the reference's ``psum`` over ``data`` and its gather over ``cand``
in one collective.  :meth:`MapReduceRuntime.repartition` re-lays the same
cells out as another split between levels, :meth:`MapReduceRuntime.rescatter`
re-places the shards from the host copy (the retry protocol's recovery).
Without a mesh the runtime is one cell on ``device``.

Every entry point takes an explicit ``device``; ``"cuda"`` is the default and
raises on a machine without a card instead of running on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.obs.metrics import get_registry

from .bitset import (WORD_BITS, popcount_rows, to_device_words, to_host_words,
                     vertical_pack, _wrap_int32)
from .counting import local_counts, local_counts_vertical

IMPLS = ("jnp", "matmul", "vertical", "vertical_matmul")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raise if it names a card that is not
    there (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch sees no CUDA device; pass "
            f"device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


@dataclasses.dataclass
class RuntimeStats:
    dispatches: int = 0
    compiles: int = 0           # distinct job shapes (the reference's compiles)
    rows_counted: int = 0       # candidates counted across all dispatches
    fused_dispatches: int = 0   # jobs that filtered on device
    overlap_seconds: float = 0.0  # host gen time spent while a job was in flight
    bytes_to_host: int = 0      # result bytes actually fetched from device
    repartitions: int = 0       # elastic mesh re-layouts (DESIGN.md §11)
    scatter_seconds: float = 0.0  # host time spent (re-)placing the database

    def __setattr__(self, name, value):
        # Mirror every increment into the process-wide metrics registry
        # (DESIGN.md §13) so `--metrics-out` snapshots see runtime counters
        # without touching the `stats.x += n` call sites.  Positive deltas
        # only: per-runtime stats reset, the registry accumulates.
        prev = getattr(self, name, None)
        if prev is not None:
            delta = value - prev
            if delta > 0:
                get_registry().counter(f"mine.{name}").inc(delta)
        object.__setattr__(self, name, value)


def _pack_mask(keep: torch.Tensor) -> torch.Tensor:
    """(n,) bool → (ceil(n/32),) int32 words, bit ``i%32`` of word ``i//32``
    = keep[i] (the reference's uint32 layout, as int32 bits)."""
    pad = (-keep.shape[0]) % WORD_BITS
    if pad:
        keep = torch.cat([keep, keep.new_zeros(pad)])
    b = keep.reshape(-1, WORD_BITS).to(torch.int64)
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=keep.device)
    return _wrap_int32((b << shifts).sum(dim=1))


def _unpack_mask(packed: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`_pack_mask` on host → (n,) bool."""
    bits = np.unpackbits(packed.view(np.uint8), bitorder="little")
    return bits[:n].astype(bool)


class ShardedDB:
    """The database as this process's cells hold it: one device tensor per
    data shard it counts (horizontal ``(T/d, W)`` words or vertical
    ``(I+1, Tw)`` bitmaps), keyed by data index.  ``shape`` is the
    reference's global shape: ``(T_padded, W)`` or ``(d, I+1, Tw)``."""

    def __init__(self, shards: dict, shape: tuple):
        self.shards = shards
        self.shape = shape


class CountFuture:
    """Handle for one in-flight counting job.

    The job runs on the runtime's CUDA stream; ``ready()`` asks its event
    without blocking, and ``result()`` waits on the event, then copies the
    results to the host.  On the CPU the job has already run.  On a mesh of
    several processes ``result()`` raises when a cell of another process
    failed the job (the reduce carries a failure flag).

    ``result()`` returns host counts ``(C,) int64`` for a plain job, or a
    ``(keep_mask (C,) bool, counts (C,) int64)`` pair for a fused job (counts
    are zeroed where the device filter dropped the candidate; ``None`` when
    the job was dispatched with ``with_counts=False``).
    """

    def __init__(self, runtime: "MapReduceRuntime", raw, *, fused: bool,
                 with_counts: bool, n_rows: int,
                 event: torch.cuda.Event | None = None, failed=None):
        self._rt = runtime
        self._raw = raw
        self._fused = fused
        self._with_counts = with_counts
        self._n = n_rows
        self._event = event
        self._failed = failed
        self._result = None
        self.wait_seconds = 0.0   # host time actually blocked in result()

    def ready(self) -> bool:
        """Non-blocking completion probe."""
        return self._event is None or self._event.query()

    def result(self):
        if self._result is None:
            t0 = time.perf_counter()
            if self._event is not None:
                self._event.synchronize()
            self.wait_seconds = time.perf_counter() - t0
            if self._failed is not None and int(self._failed):
                raise RuntimeError(f"a counting job failed on "
                                   f"{int(self._failed)} other process(es)")
            stats = self._rt.stats
            if self._fused:
                packed = to_host_words(self._raw[0])
                stats.bytes_to_host += packed.nbytes
                # candidate-sharded jobs pad rows to 32·n_cand, so the mask
                # is the per-shard masks concatenated at word boundaries
                keep = _unpack_mask(packed, self._n)
                counts = None
                if self._with_counts:
                    c = self._raw[1].cpu().numpy()
                    stats.bytes_to_host += c.nbytes
                    counts = c[:self._n].astype(np.int64)
                self._result = (keep, counts)
            else:
                c = self._raw.cpu().numpy()
                stats.bytes_to_host += c.nbytes
                self._result = c[:self._n].astype(np.int64)
            self._raw = None
        return self._result


class MapReduceRuntime:
    """Support-counting runtime over a ``(data, cand)`` mesh of cells.

    Args:
      mesh: a :class:`~repro_torch.launch.mesh.MiningMesh` —
        ``make_mining_mesh(n_data, n_cand, cells_per_process=…)`` for the
        2-D transaction×candidate decomposition (DESIGN.md §11).  None: one
        cell on ``device``.
      impl: counting family — any of ``IMPLS``: "jnp" (horizontal
        popcount-AND), "matmul" (horizontal bit-plane matmul), "vertical"
        (vertical popcount-AND) or "vertical_matmul" (vertical membership
        matmul).  None/"auto": the cross-family autotune plan winner for the
        database's *per-shard* shape bucket, resolved at :meth:`scatter_db`
        time (``kernels/autotune.py``); the static fallback — on the CPU,
        with autotune off or before the scatter — is "vertical", the
        reference's choice off the TPU.
      cand_axis: "cand" to shard *candidates* over the mesh's cand axis too
        (beyond-paper, DESIGN.md §11).  None replicates candidates, as in
        the paper: the cells of cand index > 0 then hold replicas and count
        nothing.
      device: "cuda" (default; raises without a card) or "cpu" (the kernels'
        plain versions); used when ``mesh`` is None, else the mesh's device.
      autotune: consult the cross-family plan for "auto"; False pins the
        static fallback.
    """

    def __init__(self, mesh=None, impl: str | None = None,
                 cand_axis: str | None = None, device="cuda",
                 autotune: bool = True):
        self._auto_impl = impl is None or impl == "auto"
        if self._auto_impl:
            impl = "vertical"
        if impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r}; options: {IMPLS}")
        if mesh is None:
            from repro_torch.launch.mesh import make_local_mesh
            mesh = make_local_mesh(device)
        if cand_axis is not None and cand_axis not in mesh.shape:
            raise ValueError(f"cand_axis {cand_axis!r} not in mesh axes "
                             f"{tuple(mesh.shape)}")
        self.mesh = mesh
        self.device = mesh.device
        self.impl = impl
        self.cand_axis = cand_axis
        self.autotune = autotune
        self.stats = RuntimeStats()
        self._shape_cache: set = set()
        self._n_items: int | None = None
        self._db_masks: np.ndarray | None = None  # host copy for re-scatter
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    @property
    def n_data_shards(self) -> int:
        return self.mesh.n_data

    @property
    def n_cand_shards(self) -> int:
        return self.mesh.n_cand if self.cand_axis else 1

    @property
    def mesh_split(self) -> tuple[int, int]:
        """(n_data, n_cand) — the current transaction×candidate split."""
        return (self.n_data_shards, self.n_cand_shards)

    @property
    def vertical(self) -> bool:
        return self.impl.startswith("vertical")

    @property
    def can_repartition(self) -> bool:
        """True once a database has been scattered, so :meth:`repartition`
        can rebuild the split from the retained host copy."""
        return self._db_masks is not None

    def _cells(self) -> list:
        """This process's counting cells: all of them with candidate
        sharding, else those of cand index 0 (the others are replicas)."""
        return [(d, c) for d, c in self.mesh.cells
                if self.cand_axis or c == 0]

    @property
    def cells_per_device(self) -> int:
        """The counting cells this process's device runs, one after another,
        in each job."""
        return len(self._cells())

    # -- agreement across processes -----------------------------------------

    def agree(self, value):
        """Process 0's ``value`` on every process of the mesh; the value
        itself on one process.  Every process must call it at the same
        point: decisions priced from a process's own timings (policy widths,
        the mesh split, shard balance) are taken from process 0."""
        if self.mesh.world == 1:
            return value
        box = [value]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def any_process(self, flag: bool) -> bool:
        """True on every process when ``flag`` is true on any of them (one
        ``all_reduce(MAX)``); ``flag`` itself on one process."""
        if self.mesh.world == 1:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                         device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    # -- data distribution ---------------------------------------------------

    def scatter_db(self, db_masks: np.ndarray, n_items: int | None = None):
        """Zero-pad rows to the shard multiple and place this process's
        data shards on its device.

        Horizontal impls get (T/d, W) int32 words a shard; vertical impls
        (I+1, Tw) item-major bitmaps a shard (packed on the host, one shard
        at a time — the InputFormat step of the job).  One cell returns its
        tensor, a mesh a :class:`ShardedDB`.  The unpadded host copy is
        retained for :meth:`repartition`/:meth:`rescatter`."""
        self._db_masks = np.asarray(db_masks, dtype=np.uint32)
        if n_items is not None:
            self._n_items = n_items
        return self._scatter_current()

    def _scatter_current(self):
        """(Re-)place the retained database on the current mesh."""
        db_masks = self._db_masks
        n, w = db_masks.shape
        t0 = time.perf_counter()
        if self._auto_impl and self.autotune and self._n_items is not None:
            # the cross-family plan winner at a representative *per-shard*
            # phase shape — each cell counts C/n_cand candidates against
            # T/n_data transactions; counts are bit-exact across families,
            # so the mining result is the same whichever family wins
            from repro_torch.kernels.autotune import tuned_plan
            rep_c = min(max(16 * self._n_items, 256), 4096)
            plan = tuned_plan("count", C=max(rep_c // self.n_cand_shards, 32),
                              T=max(n // self.n_data_shards, 1), W=w, kmax=4,
                              device=self.device)
            if plan is not None and plan["impl"] in IMPLS:
                self.impl = plan["impl"]
            # each process timed its own card: count with process 0's winner
            self.impl = self.agree(self.impl)
        if self.vertical and self._n_items is None:
            raise ValueError("vertical impls need n_items in scatter_db")
        if self.mesh.size == 1:
            out = to_device_words(self._pack(db_masks), self.device)
        else:
            d = self.n_data_shards
            pad = (-n) % d
            if pad:
                db_masks = np.concatenate(
                    [db_masks, np.zeros((pad, w), np.uint32)], axis=0)
            per = db_masks.shape[0] // d
            shards = {i: to_device_words(
                          self._pack(db_masks[i * per:(i + 1) * per]),
                          self.device)
                      for i in sorted({di for di, _ in self._cells()})}
            shape = ((d, self._n_items + 1, -(-per // WORD_BITS))
                     if self.vertical else db_masks.shape)
            out = ShardedDB(shards, tuple(shape))
        self.stats.scatter_seconds += time.perf_counter() - t0
        return out

    def _pack(self, rows: np.ndarray) -> np.ndarray:
        """One shard's host layout: the rows, or their vertical bitmaps."""
        return vertical_pack(rows, self._n_items) if self.vertical else rows

    def rescatter(self):
        """Re-place the shards from the host copy on the *same* mesh — the
        recovery step of the per-phase retry protocol (the analogue of HDFS
        re-reading an input split on task re-execution)."""
        if self._db_masks is None:
            raise RuntimeError("rescatter() requires a prior scatter_db()")
        return self._scatter_current()

    def repartition(self, n_data: int, n_cand: int = 1):
        """Elastically re-layout as an ``(n_data, n_cand)`` split of the same
        cells and re-scatter the retained database (DESIGN.md §11).

        Candidate counts explode between Apriori levels (k=2→3 especially),
        so the best split is per-level, not per-run: the cost-model
        controller prices the next phase's (C, T) extents and calls this
        between levels.  Returns the new database handle.
        """
        if not self.can_repartition:
            raise RuntimeError("repartition() needs a scatter_db'd database")
        if n_data * n_cand != self.mesh.size:
            raise ValueError(f"split {n_data}x{n_cand} != {self.mesh.size} "
                             f"devices")
        if (n_data, n_cand) != self.mesh_split:
            self.mesh = self.mesh.reshaped(n_data, n_cand)
            self.cand_axis = "cand" if n_cand > 1 else None
            self.stats.repartitions += 1
        return self._scatter_current()

    # -- one MapReduce job ----------------------------------------------------

    def _padded_indices(self, masks: np.ndarray) -> np.ndarray:
        """(C, W) masks (zero rows allowed) → (C, kmax) item ids padded with
        the valid-mask sentinel row (AND identity)."""
        sentinel = self._n_items
        pc = popcount_rows(masks)
        kmax = max(int(pc.max()) if pc.size else 1, 1)
        C = masks.shape[0]
        shifts = np.arange(WORD_BITS, dtype=np.uint32)
        bits = ((masks[:, :, None] >> shifts[None, None, :]) & np.uint32(1))
        bits = bits.reshape(C, -1).astype(bool)
        rows, cols = np.nonzero(bits)
        idx = np.full((C, kmax), sentinel, np.int32)
        starts = np.zeros(C + 1, np.int64)
        np.cumsum(pc, out=starts[1:])
        idx[rows, np.arange(rows.size) - starts[rows]] = cols
        return idx

    def _count(self, db, payload):
        """Map + combine of one cell: its kernel over its shard."""
        if self.vertical:
            kind = self.impl[len("vertical"):].lstrip("_") or "jnp"
            return local_counts_vertical(db, payload, impl=kind)
        return local_counts(db, payload, self.impl)

    def _map_combine(self, db, payload):
        """Every local cell's counts: ``(C,) int32`` on one cell; on a mesh
        ``(C + 1,) int32``, each counting cell's candidate slice summed over
        its data shards, zeros elsewhere, and a zero failure flag last."""
        if self.mesh.size == 1:
            return self._count(db, payload)
        C = payload.shape[0]
        per = C // self.n_cand_shards
        vec = torch.zeros(C + 1, dtype=torch.int32, device=self.device)
        for d, c in self._cells():
            rows = slice(c * per, (c + 1) * per)
            vec[rows] += self._count(db.shards[d], payload[rows])
        return vec

    def _reduce(self, vec):
        """The reduce over ``data`` (and the gather over ``cand``) across
        processes: ``(counts (C,), failed)`` with the same counts on every
        process, and ``failed`` the number of other processes whose part of
        the job raised (None on one process)."""
        if self.mesh.size == 1:
            return vec, None
        if self.mesh.world > 1:
            dist.all_reduce(vec)
            return vec[:-1], vec[-1]
        return vec[:-1], None

    def _join_failed(self, n_rows: int) -> None:
        """Join the job's reduce with the failure flag set and no counts, so
        no other process waits on a collective this one skipped; they fail
        the job from the flag.  Nothing to join on one process."""
        if self.mesh.world == 1:
            return
        vec = torch.zeros(n_rows + 1, dtype=torch.int32, device=self.device)
        vec[n_rows] = 1
        dist.all_reduce(vec)

    def _filter(self, counts, fused: bool, with_counts: bool,
                n_valid: int | None, thr: int | None):
        """The fused filter on the device (the counts as they are when the
        job is not fused)."""
        if not fused:
            return counts
        if self.cand_axis:
            # every candidate shard keeps its full row extent — rows padded
            # to 32·n_cand — and masks validity from its global row offset
            # (shard·per + i < n_valid), so its packed mask ends on a word
            # boundary and the shards' masks concatenate into the global
            # bitstream: one pack over the concatenation is the same words
            keep = counts >= thr                   # filter, fused
            if n_valid is not None:
                keep &= torch.arange(counts.shape[0],
                                     device=counts.device) < n_valid
        else:
            if n_valid is not None:
                counts = counts[:n_valid]          # pad tail never leaves
            keep = counts >= thr                   # filter, fused
        mask = _pack_mask(keep)
        if with_counts:
            return mask, torch.where(keep, counts, 0)
        return (mask,)

    def phase_count_async(self, db_sharded, cands_padded: np.ndarray,
                          min_count: float | None = None,
                          with_counts: bool = True,
                          n_valid: int | None = None) -> CountFuture:
        """Dispatch one MapReduce job without waiting for it.

        When ``min_count`` is given the job is **fused**: the support filter
        runs on the device and only the packed keep mask (+ filtered counts
        unless ``with_counts=False``) is transferred when the returned
        :class:`CountFuture` is consumed — sliced on the device to
        ``n_valid`` rows (the real, pre-padding candidate count), so the
        bucket-pad tail never crosses to the host.  On a mesh of several
        processes every process must dispatch the same jobs in the same
        order: each job is one collective, which a process joins even when
        its own part of the job (payload, upload, cells) raised.
        """
        fused = min_count is not None
        n_rows = int(cands_padded.shape[0])
        if self.cand_axis is not None:
            # candidate-sharded jobs need rows divisible by the cand shards
            # AND per-shard rows on a 32-row word boundary, so the fused
            # per-shard keep masks bit-pack without intra-shard padding
            n_rows += (-n_rows) % (WORD_BITS * self.n_cand_shards)
        if not fused:
            # unfused keeps the legacy full-padded transfer
            n_valid = None
        # integer threshold: counts are ints, so >= ceil(min_count) is
        # exactly the host-side `counts >= min_count` float comparison
        thr = math.ceil(min_count) if fused else None
        # counted before the job runs: a job that fails on one process is
        # a dispatch on every process, as it is where the failure shows
        # only in the result
        self.stats.dispatches += 1
        self.stats.rows_counted += n_rows
        if fused:
            self.stats.fused_dispatches += 1
        event = None
        with contextlib.ExitStack() as ctx:
            try:
                if self._stream is not None:
                    # launch on this runtime's card, whatever the current
                    # one is
                    ctx.enter_context(torch.cuda.device(self.device))
                    # the job's stream must see the database and earlier
                    # uploads
                    self._stream.wait_stream(
                        torch.cuda.current_stream(self.device))
                    shards = (db_sharded.shards.values()
                              if isinstance(db_sharded, ShardedDB)
                              else [db_sharded])
                    for shard in shards:
                        shard.record_stream(self._stream)
                    ctx.enter_context(torch.cuda.stream(self._stream))
                pad = n_rows - cands_padded.shape[0]
                if pad:
                    cands_padded = np.concatenate(
                        [cands_padded,
                         np.zeros((pad, cands_padded.shape[1]), np.uint32)])
                if self.vertical:
                    payload = self._padded_indices(cands_padded)
                else:
                    payload = np.asarray(cands_padded, dtype=np.uint32)
                key = (fused, with_counts, n_valid, tuple(db_sharded.shape),
                       payload.shape, self.mesh_split, self.cand_axis,
                       self.impl)
                if key not in self._shape_cache:
                    self._shape_cache.add(key)
                    self.stats.compiles += 1
                payload_t = (torch.from_numpy(payload).to(self.device)
                             if self.vertical
                             else to_device_words(payload, self.device))
                vec = self._map_combine(db_sharded, payload_t)
            except Exception:
                self._join_failed(n_rows)
                raise
            counts, failed = self._reduce(vec)
            raw = self._filter(counts, fused, with_counts, n_valid, thr)
            if self._stream is not None:
                # recorded after the reduce: the event covers every cell's
                # kernels and the collective
                event = torch.cuda.Event()
                event.record(self._stream)
        out_rows = n_rows if n_valid is None else int(n_valid)
        return CountFuture(self, raw, fused=fused, with_counts=with_counts,
                           n_rows=out_rows, event=event, failed=failed)

    def phase_count(self, db_sharded, cands_padded: np.ndarray) -> np.ndarray:
        """Synchronous unfused job: host int64 counts for every padded row."""
        return self.phase_count_async(db_sharded, cands_padded).result()

    def phase_count_filtered(self, db_sharded, cands_padded: np.ndarray,
                             min_count: float, with_counts: bool = True,
                             n_valid: int | None = None):
        """Synchronous fused job → ``(keep_mask, filtered_counts_or_None)``."""
        return self.phase_count_async(db_sharded, cands_padded,
                                      min_count=min_count,
                                      with_counts=with_counts,
                                      n_valid=n_valid).result()
