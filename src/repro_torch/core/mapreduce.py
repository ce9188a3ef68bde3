"""Single-device MapReduce runtime on a torch device.

Hadoop concept → this runtime (the reference's mapping, on one device):

* InputSplit            → the whole database, placed once on the device
* Mapper + Combiner     → the support-count kernel over the device's rows
* shuffle + Reducer     → the identity: with one device the reference's
                          ``psum`` over ``data`` adds nothing
* one MapReduce *job*   → one dispatch of the counting kernel

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

The reference's 2-D ``(data, cand)`` mesh and its repartitioning wait for the
port's mesh slice: here ``mesh_split`` is ``(1, 1)`` and ``can_repartition``
is False.

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
    repartitions: int = 0       # always 0 on one device
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


class CountFuture:
    """Handle for one in-flight counting job.

    The job runs on the runtime's CUDA stream; ``ready()`` asks its event
    without blocking, and ``result()`` waits on the event, then copies the
    results to the host.  On the CPU the job has already run.

    ``result()`` returns host counts ``(C,) int64`` for a plain job, or a
    ``(keep_mask (C,) bool, counts (C,) int64)`` pair for a fused job (counts
    are zeroed where the device filter dropped the candidate; ``None`` when
    the job was dispatched with ``with_counts=False``).
    """

    def __init__(self, runtime: "MapReduceRuntime", raw, *, fused: bool,
                 with_counts: bool, n_rows: int,
                 event: torch.cuda.Event | None = None):
        self._rt = runtime
        self._raw = raw
        self._fused = fused
        self._with_counts = with_counts
        self._n = n_rows
        self._event = event
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
            stats = self._rt.stats
            if self._fused:
                packed = to_host_words(self._raw[0])
                stats.bytes_to_host += packed.nbytes
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
    """Support-counting runtime on one torch device.

    Args:
      impl: counting family — any of ``IMPLS``: "jnp" (horizontal
        popcount-AND), "matmul" (horizontal bit-plane matmul), "vertical"
        (vertical popcount-AND) or "vertical_matmul" (vertical membership
        matmul).  None/"auto": the cross-family autotune plan winner for the
        database's shape bucket, resolved at :meth:`scatter_db` time
        (``kernels/autotune.py``); the static fallback — on the CPU, with
        autotune off or before the scatter — is "vertical", the reference's
        choice off the TPU.
      device: "cuda" (default; raises without a card) or "cpu" (the kernels'
        plain versions).
      autotune: consult the cross-family plan for "auto"; False pins the
        static fallback.
    """

    def __init__(self, impl: str | None = None, device="cuda",
                 autotune: bool = True):
        self._auto_impl = impl is None or impl == "auto"
        if self._auto_impl:
            impl = "vertical"
        if impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r}; options: {IMPLS}")
        self.device = resolve_device(device)
        self.impl = impl
        self.autotune = autotune
        self.stats = RuntimeStats()
        self._shape_cache: set = set()
        self._n_items: int | None = None
        self._db_masks: np.ndarray | None = None  # host copy for re-scatter
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    n_data_shards = 1
    n_cand_shards = 1
    mesh_split = (1, 1)
    can_repartition = False

    @property
    def vertical(self) -> bool:
        return self.impl.startswith("vertical")

    # -- data distribution ---------------------------------------------------

    def scatter_db(self, db_masks: np.ndarray, n_items: int | None = None):
        """Place the database on the device.

        Horizontal impls get the (N, W) int32 words; vertical impls the
        (I+1, Tw) item-major bitmaps (built on the host once — the
        InputFormat step of the job).  The host copy is retained for
        :meth:`rescatter`."""
        self._db_masks = np.asarray(db_masks, dtype=np.uint32)
        if n_items is not None:
            self._n_items = n_items
        return self._scatter_current()

    def _scatter_current(self):
        t0 = time.perf_counter()
        if self._auto_impl and self.autotune and self._n_items is not None:
            # the cross-family plan winner at a representative phase shape;
            # counts are bit-exact across families, so the mining result is
            # the same whichever family wins
            from repro_torch.kernels.autotune import tuned_plan
            n, w = self._db_masks.shape
            rep_c = min(max(16 * self._n_items, 256), 4096)
            plan = tuned_plan("count", C=max(rep_c, 32), T=max(n, 1), W=w,
                              kmax=4, device=self.device)
            if plan is not None and plan["impl"] in IMPLS:
                self.impl = plan["impl"]
        if self.vertical:
            if self._n_items is None:
                raise ValueError("vertical impls need n_items in scatter_db")
            host = vertical_pack(self._db_masks, self._n_items)
        else:
            host = self._db_masks
        out = to_device_words(host, self.device)
        self.stats.scatter_seconds += time.perf_counter() - t0
        return out

    def rescatter(self):
        """Re-place the database from the host copy — the recovery step of
        the per-phase retry protocol (the analogue of HDFS re-reading an
        input split on task re-execution)."""
        if self._db_masks is None:
            raise RuntimeError("rescatter() requires a prior scatter_db()")
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

    def _job(self, db, payload, fused: bool, with_counts: bool,
             n_valid: int | None, thr: int | None):
        """Map + combine + (identity) reduce, then the fused filter."""
        if self.vertical:
            kind = self.impl[len("vertical"):].lstrip("_") or "jnp"
            counts = local_counts_vertical(db, payload, impl=kind)
        else:
            counts = local_counts(db, payload, self.impl)
        if not fused:
            return counts
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
        bucket-pad tail never crosses to the host.
        """
        fused = min_count is not None
        if self.vertical:
            payload = self._padded_indices(cands_padded)
        else:
            payload = np.asarray(cands_padded, dtype=np.uint32)
        if not fused:
            # unfused keeps the legacy full-padded transfer
            n_valid = None
        n_rows = int(cands_padded.shape[0]) if n_valid is None else int(n_valid)
        key = (fused, with_counts, n_valid, tuple(db_sharded.shape),
               payload.shape, self.impl)
        if key not in self._shape_cache:
            self._shape_cache.add(key)
            self.stats.compiles += 1
        # integer threshold: counts are ints, so >= ceil(min_count) is
        # exactly the host-side `counts >= min_count` float comparison
        thr = math.ceil(min_count) if fused else None
        event = None
        if self._stream is not None:
            # the job's stream must see the database and earlier uploads
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            db_sharded.record_stream(self._stream)
            ctx = torch.cuda.stream(self._stream)
        else:
            ctx = contextlib.nullcontext()
        with ctx:
            payload_t = (torch.from_numpy(payload).to(self.device)
                         if self.vertical
                         else to_device_words(payload, self.device))
            raw = self._job(db_sharded, payload_t, fused, with_counts,
                            n_valid, thr)
            if self._stream is not None:
                event = torch.cuda.Event()
                event.record(self._stream)
        self.stats.dispatches += 1
        self.stats.rows_counted += int(cands_padded.shape[0])
        if fused:
            self.stats.fused_dispatches += 1
        return CountFuture(self, raw, fused=fused, with_counts=with_counts,
                           n_rows=n_rows, event=event)

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
