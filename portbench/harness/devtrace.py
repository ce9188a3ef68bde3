"""The measured window's device trace, from ``torch.profiler``.

The profiler records CUDA activity only (kernels, copies, fills), so it adds
no host work per operator.  Two marker kernels, launched right after the host
reads its clock at the window's start and end, tie the device timestamps to
``time.perf_counter``: host spans and device intervals then share one clock,
and each idle gap on the device can be put down to the host span open at the
time.
"""

from __future__ import annotations

import time

import numpy as np

MARKER_CYCLES = 1000
NAME_CHARS = 160     # a kernel's name as the breakdown gives it


def _marker():
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda._sleep(MARKER_CYCLES)
    torch.cuda.synchronize()
    return t


def _kineto_events(prof) -> list:
    """``(name, start_ns, duration_ns)`` of every device activity."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns(), e.duration_ns()
        else:
            start, dur = e.start_us() * 1000, e.duration_us() * 1000
        out.append((e.name(), int(start), int(dur)))
    return out


class DeviceTrace:
    """Profile the device between :meth:`start` and :meth:`stop`."""

    def __init__(self):
        self._prof = None
        self.events = None          # (names list, start s, duration s)

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t_start = _marker()

    def stop(self) -> None:
        self._t_stop = _marker()
        self._prof.__exit__(None, None, None)
        ev = _kineto_events(self._prof)
        self._prof = None
        marks = [e for e in ev if "spin_kernel" in e[0] or "sleep" in e[0]]
        if len(marks) < 2:
            raise RuntimeError(
                f"the device trace holds {len(ev)} device events and no "
                f"pair of window markers")
        first, last = marks[0][1], marks[-1][1]
        # device ns → host seconds, by the two markers (drift included)
        scale = ((self._t_stop - self._t_start) / (last - first)
                 if last > first else 1e-9)
        body = [e for e in ev if first + marks[0][2] <= e[1] < last]
        names = [e[0] for e in body]
        start = np.array([self._t_start + (e[1] - first) * scale
                          for e in body])
        dur = np.array([e[2] * scale for e in body])
        self.events = (names, start, dur)


def union_busy(start: np.ndarray, dur: np.ndarray):
    """Merged busy intervals ``(starts, ends)`` of possibly overlapping
    device activities."""
    if start.size == 0:
        return np.zeros(0), np.zeros(0)
    order = np.argsort(start)
    s, e = start[order], start[order] + dur[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.nonzero(new)[0]
    ends = np.append(run_end[idx[1:] - 1], run_end[-1])
    return s[idx], ends


def summarize(events, t0: float, t1: float, spans: list) -> dict:
    """Busy seconds, the ten device operations that took most time, and the
    idle time by the innermost host span open at each gap's middle ("no
    span": the harness, or the port outside its spans)."""
    names, start, dur = events
    bs, be = union_busy(start, dur)
    bs, be = np.clip(bs, t0, t1), np.clip(be, t0, t1)
    busy = float((be - bs).sum())
    by_name: dict = {}
    for n, d in zip(names, dur.tolist()):
        by_name[n] = by_name.get(n, 0.0) + d
    ops = [(n[:NAME_CHARS], s) for n, s in
           sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    gap_s = np.concatenate([[t0], be])
    gap_e = np.concatenate([bs, [t1]])
    keep = gap_e > gap_s
    gap_s, gap_e = gap_s[keep], gap_e[keep]
    idle: dict = {}
    if spans:
        s0 = np.array([s[1] for s in spans])
        s1 = np.array([s[2] for s in spans])
        sn = [s[0] for s in spans]
        for a in range(0, gap_s.size, 256):
            mid = (gap_s[a:a + 256] + gap_e[a:a + 256]) / 2
            inside = ((s0[None, :] <= mid[:, None])
                      & (s1[None, :] >= mid[:, None]))
            inner = np.where(inside, s0[None, :], -np.inf).argmax(axis=1)
            for g, (m, i) in enumerate(zip(inside.any(axis=1), inner)):
                label = sn[i] if m else "no span"
                length = gap_e[a + g] - gap_s[a + g]
                idle[label] = idle.get(label, 0.0) + float(length)
    else:
        idle["no span"] = float((gap_e - gap_s).sum())
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
