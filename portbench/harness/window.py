"""The measured window, and what a traced window hands the metric readers.

Untraced, a window is two reads of the host clock around work that ends on
the host.  Traced, it also installs the port's span tracer
(``repro_torch.obs.trace``) and profiles the device (``devtrace``), and
:class:`Record` carries the spans, the driver's counters and the device's
activity to the readers in ``metrics/``.
"""

from __future__ import annotations

import dataclasses
import time

from . import devtrace
from .roofline import peaks


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Window:
    def __init__(self, device, trace: bool):
        self.device = device
        self.trace = trace
        self.tracer = None
        self.dev = None
        self.t0 = self.t1 = None

    def open(self) -> float:
        import torch
        from repro_torch.obs.trace import Tracer, set_tracer
        if self.trace:
            self.tracer = Tracer()
            if torch.device(self.device).type == "cuda":
                self.dev = devtrace.DeviceTrace()
                self.dev.start()
            set_tracer(self.tracer)
        sync(self.device)
        self.t0 = time.perf_counter()
        return self.t0

    def close(self) -> float:
        from repro_torch.obs.trace import set_tracer
        sync(self.device)
        self.t1 = time.perf_counter()
        if self.trace:
            set_tracer(None)
            if self.dev is not None:
                self.dev.stop()
        return self.t1

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def spans(self) -> list:
        """``(name, t0, t1, attrs)`` of every closed span on the host clock
        (the live track), and of every span the port recorded with times of
        its own (``tid`` other than ``main``) with ``clock="own"`` added."""
        out = []
        for s in (self.tracer.spans if self.tracer else []):
            if s.t1 is None:
                continue
            attrs = dict(s.attrs)
            if s.tid != "main":
                attrs["clock"] = "own"
            out.append((s.name, s.t0, s.t1, attrs))
        return out

    def chip(self) -> dict:
        """This process's device activity in the window: the events and
        their summary (busy seconds, top operations, idle by host span)."""
        if self.dev is None:
            return {"events": None, "busy_s": 0.0, "device_ops": [],
                    "idle_gaps": []}
        host = [s for s in self.spans() if s[3].get("clock") != "own"]
        summary = devtrace.summarize(self.dev.events, self.t0, self.t1, host)
        return {"events": self.dev.events, **summary}


@dataclasses.dataclass
class Record:
    """What a per-layer reader reads.

    ``spans``: host spans of process 0 (see :meth:`Window.spans`).
    ``counters``: the driver's counts over the window (``mines``,
    ``dispatches``, ``rows_counted``, ``frequent``; ``queries``, ``answered``,
    ``shed``, ``cached``, ``late_s``, ``latency_s``).
    ``chips``: each card's :meth:`Window.chip`.
    ``work``: the jobs the window ran, for the rooflines: ``("count", C, T,
    n_items)`` or ``("rules", Q, R, n_items, fetch)``.
    """
    spans: list
    counters: dict
    chips: list
    window_s: float
    work: list
    peaks: dict = dataclasses.field(default_factory=peaks)

    def span_seconds(self, name: str) -> float:
        """Host seconds in the spans called ``name``."""
        return sum(t1 - t0 for n, t0, t1, _ in self.spans if n == name)

    def idle_pct(self) -> float | None:
        """The share of the window in which no operation ran on the device,
        averaged over the cards; None without a device trace."""
        if not self.chips or self.chips[0]["events"] is None:
            return None
        busy = sum(c["busy_s"] for c in self.chips) / len(self.chips)
        return 100.0 * (1.0 - busy / self.window_s)

    def roofline_pct(self, kind: str, *patterns: str) -> float | None:
        """The least time of the window's ``kind`` work over the device time
        of the kernels named by ``patterns``, in percent; None where the
        trace holds no such kernel."""
        from .roofline import count_work, least_seconds, rule_work
        device = self.kernel_seconds(*patterns)
        if device <= 0:
            return None
        fn = {"count": count_work, "rules": rule_work}[kind]
        least = sum(least_seconds(*fn(*w[1:]), self.peaks)
                    for w in self.work if w[0] == kind)
        return 100.0 * least / device

    def kernel_seconds(self, *patterns: str) -> float:
        """Device seconds of the activities whose names hold a pattern,
        summed over the cards."""
        total = 0.0
        for chip in self.chips:
            if chip["events"] is None:
                continue
            names, _, dur = chip["events"]
            total += sum(d for n, d in zip(names, dur.tolist())
                         if any(p in n for p in patterns))
        return total
