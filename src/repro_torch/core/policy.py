"""Pass-combining width policies — shared by the mining drivers, the serving
engine's multi-step decode fusion, and the training loop's microbatch fusion.

Each policy decides, from the statistics of the two preceding phases, either a
fixed number of passes for the next phase (``width``) or a candidate budget
(``budget``).  These are line-by-line transcriptions of the paper's drivers:

  SPC    — width 1 always.
  FPC    — fixed width (default 3).                        [Lin et al., baseline]
  DPC    — budget ct = α·|L|, α from the previous phase's absolute elapsed
           time vs threshold β.                            [Lin et al., baseline]
  VFPC   — width 2 while per-phase candidate counts are non-decreasing, then
           width += 3 per phase (reset to 2 on an increase).   [paper Alg. 3]
  ETDPC  — budget ct = α·|L|, α from the *relative* elapsed times of the two
           preceding phases (β₁, β₂ scaled thresholds).        [paper Alg. 4]

Elapsed-time thresholds are the paper's 40 s / 60 s / 60 s multiplied by
``time_scale`` (default 1e-3): XLA dispatch overhead is ~1000× smaller than
Hadoop job scheduling, and the paper's own point is that only *relative* times
are trustworthy — which is exactly what survives the rescaling.

Beyond the paper, ``measured`` (MeasuredPolicy) replaces the transcribed
β-threshold tables with predictions from the calibrated cost model
(``repro_torch/costmodel/``, DESIGN.md §9); the five paper policies stay bit-exact
as baselines.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class PhaseStats:
    """What a policy is allowed to observe about a completed phase."""
    n_candidates: int          # total candidates generated in the phase
    n_frequent_last: int       # |L| of the phase's last level (paper's |L_{k-1}|)
    elapsed: float             # wall-clock seconds of the phase


class Policy:
    """Base: subclasses implement ``decide`` → ("width", n) or ("budget", ct)."""

    def decide(self, prev: PhaseStats | None, prev2: PhaseStats | None):
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__


class SPCPolicy(Policy):
    def decide(self, prev, prev2):
        return ("width", 1)


class FPCPolicy(Policy):
    def __init__(self, npass: int = 3):
        self.npass = npass

    def decide(self, prev, prev2):
        return ("width", self.npass)


class DPCPolicy(Policy):
    """Lin et al.'s DPC: α > 1 iff previous phase was 'fast' vs absolute β."""

    def __init__(self, alpha_fast: float = 2.0, beta: float = 60.0,
                 time_scale: float = 1e-3):
        self.alpha_fast = alpha_fast
        self.beta = beta * time_scale

    def decide(self, prev, prev2):
        if prev is None:
            return ("budget_alpha", 1.0)
        alpha = self.alpha_fast if prev.elapsed < self.beta else 1.0
        return ("budget_alpha", alpha)


class VFPCPolicy(Policy):
    """Paper Algorithm 3 driver lines 10–16."""

    def __init__(self):
        self._npass = 2

    def decide(self, prev, prev2):
        if prev is None or prev2 is None:
            self._npass = 2
        elif prev.n_candidates < prev2.n_candidates:
            self._npass += 3
        else:
            self._npass = 2
        return ("width", self._npass)


class ETDPCPolicy(Policy):
    """Paper Algorithm 4 driver lines 13–22."""

    def __init__(self, beta1: float = 40.0, beta2: float = 60.0,
                 time_scale: float = 1e-3):
        self.beta1 = beta1 * time_scale
        self.beta2 = beta2 * time_scale

    def decide(self, prev, prev2):
        if prev is None:
            return ("budget_alpha", 1.0)
        et = prev.elapsed
        etprev = prev2.elapsed if prev2 is not None else et
        if etprev < et:
            if et <= self.beta1:
                alpha = 3.0
            elif et < self.beta2:
                alpha = 2.0
            else:
                alpha = 1.0
        else:
            alpha = 3.0 if etprev >= 1.5 * et else 2.0
        return ("budget_alpha", alpha)


class MeasuredPolicy(Policy):
    """Beyond-paper ``measured`` variant: width from the calibrated cost
    model (DESIGN.md §9) instead of transcribed β thresholds.

    Delegates to :meth:`repro_torch.costmodel.CostController.choose_width`, which
    minimizes predicted cost per Apriori level — one fitted job overhead
    amortized over ``w`` fused passes vs the un-pruned counting work they
    add.  Until the model has observed at least one counting job the paper's
    ETDPC table decides (the thresholds are a sane uncalibrated prior and the
    first phase needs *some* answer); every later decision is prediction-
    driven and recorded in the controller's telemetry.

    The paper-faithful policies above are deliberately untouched: they remain
    bit-identical baselines (``tests/test_policies.py`` pins their decision
    tables line-by-line against the pseudo-code).
    """

    def __init__(self, controller=None, max_width: int = 3,
                 time_scale: float = 1e-3):
        from repro_torch.costmodel import CostController
        self.controller = (controller if controller is not None
                           else CostController(max_width=max_width))
        self._fallback = ETDPCPolicy(time_scale=time_scale)

    def decide(self, prev, prev2):
        width = self.controller.choose_width(prev, prev2)
        if width is None:
            return self._fallback.decide(prev, prev2)
        # budget semantics, not a raw width: generation stops once α·|L|
        # candidates are spent, so a mispredicted lattice explosion costs at
        # most the work the model already priced in
        return ("budget_alpha", width)


ALGORITHMS = {
    "spc": (SPCPolicy, False),
    "fpc": (FPCPolicy, False),
    "dpc": (DPCPolicy, False),
    "vfpc": (VFPCPolicy, False),
    "etdpc": (ETDPCPolicy, False),
    "optimized_vfpc": (VFPCPolicy, True),
    "optimized_etdpc": (ETDPCPolicy, True),
    # beyond-paper: calibrated cost-model widths (skipped pruning, like the
    # paper's best optimized_* drivers it competes with in bench_costmodel)
    "measured": (MeasuredPolicy, True),
}
