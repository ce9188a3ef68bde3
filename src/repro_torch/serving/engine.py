"""Serving engine: batched KV-cache decoding with **paper-policy dispatch fusion**.

The port's copy of the JAX package's ``serving/engine.py``.  The
isomorphism to the paper (DESIGN.md §3):

  Apriori pass              ≙ one decode step for the whole batch
  MapReduce job overhead    ≙ host sync + dispatch per step
  multi-pass phase          ≙ npass decode steps issued back to back, with no
                              host sync between them
  candidate count |C|       ≙ active (unfinished) requests × passes
  pruning step              ≙ per-step on-device EOS masking of finished rows
  skipped pruning           ≙ fused steps emit raw tokens; finished rows keep
                              "generating" and the phase-end host check trims them
  un-pruned candidates      ≙ tokens emitted past EOS — wasted work that cannot
                              corrupt output (trimmed like infrequent candidates)

Seven paper algorithms, same Policy objects as the mining drivers: spc (1 step
per dispatch), fpc (fixed), dpc, vfpc, etdpc and the optimized_* variants —
plus ``measured``, which fuses from the calibrated cost model (its
``decode`` fit) under an optional latency budget (DESIGN.md §9).

Where the reference compiles a phase into one ``jit`` dispatch with donated
caches, the port issues the phase's steps eagerly on the device's stream
under ``torch.inference_mode()``: the caches are updated in place, and the
phase's tokens stay on the device, in a tensor of their own, until the host
reads them.

With ``mesh`` and ``rules`` the model is placed on the mesh (the decode
profile is the reference's batched-serving layout), every process of the
mesh runs the same engine on the same prompts, the caches are DTensors,
and each greedy pick goes through ``sharded_greedy``: only (max, argmax)
pairs cross between processes, and every process gets the same tokens.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.policy import ALGORITHMS, PhaseStats
from repro_torch.models.model import Model, sharded_greedy


@dataclasses.dataclass
class ServePhaseRecord:
    phase_idx: int
    npass: int
    active_before: int
    tokens_emitted: int
    wasted_tokens: int          # emitted after a row's EOS (un-pruned analogue)
    elapsed: float


class ServeEngine:
    def __init__(self, model: Model, cache_len: int,
                 algorithm: str = "optimized_vfpc", mesh=None, rules=None,
                 policy_kwargs: dict | None = None, max_npass: int = 32,
                 pad_id: int = 0, pipeline_depth: int = 1,
                 latency_budget_ms: float | None = None, controller=None):
        """``pipeline_depth > 1`` (optimized engines only): keep that many
        fused phases in flight and read results one phase behind — the host
        EOS check ("pruning") lags the dispatch stream, trading a few more
        post-EOS tokens for zero host-sync bubbles between phases.

        ``algorithm="measured"`` fuses decode steps from the calibrated cost
        model (DESIGN.md §9): the widest phase whose predicted dispatch time
        fits ``latency_budget_ms`` (maximal fusion when no budget is set).
        ``controller`` shares a :class:`repro_torch.costmodel.CostController`;
        any engine given one calibrates its ``decode`` fit per dispatch,
        whatever its policy.  ``mesh`` and ``rules`` (the reference's
        sharding): the model is placed on the mesh (``Model.shard``) and
        serves under them."""
        if mesh is not None:
            model.shard(mesh, rules)
        self.ctx = model.ctx
        self.model = model
        self.device = model.device
        self.cache_len = cache_len
        policy_cls, self.optimized = ALGORITHMS[algorithm]
        self.algorithm = algorithm
        self.latency_budget_s = (None if latency_budget_ms is None
                                 else float(latency_budget_ms) / 1e3)
        if algorithm == "measured":
            if controller is None:
                from repro_torch.costmodel import CostController
                controller = CostController(device=self.device)
            self.policy = None
        else:
            self.policy = policy_cls(**(policy_kwargs or {}))
        self.controller = controller
        self.max_npass = max_npass
        self.pad_id = pad_id
        self.pipeline_depth = pipeline_depth if self.optimized else 1
        self.records: list[ServePhaseRecord] = []

    # -- one phase ---------------------------------------------------------------

    def _multi_step(self, caches, token, pos, eos_seen, eos_id: int,
                    npass: int, masked: bool):
        """Issue ``npass`` greedy decode steps back to back; nothing here
        waits for the device.  Returns (token, pos, eos_seen, toks) with
        toks a fresh (npass, B) device tensor."""
        toks = []
        for _ in range(npass):
            logits, caches = self.model.decode_step(caches, token, pos)
            nxt = sharded_greedy(logits, self.ctx)
            if masked:  # "pruning": per-step EOS bookkeeping on the device
                eos_seen = eos_seen | (token[:, 0] == eos_id)
                nxt = torch.where(eos_seen, self.pad_id, nxt)
            toks.append(nxt)
            token, pos = nxt[:, None], pos + 1
        return token, pos, eos_seen, torch.stack(toks)

    # -- host driver -------------------------------------------------------------

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, prompt_lens: np.ndarray | None = None,
                 max_new_tokens: int = 64, eos_id: int = -1,
                 extra_batch: dict | None = None):
        """Greedy-generate for a right-padded prompt batch.

        ``extra_batch`` is merged into the prefill batch, as the
        reference's: the frontend stubs' ``vision_embeds`` or
        ``frame_embeds`` (tensors or arrays, moved to the model's device).
        Returns (tokens (B, max_new_tokens) with pad after EOS, records).
        """
        B, S = prompts.shape
        if prompt_lens is None:
            prompt_lens = np.full((B,), S, np.int32)
        # the last decode step writes the cache at prompt_len + max_new - 2
        need = max(S, int(np.max(prompt_lens)) + max_new_tokens - 1)
        if need > self.cache_len:
            raise ValueError(f"cache_len {self.cache_len} < {need} positions "
                             f"these prompts and max_new_tokens need")
        dev = self.device
        last_pos = torch.as_tensor(prompt_lens - 1, dtype=torch.long,
                                   device=dev)
        batch = {"tokens": torch.as_tensor(prompts, dtype=torch.long,
                                           device=dev)}
        for key, val in (extra_batch or {}).items():
            batch[key] = torch.as_tensor(val, device=dev)

        t0 = time.perf_counter()
        logits, caches = self.model.prefill(batch, self.cache_len, last_pos)
        first = sharded_greedy(logits, self.ctx)
        prefill_time = time.perf_counter() - t0

        out = np.full((B, max_new_tokens), self.pad_id, np.int32)
        out[:, 0] = first.cpu().numpy()
        eos_seen_host = (out[:, 0] == eos_id)
        produced = 1
        token = first[:, None]
        pos = torch.as_tensor(prompt_lens, dtype=torch.long, device=dev)
        eos_seen = torch.as_tensor(eos_seen_host, device=dev)
        history: list[PhaseStats] = []
        self.records = []
        phase_idx = 0
        history.append(PhaseStats(B, B, prefill_time))

        inflight: list = []   # (phase_idx, npass, active, toks_dev, t_issue)
        scheduled = produced  # positions dispatched (≥ produced when pipelining)

        def drain_one():
            nonlocal produced, phase_idx
            pidx, npass, active, toks_dev, t_issue = inflight.pop(0)
            toks = toks_dev.cpu().numpy().T.astype(np.int32)  # (B, npass)
            elapsed = time.perf_counter() - t_issue
            # phase-end "support filter": trim tokens emitted after EOS
            wasted = 0
            for b in range(B):
                for j in range(npass):
                    if eos_seen_host[b]:
                        wasted += int(toks[b, j] != self.pad_id)
                        toks[b, j] = self.pad_id
                    elif toks[b, j] == eos_id:
                        out[b, produced + j] = toks[b, j]
                        eos_seen_host[b] = True
                    else:
                        out[b, produced + j] = toks[b, j]
            produced += npass
            if self.controller is not None:
                self.controller.observe_serve(float(B), npass, elapsed,
                                              kind="decode")
            history.append(PhaseStats(npass * active, active, elapsed))
            self.records.append(ServePhaseRecord(
                pidx, npass, active, npass * active, wasted, elapsed))

        while scheduled < max_new_tokens and not eos_seen_host.all():
            active = int((~eos_seen_host).sum())
            if self.policy is None:   # measured: decode-step fusion from the
                                      # cost model (ops basis: batch rows/step)
                npass = self.controller.choose_fusion(
                    work_per_unit=float(B),
                    queued=max_new_tokens - scheduled,
                    max_fuse=self.max_npass,
                    latency_budget_s=self.latency_budget_s, kind="decode")
                npass = 1 if npass is None else int(npass)
            else:
                prev = history[-1] if history else None
                prev2 = history[-2] if len(history) > 1 else None
                mode, val = self.policy.decide(prev, prev2)
                if mode == "width":
                    npass = int(val)
                else:  # budget: passes while cumulative candidates ≤ α·active
                    npass = int(np.floor(val)) + 1
            npass = max(1, min(npass, self.max_npass, max_new_tokens - scheduled))

            t0 = time.perf_counter()
            token, pos, eos_seen, toks = self._multi_step(
                caches, token, pos, eos_seen, eos_id, npass,
                masked=not self.optimized)
            scheduled += npass
            inflight.append((phase_idx, npass, active, toks, t0))
            phase_idx += 1
            # pipelining: keep up to `pipeline_depth` phases in flight; the
            # EOS check lags behind the dispatch stream
            while len(inflight) >= self.pipeline_depth:
                drain_one()
                eos_seen = torch.as_tensor(eos_seen_host, device=dev)
        while inflight:
            drain_one()

        return out, self.records

    @property
    def dispatches(self) -> int:
        return len(self.records)
