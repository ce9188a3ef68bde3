#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py     # a few minutes on an H100, one of them
                              # spent generating c20d200k on the host

Phases, each printing its own lines; any failure raises and the process exits
non-zero without printing a result:

1. device   — the card's name and count, and ``nvidia-smi``'s name and power
              limit;
2. build    — every CUDA source under ``src/repro_torch/csrc`` compiled by
              ``nvcc`` for sm_90a, one process each, all started together,
              with ``ptxas``'s registers and spills by kernel; then
              ``cuobjdump -sass`` of the counting, delta and rule libraries:
              the tensor-core kernels' IGMMA/BGMMA/IMMA and any IDP4A
              instructions, and a failure if one has no tensor-core
              instruction or any IDP4A, if ``support_count``'s instance has
              no single-bit (BGMMA) product, or if the delta library's
              ``overlap_mma_kernel`` is not its weighted bits instance with
              BGMMA;
3. kernels  — each hand-written kernel against its plain PyTorch version on
              the card at small ragged shapes: exact equality (integer counts,
              and float32 score bits for the rule kernels); the tensor-core
              forms also at their tiles' edges, at 1 to 17 words a row and
              on high-hit inputs where most counts are non-zero; the delta
              forms also with all-zero signs, weights outside {-1, 0, 1} and
              tiles of one weight; the rule forms at 1, 33, 63, 64, 65 and
              512 queries and R ≡ 1, 2, 3 (mod 4), with empty antecedents
              and consequents inside their baskets; vertical_count at its
              tiles' edges (Tw of 31-33 and 65 words, C of 1,023-1,025),
              kmax 1, 5 and 9, on both sides of its large-item switch (800,
              1,800 and 4,000 items) and with more candidate chunks than
              resident blocks; delta_count past one staged slab tile (T of
              513 to 4,099), C off its blocks, W of 1, 4, 8 and 9;
4. main     — ``mine()`` on the paper's speed-up dataset c20d200k (200,000
              transactions, 192 items, average width 20), min_sup 0.125,
              optimized_vfpc, once with each counting family on the card; each
              family's kernel launch count is set to 0 just before its run and
              read just after, and each run (impl=auto's too) must also have
              launched both candidate generation kernels (phase 15).  All four
              must give byte-identical levels, equal
              to the port's CPU run with the plain vertical version, and the
              port must equal the sequential oracle on a small input;
6. serving  — full-scale mushroom (8,124 transactions, 119 items) split
              round-robin into 4 tenants, each mined on the card at min_sup
              0.2 and turned into rules at min_conf 0.7 (arrays bitwise equal
              to a CPU run of the port); 4,096 mixed-tenant queries served
              through one RuleStore arena in batches of 32 (max_fuse 16,
              top-5), once with each scoring family on the card: each
              family's kernel alone launches, the recommendations are
              identical across families, equal to a CPU run and, on the
              first 256 queries, to a numpy brute-force oracle; then one
              open-loop run at a fixed offered rate under an SLO;
7. stream   — mushroom through a sliding window of 4,096 transactions at
              min_sup 0.2 / min_conf 0.7: prefill, then 16 updates of 256,
              once with each delta family; after every update the published
              levels equal a from-scratch mine of the window;
5. timing   — each kernel at its path's largest shape (counting: the mining
              path's largest phase; rules: 512 padded queries against the
              arena; delta: the tracked candidates against the 512-row slab):
              exact equality with its plain version and its library call,
              then CUDA-event times of the wrapper (the mean of 5 calls, or
              of 50 below a millisecond), the plain version and the
              library call (``torch._int_mm`` plus compare and select or
              sum, of the matmul form for both forms of a function), beside
              the least time the card could take; every kernel also
              without the host (launches replayed from a CUDA graph: the
              counting kernels' C entry points, the others' wrappers);
              vertical_count's reckoned L2 bytes a launch; every kernel
              (all eight rows have been redesigned) also beside its earlier
              kernel's time and with its achieved TOP/s; row 2 at the
              widths the port counts (W = 4, 6, 9 and 17 at c20d200k's and
              mushroom's largest jobs), exact, from a CUDA graph, beside
              the int8-plane instance it replaced; the
              torch ops that the earlier rule_scores_matmul wrapper ran
              before its kernel; and the time of the top-k that follows the
              rule kernels.

9. mesh     — ``mine()`` on phase 4's c20d200k database over a ``(data,
              cand)`` mesh of cells on the one card (``launch/mesh.py``):
              every fixed family at the splits (4, 1), (2, 2) and (1, 4), four
              cells on cuda:0, and (1, 16) with sixteen cells (candidate
              shards of 2,560 rows); an elastic run scripted through (4, 1) →
              (1, 4) → (2, 2); a run on (2, 2) retrying two injected failures;
              a run with width-balanced shards.  Every run's levels must be
              byte-identical to phase 4's single-cell levels; the counting
              kernels' launches are set to 0 before each run and read after,
              and each kernel of rows 1–4 must launch once a counting cell a
              job, and both generation kernels at least once.  Then each counting kernel against its plain version at
              the shapes a cell gets (2,560 candidate rows; 50,000
              transactions, Tw 1,563), exactly; then two processes started
              with ``torch.multiprocessing`` (spawn), joined by ``gloo``
              through a file store, both on cuda:0 with two cells each,
              mining on (2, 2) and (4, 1) — and, with two or more cards, the
              same with ``nccl``, one card a process; a process that fails
              or outlives its timeout fails the phase;
8. plans    — the autotuner's cross-family plans (``kernels/autotune.py``)
              on a fresh plan cache and cost model: ``count`` at mine()'s
              scatter shape on c20d200k, ``rules`` at 512 padded queries
              against the arena, ``delta`` at the tracked candidates against
              the 512-row slab; one line each with every family's time, the
              winner and the sweep's seconds, and every kernel launched;
10. lm      — LM serving (``repro_torch/models``, ``serving/engine.py``),
              which reaches no kernel of the port: qwen3-14b's smoke config
              with its GQA group padded 5 → 6 from one numpy parameter tree
              in a model on the card and one on the CPU — in float32 (TF32
              off) teacher-forced logits over prefill and 4 decode steps
              within 1e-4 and every algorithm's tokens equal, in bf16 the
              logits within 0.03 (the CPU tests' tolerances); then
              qwen3-14b and smollm-135m at their full configs from a
              ``torch.Generator`` seed: 8 ragged prompts of 16-64 tokens,
              32 new tokens under every algorithm (tokens equal to spc's),
              prefill(60) + 4 decode steps against prefill(64) within 0.05
              of max |logit|, EOS trimming (fpc = optimized_vfpc, pads after
              row 0's EOS) and ``pipeline_depth=2`` (same tokens, no less
              waste); each with its parameters, weight bytes, peak memory,
              prefill ms, a decode step's ms back to back and from a CUDA
              graph beside its HBM floor, and each algorithm's dispatches,
              widths, ms a step and tokens/s; then ``python -m
              repro_torch.launch.serve --arch smollm-135m`` on the card.
11. families — MoE, SSM, hybrid, encoder-decoder and VLM serving
              (``models/{moe,ssm,encdec}.py``), which reach no kernel of
              the port either: each family's smoke config (granite-moe-
              3b-a800m's 8 experts padded to 16, mamba2-370m, jamba-v0.1-
              52b's period of 4, whisper-small with frame embeddings,
              internvl2-76b with vision embeddings, all from seeds) card
              against CPU as phase 10's; one MoE layer at capacity factor
              0.5 that drops assignments, card against CPU, with its drop
              count; then six configs at full width, each whole but
              jamba-v0.1-52b (16 of 32 layers, two periods) and
              internvl2-76b (8 of 80): qwen3-moe-30b-a3b (61.1 GB),
              granite-moe-3b-a800m, mamba2-370m, jamba-v0.1-52b, whisper-
              small (1,500 frame embeddings) and internvl2-76b (prompts of
              272-320 tokens led by 256 vision embeddings), each served and
              checked as phase 10's.  A MoE config's bf16 prefill/decode
              parity is held on two seeds' inputs with the router's picks
              pinned to the longer prefill's (printed: how many would have
              differed), and in float32, unpinned in effect (no pick may
              differ), at full width on the layers a card holds in float32
              (moe_parity_f32).
12. train   — LM training (``optim``, ``train``, ``Model.loss`` and its
              backward), which reaches no kernel of the port either: each
              family's smoke config (dense, MoE, SSM, hybrid, encoder-
              decoder with frame embeddings, VLM with vision embeddings)
              from one numpy parameter tree on the card and the CPU — in
              float32 (TF32 off) the loss and every gradient, then one
              AdamW step from equal gradients with and without int8
              compression, in bf16 the loss (the CPU tests' tolerances);
              then at full width, B = 8, S = 2,048 of ``TokenPipeline``
              data, each run from seed 0's weights: smollm-135m under
              every algorithm, granite-moe-3b-a800m (4.03 B stored
              parameters, about 48 GB with gradients and float32 m and v)
              under spc and vfpc, mamba2-370m under vfpc — losses finite
              and falling; each model's parameters, state bytes, peak
              memory, step ms and tokens/s by algorithm, model FLOPs a
              step and their share of the bf16 dense peak, and a step's
              device time alone (the profiler's kernel durations); on
              smollm-135m a fused phase of 3 steps against 3 single-step
              phases (the reference's 2e-2 bound) with its host syncs
              counted under ``torch.cuda.set_sync_debug_mode("warn")``,
              a checkpoint of the full state round-tripped bit for bit,
              and a poisoned (NaN) phase restored from its checkpoint;
              then ``python -m repro_torch.launch.train --smoke --steps
              12 --ckpt`` twice, the second resuming at step 12.
13. shard   — the sharded LM paths (``sharding.py``, DTensor), which reach
              no kernel of the port: processes spawned on cuda:0 over
              ``gloo`` (c10d stages card tensors through the host; the
              gathers DTensor would crash on go through c10d, counted).
              qwen3-14b at full width (heads 40 → 48) under the decode
              profile on (1, 4): teacher-forced prefill(60) + 4 decode
              steps within 0.05 of max |logit| of the one-process model's
              (computed first and freed), 16 new tokens for 8 ragged
              prompts under spc and optimized_vfpc with every
              ``sharded_greedy`` pick equal to the gathered argmax, the
              tokens equal to the one-process run's counted, each
              process's weight bytes equal to its specs', peak memory and
              decode ms a step; granite-moe-3b-a800m (experts 40 → 48)
              prefill of 8 × 64 on (1, 4) under the default profile, every
              MoE layer expert-parallel: in float32 at capacity factor 8
              within 0.05 of the one-process global path, at its own
              factor the drops of both; in its own bf16 at factor 8, the
              router picks pinned to the one-process run's as phase 11
              pins them, within 0.05, with the picks that would have
              differed counted and the unpinned error printed;
              smollm-135m training, B = 8, S = 2,048, on (2, 2):
              three steps within 2e-2 of one process's, the checkpoint
              after step 2 written from the mesh and restored on (2, 1)
              bit for bit, its step 3 within 2e-2; with two cards or
              more the training again over ``nccl``.  Each of the three
              runs also takes one step of the dry run's own
              (``dryrun.build_step``: qwen3-14b's decode step with
              ``sharded_greedy``, granite's float32 prefill at factor 8,
              smollm-135m's training step) under
              ``roofline.CollectiveTally`` on every process.  A
              ``shard:`` summary line precedes the kernels line.
14. dryrun  — the dry run's traced half, on the host alone: started
              before phase 12 in processes at low priority with no card
              (so phases 12 and 13 take their host-clock times beside
              these traces),
              (a) the three phase-13 steps traced at full width on fake
              tensors over a fake process group of 4 ranks, and (b)
              ``python -m repro_torch.launch.dryrun`` on qwen3-14b ×
              decode_32k on 16x16 and 2x16x16 and mamba2-370m ×
              prefill_32k on 16x16, at full width.  Each traced step's
              collectives must equal its real run's tally on every process,
              by op family, count and bytes (c10d gathers routed for gloo
              are all-gathers too), and its FLOPs too; qwen3-14b's traced
              argument bytes plus temp bytes must lie within 10% of the
              card's peak allocated bytes over that decode step alone
              (``reset_peak_memory_stats`` right before it) — a check
              that the arguments dominate — and its traced temp bytes
              must lie within 10% of the card's step-only excess (that
              peak less the bytes allocated at the reset); each
              production record is printed: collectives by op, per-chip
              bytes, FLOPs, temp bytes, trace seconds and the dominant
              roofline term.
15. candidates — candidate generation on the card (``csrc/candidate_gen.cu``,
              ``kernels/candidate_gen.py``): one optimized_vfpc mine of
              each mining cell's rows (the benchmark's ``portbench/configs``
              c20d200k and mushroom) on the card, its join and prune
              inputs recorded and its launches of both kernels counted
              (set to 0 just before the mine, read just after, each above
              0, each row's ``mine_launches``); at each cell's largest join (c20d200k
              1,770 → 34,220 rows of 6 words, mushroom 8,855 → 33,649 of
              4) and largest prune (mushroom's 8,855), the kernels against
              their plain version on the card and the result home against
              the numpy path, exactly; then CUDA-event times of the
              wrapper (the count read included), the kernels alone
              (their C entry points from a CUDA graph) and the plain
              version, beside the bytes' bound; and host-clock ms a call
              of the whole card path (upload to copy home) beside the
              numpy path it replaces.  Its line is
              ``{"candidate_kernels": [...]}``.

Phases 4, 6 and 7 also drive ``impl="auto"``, the path a user gets by
default: phase 4 runs ``mine()`` with it on a cold plan cache (the count
plan's sweep inside the scatter, every counting kernel) and again on the
cached plan, levels byte-identical to the fixed families'; phase 6 serves
the queries with it (the warm-up sweeps both rule kernels at each padded
query count), recommendations identical to both families'; phase 7 streams
with it (the delta plan swept at the first update of each shape), levels
equal to both families' after every update.  The run keeps its plan and
cost-model caches in a temporary directory, so no earlier run's plan skips
a sweep, and phases 6, 7 and 8 start theirs empty, so no fit the mining
phases calibrated prunes a family from their sweeps.

Phases run in the order 1, 2, 3, 4, 15, 9, 6, 7, 8, 10, 11, 12, 13, 14, 5.  Each path's launch
counts are set to 0 just before it is driven and read just after.  The line
before the last is ``{"kernels": [...]}`` (with each kernel's launches during
the phase-8 sweeps as ``sweep_launches`` and during phase 9's runs as
``mesh_launches``); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from argparse import Namespace

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.core import MapReduceRuntime, mine, sequential_apriori  # noqa: E402
from repro_torch.core import candidates  # noqa: E402
from repro_torch.core.policy import ALGORITHMS  # noqa: E402
from repro_torch.core.bitset import (pack_itemsets, to_device_words,  # noqa: E402
                                     tpopcount_rows, tunpack_bits,
                                     vertical_pack)
from repro_torch.costmodel import CostController, CostModel  # noqa: E402
from repro_torch.data import TokenPipeline, dataset_by_name  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.delta_count import build_slab  # noqa: E402
from repro_torch.kernels.vertical_count import vertical_membership  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (init_distributed, make_mining_mesh,  # noqa: E402
                                     shutdown_distributed)
from repro_torch.models import build_model, load_reference_params, moe  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.convert import STACKS, reference_shapes  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw  # noqa: E402
from repro_torch.roofline import tally_step  # noqa: E402
from repro_torch.train import (TrainLoop, init_train_state,  # noqa: E402
                               load_checkpoint, make_train_step,
                               save_checkpoint)
from repro_torch.launch.serve_rules import (make_queries, mine_tenants,  # noqa: E402
                                            serve_open_loop)
from repro_torch.serving import (RuleServeEngine, RuleStore,  # noqa: E402
                                 ServeEngine, stable_top_k)
from repro_torch.serving.common import bucket_rows, latency_ms  # noqa: E402
from repro_torch.stream import StreamMiner, levels_equal  # noqa: E402
import repro_torch.stream.miner as stream_miner  # noqa: E402

DATASET, MIN_SUP, ALGORITHM = "c20d200k", 0.125, "optimized_vfpc"

# NVIDIA H100 SXM peaks at the full 700 W power limit (NVIDIA's data sheet,
# dense rates): 3.35 TB/s of HBM3 and 1,979 TOP/s of int8 tensor cores.  The
# popcount kernels do 32-bit integer work on the CUDA cores, for which the
# data sheet lists no rate; their bound uses its CUDA-core float32 rate,
# 67 TFLOP/s, which is at least the integer rate, so the bound stays a bound.
# The data sheet lists no single-bit (wgmma .b1) rate either: the probe
# (python -m repro_torch.probes.b1_wgmma, PERF.md) measured its
# m64n128k256 instruction at the int8 m64n128k32 instruction's rate, 8× its
# ops, so a bit-op's peak is taken as 8 × 1,979 TOP/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
B1_OPS_PER_S = 8 * INT8_OPS_PER_S
CUDA_CORE_OPS_PER_S = 67e12

# serving and streaming configuration (phases 6 and 7)
SERVE_DATASET, SERVE_MIN_SUP, SERVE_MIN_CONF = "mushroom", 0.2, 0.7
N_TENANTS, N_QUERIES, SERVE_BATCH, MAX_FUSE, TOP_K = 4, 4096, 32, 16, 5
ORACLE_QUERIES = 256
OPEN_LOOP_QPS, OPEN_LOOP_SLO_MS = 8000.0, 25.0
CAPACITY, STREAM_BATCH, STREAM_UPDATES = 4096, 256, 16

# the mesh phase (9): one-card splits of four cells, the narrow split of
# sixteen, the splits of the two-process run (two cells a process), and the
# seconds a process of that run may take
MESH_SPLITS, NARROW_SPLIT = ((4, 1), (2, 2), (1, 4)), (1, 16)
PROCESS_SPLITS, PROCESS_FAMILIES = ((2, 2), (4, 1)), ("jnp", "vertical")
PROCESS_TIMEOUT_S = 300

# candidate generation's kernels (phase 15), which every mine on the card
# launches beside its counting family's; the checks of which counting kernel
# ran count the TPU kernels' ports alone, and each mine of phases 4, 9 and
# 15 must have launched both of these
GENERATION = ("candidate_join", "candidate_prune")


def launch_counts() -> dict:
    """``kernels.LAUNCHES`` without candidate generation's kernels."""
    return {k: v for k, v in kernels.LAUNCHES.items() if k not in GENERATION}


def generation_launches(label: str) -> dict:
    """Candidate generation's launches since the counts were set to 0; fail
    unless the mine just run generated on the card (both kernels)."""
    counts = {k: kernels.LAUNCHES[k] for k in GENERATION}
    if not all(counts.values()):
        raise AssertionError(f"{label}: candidate generation did not run on "
                             f"the card ({counts})")
    return counts


# kernel name → the runtime family that reaches it, and the TPU kernel it replaces
FAMILY = {"vertical_count": "vertical", "support_count": "jnp",
          "support_count_matmul": "matmul",
          "vertical_count_matmul": "vertical_matmul"}
RULE_FAMILY = {"rule_scores": "jnp", "rule_scores_matmul": "matmul"}
DELTA_FAMILY = {"delta_count": "jnp", "delta_count_matmul": "matmul"}
REPLACES = {
    "support_count": "src/repro/kernels/support_count.py:36",
    "support_count_matmul": "src/repro/kernels/support_count.py:129",
    "vertical_count": "src/repro/kernels/vertical_count.py:43",
    "vertical_count_matmul": "src/repro/kernels/vertical_count.py:190",
    "delta_count": "src/repro/kernels/delta_count.py:50",
    "delta_count_matmul": "src/repro/kernels/delta_count.py:172",
    "rule_scores": "src/repro/kernels/rule_match.py:40",
    "rule_scores_matmul": "src/repro/kernels/rule_match.py:201",
}
SOURCE = {name: "src/repro_torch/csrc/counting.cu" for name in FAMILY}
SOURCE.update({name: "src/repro_torch/csrc/delta_count.cu"
               for name in DELTA_FAMILY})
SOURCE.update({name: "src/repro_torch/csrc/rule_match.cu"
               for name in RULE_FAMILY})
SOURCE.update({name: "src/repro_torch/csrc/overlap_mma.cuh"
               for name in ("support_count", "support_count_matmul",
                            "vertical_count_matmul", "delta_count_matmul")})
# the redesigned kernels' time before their redesign (PERF.md's kernel
# table: chip_smoke.py on one NVIDIA H100 80GB HBM3 at 700 W): row 2 on int8
# planes expanded in shared memory, rows 4 and 6 on __dp4a (6 behind the
# wrapper's plane unpack), row 1 on a ballot
# kernel on the CUDA cores, row 7 on 16 baskets a block, row 8 on __dp4a
# behind the wrapper's plane unpack, row 3 reading each candidate's rows
# from L2, row 5 on one warp reduction a candidate and 32 rows
EARLIER_MS = {"support_count_matmul": 3.459, "vertical_count_matmul": 39.622,
              "support_count": 12.313, "rule_scores_matmul": 0.952,
              "delta_count_matmul": 0.313, "rule_scores": 0.075,
              "vertical_count": 0.637, "delta_count": 0.035}
# row 2 at the widths the port counts (W = 4 mushroom, 6 c20d200k, 9 and 17
# two and three chunks of 256 bits), at c20d200k's second job (C = 40,960,
# T = 200,000) and mushroom's largest join (C = 33,649, T = 8,124); beside
# each, the device ms of the int8-plane instance it replaced at that shape
# (from a CUDA graph on one NVIDIA H100 80GB HBM3 at 700 W)
WIDTH_SHAPES = ((40960, 200000), (33649, 8124))
WIDTHS = (4, 6, 9, 17)
WIDTH_INT8_MS = {(40960, 200000, 4): 2.8205, (40960, 200000, 6): 3.3565,
                 (40960, 200000, 9): 8.4290, (40960, 200000, 17): 14.4276,
                 (33649, 8124, 4): 0.1006, (33649, 8124, 6): 0.1213,
                 (33649, 8124, 9): 0.2930, (33649, 8124, 17): 0.4948}
# vertical_count's tiled instances (csrc/counting.cu): kVertChunk candidates
# a block, each block reading the vertical DB from L2 once; past
# kVertMaxRows rows (two buffers of an 8-word tile in the H100's 232,448
# bytes of shared memory a block) or kVertMaxK slots, the L2 instance reads
# every candidate's kmax rows
VERT_CHUNK, VERT_MAX_ROWS, VERT_MAX_K = 1024, 232448 // (2 * 9 * 4), 8

# LM serving (phase 10): the full configs served, the batch (ragged prompts
# of 16-64 tokens, 32 new tokens), the card-against-CPU tolerances
# (tests/test_torch_models.py's: 1e-4 in float32, 0.03 in bf16) and the
# reference's own prefill-against-decode bound (tests/test_models.py)
LM_ARCHS = ("qwen3-14b", "smollm-135m")
LM_BATCH, LM_PROMPT, LM_NEW, LM_EXTRA = 8, (16, 64), 32, 4
LM_F32_TOL, LM_BF16_TOL, LM_PARITY_TOL = 1e-4, 0.03, 0.05
# the other families (phase 11): a smoke config of each family card
# against CPU (MoE with padded experts, SSM, hybrid, encoder-decoder, VLM),
# then six configs at full width: arch, layers kept (None: all; jamba-v0.1-
# 52b keeps two of its four periods, 52.0 of 102.9 GB, internvl2-76b 8 of
# its 80 layers, 17.9 of 141 GB)
FAMILY_SMOKE = ("granite-moe-3b-a800m", "mamba2-370m", "jamba-v0.1-52b",
                "whisper-small", "internvl2-76b")
FAMILY_FULL = (("qwen3-moe-30b-a3b", None), ("granite-moe-3b-a800m", None),
               ("mamba2-370m", None), ("jamba-v0.1-52b", 16),
               ("whisper-small", None), ("internvl2-76b", 8))
# the seeds of a MoE config's prefill/decode inputs (seed 0: the same
# inputs as a dense config's single check)
MOE_PARITY_SEEDS = (0, 1)
# the MoE configs' float32 prefill/decode parity: the layers one card holds
# in float32 (qwen3-moe-30b-a3b 24 of 48, 61 GB; jamba-v0.1-52b one period
# of 8, 52 GB; granite-moe-3b-a800m all 32, 16 GB)
MOE_F32_LAYERS = {"qwen3-moe-30b-a3b": 24, "jamba-v0.1-52b": 8,
                  "granite-moe-3b-a800m": None}
# training (phase 12): a smoke config of each family card against CPU
# (dense, MoE, SSM, hybrid, encoder-decoder, VLM), with its tolerances:
# float32 loss and gradients (relative to each parameter's largest
# gradient) and one AdamW step from equal gradients, bf16 loss; then
# smollm-135m at full width under every algorithm, and granite-moe-3b-
# a800m and mamba2-370m under some, at B = 8, S = 2,048: (arch,
# algorithms, steps a run — enough for two phases under each, so the loss
# can be seen to fall — peak learning rate; granite-moe-3b-a800m's loss
# rose over 4 steps at 1e-3); the fused-against-sequential bound is
# the reference's own (tests/test_train.py); the card's bf16 dense peak
TRAIN_SMOKE = ("smollm-135m", "granite-moe-3b-a800m", "mamba2-370m",
               "jamba-v0.1-52b", "whisper-small", "internvl2-76b")
TRAIN_F32_TOL, TRAIN_STEP_TOL, TRAIN_BF16_TOL = 1e-4, 1e-5, 2e-3
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
TRAIN_FULL = (("smollm-135m", tuple(sorted(ALGORITHMS)), 4, 1e-3),
              ("granite-moe-3b-a800m", ("spc", "vfpc"), 4, 1e-4),
              ("mamba2-370m", ("vfpc",), 4, 3e-4))
TRAIN_FUSED_TOL = 2e-2
BF16_FLOPS_PER_S = 989e12


def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {name} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")
    print(smi)
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = kernels.build_all()
    print(f"build: {time.perf_counter() - t0:.1f}s "
          f"({', '.join(str(p.name) for p in libs.values())})")
    for src, log in kernels._build.BUILD_LOGS.items():
        fn = "?"
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:
                fn = entry.group(1)
            if "registers" in line or "spill" in line or "C7520" in line:
                print(f"  ptxas {src} {fn}: {line.strip()}")
    counting = check_sass(libs["counting"], "overlap_mma_kernel")
    check_sass(libs["rule_match"], "rule_scores_matmul_kernel", b1=True)
    # support_count is overlap_mma_kernel<kBits>, kBits = 2, and
    # delta_count_matmul its weighted instance <kBits, true>
    bits = [fn for fn in counting if "overlap_mma_kernelILi2E" in fn]
    if len(bits) != 1 or not counting[bits[0]]["BGMMA"]:
        raise AssertionError("support_count's overlap_mma_kernel instance "
                             "has no single-bit tensor-core product")
    delta = check_sass(libs["delta_count"], "overlap_mma_kernel", b1=True)
    if len(delta) != 1 or "ILi2ELb1E" not in next(iter(delta)):
        raise AssertionError("delta_count_matmul is not overlap_mma_kernel's "
                             "weighted bits instance")


def check_sass(lib, kernel: str, b1: bool = False) -> dict:
    """Count the tensor-core (IGMMA int8, BGMMA single-bit, IMMA) and __dp4a
    (IDP.4A) instructions of each instance of ``kernel`` in the library's
    SASS; raise unless every instance has tensor-core instructions (BGMMA
    ones where ``b1``) and no __dp4a.  Return the counts by instance."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1) if kernel in head.group(1) else None
            if fn:
                counts[fn] = dict.fromkeys(("IGMMA", "BGMMA", "IMMA",
                                            "IDP4A"), 0)
            continue
        op = re.search(r"\b(IGMMA|BGMMA|IMMA|IDP)[.\s]", line)
        if fn and op:
            counts[fn]["IDP4A" if op.group(1) == "IDP" else op.group(1)] += 1
    if not counts:
        raise AssertionError(f"no {kernel} in the SASS of {lib}")
    for fn, c in counts.items():
        print(f"  sass {fn}: {c}")
        tensor = c["BGMMA"] if b1 else c["IGMMA"] + c["BGMMA"] + c["IMMA"]
        if not tensor or c["IDP4A"]:
            raise AssertionError(f"{fn} does not run on the tensor cores alone")
    return counts


def _random_vertical(rng, n_items, n, kmax, C, dense=False):
    """Up to 11 items a row or, ``dense``, each item with probability 0.8;
    candidates of up to ``kmax`` distinct items, padded with the sentinel,
    one all-sentinel (the empty set) and one with a duplicate slot."""
    if dense:
        rows = [np.nonzero(rng.random(n_items) < 0.8)[0] for _ in range(n)]
    else:
        rows = [sorted(rng.choice(n_items, rng.integers(0, 12), replace=False))
                for _ in range(n)]
    db = pack_itemsets(rows, n_items)
    idx = np.full((C, kmax), n_items, np.int32)
    for i in range(C):
        k = rng.integers(0, kmax + 1)
        idx[i, :k] = rng.choice(n_items, k, replace=False)
    idx[C // 2, :] = n_items          # all-sentinel slots: the empty set
    if kmax > 1:
        idx[1, 1] = idx[1, 0]         # a duplicate slot
    return vertical_pack(db, n_items), idx


def _high_hit(rng, C, T, W):
    """Sparse candidates of 1-3 bits against dense rows (each bit set with
    probability 0.8): most counts are non-zero and many distinct."""
    c = np.zeros((C, W), np.uint32)
    for i in range(C):
        for b in rng.choice(32 * W, rng.integers(1, 4), replace=False):
            c[i, b // 32] |= np.uint32(1 << (b % 32))
    dense = rng.random((T, 32 * W)) < 0.8
    t = np.packbits(dense, axis=1, bitorder="little").view(np.uint32)
    return c, t.reshape(T, W)


def _signed(rng, C, T, W, high, signs):
    """A delta case: random or high-hit words, an empty candidate, and the
    slab's signs drawn from ``signs`` (weights)."""
    if high:
        c, t = _high_hit(rng, C, T, W)
    else:
        c = rng.integers(0, 2 ** 32, (C, W), dtype=np.uint32)
        c &= rng.integers(0, 2 ** 32, (C, W), dtype=np.uint32)
        t = ~(rng.integers(0, 2 ** 32, (T, W), dtype=np.uint32)
              & rng.integers(0, 2 ** 32, (T, W), dtype=np.uint32))
    c[0] = 0
    c[-1] &= t[0]
    sign = rng.choice(np.asarray(signs, np.int32), T)
    return c, t, sign


def kernel_cases(device):
    """Small ragged inputs for each kernel: W > 1, ragged tails, empty
    candidates, duplicate and sentinel slots; for the tensor-core forms
    (both support forms, the vertical matmul form, the delta matmul form)
    also the tiles' edges (256 candidates × 128 rows), 1 to 17 words (one to
    three K chunks of bits, past 256 planes), K not a multiple of 32, and
    high-hit inputs; for the delta forms also a slab of all-zero signs,
    weights outside {-1, 0, 1} and tiles of one weight; for the rule forms R
    off the 128-rule tile and R ≡ 1, 2, 3 (mod 4) (every row alignment), 1,
    33, 63, 64, 65 and 512 queries, W of 1, 4 and 9, empty antecedents and
    consequents, rules held by their basket."""
    rng = np.random.default_rng(0)
    horizontal, signed = [], []
    # W = 9 and 17 take the counting kernels' chunked instance for W > 8
    for C, T, W in ((1, 1, 1), (17, 33, 2), (300, 700, 8), (1000, 4099, 6),
                    (45, 600, 9), (300, 1025, 17)):
        c = rng.integers(0, 2 ** 32, (C, W), dtype=np.uint32)
        t = rng.integers(0, 2 ** 32, (T, W), dtype=np.uint32)
        c[0] = 0
        c[-1] &= t[0]                 # contained in at least one row
        sign = rng.integers(-1, 2, T).astype(np.int32)
        horizontal.append((to_device_words(c, device),
                           to_device_words(t, device)))
        signed.append(horizontal[-1] + (torch.from_numpy(sign).to(device),))
    # tile edges (C of 255-257, T of 127-129), W of 1, 8, 9 and 17,
    # high-hit words; signs of {-1, 0, 1}, all zero, outside {-1, 0, 1},
    # and a slab of 128 rows of +1 then 128 of -1 (tiles of one weight)
    for (C, T, W), high, signs in (
            ((255, 127, 1), False, (-1, 0, 1)),
            ((256, 128, 8), True, (-1, 0, 1)),
            ((257, 129, 9), True, (-1, 0, 1)),
            ((257, 383, 17), False, (-1, 0, 1)),
            ((300, 1025, 4), True, (0,)),
            ((513, 257, 4), True, (-3, 3, 7)),
            ((257, 129, 17), True, (-3, 0, 7)),
            ((255, 256, 1), True, (1,)),
            ((65, 200, 2), True, (7,)),
            ((2000, 512, 4), True, (1,)),
            # delta_count's register instances: slabs past one staged tile
            # of 512 rows, C off its blocks of 256, 128, 64 and 32
            # candidates (and the streaming shape's C + 1), all-zero signs,
            # weights -3 and 7, W of 1, 4, 8 and 9 (the chunked instance)
            ((1000, 513, 4), True, (-1, 0, 1)),
            ((300, 1100, 8), True, (-3, 7)),
            ((777, 4099, 1), True, (-1, 0, 1)),
            ((100, 4099, 4), True, (-3, 7)),
            ((1001, 600, 1), True, (0,)),
            ((28673, 512, 4), True, (-1, 0, 1)),
            ((300, 600, 9), True, (-3, 7))):
        c, t, sign = _signed(rng, C, T, W, high, signs)
        if C == 2000:
            sign[T // 2:] = -1
        signed.append((to_device_words(c, device), to_device_words(t, device),
                       torch.from_numpy(sign).to(device)))
    matmul = list(horizontal)
    for (C, T, W), high in (((63, 127, 3), False), ((65, 257, 6), False),
                            ((129, 257, 9), False), ((129, 127, 17), False),
                            ((65, 257, 6), True), ((257, 1000, 17), True),
                            ((2000, 3000, 6), True), ((300, 1025, 1), True),
                            ((513, 383, 8), True), ((257, 129, 9), True)):
        if high:
            c, t = _high_hit(rng, C, T, W)
        else:
            c = rng.integers(0, 2 ** 32, (C, W), dtype=np.uint32)
            t = rng.integers(0, 2 ** 32, (T, W), dtype=np.uint32)
        c[0] = 0
        matmul.append((to_device_words(c, device), to_device_words(t, device)))
    vertical = []
    # vertical_count's tiled instances (csrc/counting.cu): 1,024 candidates
    # a block, tiles of 32 words at 192 items, 16 at 800, 8 at 1,800; the L2
    # instance past 3,227 items or 8 slots.  Tw of 31, 32, 33 and 65 words
    # (990, 1,024, 1,040 and 2,080 transactions), 17, 8 and 10 at the
    # narrower tiles; C of 1,023, 1,024, 1,025 and 2,049; kmax 1, 3, 5 and 9
    for n_items, n, kmax, C in ((37, 101, 5, 23), (192, 5003, 4, 777),
                                (192, 990, 3, 1023), (192, 1024, 3, 1024),
                                (192, 1040, 3, 1025), (192, 5003, 1, 1025),
                                (192, 2080, 5, 2049), (192, 3000, 9, 300),
                                (800, 530, 3, 300), (1800, 250, 3, 1025),
                                (1800, 290, 5, 700), (4000, 1000, 3, 500)):
        vdb, idx = _random_vertical(rng, n_items, n, kmax, C)
        vertical.append((to_device_words(vdb, device),
                         torch.from_numpy(idx).to(device)))
    # more candidate chunks than resident blocks, so one block walks every
    # tile and stores its counts: random slots, sentinels and duplicates
    vdb, _ = _random_vertical(rng, 37, 2000, 2, 2)
    idx = rng.integers(0, 38, (600_000, 2)).astype(np.int32)
    vertical.append((to_device_words(vdb, device),
                     torch.from_numpy(idx).to(device)))
    vertical_matmul = list(vertical)
    for n_items, n, kmax, C, dense in ((37, 257, 3, 65, False),
                                       (119, 127, 3, 129, False),
                                       (300, 4099, 4, 257, False),
                                       (37, 1000, 3, 65, True),
                                       (119, 2000, 3, 129, True),
                                       (300, 700, 3, 63, True)):
        vdb, idx = _random_vertical(rng, n_items, n, kmax, C, dense)
        vertical_matmul.append((to_device_words(vdb, device),
                                torch.from_numpy(idx).to(device)))
    rules = []
    for R, Q, W in ((1, 1, 1), (37, 13, 2), (700, 70, 4), (1000, 45, 9),
                    (300, 33, 1), (129, 512, 4), (1000, 1, 9), (257, 33, 4),
                    # R ≡ 1, 2, 3 (mod 4) against the query tile's edges
                    (4097, 63, 4), (4098, 64, 4), (4099, 65, 4),
                    (1001, 512, 2), (1002, 65, 9), (1003, 64, 1)):
        def sparse(n):     # AND of three draws: an eighth of the bits set
            return (rng.integers(0, 2 ** 32, (n, W), dtype=np.uint32)
                    & rng.integers(0, 2 ** 32, (n, W), dtype=np.uint32)
                    & rng.integers(0, 2 ** 32, (n, W), dtype=np.uint32))
        ante, cons = sparse(R), sparse(R)
        baskets = ~sparse(Q)
        for r in range(1, min(R, 9)):     # held by basket r % Q, with and
            ante[r] &= baskets[r % Q]     # without the consequent
            cons[r] &= baskets[r % Q] if r % 2 else ~baskets[r % Q]
        if R > 2:
            cons[-2] = 0                  # an empty consequent never fires
        ante[-1] = 0                      # an empty antecedent fires always
        scores = rng.random(R).astype(np.float32)
        scores[0] = np.inf                # +inf is a legal score
        for exclude in (True, False):
            rules.append((to_device_words(ante, device),
                          to_device_words(cons, device),
                          torch.from_numpy(scores).to(device),
                          to_device_words(baskets, device), exclude))
    return {"support_count": matmul, "support_count_matmul": matmul,
            "vertical_count": vertical,
            "vertical_count_matmul": vertical_matmul,
            "delta_count": signed, "delta_count_matmul": signed,
            "rule_scores": rules, "rule_scores_matmul": rules}


def _max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """0 when the two tensors hold the same values (for float32: the same
    bits, -inf included); else the largest absolute difference."""
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {a.shape} vs {b.shape}")
    if not a.numel():
        return 0
    if a.is_floating_point():
        if torch.equal(a.view(torch.int32), b.view(torch.int32)):
            return 0
        return float((a.double() - b.double()).abs().nan_to_num(
            nan=float("inf")).max())
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def phase_kernels(device) -> None:
    for name, cases in kernel_cases(device).items():
        wrapper, plain = kernels.KERNELS[name]
        worst, nonzero, total = 0, 0, 0
        for args in cases:
            got = wrapper(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            worst = max(worst, _max_abs_diff(got, want))
            nonzero += int((want != 0).sum())
            total += want.numel()
        print(f"kernel {name}: {len(cases)} ragged cases, max|diff|={worst}, "
              f"{nonzero} of {total} results non-zero")
        if worst:
            raise AssertionError(f"{name} disagrees with its plain version")


def _levels_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        np.array_equal(a[k][0], b[k][0]) and np.array_equal(a[k][1], b[k][1])
        for k in a)


def phase_main():
    """Drive the main path with each family; return the launches each
    kernel made, the database and the largest phase's padded candidates."""
    t0 = time.perf_counter()
    txns, n_items = dataset_by_name(DATASET, seed=0)
    db = pack_itemsets(txns, n_items)
    print(f"data: {DATASET} n_txns={db.shape[0]} "
          f"n_items={n_items} generated in {time.perf_counter() - t0:.1f}s")

    largest = {}
    launches, results = {}, {}
    # impl=auto, a user's first run: the count plan's sweep (every counting
    # kernel) inside the scatter, then the winner
    auto_cold = mine_auto(db, n_items, "cold")
    for name, family in FAMILY.items():
        rt = MapReduceRuntime(impl=family, device="cuda")
        dispatch = rt.phase_count_async

        def record(db_dev, cands, *a, _dispatch=dispatch, **kw):
            if cands.shape[0] > largest.get("cands", np.zeros((0,))).shape[0]:
                largest["cands"] = cands.copy()
            return _dispatch(db_dev, cands, *a, **kw)
        rt.phase_count_async = record

        torch.cuda.synchronize()
        kernels.reset_launches()
        t1 = time.perf_counter()
        res = mine(db_masks=db, n_items=n_items, min_sup=MIN_SUP,
                   algorithm=ALGORITHM, runtime=rt)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        counts = launch_counts()
        generated = generation_launches(f"mine impl={family}")
        launches[name] = counts[name]
        results[family] = res
        sizes = {k: int(v[0].shape[0]) for k, v in sorted(res.levels.items())}
        plan = [(p.k_start, p.candidate_counts) for p in res.phases]
        print(f"mine impl={family}: {secs:.3f}s (scatter "
              f"{rt.stats.scatter_seconds:.3f}s, candidate generation "
              f"{sum(p.gen_seconds for p in res.phases):.3f}s, counting jobs "
              f"{sum(p.count_seconds for p in res.phases):.3f}s) "
              f"phases={res.n_phases} dispatches={res.dispatches} "
              f"launches={counts} generation={generated} levels={sizes} "
              f"plan={plan}")
        if counts[name] <= 0 or any(v for k, v in counts.items() if k != name):
            raise AssertionError(f"impl={family} did not run on {name} alone")

    # impl=auto again: the plan is cached, so the run is the winner's alone
    auto_warm = mine_auto(db, n_items, "warm")
    ref = results["vertical"].levels
    for family, res in results.items():
        if not _levels_equal(res.levels, ref):
            raise AssertionError(f"impl={family} levels differ from vertical")
    for res in (auto_cold, auto_warm):
        if not _levels_equal(res.levels, ref):
            raise AssertionError("impl=auto levels differ from vertical")
    print("levels: impl=auto byte-identical to all four fixed families")
    t1 = time.perf_counter()
    cpu = mine(db_masks=db, n_items=n_items, min_sup=MIN_SUP,
               algorithm=ALGORITHM, device="cpu")
    print(f"mine device=cpu impl=vertical (plain): "
          f"{time.perf_counter() - t1:.2f}s")
    if not _levels_equal(cpu.levels, ref):
        raise AssertionError("card levels differ from the CPU plain run")
    print("levels: all four families byte-identical, equal to the CPU run")
    ref_levels = ref

    small, n_small = dataset_by_name("c20d10k", seed=1, scale=0.03)
    oracle = sequential_apriori(small, MIN_SUP)
    for family in FAMILY.values():
        got = mine(small, n_items=n_small, min_sup=MIN_SUP,
                   algorithm=ALGORITHM,
                   runtime=MapReduceRuntime(impl=family, device="cuda"))
        if got.itemsets() != oracle:
            raise AssertionError(f"impl={family} differs from the oracle")
    print(f"oracle: {len(small)} txns, all four families equal "
          f"sequential_apriori")
    return launches, db, n_items, largest["cands"], ref_levels


def mine_auto(db, n_items, label: str):
    """``mine()`` with ``impl="auto"`` on the card: the scatter adopts the
    count plan (sweeping on a cold plan cache).  Return the result."""
    rt = MapReduceRuntime(impl="auto", device="cuda")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t1 = time.perf_counter()
    res = mine(db_masks=db, n_items=n_items, min_sup=MIN_SUP,
               algorithm=ALGORITHM, runtime=rt)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    counts = launch_counts()
    generated = generation_launches(f"mine impl=auto ({label})")
    winner = {v: k for k, v in FAMILY.items()}[rt.impl]
    print(f"mine impl=auto ({label} plan cache) -> {rt.impl}: {secs:.3f}s "
          f"(scatter with the plan {rt.stats.scatter_seconds:.3f}s, counting "
          f"jobs {sum(p.count_seconds for p in res.phases):.3f}s) "
          f"dispatches={res.dispatches} launches="
          f"{ {k: v for k, v in counts.items() if v} } "
          f"generation={generated}")
    others = [k for k in FAMILY if k != winner]
    if label == "cold" and not all(counts[k] for k in FAMILY):
        raise AssertionError("the count plan's sweep skipped a kernel")
    if label == "warm" and (counts[winner] != res.dispatches
                            or any(counts[k] for k in others)):
        raise AssertionError(f"impl=auto did not run on {winner} alone")
    return res


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def mesh_runtime(family: str, split, cells: int, device):
    """A runtime of ``family`` over a ``split`` mesh, ``cells`` cells on
    this process's ``device``; candidates sharded where the split has a
    cand axis."""
    mesh = make_mining_mesh(*split, cells_per_process=cells, device=device)
    return MapReduceRuntime(mesh=mesh, impl=family,
                            cand_axis="cand" if split[1] > 1 else None)


def mesh_mine(db, n_items, rt, label: str, levels, **kw):
    """``mine()`` on a mesh runtime with its launch counts set to 0 just
    before and read just after; fail unless the levels are phase 4's and
    the family's kernel launched once a counting cell a job (failed and
    retried jobs included), alone.
    Return (result, seconds, launches)."""
    family = rt.impl
    name = {v: k for k, v in FAMILY.items()}[family]
    split = rt.mesh_split
    _sync(rt.device)
    kernels.reset_launches()
    t1 = time.perf_counter()
    res = mine(db_masks=db, n_items=n_items, min_sup=MIN_SUP,
               algorithm=ALGORITHM, runtime=rt, **kw)
    _sync(rt.device)
    secs = time.perf_counter() - t1
    counts = launch_counts()
    cells = len(rt._cells())
    generated = generation_launches(f"mesh {label} {split}")
    print(f"mesh {label} {split[0]}x{split[1]} impl={family}: {secs:.3f}s "
          f"(scatter {rt.stats.scatter_seconds:.3f}s, counting jobs "
          f"{sum(p.count_seconds for p in res.phases):.3f}s) cells="
          f"{rt.mesh.size} counting={cells} dispatches={res.dispatches} "
          f"repartitions={res.repartitions} retries={res.retries} "
          f"launches={ {k: v for k, v in counts.items() if v} } "
          f"generation={generated}")
    if not _levels_equal(res.levels, levels):
        raise AssertionError(f"mesh {label} {split} impl={family}: levels "
                             f"differ from the single-cell run")
    if counts[name] <= 0 or any(v for k, v in counts.items() if k != name):
        raise AssertionError(f"mesh {label} impl={family} did not run on "
                             f"{name} alone")
    if counts[name] != cells * res.dispatches:
        raise AssertionError(f"mesh {label} impl={family}: {counts[name]} "
                             f"launches for {res.dispatches} jobs of {cells} "
                             f"cells")
    return res, secs, counts


def _mesh_worker(rank: int, backend: str, store: str, db_path: str,
                 out_path: str, device: str) -> None:
    """One process of the two-process run: join the group, then mine on
    each of ``PROCESS_SPLITS`` with two cells on this process's card, and
    save the levels for the parent to compare."""
    init_distributed(store, 2, rank, backend=backend, device=device,
                     timeout=PROCESS_TIMEOUT_S)
    data = np.load(db_path)
    db, n_items = data["db"], int(data["n_items"])
    out = {}
    for family in PROCESS_FAMILIES:
        for split in PROCESS_SPLITS:
            rt = mesh_runtime(family, split, 2, device)
            kernels.reset_launches()
            t1 = time.perf_counter()
            res = mine(db_masks=db, n_items=n_items, min_sup=MIN_SUP,
                       algorithm=ALGORITHM, runtime=rt, elastic=False)
            _sync(rt.device)
            secs = time.perf_counter() - t1
            print(f"  process {rank} ({backend}, {rt.device}, cells "
                  f"{rt.mesh.cells}) mesh {split[0]}x{split[1]} impl="
                  f"{family}: {secs:.3f}s dispatches={res.dispatches} "
                  f"launches={ {k: v for k, v in kernels.LAUNCHES.items() if v} }",
                  flush=True)
            for k, (masks, counts) in res.levels.items():
                out[f"{family}|{split[0]}x{split[1]}|{k}|masks"] = masks
                out[f"{family}|{split[0]}x{split[1]}|{k}|counts"] = counts
    shutdown_distributed()
    np.savez(out_path, **out)


def mesh_processes(db, n_items, levels, backend: str, tmp: str,
                   device: str) -> float:
    """Two processes (spawned), each mining ``PROCESS_SPLITS`` with two
    cells on ``device`` (``"cuda:0"``: both on card 0; ``"cuda"``: one
    card a process); fail unless both exit 0 within the timeout and every
    level equals phase 4's.  Return the seconds the run took."""
    db_path = os.path.join(tmp, "mesh_db.npz")
    np.savez(db_path, db=db, n_items=np.int64(n_items))
    store = "file://" + os.path.join(tmp, f"store-{backend}")
    outs = [os.path.join(tmp, f"mesh-{backend}-{r}.npz") for r in (0, 1)]
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_mesh_worker,
                         args=(r, backend, store, db_path, outs[r],
                               device))
             for r in (0, 1)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=max(PROCESS_TIMEOUT_S - (time.perf_counter() - t0),
                               1))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    secs = time.perf_counter() - t0
    codes = [p.exitcode for p in procs]
    if codes != [0, 0]:
        raise AssertionError(f"the two-process {backend} run failed or hung "
                             f"(exit codes {codes})")
    for path in outs:
        got = dict(np.load(path))
        for family in PROCESS_FAMILIES:
            for split in PROCESS_SPLITS:
                tag = f"{family}|{split[0]}x{split[1]}|"
                mine_levels = {}
                for key, val in got.items():
                    if key.startswith(tag):
                        k, kind = key[len(tag):].split("|")
                        mine_levels.setdefault(int(k), {})[kind] = val
                mine_levels = {k: (v["masks"], v["counts"])
                               for k, v in mine_levels.items()}
                if not _levels_equal(mine_levels, levels):
                    raise AssertionError(f"{backend} {path} {tag}: levels "
                                         f"differ from the single-cell run")
    return secs


def phase_mesh(db, n_items, cands, levels, device) -> dict:
    """Drive ``mine()`` over meshes of cells on the card (see the module
    docstring, phase 9); return each counting kernel's launches over the
    phase's mining runs."""
    total: dict = {}
    summary: dict = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    for family in FAMILY.values():
        for split in MESH_SPLITS + (NARROW_SPLIT,):
            cells = split[0] * split[1]
            rt = mesh_runtime(family, split, cells, device)
            res, secs, counts = mesh_mine(db, n_items, rt, "split", levels,
                                          elastic=False)
            add(counts)
            name = {v: k for k, v in FAMILY.items()}[family]
            row = summary.setdefault(f"{split[0]}x{split[1]}",
                                     {"cells": cells, "seconds": {},
                                      "launches_per_cell": {}})
            row["seconds"][family] = secs
            row["launches_per_cell"][name] = counts[name] / cells
    # elastic: the split scripted through (4, 1) → (1, 4) → (2, 2)
    rt = mesh_runtime("jnp", (4, 1), 4, device)
    controller = CostController(model=CostModel(persist=False))
    script = iter([(1, 4), (2, 2)])
    controller.choose_mesh = lambda *a, **k: next(script, None)
    res, _, counts = mesh_mine(db, n_items, rt, "elastic", levels,
                               controller=controller, elastic=True)
    add(counts)
    if res.repartitions != 2 or rt.mesh_split != (2, 2):
        raise AssertionError(f"elastic run: {res.repartitions} "
                             f"repartitions, ending on {rt.mesh_split}")
    # retry: two injected failures of a counting job on (2, 2)
    calls = {"n": 0}

    def fail_twice(event, k):
        if event == "count_dispatch":
            calls["n"] += 1
            if calls["n"] in (2, 3):
                raise RuntimeError("injected shard failure")
    res, _, counts = mesh_mine(db, n_items, mesh_runtime("vertical", (2, 2), 4,
                                            device),
                               "retry", levels, elastic=False,
                               count_hook=fail_twice)
    add(counts)
    if res.retries != 2:
        raise AssertionError(f"retry run: {res.retries} retries, injected 2")
    # width-balanced shards
    rt = mesh_runtime("matmul", (4, 1), 4, device)
    res, _, counts = mesh_mine(db, n_items, rt, "balance", levels,
                               balance_shards_by_width=True)
    add(counts)
    if np.array_equal(rt._db_masks, db):
        raise AssertionError("balance run: the shards were not rebalanced")
    for name in FAMILY:
        if not total.get(name):
            raise AssertionError(f"the mesh phase never launched {name}")

    # each counting kernel at the shapes a cell gets, against its plain
    # version (these launches are not the path's)
    per = cands.shape[0] // NARROW_SPLIT[1]
    shard = db[:db.shape[0] // MESH_SPLITS[0][0]]
    rt = MapReduceRuntime(impl="vertical", device=device)
    vdb = rt.scatter_db(db, n_items=n_items)
    idx = torch.from_numpy(rt._padded_indices(cands)).to(device)
    shapes = {
        "narrow": (to_device_words(cands[:per], device),
                   to_device_words(db, device), idx[:per], vdb),
        "data shard": (to_device_words(cands, device),
                       to_device_words(shard, device), idx,
                       to_device_words(vertical_pack(shard, n_items), device)),
    }
    for label, (words, txns, ids, vdb) in shapes.items():
        for name in FAMILY:
            wrapper, plain = kernels.KERNELS[name]
            args = (vdb, ids) if name.startswith("vertical") else (words, txns)
            got = wrapper(*args)
            _sync(device)
            err = _max_abs_diff(got, plain(*args))
            print(f"  mesh kernel {name} at the {label} shape "
                  f"{tuple(args[0].shape)} x {tuple(args[1].shape)}: "
                  f"max|diff|={err}")
            if err:
                raise AssertionError(f"{name} disagrees at the {label} shape")

    with tempfile.TemporaryDirectory() as tmp:
        secs = mesh_processes(db, n_items, levels, "gloo", tmp, "cuda:0")
        print(f"mesh processes: 2 × 2 cells over gloo (NCCL "
              f"refuses two ranks on one GPU; gloo all-reduces card "
              f"tensors): {secs:.1f}s, levels equal to phase 4's on every "
              f"split and family")
        summary["processes"] = {"gloo_seconds": secs}
        if torch.cuda.device_count() >= 2:
            secs = mesh_processes(db, n_items, levels, "nccl", tmp, "cuda")
            print(f"mesh processes: 2 processes × 2 cells, one card each, "
                  f"over nccl: {secs:.1f}s, levels equal to phase 4's")
            summary["processes"]["nccl_seconds"] = secs
        else:
            print("mesh processes over nccl: not run (one card; it needs a "
                  "card a process)")
    print("mesh: " + json.dumps(summary))
    return total


def graph_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Device time of one ``fn()`` call without the host: ``n`` calls
    captured in one CUDA graph, the graph replayed ``reps`` times under
    CUDA events, the mean per call."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return time_ms(graph.replay, reps) / n


def time_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn()`` over ``reps`` calls, after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def library_overlap_count(a, width, b, valid=None, chunk=16384):
    """The matmul forms through ``torch._int_mm`` (cuBLASLt int8 tensor
    cores) plus compare-and-sum, over chunks of ``b``'s rows so the (M, N)
    int32 product stays a few GB.  Timed as a yardstick only."""
    out = torch.zeros(a.shape[0], dtype=torch.int32, device=a.device)
    for s in range(0, b.shape[0], chunk):
        bc = b[s:s + chunk]
        n = bc.shape[0]
        if n % 8:
            bc = torch.nn.functional.pad(bc, (0, 0, 0, 8 - n % 8))
        match = torch._int_mm(a, bc.T)[:, :n] == width[:, None]
        if valid is not None:
            match &= valid[s:s + n].bool()
        out += match.sum(dim=1, dtype=torch.int32)
    return out


def _library_support_count_matmul(cands, txns):
    return library_overlap_count(tunpack_bits(cands), tpopcount_rows(cands),
                                 tunpack_bits(txns))


def _library_vertical_count_matmul(vdb, idx):
    n_items = vdb.shape[0] - 1
    k = -(-n_items // 8) * 8
    A, nreal = vertical_membership(idx, n_items, k)
    vbits = tunpack_bits(vdb)
    planes = torch.nn.functional.pad(vbits[:n_items].T, (0, k - n_items))
    return library_overlap_count(A, nreal, planes.contiguous(),
                                 valid=vbits[n_items])


def _library_rule_scores_matmul(antes, cons, scores, baskets, exclude):
    """The matmul rule form through ``torch._int_mm`` (rules padded to a
    multiple of 8 rows, as it requires) plus compare-and-select.  Timed as
    a yardstick only."""
    R = antes.shape[0]
    pad = (0, 0, 0, (-R) % 8)
    bb = tunpack_bits(baskets)
    ab = torch.nn.functional.pad(tunpack_bits(antes), pad)
    ok = torch._int_mm(bb, ab.T)[:, :R] == tpopcount_rows(antes)[None, :]
    if exclude:
        cb = torch.nn.functional.pad(tunpack_bits(cons), pad)
        ok &= torch._int_mm(bb, cb.T)[:, :R] != tpopcount_rows(cons)[None, :]
    return torch.where(ok, scores[None, :],
                       torch.tensor(float("-inf"), device=scores.device))


def _library_delta_count_matmul(cands, txns, signs):
    T = txns.shape[0]
    tb = torch.nn.functional.pad(tunpack_bits(txns), (0, 0, 0, (-T) % 8))
    match = (torch._int_mm(tunpack_bits(cands), tb.T)[:, :T]
             == tpopcount_rows(cands)[:, None])
    return torch.where(match, signs[None, :], 0).sum(dim=1, dtype=torch.int32)


def width_rows() -> None:
    """Row 2's C entry point at each of ``WIDTH_SHAPES`` and ``WIDTHS``:
    exact against its plain version, then its device time from a CUDA
    graph beside the bound (2·C·T·32W bit operations at the b1 rate) and
    the int8-plane instance's time at that shape."""
    rng = np.random.default_rng(33)
    for C, T in WIDTH_SHAPES:
        for W in WIDTHS:
            c = to_device_words(rng.integers(0, 2 ** 32, (C, W), np.uint32)
                                & rng.integers(0, 2 ** 32, (C, W), np.uint32),
                                "cuda")
            t = to_device_words(rng.integers(0, 2 ** 32, (T, W), np.uint32),
                                "cuda")
            if not torch.equal(kernels.support_count_matmul(c, t),
                               kernels.support_count_matmul_plain(c, t)):
                raise AssertionError(f"support_count_matmul disagrees at "
                                     f"C={C} T={T} W={W}")
            ms = graph_ms(entry_launch("support_count_matmul", (c, t)))
            bound = 1e3 * 2.0 * C * T * 32 * W / B1_OPS_PER_S
            print(f"  width support_count_matmul C={C} T={T} W={W}: "
                  f"{ms:.4f} ms a launch (b1; bound {bound:.4f} ms), int8 "
                  f"planes {WIDTH_INT8_MS[(C, T, W)]:.4f} ms")


def vertical_l2_bytes(n_rows: int, tw: int, C: int, kmax: int) -> float:
    """The bytes one vertical_count launch reads from L2, reckoned from its
    instance: the DB once a candidate chunk (tiled), or kmax rows a
    candidate (the L2 instance), beside the indices."""
    if n_rows <= VERT_MAX_ROWS and kmax <= VERT_MAX_K:
        rows = -(-C // VERT_CHUNK) * n_rows
    else:
        rows = C * kmax
    return 4.0 * (rows * tw + C * kmax)


def entry_launch(name: str, args):
    """A launch of counting kernel ``name``'s C entry point on ``args``
    into a fresh output, without its wrapper (whose range check of the
    vertical indices synchronises): what a CUDA graph can capture."""
    a, b = args
    out = torch.empty(b.shape[0] if name.startswith("vertical") else
                      a.shape[0], dtype=torch.int32, device=a.device)
    if name == "vertical_count":
        ptrs = (a.data_ptr(), a.shape[0], a.shape[1], b.data_ptr(),
                b.shape[0], b.shape[1], out.data_ptr())
    elif name == "vertical_count_matmul":
        ptrs = (a.data_ptr(), a.shape[0] - 1, a.shape[1], b.data_ptr(),
                b.shape[0], b.shape[1], out.data_ptr())
    else:
        ptrs = (a.data_ptr(), b.data_ptr(), a.shape[0], b.shape[0],
                a.shape[1], out.data_ptr())
    return lambda: kernels._build.launch(name, *ptrs)


def phase_timing(launches, db, n_items, cands, rule_args, delta_args) -> list:
    device = torch.device("cuda")
    rt = MapReduceRuntime(impl="vertical", device=device)
    vdb = rt.scatter_db(db, n_items=n_items)
    idx_np = rt._padded_indices(cands)
    idx = torch.from_numpy(idx_np).to(device)
    words = to_device_words(cands, device)
    txns = to_device_words(db, device)
    C, W = cands.shape
    T, tw, kmax = db.shape[0], vdb.shape[1], idx_np.shape[1]
    k_real = np.maximum((idx_np != n_items).sum(axis=1), 1)
    print(f"largest phase: C={C} T={T} W={W} Tw={tw} kmax={kmax}")
    tiled = vertical_l2_bytes(vdb.shape[0], tw, C, kmax)
    each = vertical_l2_bytes(VERT_MAX_ROWS + 1, tw, C, kmax)
    print(f"  vertical_count reads {tiled / 1e9:.4f} GB from L2 a launch "
          f"(reckoned; {each / 1e9:.4f} GB reading each candidate's rows "
          f"from L2), for a vertical DB of {4e-6 * vdb.numel():.3f} MB")
    ante, cons, scores, baskets, _ = rule_args
    R, RW, Qp = ante.shape[0], ante.shape[1], baskets.shape[0]
    print(f"largest rule dispatch: Qp={Qp} R={R} W={RW}")
    dc, slab, signs = delta_args
    DC, DT, DW = dc.shape[0], slab.shape[0], dc.shape[1]
    print(f"largest delta update: C={DC} T={DT} W={DW}")

    # bytes: every input read once, the output written once; operations:
    # what these inputs need (real item slots, not kmax pads)
    vert_bytes = 4.0 * (vdb.numel() + idx.numel() + C)
    horz_bytes = 4.0 * (words.numel() + txns.numel() + C)
    rule_bytes = 4.0 * (2 * R * RW + R + Qp * RW + Qp * R)
    delta_bytes = 4.0 * (DC * DW + DT * DW + DT + DC)
    work = {
        "vertical_count": (vert_bytes, tw * float((k_real + 1).sum()),
                           CUDA_CORE_OPS_PER_S),
        # the AND-popcount of every candidate and transaction bit
        "support_count": (horz_bytes, 2.0 * C * T * 32 * W, B1_OPS_PER_S),
        "support_count_matmul": (horz_bytes, 2.0 * C * T * 32 * W,
                                 B1_OPS_PER_S),
        "vertical_count_matmul": (vert_bytes, 2.0 * C * 32 * tw * n_items,
                                  INT8_OPS_PER_S),
        # AND and compare of ante and cons words, then one select
        "rule_scores": (rule_bytes, Qp * R * (4.0 * RW + 1),
                        CUDA_CORE_OPS_PER_S),
        "rule_scores_matmul": (rule_bytes, 2 * 2.0 * Qp * R * 32 * RW,
                               B1_OPS_PER_S),
        "delta_count": (delta_bytes, 3.0 * DW * DC * DT, CUDA_CORE_OPS_PER_S),
        # the AND-popcount of every candidate and slab bit, as row 1
        "delta_count_matmul": (delta_bytes, 2.0 * DC * DT * 32 * DW,
                               B1_OPS_PER_S),
    }
    args = {"vertical_count": (vdb, idx), "vertical_count_matmul": (vdb, idx),
            "support_count": (words, txns),
            "support_count_matmul": (words, txns),
            "rule_scores": rule_args, "rule_scores_matmul": rule_args,
            "delta_count": delta_args, "delta_count_matmul": delta_args}
    # each popcount form computes the same function as its matmul twin, so
    # the twin's torch._int_mm yardstick is its library call too
    library = {"support_count_matmul": _library_support_count_matmul,
               "vertical_count_matmul": _library_vertical_count_matmul,
               "rule_scores_matmul": _library_rule_scores_matmul,
               "delta_count_matmul": _library_delta_count_matmul,
               "support_count": _library_support_count_matmul,
               "vertical_count": _library_vertical_count_matmul,
               "delta_count": _library_delta_count_matmul,
               "rule_scores": _library_rule_scores_matmul}
    rows = []
    # the TPU kernels' ports; phase 15 times candidate generation's
    for name in args:
        wrapper, plain = kernels.KERNELS[name]
        a = args[name]
        err = _max_abs_diff(wrapper(*a), plain(*a))
        if name in library:
            err = max(err, _max_abs_diff(wrapper(*a), library[name](*a)))
        if err:
            raise AssertionError(f"{name} disagrees at its largest shape")
        ms = time_ms(lambda: wrapper(*a), 5)
        if ms < 1.0:    # 50 calls: one stall of the shared host moves it less
            ms = time_ms(lambda: wrapper(*a), 50)
        plain_ms = time_ms(lambda: plain(*a), 2)
        lib_ms = (time_ms(lambda: library[name](*a), 2)
                  if name in library else None)
        nbytes, ops, rate = work[name]
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
        row = {"name": name, "route": "cuda", "source": SOURCE[name],
               "replaces": REPLACES[name], "launches": launches[name],
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": lib_ms}
        print(f"time {name}: max|diff|={err} {ms:.3f} ms (plain "
              f"{plain_ms:.3f}, library {lib_ms}, bound "
              f"{row['bound_ms']:.4f} by {row['bound_by']})")
        # the counting kernels through their C entry points, the others
        # through their wrappers, which never synchronise
        fn = (entry_launch(name, a) if name in FAMILY
              else (lambda: wrapper(*a)))
        print(f"  kernel only {name}: {graph_ms(fn):.4f} ms a launch from a "
              f"CUDA graph, beside the wrapper's {ms:.4f} ms back to back")
        if name in EARLIER_MS:
            print(f"  redesigned {name}: {ms:.3f} ms, earlier kernel "
                  f"{EARLIER_MS[name]:.3f} ms, bound "
                  f"{row['bound_ms']:.4f} ms, {ops / ms / 1e9:.1f} TOP/s "
                  f"achieved, library {lib_ms} ms")
        rows.append(row)
    # per-SM pipe rates of compute capability 9.0 (the CUDA C++ Programming
    # Guide's throughput table): 16 __popc results, 64 32-bit integer
    # operations and 128 bytes of shared memory a clock
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    clk = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]) * 1e6
    per_s = n_sms * clk
    print(f"  vertical_count at the SM pipes' rates ({n_sms} SMs at "
          f"{clk / 1e9:.3f} GHz): {1e3 * C * tw / (16 * per_s):.4f} ms for "
          f"C·Tw popcounts at 16 a clock an SM, "
          f"{1e3 * 4 * C * kmax * tw / (128 * per_s):.4f} ms for C·kmax·Tw "
          f"shared-memory words at 128 bytes a clock an SM")
    print(f"  delta_count on the integer pipes: "
          f"{1e3 * DC * DT * (DW + 2) / (64 * per_s):.4f} ms for C·T·(W+2) "
          f"LOP3s, compares and adds at 64 a clock an SM")
    print(f"  delta_count_matmul on the int8 tensor cores would be bound at "
          f"{1e3 * 2.0 * DC * DT * 32 * DW / INT8_OPS_PER_S:.4f} ms")
    print(f"  support_count on the CUDA cores would be bound at "
          f"{1e3 * 3.0 * W * C * T / CUDA_CORE_OPS_PER_S:.4f} ms "
          f"(C·T·3W integer operations at 67 TOP/s)")

    width_rows()

    # the torch ops that the earlier rule_scores_matmul wrapper ran before
    # its kernel: planes and popcounts of the arena and the baskets
    def unpack():
        tunpack_bits(ante), tpopcount_rows(ante)
        tunpack_bits(cons), tpopcount_rows(cons)
        tunpack_bits(baskets)
    print(f"time earlier rule_scores_matmul wrapper's unpack: "
          f"{time_ms(unpack, 5):.3f} ms")

    # the top-k after the rule kernels is a plain torch op, not a kernel
    s = kernels.rule_scores_matmul(*rule_args)
    kf = min(TOP_K * 8, R)
    topk_ms = time_ms(lambda: stable_top_k(s, kf), 5)
    unstable_ms = time_ms(lambda: torch.topk(s, kf, dim=1), 5)
    print(f"time stable_top_k (Qp={Qp}, R={R}, k={kf}): {topk_ms:.3f} ms "
          f"(torch.topk alone, ties unordered: {unstable_ms:.3f} ms)")
    return rows


# -- phase 15: candidate generation on the card ------------------------------


def _generation_inputs(cell: str, device):
    """The join inputs and the (candidates, level) prune inputs of one
    optimized_vfpc mine of the benchmark's ``cell`` rows on ``device``, as
    core/candidates.py's card path receives them (apriori_gen's join and
    the prune of its output included), and the generation kernels'
    launches during that mine."""
    root = os.path.dirname(os.path.abspath(__file__))
    if root not in sys.path:
        sys.path.insert(0, root)
    from portbench.data.generators import generate, pack
    with open(os.path.join(root, "portbench", "configs",
                           f"{cell}.json")) as f:
        config = json.load(f)
    rows = generate(config["dataset"])
    joins, gens, prunes = [], [], []
    torch.cuda.synchronize()
    kernels.reset_launches()
    saved = {name: getattr(candidates, name)
             for name in ("_join_on", "_apriori_gen_on", "_prune_on")}

    def record_join(prev, dev, parents=True):
        joins.append(prev.copy())
        return saved["_join_on"](prev, dev, parents)

    def record_gen(prev, k, dev):
        gens.append(prev.copy())
        return saved["_apriori_gen_on"](prev, k, dev)

    def record_prune(cands, prev, dev):
        prunes.append((cands.copy(), prev.copy()))
        return saved["_prune_on"](cands, prev, dev)

    candidates._join_on = record_join
    candidates._apriori_gen_on = record_gen
    candidates._prune_on = record_prune
    try:
        mine(db_masks=pack(rows), n_items=rows.shape[1],
             min_sup=config["mine"]["min_sup"], algorithm=ALGORITHM,
             runtime=MapReduceRuntime(impl=config["mine"]["impl"],
                                      device=device))
    finally:
        for name, fn in saved.items():
            setattr(candidates, name, fn)
    launched = generation_launches(f"candidates {cell} mine")
    # apriori_gen on the card joins its level and prunes the join's output
    return (joins + gens,
            prunes + [(candidates.join(p, 0), p) for p in gens], launched)


def host_ms(fn, reps: int) -> float:
    """Mean host-clock ms of ``fn()`` over ``reps`` calls, after a warm-up
    call: for a call that ends with its result on the host."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def _generation_row(name, cell, wrapper, plain, entry, home, numpy_path,
                    nbytes) -> dict:
    """One kernel's row: the wrapper against its plain version on the card
    and the card path's result home against the numpy path, exactly, then
    the times."""
    got, want = wrapper(), plain()
    for a, b in zip(got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{name} ({cell}) disagrees with its plain "
                                 f"version on the card")
    for a, b in zip(home(), numpy_path()):
        if a.dtype != b.dtype or a.tobytes() != b.tobytes():
            raise AssertionError(f"{name} ({cell}) differs from the numpy "
                                 f"path")
    row = {"name": name, "cell": cell, "replaces": "none",
           "ms": time_ms(wrapper, 50), "device_ms": graph_ms(entry),
           "plain_ms": time_ms(plain, 3),
           "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
           "host_ms": host_ms(home, 50), "numpy_ms": host_ms(numpy_path, 5)}
    print(f"candidates {name} {cell}: wrapper {row['ms']:.4f} ms, kernels "
          f"alone {row['device_ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, "
          f"bytes' bound {row['bound_ms']:.5f} ms; host ms a call "
          f"{row['host_ms']:.4f} (card path, upload to copy home) against "
          f"{row['numpy_ms']:.3f} (numpy)")
    return row


def phase_candidates(device) -> list:
    """Phase 15: the join and prune kernels at the mining cells' largest
    shapes."""
    from repro_torch.kernels import candidate_gen as cg
    t0 = time.perf_counter()
    rows = []
    for cell in ("c20d200k", "mushroom"):
        joins, prunes, launched = _generation_inputs(cell, device)
        prev = max(joins,
                   key=lambda p: candidates.join_pairs(p, 0)[0].shape[0])
        words = to_device_words(prev, device)
        n, W = prev.shape
        out, left, right = cg.join_words(words)
        M = out.shape[0]
        print(f"candidates {cell}: {len(joins)} joins, {len(prunes)} prunes "
              f"a mine, launches in the mine {launched}; largest join {n} -> "
              f"{M} rows of {W} words")
        scratch = torch.empty(cg.SCRATCH_INTS, dtype=torch.int32,
                              device=device)

        def join_entry():
            kernels._build.launch("candidate_join", words.data_ptr(), n, W,
                                  scratch.data_ptr(), None, None, None)
            kernels._build.launch("candidate_join", words.data_ptr(), n, W,
                                  scratch.data_ptr(), out.data_ptr(),
                                  left.data_ptr(), right.data_ptr())
        rows.append(_generation_row(
            "candidate_join", cell, lambda: cg.join_words(words),
            lambda: cg.join_words_plain(words), join_entry,
            lambda: candidates.join_pairs(prev, 0, device=device),
            lambda: candidates.join_pairs(prev, 0),
            4.0 * (n * W + M * W) + 16.0 * M))

        cands, level = max(prunes, key=lambda p: p[0].shape[0])
        cw, lw = to_device_words(cands, device), to_device_words(level, device)
        m, kept = cands.shape[0], cg.prune_words(cw, lw).shape[0]
        print(f"candidates {cell}: largest prune {m} -> {kept} rows against "
              f"a level of {level.shape[0]}")
        pruned = torch.empty((max(kept, 1), W), dtype=torch.int32,
                             device=device)

        def prune_entry():
            kernels._build.launch("candidate_prune", cw.data_ptr(), m,
                                  lw.data_ptr(), level.shape[0], W,
                                  scratch.data_ptr(), None)
            kernels._build.launch("candidate_prune", cw.data_ptr(), m,
                                  lw.data_ptr(), level.shape[0], W,
                                  scratch.data_ptr(), pruned.data_ptr())
        rows.append(_generation_row(
            "candidate_prune", cell, lambda: (cg.prune_words(cw, lw),),
            lambda: (cg.prune_words_plain(cw, lw),), prune_entry,
            lambda: (candidates.prune(cands, level, 0, device=device),),
            lambda: (candidates.prune(cands, level, 0),),
            4.0 * (m * W + level.shape[0] * W + kept * W)))
        for row in rows[-2:]:
            row["mine_launches"] = launched
    print(f"candidates: {time.perf_counter() - t0:.1f}s")
    return rows


def _mine_tenants(txns, n_items, device):
    """The serving CLI's tenant split, mined and turned into rules on
    ``device``."""
    args = Namespace(min_sup=SERVE_MIN_SUP, min_conf=SERVE_MIN_CONF,
                     mine_algorithm=ALGORITHM, device=device)
    return mine_tenants(txns, n_items, N_TENANTS, args)


def _ruleset_equal(a, b) -> bool:
    for f in ("ante_masks", "cons_masks", "union_counts", "ante_counts",
              "cons_counts", "confidence", "lift", "leverage", "score"):
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.tobytes() != y.tobytes():
            return False
    return a.n_items == b.n_items and a.n_txns == b.n_txns


def _oracle(rulesets, pair, kf: int):
    """Brute-force recommendations of one (tenant, basket) query in numpy:
    every rule of the tenant whose antecedent the basket holds and whose
    consequent it does not, by score (ties lowest index first), cut to the
    engine's ``kf`` fetched slots, consequents de-duplicated, top ``TOP_K``."""
    name, basket = pair
    rs = rulesets[name]
    b = pack_itemsets([[i for i in basket if 0 <= i < rs.n_items]],
                      rs.n_items)[0]
    ok = (((rs.ante_masks & b) == rs.ante_masks).all(axis=1)
          & ~((rs.cons_masks & b) == rs.cons_masks).all(axis=1))
    hits = np.nonzero(ok)[0]
    hits = hits[np.argsort(-rs.score[hits], kind="stable")][:kf]
    out, seen = [], set()
    for r in hits:
        cons = tuple(int(i) for i in np.nonzero(np.unpackbits(
            rs.cons_masks[r].view(np.uint8), bitorder="little"))[0])
        if cons in seen:
            continue
        seen.add(cons)
        out.append((cons, float(rs.score[r])))
        if len(out) == TOP_K:
            break
    return out


def _serving_split(eng, queries, reps: int = 4) -> dict:
    """Mean per-dispatch ms of each step of a fused 512-query dispatch:
    host pack, upload, scoring kernel, top-k, transfer home, host decode."""
    state = eng.store.state
    scorer = kernels.KERNELS[
        {v: k for k, v in RULE_FAMILY.items()}[eng.family]][0]
    kf = min(TOP_K * 8, len(state))
    n = SERVE_BATCH * MAX_FUSE
    split = dict.fromkeys(("pack", "upload", "kernel", "top_k", "to_host",
                           "decode"), 0.0)
    for i in range(reps):
        pairs = queries[i * n:(i + 1) * n]
        t = [time.perf_counter()]
        packed = state.pack(pairs)
        packed = np.concatenate([packed, np.zeros(
            (bucket_rows(n) - n, state.W), np.uint32)])
        t.append(time.perf_counter())
        baskets = to_device_words(packed, state.device)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        s = scorer(state.d_ante, state.d_cons, state.d_scores, baskets)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        vals, idx = stable_top_k(s[:n], kf)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        t.append(time.perf_counter())
        eng._decode(state, vals, idx, TOP_K)
        t.append(time.perf_counter())
        for key, a, b in zip(split, t, t[1:]):
            split[key] += 1e3 * (b - a) / reps
    return split


def phase_serving():
    """Drive rule serving with each scoring family; return the launches of
    the rule kernels and the arguments of the largest rule dispatch."""
    txns, n_items = dataset_by_name(SERVE_DATASET, seed=0)
    t0 = time.perf_counter()
    tenants, slices = _mine_tenants(txns, n_items, "cuda")
    gen_s = time.perf_counter() - t0
    counts = {t: len(r) for t, r in tenants.items()}
    widths = {t: r.ante_masks.shape[1] for t, r in tenants.items()}
    t0 = time.perf_counter()
    cpu_tenants, _ = _mine_tenants(txns, n_items, "cpu")
    cpu_s = time.perf_counter() - t0
    for t in tenants:
        if not _ruleset_equal(tenants[t], cpu_tenants[t]):
            raise AssertionError(f"tenant {t}: card RuleSet differs from CPU")
    store = RuleStore(tenants=tenants, device="cuda")
    print(f"rules: {SERVE_DATASET} n_txns={len(txns)} n_items={n_items} "
          f"{N_TENANTS} tenants mined + rules on the card in {gen_s:.2f}s "
          f"(CPU {cpu_s:.2f}s): {sum(counts.values())} rules {counts}, "
          f"W={widths} arena W={store.state.W}; RuleSet arrays bitwise "
          f"equal to the CPU run")

    names = list(tenants)
    queries = [(names[i % N_TENANTS],
                make_queries(slices[names[i % N_TENANTS]], 1, seed=1 + i)[0])
               for i in range(N_QUERIES)]
    batches = [queries[i:i + SERVE_BATCH]
               for i in range(0, N_QUERIES, SERVE_BATCH)]
    launches, results = {}, {}
    for name, family in RULE_FAMILY.items():
        eng = RuleServeEngine(store, top_k=TOP_K, impl=family,
                              max_fuse=MAX_FUSE, device="cuda")
        eng.warmup(SERVE_BATCH * MAX_FUSE)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t1 = time.perf_counter()
        results[family], records = eng.serve(batches)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        counts = launch_counts()
        launches[name] = counts[name]
        lat = latency_ms(records)
        print(f"serve impl={family}: {N_QUERIES} queries in {secs:.3f}s = "
              f"{N_QUERIES / secs:,.0f} qps, {len(records)} dispatches, "
              f"p50={np.percentile(lat, 50):.3f} ms "
              f"p99={np.percentile(lat, 99):.3f} ms, launches="
              f"{ {k: v for k, v in counts.items() if v} }")
        if counts[name] <= 0 or any(v for k, v in counts.items() if k != name):
            raise AssertionError(f"impl={family} did not run on {name} alone")
        split = _serving_split(eng, queries)
        print(f"serve impl={family} split per {SERVE_BATCH * MAX_FUSE}-query "
              f"dispatch (ms): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in split.items()))
    # impl=auto, after the fixed families so that the arena's decode cache
    # is as warm for it as for the second of them: the warm-up sweeps both
    # rule kernels at each padded query count (the rules plan), then every
    # dispatch runs its bucket's winner
    fresh_plan_caches()
    eng = RuleServeEngine(store, top_k=TOP_K, max_fuse=MAX_FUSE,
                          device="cuda")
    kernels.reset_launches()
    t1 = time.perf_counter()
    eng.warmup(SERVE_BATCH * MAX_FUSE)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t1
    swept = launch_counts()
    kernels.reset_launches()
    t1 = time.perf_counter()
    results["auto"], records = eng.serve(batches)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    counts = launch_counts()
    plans = dict(sorted(eng.store.state.plans.items()))
    lat = latency_ms(records)
    print(f"serve impl=auto: warm-up with the plan sweeps {warm_s:.3f}s "
          f"(launches { {k: v for k, v in swept.items() if v} }), "
          f"families by padded query count {plans}; "
          f"{N_QUERIES} queries in {secs:.3f}s = {N_QUERIES / secs:,.0f} "
          f"qps, {len(records)} dispatches, p50={np.percentile(lat, 50):.3f}"
          f" ms p99={np.percentile(lat, 99):.3f} ms, launches="
          f"{ {k: v for k, v in counts.items() if v} }")
    if not all(swept[k] for k in RULE_FAMILY):
        raise AssertionError("the rules plan's sweep skipped a kernel")
    ran = {k for k, v in RULE_FAMILY.items() if v in plans.values()}
    if (sum(counts.values()) != len(records)
            or any(v for k, v in counts.items() if k not in ran)):
        raise AssertionError("impl=auto ran a kernel its plans did not pick")
    if results["jnp"] != results["matmul"]:
        raise AssertionError("the two scoring families recommend differently")
    if results["auto"] != results["jnp"]:
        raise AssertionError("impl=auto recommends differently")

    cpu_store = RuleStore(tenants=cpu_tenants, device="cpu")
    t1 = time.perf_counter()
    cpu, _ = RuleServeEngine(cpu_store, top_k=TOP_K, impl="jnp",
                             max_fuse=MAX_FUSE, device="cpu").serve(batches)
    print(f"serve device=cpu impl=jnp (plain): "
          f"{time.perf_counter() - t1:.2f}s")
    if cpu != results["jnp"]:
        raise AssertionError("card recommendations differ from the CPU run")
    flat = [recs for batch in results["jnp"] for recs in batch]
    kf = min(TOP_K * 8, len(store.state))
    for pair, recs in zip(queries[:ORACLE_QUERIES], flat):
        if [(r.consequent, r.score) for r in recs] != _oracle(cpu_tenants,
                                                              pair, kf):
            raise AssertionError(f"query {pair} differs from the oracle")
    n_recs = sum(len(r) for r in flat)
    print(f"recommendations: {n_recs} over {N_QUERIES} queries, identical "
          f"for impl=auto, both families and the CPU run; the first "
          f"{ORACLE_QUERIES} "
          f"equal the numpy brute-force oracle")

    controller = CostController(model=CostModel(persist=False))
    eng = RuleServeEngine(store, top_k=TOP_K, max_fuse=MAX_FUSE,
                          controller=controller, device="cuda")
    eng.warmup(SERVE_BATCH)
    record: dict = {}
    serve_open_loop(eng, queries, Namespace(
        latency_slo_ms=OPEN_LOOP_SLO_MS, batch=SERVE_BATCH, max_wait_ms=5.0,
        cache_size=256, no_fair_shedding=False, seed=0,
        rate_qps=OPEN_LOOP_QPS), controller, record)
    ol = record["open_loop"]
    print(f"open loop impl={eng.family} on {torch.cuda.get_device_name(0)}: "
          f"offered {OPEN_LOOP_QPS:,.0f} qps, sustained "
          f"{ol['sustained_qps']:,.0f} qps, p99 {ol['p99_ms']:.3f} ms "
          f"(SLO {OPEN_LOOP_SLO_MS} ms), shed rate {ol['shed_rate']:.4f}")

    n = SERVE_BATCH * MAX_FUSE
    packed = store.state.pack(queries[:n])
    baskets = to_device_words(np.concatenate([packed, np.zeros(
        (bucket_rows(n) - n, store.state.W), np.uint32)]), "cuda")
    rule_args = (store.state.d_ante, store.state.d_cons, store.state.d_scores,
                 baskets, True)
    return launches, rule_args, queries


def phase_stream():
    """Stream mushroom through a sliding window with each delta family;
    return the launches of the delta kernels and the largest update's
    arguments."""
    txns, n_items = dataset_by_name(SERVE_DATASET, seed=0)
    largest: dict = {}
    delta_count = stream_miner.delta_count

    def record(cands, added, evicted, **kw):
        if cands.shape[0] >= largest.get("cands", np.zeros((0,))).shape[0]:
            largest.update(cands=cands, added=added, evicted=evicted)
        return delta_count(cands, added, evicted, **kw)
    stream_miner.delta_count = record
    launches, published = {}, {}
    fresh_plan_caches()
    try:
        for name, family in [("auto", "auto"), *DELTA_FAMILY.items()]:
            miner = StreamMiner(n_items, SERVE_MIN_SUP, capacity=CAPACITY,
                                min_confidence=SERVE_MIN_CONF, impl=family,
                                device="cuda")
            torch.cuda.synchronize()
            kernels.reset_launches()
            fill = min(len(txns), CAPACITY)
            rec = miner.push(txns[:fill])
            print(f"stream impl={family} prefill: {fill} txns → "
                  f"{rec.n_frequent} frequent itemsets, {rec.n_rules} rules "
                  f"({rec.path}, {rec.update_seconds:.3f}s), tracked "
                  f"{miner.n_tracked}")
            paths: dict = {}
            published[family] = []
            for u in range(STREAM_UPDATES):
                lo = (fill + u * STREAM_BATCH) % max(len(txns) - STREAM_BATCH,
                                                     1)
                rec = miner.push(txns[lo:lo + STREAM_BATCH])
                paths[rec.path] = paths.get(rec.path, 0) + 1
                scratch = mine(db_masks=miner.window.contents(),
                               n_items=n_items, min_sup=SERVE_MIN_SUP,
                               algorithm=miner.algorithm,
                               runtime=MapReduceRuntime(device="cuda"))
                if not levels_equal(miner.levels, scratch.levels):
                    raise AssertionError(
                        f"update {u} ({rec.path}) differs from scratch")
                published[family].append(dict(miner.levels))
                print(f"  update {u}: {rec.path} +{rec.n_added}/"
                      f"-{rec.n_evicted} {1e3 * rec.update_seconds:.2f} ms "
                      f"(delta {1e3 * rec.delta_seconds:.2f}, re-mine "
                      f"{1e3 * rec.remine_seconds:.2f}, refresh "
                      f"{1e3 * rec.refresh_seconds:.2f}) frequent="
                      f"{rec.n_frequent} rules={rec.n_rules}")
            torch.cuda.synchronize()
            counts = launch_counts()
            print(f"stream impl={family}: paths {paths}, tracked "
                  f"{miner.n_tracked}, delta families "
                  f"{dict(miner.delta_families)}, launches "
                  f"{ {k: v for k, v in counts.items() if v} }; every "
                  f"update equals a scratch mine of the window")
            if family == "auto":
                # the delta plan's sweep runs both delta kernels
                if not all(counts[k] for k in DELTA_FAMILY):
                    raise AssertionError("the delta plan's sweep skipped a "
                                         "kernel")
                continue
            launches[name] = counts[name]
            other = [k for k in DELTA_FAMILY if k != name]
            if counts[name] <= 0 or any(counts[k] for k in other):
                raise AssertionError(f"impl={family} did not run on {name} "
                                     f"alone")
    finally:
        stream_miner.delta_count = delta_count
    for family in DELTA_FAMILY.values():
        if not all(levels_equal(a, b) for a, b in zip(published["auto"],
                                                    published[family])):
            raise AssertionError(f"stream impl=auto differs from {family}")
    print("stream: impl=auto published the levels of both fixed families "
          "after every update")
    slab, signs = build_slab(largest["added"], largest["evicted"])
    delta_args = (to_device_words(largest["cands"], "cuda"),
                  to_device_words(slab, "cuda"),
                  torch.from_numpy(signs).to("cuda"))
    return launches, delta_args


def fresh_plan_caches() -> None:
    """Empty plan and cost-model caches from here on.  The mining phases
    calibrate every counting family's fit, and a plan prunes from its sweep
    a family those fits price far above the best, so a sweep that must
    time every kernel starts from fresh caches."""
    import repro_torch.costmodel.model as costmodel_model
    from repro_torch.kernels import autotune
    fresh = tempfile.mkdtemp(dir=os.path.dirname(autotune.cache_path()))
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(fresh, "at.json")
    os.environ["REPRO_TORCH_COSTMODEL_CACHE"] = os.path.join(fresh, "cm.json")
    autotune._memory_cache.clear()
    costmodel_model._default = None


def phase_plans(db, n_items, rule_args, delta_args) -> dict:
    """Each kind's cross-family plan at its path's shape — the count plan
    at mine()'s scatter shape, the rules plan at the largest dispatch, the
    delta plan at the largest update — swept on a fresh plan cache and a
    fresh cost model (so no fit prunes a family).  Return the launches each
    kernel made during the three sweeps."""
    from repro_torch.kernels import autotune
    fresh_plan_caches()
    n, w = db.shape
    ante, _, _, baskets, _ = rule_args
    cands, slab, _ = delta_args
    shapes = {
        # MapReduceRuntime._scatter_current's representative phase shape
        "count": dict(C=max(min(max(16 * n_items, 256), 4096), 32), T=n,
                      W=w, kmax=4),
        "rules": dict(C=ante.shape[0], T=baskets.shape[0], W=ante.shape[1]),
        "delta": dict(C=cands.shape[0], T=slab.shape[0], W=cands.shape[1]),
    }
    torch.cuda.synchronize()
    kernels.reset_launches()
    for kind, shape in shapes.items():
        t1 = time.perf_counter()
        plan = autotune.tuned_plan(kind, device="cuda", **shape)
        secs = time.perf_counter() - t1
        timed = plan["timed_us"]
        if set(timed) != set(autotune.PLAN_FAMILIES[kind]):
            raise AssertionError(f"the {kind} plan timed {sorted(timed)}")
        if timed[plan["family"]] != min(timed.values()):
            raise AssertionError(f"the {kind} plan's winner is not fastest")
        print(f"plan {kind}: " + json.dumps(
            {"shape": shape, "winner": plan["family"], "impl": plan["impl"],
             "timed_us": timed, "sweep_s": secs}))
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"plan sweeps: launches {counts}")
    if not all(counts.values()):
        raise AssertionError("a kernel was not launched by the plan sweeps")
    return counts

# -- phase 10: LM serving ------------------------------------------------------


def _rel_err(want: torch.Tensor, got: torch.Tensor) -> float:
    want, got = want.float().cpu(), got.float().cpu()
    return float((want - got).abs().max() / (want.abs().max() + 1e-9))


def numpy_tree(model, seed: int) -> dict:
    """A parameter tree in the JAX package's layout (nested dicts, block
    leaves stacked under ``blocks/sub{j}``, ``enc_blocks`` and
    ``dec_blocks``), float32 from a numpy seed, each leaf drawn from its
    reference distribution (norms and ``D_skip`` near 1, the learned
    positions small and non-zero so they matter)."""
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for path, shape in reference_shapes(model).items():
        name = path[-1]
        dims = shape[1:] if path[0] in STACKS else shape
        if name in ("scale", "q_norm", "k_norm", "out_norm", "D_skip"):
            arr = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "dt_bias":     # softplus(dt_bias) in [1e-3, 1e-1]
            arr = np.log(np.expm1(np.exp(rng.uniform(
                np.log(1e-3), np.log(1e-1), shape))))
        elif name == "A_log":
            arr = np.log(rng.uniform(1.0, 16.0, shape))
        elif name in ("table", "pos_embed", "dec_pos", "enc_pos"):
            arr = 0.02 * rng.standard_normal(shape)
        else:   # the reference's init scales: 1/sqrt(fan-in)
            if name == "wo":
                fan_in = dims[0] * dims[1]
            elif "moe" in path and name != "router":   # (E, in, out)
                fan_in = dims[1]
            else:
                fan_in = dims[0]
            arr = fan_in ** -0.5 * rng.standard_normal(shape)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[name] = arr.astype(np.float32)
    return tree


def frontend_batch(cfg, batch: int, seed: int, device) -> dict:
    """The frontend stubs' inputs from a seed, on ``device`` in the model
    dtype: ``vision_embeds`` (B, n_frontend_tokens, D) for the VLM,
    ``frame_embeds`` (B, enc_seq, D) for the encoder-decoder, else none."""
    if cfg.frontend == "vision_stub":
        key, n = "vision_embeds", cfg.n_frontend_tokens
    elif cfg.frontend == "audio_stub":
        key, n = "frame_embeds", cfg.enc_seq
    else:
        return {}
    gen = torch.Generator(device=device).manual_seed(seed)
    embeds = torch.randn((batch, n, cfg.d_model), generator=gen,
                         device=device).mul_(0.5)
    return {key: embeds.to(getattr(torch, cfg.dtype))}


def teacher_forced(model, toks: np.ndarray, S: int,
                   extra: dict | None = None) -> torch.Tensor:
    """Logits of prefill(toks[:, :S]) (with ``extra``, the frontend
    inputs) and of a decode step fed each later token: (1 + T - S, B, Vp)."""
    dev = model.device
    toks = torch.as_tensor(toks, dtype=torch.long, device=dev)
    B, T = toks.shape
    logits, caches = model.prefill({"tokens": toks[:, :S], **(extra or {})},
                                   T)
    out = [logits]
    for t in range(S, T):
        logits, caches = model.decode_step(
            caches, toks[:, t:t + 1],
            torch.full((B,), t, dtype=torch.long, device=dev))
        out.append(logits)
    return torch.stack(out)


def _serve(model, prompts, lens, algo, max_new, eos_id=-1, extra=None,
           **kw):
    if algo == "measured":
        kw["controller"] = CostController(CostModel(persist=False),
                                          device=model.device)
    eng = ServeEngine(model, cache_len=prompts.shape[1] + max_new,
                      algorithm=algo, **kw)
    return eng.generate(prompts, prompt_lens=lens, max_new_tokens=max_new,
                        eos_id=eos_id, extra_batch=extra)


def _ragged_prompts(cfg, rng, batch, lengths):
    lens = rng.integers(lengths[0], lengths[1] + 1, batch).astype(np.int32)
    prompts = rng.integers(1, cfg.vocab_size,
                           (batch, lengths[1])).astype(np.int32)
    for i, n in enumerate(lens):
        prompts[i, n:] = 0
    return prompts, lens


def lm_small(device, arch: str = "qwen3-14b", **overrides) -> None:
    """An arch's smoke config (``overrides`` replacing fields): one numpy
    tree carried into a model on the card and one on the CPU.  float32
    (TF32 off): teacher-forced logits over prefill and 4 decode steps
    within 1e-4, and every algorithm's tokens equal on both devices to the
    CPU's spc; bf16: the logits within 0.03."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), **overrides)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    cpu32 = build_model(cfg32, device="cpu", seed=None)
    card32 = build_model(cfg32, device=device, seed=None)
    tree = numpy_tree(cpu32, seed=0)
    load_reference_params(cpu32, tree)
    load_reference_params(card32, tree)
    rng = np.random.default_rng(1)
    V = cfg.vocab_size
    S = 12 if cfg.frontend != "vision_stub" else cfg.n_frontend_tokens + 4
    toks = rng.integers(0, V, (4, S + LM_EXTRA))
    prompts, lens = _ragged_prompts(cfg, rng, 4, (3, 8) if S == 12
                                    else (S - 4, S))

    def extra(model, dtype):
        fe = frontend_batch(dataclasses.replace(cfg, dtype=dtype), 4, 2,
                            "cpu")
        return {k: v.to(model.device) for k, v in fe.items()}

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        err32 = _rel_err(
            teacher_forced(cpu32, toks, S, extra(cpu32, "float32"))[..., :V],
            teacher_forced(card32, toks, S,
                           extra(card32, "float32"))[..., :V])
        want = _serve(cpu32, prompts, lens, "spc", 16,
                      extra=extra(cpu32, "float32"))[0]
        for algo in sorted(ALGORITHMS):
            for model in (cpu32, card32):
                got = _serve(model, prompts, lens, algo, 16,
                             extra=extra(model, "float32"))[0]
                if not np.array_equal(got, want):
                    raise AssertionError(f"lm small {cfg.name}: {algo} on "
                                         f"{model.device} differs from spc")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    if err32 > LM_F32_TOL:
        raise AssertionError(f"lm small {cfg.name} float32: card vs CPU "
                             f"{err32}")
    cpu16 = build_model(cfg, device="cpu", seed=None)
    card16 = build_model(cfg, device=device, seed=None)
    cpu16.load_state_dict(cpu32.state_dict())     # cast where bf16
    card16.load_state_dict(cpu32.state_dict())
    err16 = _rel_err(
        teacher_forced(cpu16, toks, S, extra(cpu16, cfg.dtype))[..., :V],
        teacher_forced(card16, toks, S, extra(card16, cfg.dtype))[..., :V])
    print(f"lm small {cfg.name} ({cfg.family}, heads {cfg.n_heads} padded "
          f"to {cfg.padded_heads}, experts {cfg.n_experts} padded to "
          f"{cfg.experts_padded}): card vs CPU, prefill + {LM_EXTRA} decode "
          f"steps: float32 rel err {err32:.3g} (tol {LM_F32_TOL}), bf16 "
          f"{err16:.3g} (tol {LM_BF16_TOL}); tokens of all "
          f"{len(ALGORITHMS)} algorithms equal on both")
    if err16 > LM_BF16_TOL:
        raise AssertionError(f"lm small {cfg.name} bf16: card vs CPU "
                             f"{err16}")


def moe_drops(device) -> None:
    """One MoE layer (qwen3-moe-30b-a3b's smoke config, 8 experts padded to
    16, capacity factor 0.5) that drops assignments: the routed and the
    dense path on the card against the CPU on the same float32 weights and
    inputs, within 1e-4 (TF32 off)."""
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b", smoke=True),
                              dtype="float32", capacity_factor=0.5)
    cpu = moe.MoE(cfg, "cpu")
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    card = moe.MoE(cfg, device)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn((4, 24, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            drops = [moe.n_dropped(m, x.to(m.router.device), cfg)
                     for m in (cpu, card)]
            routed = [moe.moe_apply(m, x.to(m.router.device), cfg)
                      for m in (cpu, card)]
            dense = [moe.moe_apply_dense(m, x.to(m.router.device), cfg)
                     for m in (cpu, card)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    err = max(_rel_err(routed[0][0], routed[1][0]),
              _rel_err(routed[0][1][None], routed[1][1][None]),
              _rel_err(dense[0], dense[1]))
    print(f"moe drops {cfg.name} (capacity factor {cfg.capacity_factor}, "
          f"{moe.capacity(cfg, 96)} slots an expert): {drops[1]} of "
          f"{96 * cfg.top_k} assignments dropped on the card, {drops[0]} on "
          f"the CPU; routed, aux and dense card vs CPU rel err {err:.3g} "
          f"(tol {LM_F32_TOL})")
    if drops[0] != drops[1] or drops[1] == 0 or err > LM_F32_TOL:
        raise AssertionError(f"moe drops: {drops}, err {err}")


def _full_config(arch: str, n_layers: int | None):
    cfg = get_config(arch)
    return (cfg if n_layers is None
            else dataclasses.replace(cfg, n_layers=n_layers))


def lm_full(arch: str, device, n_layers: int | None = None) -> None:
    """One config at full width on the card (``n_layers`` cuts its depth):
    random init, ragged prompts served by every algorithm (tokens equal
    to spc's), prefill/decode parity, EOS trimming and pipelining."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = _full_config(arch, n_layers)
    t0 = time.perf_counter()
    model = build_model(cfg, device=device, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    wbytes = model.weight_bytes()
    floor_ms = wbytes / HBM_BYTES_PER_S * 1e3
    rng = np.random.default_rng(0)
    lengths = LM_PROMPT
    if cfg.frontend == "vision_stub":   # the stub tokens lead every prompt
        lengths = tuple(cfg.n_frontend_tokens + n for n in LM_PROMPT)
    prompts, lens = _ragged_prompts(cfg, rng, LM_BATCH, lengths)
    extra = frontend_batch(cfg, LM_BATCH, 0, device)
    cache_len = prompts.shape[1] + LM_NEW
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.long,
                                       device=device), **extra}
    last = torch.as_tensor(lens - 1, dtype=torch.long, device=device)

    def prefill():
        model.prefill(batch, cache_len, last)
        torch.cuda.synchronize()

    prefill()
    t0 = time.perf_counter()
    for _ in range(3):
        prefill()
    prefill_ms = (time.perf_counter() - t0) / 3 * 1e3
    _serve(model, prompts, lens, "spc", 4, extra=extra)   # warm-up
    # one decode step at the serving batch: back to back on the host, and
    # the device alone (steps replayed from a CUDA graph)
    _, caches = model.prefill(batch, cache_len, last)
    token = torch.ones((LM_BATCH, 1), dtype=torch.long, device=device)
    pos = torch.as_tensor(lens, dtype=torch.long, device=device)

    def step():
        model.decode_step(caches, token, pos)

    eager_ms, device_ms = time_ms(step, 10), graph_ms(step, n=4, reps=3)
    del caches
    depth = get_config(arch).n_layers
    print(f"lm {arch}: layers={cfg.n_layers}/{depth} params={n_params} "
          f"(param_count() {cfg.param_count()}, padded heads "
          f"{cfg.padded_heads}, padded experts {cfg.experts_padded}) "
          f"weight_bytes={wbytes} init_s={init_s:.3f} "
          f"prefill_ms={prefill_ms:.3f} (B={LM_BATCH}, S={prompts.shape[1]}"
          f", lens {lens.tolist()}{', ' + ', '.join(extra) if extra else ''}"
          f") decode step {eager_ms:.3f} ms back to back, {device_ms:.3f} ms "
          f"on the device alone (CUDA graph), HBM floor {floor_ms:.3f} ms "
          f"(weights at 3.35 TB/s)")
    base, rows = None, {}
    for algo in sorted(ALGORITHMS, key=lambda a: a != "spc"):
        out, recs = _serve(model, prompts, lens, algo, LM_NEW, extra=extra)
        steps = sum(r.npass for r in recs)
        secs = sum(r.elapsed for r in recs)
        tokens = sum(r.tokens_emitted for r in recs)
        rows[algo] = {"dispatches": len(recs),
                      "widths": [r.npass for r in recs],
                      "decode_ms_per_step": secs / steps * 1e3,
                      "tok_s": tokens / secs}
        print(f"lm {arch} {algo}: " + json.dumps(rows[algo]))
        if base is None:
            base = out
        elif not np.array_equal(out, base):
            raise AssertionError(f"lm {arch}: {algo} differs from spc")
    full = rng.integers(1, cfg.vocab_size, (LM_BATCH, lengths[1]))
    S = full.shape[1] - LM_EXTRA
    for seed in MOE_PARITY_SEEDS if cfg.n_experts else (0,):
        toks = (full if seed == 0 else np.random.default_rng(seed).integers(
            1, cfg.vocab_size, full.shape))
        parity, differs, pairs = prefill_decode_parity(model, toks, S, extra)
        line = (f"prefill({S}) + {LM_EXTRA} decode steps vs prefill("
                f"{S + LM_EXTRA})")
        if cfg.n_experts:
            print(f"lm {arch} seed {seed}: {line} at capacity factor 16, "
                  f"router picks pinned to prefill({S + LM_EXTRA})'s: rel "
                  f"err {parity:.4g} (bound {LM_PARITY_TOL}); unpinned, "
                  f"{differs} of {pairs} (row, position, MoE layer) picks "
                  f"would differ")
        else:
            print(f"lm {arch}: {line}: rel err {parity:.4g} (bound "
                  f"{LM_PARITY_TOL})")
        if parity >= LM_PARITY_TOL:
            raise AssertionError(f"lm {arch}: prefill/decode parity "
                                 f"{parity}")
    eos_id = int(base[0, 3])
    pruned, _ = _serve(model, prompts, lens, "fpc", LM_NEW, eos_id, extra)
    opt, recs1 = _serve(model, prompts, lens, "optimized_vfpc", LM_NEW,
                        eos_id, extra)
    piped, recs2 = _serve(model, prompts, lens, "optimized_vfpc", LM_NEW,
                          eos_id, extra, pipeline_depth=2)
    stop = int(np.argmax(opt[0] == eos_id))
    waste = [sum(r.wasted_tokens for r in recs) for recs in (recs1, recs2)]
    if not (np.array_equal(pruned, opt) and np.array_equal(opt, piped)
            and (opt[0, stop + 1:] == 0).all() and waste[1] >= waste[0]):
        raise AssertionError(f"lm {arch}: EOS trimming or pipelining "
                             f"changed the output")
    peak = torch.cuda.max_memory_allocated()
    print(f"lm {arch}: eos {eos_id} (row 0 stops at {stop}): fpc == "
          f"optimized_vfpc == pipeline_depth=2; wasted {waste[0]} -> "
          f"{waste[1]}; max_memory_allocated={peak}")
    del model, extra, batch
    if cfg.n_experts:
        moe_parity_f32(arch, device, full, S)


class RouteLog:
    """While entered, wraps ``moe._top_k``, through which every router pick
    goes.  Without ``pin`` it records each call's picks (``picks``, in call
    order).  With ``pin`` (call index -> expert ids), it hands each call the
    pinned ids and their probabilities in place of its own picks, and counts
    the rows whose own pick set would have differed (``differs`` of
    ``rows``)."""

    def __init__(self, pin=None):
        self.pin, self.picks, self.differs, self.rows = pin, [], 0, 0

    def __enter__(self):
        self._top_k = moe._top_k

        def top_k(probs, k):
            w, idx = self._top_k(probs, k)
            if self.pin is None:
                self.picks.append(idx)
                return w, idx
            pinned = self.pin(len(self.picks))
            self.picks.append(pinned)
            self.differs += int((idx.sort(-1).values
                                 != pinned.sort(-1).values).any(-1).sum())
            self.rows += idx.shape[0]
            return probs.gather(-1, pinned), pinned

        moe._top_k = top_k
        return self

    def __exit__(self, *exc):
        moe._top_k = self._top_k


def prefill_decode_parity(model, full: np.ndarray, S: int, extra: dict):
    """prefill(S) + decode steps against prefill(S + extra steps) at the
    last position, as ``tests/test_models.py``; a MoE model at capacity
    factor 16, where routed prefill drops nothing, as the reference's
    ``test_moe_parity_high_capacity``.  A MoE model's prefill(S) and steps
    take the experts prefill(S + extra steps) picked at each (row,
    position, layer): a near-tied top-k, which a one-ulp bf16 difference
    between the paths can flip, then moves no logit, and the bound holds
    the paths' arithmetic (routed buffer, products and combine against the
    all-expert decode) on every row.  Returns (rel err over the real vocab,
    the picks whose own expert set differed from the pinned one, the picks
    compared)."""
    net, cfg = model.net, model.cfg
    if cfg.n_experts:
        net.cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    B, T = full.shape
    try:
        with RouteLog() as whole_log:
            whole, _ = model.prefill({"tokens": torch.as_tensor(
                full, dtype=torch.long, device=model.device), **extra}, T)
        n_moe = len(whole_log.picks)
        ids = [p.view(B, T, -1) for p in whole_log.picks]

        def pin(call):      # prefill(S)'s layers, then each step's
            step, layer = divmod(call, n_moe)
            at = slice(0, S) if step == 0 else slice(S + step - 1, S + step)
            return ids[layer][:, at].reshape(-1, ids[layer].shape[-1])

        with RouteLog(pin if n_moe else None) as step_log:
            steps = teacher_forced(model, full, S, extra)
    finally:
        net.cfg = cfg
    V = cfg.vocab_size          # the padded vocab's -1e30 are not logits
    return (_rel_err(whole[:, :V], steps[-1][:, :V]), step_log.differs,
            step_log.rows)


def moe_parity_f32(arch: str, device, full: np.ndarray, S: int) -> None:
    """The prefill/decode parity of a MoE config in float32 (TF32 off), at
    full width with the layers a card holds in float32 (MOE_F32_LAYERS).
    In bf16 a near-tied top-k flips between the paths (lm_full pins the
    picks and counts the flips); in float32 the decode steps' routers must
    pick every expert prefill picked, which holds the decode router that
    pinning bypasses."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(_full_config(arch, MOE_F32_LAYERS[arch]),
                              dtype="float32")
    model = build_model(cfg, device=device, seed=0)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        parity, differs, pairs = prefill_decode_parity(model, full, S, {})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    print(f"lm {arch} float32, layers={cfg.n_layers}/"
          f"{get_config(arch).n_layers}: prefill({S}) + {LM_EXTRA} decode "
          f"steps vs prefill({S + LM_EXTRA}) at capacity factor 16: rel err "
          f"{parity:.4g} (bound {LM_PARITY_TOL}); top-k differs in {differs}"
          f" of {pairs} picks (bound 0)")
    del model
    if parity >= LM_PARITY_TOL or differs:
        raise AssertionError(f"lm {arch} float32: prefill/decode parity "
                             f"{parity}, {differs} picks differ")


def lm_cli() -> None:
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "smollm-135m"], env=env, capture_output=True, text=True,
        timeout=300)
    if proc.returncode != 0 or not proc.stdout.startswith(
            "algorithm=optimized_vfpc dispatches="):
        raise AssertionError(f"serve CLI failed:\n{proc.stdout}\n"
                             f"{proc.stderr}")
    print(f"lm cli ({time.perf_counter() - t0:.1f}s): "
          f"{proc.stdout.splitlines()[0]}")


def phase_lm(device) -> None:
    t0 = time.perf_counter()
    lm_small(device, q_head_pad_group=6)
    for arch in LM_ARCHS:
        lm_full(arch, device)
    gc.collect()
    torch.cuda.empty_cache()
    lm_cli()
    print(f"lm: {time.perf_counter() - t0:.1f}s")


def phase_families(device) -> None:
    """Phase 11: MoE, SSM, hybrid, encoder-decoder and VLM serving."""
    t0 = time.perf_counter()
    for arch in FAMILY_SMOKE:
        lm_small(device, arch)
    moe_drops(device)
    for arch, n_layers in FAMILY_FULL:
        lm_full(arch, device, n_layers)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"families: {time.perf_counter() - t0:.1f}s")


# -- phase 12: training -------------------------------------------------------


def _rel_max(want: dict, got: dict) -> float:
    """The largest over names of max |want - got| / max |want|."""
    return max(_rel_err(want[n].detach(), got[n].detach()) for n in want)


def _train_batch(cfg, toks: np.ndarray, dtype: str, device) -> dict:
    """tokens and labels from (B, S + 1) ids, and the frontend stubs'
    inputs from a seed, on ``device`` in ``dtype``."""
    t = torch.as_tensor(toks, dtype=torch.long)
    fe = frontend_batch(dataclasses.replace(cfg, dtype=dtype), t.shape[0], 2,
                        "cpu")
    return {"tokens": t[:, :-1].to(device), "labels": t[:, 1:].to(device),
            **{k: v.to(device) for k, v in fe.items()}}


def train_small(device, arch: str) -> None:
    """An arch's smoke config from one numpy parameter tree, in a model on
    the card and one on the CPU.  float32 (TF32 off): the loss and every
    parameter's gradient card against CPU, then one ``apply_updates`` step
    on both from the CPU's gradients, with and without compression
    (parameters, m, v); bf16: the loss."""
    cfg = get_config(arch, smoke=True)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    tree = numpy_tree(build_model(cfg32, device="cpu", seed=None), seed=0)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 16 + cfg.n_frontend_tokens + 1))
    errs = {}
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for compress in (False, True):
            opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                              compress=compress)
            runs = []
            for dev in ("cpu", device):
                model = build_model(cfg32, device=dev, seed=None)
                load_reference_params(model, tree)
                state = init_train_state(model, opt, seed=None)
                loss, metrics = model.loss(_train_batch(cfg, toks, "float32",
                                                        dev))
                loss.backward()
                runs.append((model, state, loss.detach(),
                             metrics["aux"].detach()))
            (cpu, cpu_state, *cpu_loss), (card, card_state, *card_loss) = runs
            errs["loss"] = max(_rel_err(a[None], b[None])
                               for a, b in zip(cpu_loss, card_loss))
            grads = {n: p.grad for n, p in cpu.named_parameters()}
            errs["grads"] = _rel_max(
                grads, {n: p.grad for n, p in card.named_parameters()})
            groups = convert.leaf_groups(cpu) if compress else None
            stepped = [adamw.apply_updates(
                st["params"], {n: g.to(m.device) for n, g in grads.items()},
                st["opt"], opt, groups)
                for m, st in ((cpu, cpu_state), (card, card_state))]
            key = "step compressed" if compress else "step"
            errs[key] = max(
                _rel_max(stepped[0][0], stepped[1][0]),
                _rel_max(stepped[0][1]["m"], stepped[1][1]["m"]),
                _rel_max(stepped[0][1]["v"], stepped[1][1]["v"]),
                _rel_err(stepped[0][2]["grad_norm"][None],
                         stepped[1][2]["grad_norm"][None]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    losses = []
    for dev in ("cpu", device):
        model = build_model(cfg, device=dev, seed=None)
        model.load_state_dict(cpu.state_dict())        # cast where bf16
        with torch.no_grad():
            losses.append(model.loss(_train_batch(cfg, toks, cfg.dtype,
                                                  dev))[0])
    err16 = _rel_err(losses[0][None], losses[1][None])
    print(f"train small {cfg.name} ({cfg.family}): card vs CPU, float32 "
          f"rel err loss {errs['loss']:.3g} (tol {TRAIN_F32_TOL}), grads "
          f"{errs['grads']:.3g} (tol {TRAIN_F32_TOL}), one AdamW step from "
          f"equal grads {errs['step']:.3g}, compressed "
          f"{errs['step compressed']:.3g} (tol {TRAIN_STEP_TOL}); bf16 loss "
          f"{err16:.3g} (tol {TRAIN_BF16_TOL})")
    if (max(errs["loss"], errs["grads"]) > TRAIN_F32_TOL
            or max(errs["step"], errs["step compressed"]) > TRAIN_STEP_TOL
            or err16 > TRAIN_BF16_TOL):
        raise AssertionError(f"train small {cfg.name}: {errs}, bf16 {err16}")


SYNC_WARNING = "called a synchronizing CUDA operation"


class SyncCount(TorchDispatchMode):
    """While entered, the CUDA sync debug mode warns at every host sync it
    detects; the aten op that synced is named (``ops``), and every sync
    warning seen is counted (``total``, the ones backward replays
    included).  Setting the mode warns that it is a prototype: that
    warning is not a sync."""

    def __enter__(self):
        self.ops, self._caught = collections.Counter(), warnings.catch_warnings(
            record=True)
        self._log = self._caught.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        torch.cuda.set_sync_debug_mode("default")
        self._caught.__exit__(*exc)
        self.total = sum(SYNC_WARNING in str(w.message) for w in self._log)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = len(self._log)
        out = func(*args, **(kwargs or {}))
        if any(SYNC_WARNING in str(w.message) for w in self._log[before:]):
            self.ops[str(func)] += 1
        return out


def _state_bytes(state: dict) -> int:
    tensors = [*state["params"].values()]
    for key in ("m", "v", "err"):
        tensors += state["opt"].get(key, {}).values()
    return sum(t.numel() * t.element_size() for t in tensors)


def step_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of a training step: 6 · N · tokens, N the active
    parameters (``active_param_count()``: the tied embedding once, as the
    output head's product), plus causal attention's 12 · L · B · S² · d / 2
    over the L attention layers, d = real heads × head_dim."""
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    d = cfg.n_heads * cfg.resolved_head_dim
    return (6.0 * cfg.active_param_count() * batch * seq
            + 12.0 * n_attn * batch * seq * seq * d / 2)


def device_busy_ms(fn) -> float | None:
    """The device time of ``fn()`` alone: the sum of its kernels' and
    copies' durations under ``torch.profiler``, tracing the device only
    (the host's op events are not needed); None where the profiler sees
    no device activity."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0)
             for e in prof.key_averages())
    return us / 1e3 if us else None


class BoundedPipeline(TokenPipeline):
    """A token pipeline that raises once a run has drawn more than
    ``limit`` batches: a TrainLoop without a checkpoint re-runs a NaN phase
    forever (as the reference's does), and the phase must fail instead."""

    def __init__(self, *args, limit: int, **kwargs):
        super().__init__(*args, **kwargs)
        self.limit = limit

    def next_batch(self):
        if self._step >= self.limit:
            raise AssertionError(f"the run drew {self._step} batches for "
                                 f"at most {self.limit} steps: its phases "
                                 f"keep failing (NaN losses)")
        return super().next_batch()


def train_full(arch: str, device, algorithms, steps: int,
               lr: float) -> tuple:
    """One config at full width on the card: B = 8, S = 2,048 from the
    token pipeline, ``steps`` steps under each algorithm, each run from
    seed 0's weights and a zeroed optimizer state; the loss finite and
    falling.  Returns (model, the optimizer config, a maker of the run's
    pipeline)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    model = build_model(cfg, device=device, seed=None)
    opt = AdamWConfig(lr=lr, warmup_steps=2, total_steps=steps)
    state = init_train_state(model, opt, seed=0)

    def pipeline():
        return BoundedPipeline(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH, limit=2 * steps)

    # warm-up, then one step timed on the host and its device time alone
    loop = TrainLoop(model, pipeline(), opt, algorithm="spc")
    batch = loop._stack_batches(1)
    step = make_train_step(model, opt, npass=1)
    step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, batch)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    busy = device_busy_ms(lambda: step(state, batch))
    flops = step_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    rows = {}
    for algo in algorithms:
        state = None                    # free m and v before the next run
        gc.collect()
        state = init_train_state(model, opt, seed=0)
        loop = TrainLoop(model, pipeline(), opt, algorithm=algo)
        state, recs = loop.run(state, steps)
        losses = [r.mean_loss for r in recs]
        secs = sum(r.elapsed for r in recs)
        rows[algo] = {"widths": [r.npass for r in recs],
                      "losses": [round(x, 4) for x in losses],
                      "step_ms": secs / steps * 1e3,
                      "tok_s": steps * tokens / secs}
        print(f"train {arch} {algo}: " + json.dumps(rows[algo]))
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"train {arch} {algo}: losses {losses}")
    n_params = sum(p.numel() for p in model.parameters())
    peak = torch.cuda.max_memory_allocated()
    best = min(r["step_ms"] for r in rows.values())
    print(f"train {arch}: params={n_params} (param_count() "
          f"{cfg.param_count()}, active {cfg.active_param_count()}) "
          f"state_bytes={_state_bytes(state)} (params, m, v) "
          f"max_memory_allocated={peak} B={TRAIN_BATCH} S={TRAIN_SEQ}: one "
          f"step {host_ms:.1f} ms on the host clock, device busy "
          + (f"{busy:.1f} ms ({busy / host_ms:.1%})" if busy else
             "not measured (the profiler saw no device time)")
          + f"; model FLOPs a step {flops:.4g} (6 N tokens + causal "
          f"attention), {flops / (host_ms / 1e3) / BF16_FLOPS_PER_S:.2%} of "
          f"the bf16 dense peak at {host_ms:.1f} ms, "
          f"{flops / (best / 1e3) / BF16_FLOPS_PER_S:.2%} at the best "
          f"policy's {best:.1f} ms")
    return model, opt, pipeline


def fused_equals_sequential(model, opt, pipeline, tmp: str) -> None:
    """smollm-135m at full width: a fused phase of 3 steps on one model and
    3 single-step phases on another from the same weights and batches
    give the same parameters and moments within the reference's own bound
    (tests/test_train.py: 2e-2), the fused phase's host syncs counted; the
    full state then round-trips a checkpoint bit for bit."""
    cfg = model.cfg
    twin = build_model(cfg, device=model.device, seed=None)
    states = [init_train_state(m, opt, seed=0) for m in (model, twin)]
    batch3 = TrainLoop(model, pipeline(), opt)._stack_batches(3)
    fused = make_train_step(model, opt, npass=3)
    torch.cuda.synchronize()
    with SyncCount() as syncs:
        _, metrics = fused(states[0], batch3)
    torch.cuda.synchronize()
    single = make_train_step(twin, opt, npass=1)
    for i in range(3):
        single(states[1], {k: v[i:i + 1] for k, v in batch3.items()})
    torch.cuda.synchronize()
    diff = 0.0
    for key in ("params", "m", "v"):
        a = states[0]["params"] if key == "params" else states[0]["opt"][key]
        b = states[1]["params"] if key == "params" else states[1]["opt"][key]
        diff = max(diff, max(float((a[n].detach().float()
                                    - b[n].detach().float()).abs().max())
                             for n in a))
    print(f"train {cfg.name}: fused phase of 3 steps vs 3 single-step "
          f"phases: max abs diff over params, m, v {diff:.3g} (bound "
          f"{TRAIN_FUSED_TOL}); host syncs inside the fused phase: "
          f"{syncs.total}" + (f" ({dict(syncs.ops)})" if syncs.ops else ""))
    if diff > TRAIN_FUSED_TOL:
        raise AssertionError(f"fused vs sequential {diff}")
    t0 = time.perf_counter()
    ckpt = os.path.join(tmp, "roundtrip")
    save_checkpoint(ckpt, 3, convert.state_to_reference(model, states[0]))
    tree, step = load_checkpoint(ckpt)
    convert.load_reference_state(twin, tree, states[1])
    same = step == 3 and all(
        torch.equal(a, b) for key in ("m", "v") for a, b in zip(
            states[0]["opt"][key].values(), states[1]["opt"][key].values()))
    same = same and all(torch.equal(a, b) for a, b in zip(
        model.parameters(), twin.parameters())) and torch.equal(
        states[0]["opt"]["step"], states[1]["opt"]["step"])
    size = sum(os.path.getsize(os.path.join(ckpt, "step_3", f))
               for f in os.listdir(os.path.join(ckpt, "step_3")))
    print(f"train {cfg.name}: checkpoint of the full state ({size} bytes) "
          f"saved and loaded into a second model in "
          f"{time.perf_counter() - t0:.1f}s: bit for bit {same}")
    if not same:
        raise AssertionError("checkpoint round trip changed the state")


def nan_recovery(model, opt, pipeline, tmp: str) -> None:
    """A poisoned phase (NaN embedding table) is restored from the
    checkpoint and not counted; the run ends finite."""
    ckpt = os.path.join(tmp, "nan")
    loop = TrainLoop(model, pipeline(), opt, algorithm="spc",
                     checkpoint_dir=ckpt, ckpt_every_phases=1)
    state = init_train_state(model, opt, seed=0)
    state, _ = loop.run(state, 2)
    with torch.no_grad():
        state["params"]["decoder.embed.table"].mul_(float("nan"))
    state, recs = loop.run(state, 3)
    renan = [r.phase_idx for r in recs if r.renan]
    print(f"train {model.cfg.name}: NaN phases {renan} restored from the "
          f"step-2 checkpoint; final step {int(state['opt']['step'])}, loss "
          f"{recs[-1].mean_loss:.4f}")
    if not renan or not np.isfinite(recs[-1].mean_loss) or int(
            state["opt"]["step"]) != 3:
        raise AssertionError(f"NaN recovery: {recs}")


def train_cli(tmp: str) -> None:
    """``launch.train`` on the card twice with one checkpoint directory:
    the second run resumes at the first's last step."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "smollm-135m", "--smoke", "--steps", "12", "--ckpt",
           os.path.join(tmp, "cli")]
    outs = []
    for _ in range(2):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"train CLI failed:\n{proc.stdout}\n"
                                 f"{proc.stderr}")
        outs.append(proc.stdout.splitlines())
        print(f"train cli ({time.perf_counter() - t0:.1f}s): "
              f"{outs[-1][0]} ... {outs[-1][-1]}")
    if not (outs[0][-1].startswith("final loss") and
            outs[1][0] == "resumed from step 12"):
        raise AssertionError(f"train CLI did not resume: {outs}")


def phase_train(device) -> None:
    """Phase 12: training (optim, train, Model.loss and its backward)."""
    t0 = time.perf_counter()
    for arch in TRAIN_SMOKE:
        train_small(device, arch)
    with tempfile.TemporaryDirectory() as tmp:
        for arch, algorithms, steps, lr in TRAIN_FULL:
            model, opt, pipeline = train_full(arch, device, algorithms,
                                              steps, lr)
            if arch == "smollm-135m":
                fused_equals_sequential(model, opt, pipeline, tmp)
                nan_recovery(model, opt, pipeline, tmp)
            del model
        gc.collect()
        torch.cuda.empty_cache()
        train_cli(tmp)
    print(f"train: {time.perf_counter() - t0:.1f}s")


# -- phase 13: sharding ------------------------------------------------------

# the LM paths on a mesh of processes: qwen3-14b serving under the decode
# profile on (1, 4), granite-moe-3b-a800m's expert parallelism on (1, 4),
# smollm-135m training on (2, 2) with an elastic restore on (2, 1)
SHARD_SERVE = "qwen3-14b"
SHARD_EP = "granite-moe-3b-a800m"
SHARD_TRAIN = "smollm-135m"
SHARD_TOL = 0.05             # of max |logit|: the reference's bf16 bound
SHARD_TIMEOUT_S = 420
SHARD_STEPS = 3
# new tokens a prompt in the sharded serving check: each is a decode step
# over gloo under two policies, phase 13's slowest part, so the count is
# cut from 32 to hold the script within its time limit
SHARD_NEW = 16
SHARD_OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)


# DTensor's functional all-gather crashes the process (SIGSEGV) on card
# tensors over ``gloo`` (torch 2.11, several processes on one H100), while
# c10d's ``all_gather_into_tensor`` takes the same tensors; so in this
# layout (gloo, every process on cuda:0) the gathers go through c10d, each
# one counted here
ROUTED: dict = {}


def route_gloo_gathers() -> None:
    """Send DTensor's all-gathers of card tensors on ``gloo`` groups
    through ``dist.all_gather_into_tensor`` (idempotent; other groups and
    CPU tensors keep the functional collective)."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed import distributed_c10d as c10d

    def wrap(orig):
        if getattr(orig, "_routed", False):
            return orig

        def gather(self, gather_dim, group, tag=""):
            pg = c10d._resolve_process_group(
                funcol._resolve_group_name(group, tag))
            if not (self.is_cuda and dist.get_backend(pg) == "gloo"):
                return orig(self, gather_dim, group, tag)
            n = dist.get_world_size(pg)
            x = self.contiguous()
            out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                              dtype=x.dtype, device=x.device)
            dist.all_gather_into_tensor(out, x, group=pg)
            ROUTED["all_gather"] = ROUTED.get("all_gather", 0) + 1
            if gather_dim != 0:
                out = torch.cat(torch.chunk(out, n, dim=0), dim=gather_dim)
            return out

        gather._routed = True
        return gather

    for name in ("all_gather_single", "all_gather_tensor"):
        if hasattr(funcol, name):
            setattr(funcol, name, wrap(getattr(funcol, name)))


# phase 14: each phase-13 run's step, as (arch, step shape, mesh, rules
# profile, config changes), traced against the real run's tally
DRY_STEPS = {
    "decode": (SHARD_SERVE, ShapeConfig("decode", 64, 8, "decode"), (1, 4),
               "decode", {}),
    "ep_prefill": (SHARD_EP, ShapeConfig("prefill", 64, 8, "prefill"),
                   (1, 4), "default",
                   {"dtype": "float32", "capacity_factor": 8.0}),
    "train": (SHARD_TRAIN, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH,
                                       "train"), (2, 2), "default", {}),
}


def _tally_real(model, shape, opt=None, memory: bool = False) -> dict:
    """One step of ``shape`` (``dryrun.build_step``'s) on this process's
    card under ``roofline.CollectiveTally``; with ``memory`` also the
    card's peak allocated bytes over that step alone and the bytes
    allocated when it began."""
    fn = dryrun.build_step(model, shape, opt)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _, rec = tally_step(fn)
    torch.cuda.synchronize()
    if memory:
        rec["card_peak"] = torch.cuda.max_memory_allocated()
        rec["card_base"] = base
    return rec


def _shard_worker(task: str, rank: int, world: int, backend: str, store: str,
                  device: str, out_path: str, tmp: str, args: tuple) -> None:
    """One process of a phase-13 run: join the group (gloo on cuda:0 routes
    DTensor's gathers through c10d), run ``task``, save what it returns for
    the parent."""
    init_distributed(store, world, rank, backend=backend, device=device,
                     timeout=SHARD_TIMEOUT_S)
    if backend == "gloo":
        route_gloo_gathers()
        warnings.filterwarnings("ignore", "a cuda mesh over gloo")
    try:
        out = SHARD_TASKS[task](rank, world, tmp, *args)
    finally:
        shutdown_distributed()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def _shard_spawn(task: str, world: int, tmp: str, backend: str = "gloo",
                 device: str = "cuda:0", args: tuple = ()) -> list:
    """``task`` in ``world`` spawned processes (``gloo`` on cuda:0 by
    default: every process on card 0); fail unless all exit 0 within the
    timeout.  Returns their results in rank order."""
    store = "file://" + os.path.join(tmp, f"store-{task}-{backend}-{world}")
    outs = [os.path.join(tmp, f"{task}-{backend}-{r}.pkl")
            for r in range(world)]
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_shard_worker,
                         args=(task, r, world, backend, store, device,
                               outs[r], tmp, args)) for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=max(SHARD_TIMEOUT_S - (time.perf_counter() - t0),
                               1))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"shard {task} ({backend}, {world} processes) "
                             f"failed or hung: exit codes {codes}")
    out = []
    for path in outs:
        with open(path, "rb") as f:
            out.append(pickle.load(f))
    return out


def _spec_bytes(model) -> int:
    from repro_torch import sharding
    specs = model.param_specs()
    return sum(sharding.spec_bytes(tuple(p.shape), p.element_size(),
                                   model.ctx.mesh, specs[n])
               for n, p in model.named_parameters())


def _full_logits(x) -> np.ndarray:
    from repro_torch.sharding import is_dtensor
    x = x.full_tensor() if is_dtensor(x) else x
    return x.float().cpu().numpy()


def _transport() -> dict:
    """The gathers this process routed through c10d."""
    return {"routed": dict(ROUTED)}


def _task_serve(rank, world, tmp):
    """qwen3-14b under the decode profile on (1, world): teacher-forced
    logits, decode ms a step, and SHARD_NEW new tokens under spc and
    optimized_vfpc, every greedy pick checked against the gathered
    argmax."""
    from repro_torch import sharding
    from repro_torch.launch.mesh import make_lm_mesh
    import repro_torch.serving.engine as engine_mod
    mesh = make_lm_mesh(1, world, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(SHARD_SERVE, device="cuda", seed=0, mesh=mesh,
                        rules=sharding.make_rules("decode"))
    data = np.load(os.path.join(tmp, "serve_inputs.npz"))
    toks = torch.as_tensor(data["toks"], dtype=torch.long, device="cuda")
    B, T = toks.shape
    S = T - 4
    logits, caches = model.prefill({"tokens": toks[:, :S]}, T)
    out = [_full_logits(logits)]
    step_ms = []
    for t in range(S, T):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, caches = model.decode_step(
            caches, toks[:, t:t + 1],
            torch.full((B,), t, dtype=torch.long, device="cuda"))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        out.append(_full_logits(logits))
    picks = {"steps": 0, "differ": 0}
    greedy = engine_mod.sharded_greedy

    def checked(lg, ctx):
        got = greedy(lg, ctx)
        picks["steps"] += 1
        picks["differ"] += int((got != torch.argmax(lg.full_tensor(),
                                                    dim=-1)).sum())
        return got

    engine_mod.sharded_greedy = checked
    tokens = {algo: _serve(model, data["prompts"], data["lens"], algo,
                           SHARD_NEW)[0]
              for algo in ("spc", "optimized_vfpc")}
    engine_mod.sharded_greedy = greedy
    peak = torch.cuda.max_memory_allocated()
    del logits, caches
    tally = _tally_real(model, DRY_STEPS["decode"][1], memory=True)
    return {"logits": np.stack(out) if rank == 0 else None,
            "tokens": tokens, "picks": picks, "held": model.weight_bytes(),
            "spec": _spec_bytes(model), "peak": peak,
            "decode_ms": step_ms, "tally": tally, **_transport()}


def _count_drops():
    """Wrap ``moe.dispatch`` to count the assignments it drops; returns
    the counter (a one-element list) and the original."""
    counter = [0]
    orig = moe.dispatch

    def counting(w, idx, cfg):
        d = orig(w, idx, cfg)
        counter[0] += int((~d.keep).sum())
        return d

    moe.dispatch = counting
    return counter, orig


def _ep_prefill(model, toks, factor, route=None):
    """Prefill at capacity ``factor``: (full logits, drops); ``route`` (a
    ``RouteLog``) records or pins the router picks meanwhile."""
    model.net.cfg = dataclasses.replace(model.net.cfg,
                                        capacity_factor=factor)
    counter, orig = _count_drops()
    try:
        with route or contextlib.nullcontext():
            logits, _ = model.prefill({"tokens": toks}, toks.shape[1])
    finally:
        moe.dispatch = orig
    return _full_logits(logits), counter[0]


def _ep_config(dtype=None):
    """granite-moe-3b-a800m, in ``dtype`` (its own when None)."""
    cfg = get_config(SHARD_EP)
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


def _ep_pin(picks: np.ndarray, shape: tuple, rank: int, world: int,
            device="cuda"):
    """A ``RouteLog`` pin giving each MoE layer's call on (1, ``world``)
    this process's rows of the one-process picks (layers, B·S, k): the
    expert-parallel path routes its sequence slice (B, S / world)."""
    B, S = shape
    Sl = S // world
    pins = [torch.as_tensor(p, device=device).view(B, S, -1)
            [:, rank * Sl:(rank + 1) * Sl].reshape(B * Sl, -1)
            for p in picks]
    return lambda call: pins[call]


def _task_ep(rank, world, tmp):
    """granite-moe-3b-a800m's prefill under the default profile on (1,
    world), expert parallel: float32 at capacity factor 8 and at its own;
    then its own bf16 at factor 8, unpinned and with the router picks
    pinned to the one-process run's (counting the picks that differ)."""
    import torch.distributed as dist
    from repro_torch import sharding
    from repro_torch.launch.mesh import make_lm_mesh
    mesh = make_lm_mesh(1, world, device="cuda")
    model = build_model(_ep_config("float32"), device="cuda", seed=0,
                        mesh=mesh, rules=sharding.make_rules())
    own = model.cfg.capacity_factor
    toks = torch.as_tensor(np.load(os.path.join(tmp, "ep_inputs.npy")),
                           dtype=torch.long, device="cuda")
    out = {"held": model.weight_bytes(), "spec": _spec_bytes(model)}
    for factor in (8.0, own):
        lg, drops = _ep_prefill(model, toks, factor)
        d = torch.tensor(drops, device="cuda")
        dist.all_reduce(d)
        out[factor] = (lg if rank == 0 else None, int(d))
    out["ep"] = [blk.moe.ep_dispatches for blk in model.net.blocks
                 if hasattr(blk, "moe")]
    model.net.cfg = dataclasses.replace(model.net.cfg, capacity_factor=8.0)
    out["tally"] = _tally_real(model, DRY_STEPS["ep_prefill"][1])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model = build_model(_ep_config(), device="cuda", seed=0, mesh=mesh,
                        rules=sharding.make_rules())
    out["bf16"], _ = _ep_prefill(model, toks, 8.0)
    log = RouteLog(_ep_pin(np.load(os.path.join(tmp, "ep_bf16_picks.npy")),
                           tuple(toks.shape), rank, world))
    out["bf16_pinned"], _ = _ep_prefill(model, toks, 8.0, log)
    n = torch.tensor([log.differs, log.rows], device="cuda")
    dist.all_reduce(n)
    out["bf16_differs"], out["bf16_rows"] = (int(v) for v in n)
    if rank:
        out["bf16"] = out["bf16_pinned"] = None
    out.update(_transport())
    return out


def _train_setup(mesh=None, seed=0):
    from repro_torch import sharding
    cfg = get_config(SHARD_TRAIN)
    model = build_model(cfg, device="cuda", seed=seed, mesh=mesh,
                        rules=sharding.make_rules() if mesh else None)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH)
    return model, SHARD_OPT, pipe


def _train_steps(model, opt, pipe, state, steps):
    fn = make_train_step(model, opt, npass=1)
    losses, secs = [], []
    for _ in range(steps):
        t, l = pipe.next_batch()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, met = fn(state, {"tokens": t[None], "labels": l[None]})
        losses.append(float(met["loss"][0]))
        secs.append(time.perf_counter() - t1)
    return state, losses, secs


def _task_train(rank, world, tmp, shape, device="cuda"):
    """smollm-135m, B = 8, S = 2,048, on ``shape``: two steps, a checkpoint
    written from the mesh, a third step."""
    from repro_torch.launch.mesh import make_lm_mesh
    mesh = make_lm_mesh(*shape, device=device)
    torch.cuda.reset_peak_memory_stats()
    model, opt, pipe = _train_setup(mesh)
    state = init_train_state(model, opt, seed=None)
    state, losses, secs = _train_steps(model, opt, pipe, state, 2)
    ckpt = os.path.join(tmp, f"shard-ckpt-{world}")
    save_checkpoint(ckpt, 2, convert.state_to_reference(model, state))
    state, more, s3 = _train_steps(model, opt, pipe, state, 1)
    from repro_torch import sharding
    held = sum(sharding.shard_bytes(t) for t in state["opt"]["m"].values())
    peak = torch.cuda.max_memory_allocated()
    tally = None
    if torch.distributed.get_backend() == "gloo":     # phase 14's
        del state
        tally = _tally_real(model, DRY_STEPS["train"][1], opt)
    return {"losses": losses + more, "secs": secs + s3, "ckpt": ckpt,
            "held": model.weight_bytes(), "spec": _spec_bytes(model),
            "opt_m": held, "peak": peak, "tally": tally, **_transport()}


def _task_restore(rank, world, tmp, ckpt):
    """Restore the (2, 2) checkpoint on (world, 1): parameters bit-equal
    to the saved ones, then the third step."""
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models.model import Model
    from repro_torch.sharding import ShardCtx, make_rules
    from repro_torch.train import restore_elastic
    mesh = make_lm_mesh(world, 1, device="cuda")
    _, opt, pipe = _train_setup()
    model = Model(get_config(SHARD_TRAIN), device="cuda",
                  ctx=ShardCtx(mesh, make_rules()))
    state, step = restore_elastic(ckpt, model, opt)
    tree, _ = load_checkpoint(ckpt)
    got = convert.state_to_reference(model, state)["params"]
    equal = True

    def walk(a, b):
        nonlocal equal
        for k, v in a.items():
            if isinstance(v, dict):
                walk(v, b[k])
                continue
            pieces = v if isinstance(v, list) else [v]
            full = torch.stack([p.full_tensor() for p in pieces]) \
                if isinstance(v, list) else pieces[0].full_tensor()
            equal &= bool(torch.equal(full.cpu().view(-1).view(torch.uint8),
                                      b[k].contiguous().view(-1)
                                      .view(torch.uint8)))

    walk(got, tree["params"])
    for _ in range(step):
        pipe.next_batch()
    _, losses, _ = _train_steps(model, opt, pipe, state, 1)
    return {"step": step, "equal": equal, "loss": losses[0]}


SHARD_TASKS = {"serve": _task_serve, "ep": _task_ep, "train": _task_train,
               "restore": _task_restore}


def shard_nccl(tmp: str, one_losses: list | None = None):
    """Phase 13's training over ``nccl``, one card a process ((2, 2) on
    four cards, (2, 1) on two), against one process's losses (run here
    when not given); "not run (one card)" on one card."""
    n = torch.cuda.device_count()
    if n < 2:
        print("shard train nccl: not run (one card)")
        return "not run (one card)"
    if one_losses is None:
        model, opt, pipe = _train_setup()
        state = init_train_state(model, opt, seed=None)
        _, one_losses, _ = _train_steps(model, opt, pipe, state,
                                        SHARD_STEPS)
        del model, state
        gc.collect()
        torch.cuda.empty_cache()
    world = 4 if n >= 4 else 2
    shape = (2, 2) if world == 4 else (2, 1)
    res = _shard_spawn("train", world, tmp, backend="nccl", device="cuda",
                       args=(shape, "cuda"))
    print(f"shard train nccl on {shape}, one card a process: losses "
          f"{res[0]['losses']}, one process {one_losses}; s a step "
          f"{[round(x, 3) for x in res[0]['secs']]}; weight bytes a process "
          f"{[r['held'] for r in res]} (specs {[r['spec'] for r in res]})")
    if any(abs(a - b) > TRAIN_FUSED_TOL
           for a, b in zip(res[0]["losses"], one_losses)) or \
            any(r["held"] != r["spec"] for r in res):
        raise AssertionError("train over nccl is off")
    return res[0]["losses"]


def phase_shard(device) -> dict:
    """Phase 13: the LM paths sharded over processes on one card (gloo)."""
    t0 = time.perf_counter()
    summary = {}
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        # 1. serving: the one-process model first, then freed
        rng = np.random.default_rng(13)
        cfg = get_config(SHARD_SERVE)
        toks = rng.integers(1, cfg.vocab_size, (8, 64)).astype(np.int32)
        prompts, lens = _ragged_prompts(cfg, rng, 8, (16, 64))
        np.savez(os.path.join(tmp, "serve_inputs.npz"), toks=toks,
                 prompts=prompts, lens=lens)
        model = build_model(cfg, device=device, seed=0)
        one = teacher_forced(model, toks, 60).float().cpu().numpy()
        one_tokens = {algo: _serve(model, prompts, lens, algo,
                                   SHARD_NEW)[0]
                      for algo in ("spc", "optimized_vfpc")}
        del model
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        res = _shard_spawn("serve", 4, tmp)
        V = cfg.vocab_size          # the padded vocabulary is -1e30 in both
        err = float(np.abs(res[0]["logits"] - one)[..., :V].max())
        scale = float(np.abs(one[..., :V]).max())
        picks = sum(r["picks"]["differ"] for r in res)
        same = {algo: int((res[0]["tokens"][algo] == one_tokens[algo]).sum())
                for algo in one_tokens}
        for r in res:
            if r["held"] != r["spec"]:
                raise AssertionError(f"serve: a process holds {r['held']} "
                                     f"weight bytes, its specs {r['spec']}")
            for algo, t in r["tokens"].items():
                if not np.array_equal(t, res[0]["tokens"][algo]):
                    raise AssertionError("serve: processes' tokens differ")
        print(f"shard serve {SHARD_SERVE} decode profile (1, 4), 4 gloo "
              f"processes on cuda:0: teacher-forced max |diff| {err:.5f} "
              f"of max |logit| {scale:.3f}; sharded_greedy picks differing "
              f"from the gathered argmax {picks} of "
              f"{res[0]['picks']['steps']} steps; tokens equal to the "
              f"one-process run's {same} of "
              f"{toks.shape[0] * SHARD_NEW} each; "
              f"weight bytes a process {[r['held'] for r in res]} (specs "
              f"{[r['spec'] for r in res]}); peak "
              f"{[round(r['peak'] / 2**30, 2) for r in res]} GiB; decode "
              f"ms a step (gloo transport) "
              f"{[round(x, 1) for x in res[0]['decode_ms']]}; gathers routed "
              f"through c10d {res[0]['routed']}; "
              f"{time.perf_counter() - t1:.1f}s")
        if err > SHARD_TOL * scale or picks:
            raise AssertionError(f"serve: logits {err} > {SHARD_TOL} × "
                                 f"{scale} or {picks} picks differ")
        summary["serve"] = {"err": err, "scale": scale, "same": same,
                            "weight_bytes": res[0]["held"],
                            "decode_ms": res[0]["decode_ms"]}
        REAL_TALLIES["decode"] = [r["tally"] for r in res]

        # 2. expert parallelism at full width: float32, then its own bf16
        # with the router picks pinned to the one-process run's
        cfg = _ep_config("float32")
        etoks = rng.integers(1, cfg.vocab_size, (8, 64)).astype(np.int32)
        np.save(os.path.join(tmp, "ep_inputs.npy"), etoks)
        etoks_d = torch.as_tensor(etoks, dtype=torch.long, device=device)
        model = build_model(cfg, device=device, seed=0)
        ref = {}
        for factor in (8.0, cfg.capacity_factor):
            ref[factor] = _ep_prefill(model, etoks_d, factor)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        model = build_model(_ep_config(), device=device, seed=0)
        with RouteLog() as log:
            ref_bf16, _ = _ep_prefill(model, etoks_d, 8.0)
        np.save(os.path.join(tmp, "ep_bf16_picks.npy"),
                torch.stack(log.picks).cpu().numpy())
        del model, log
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        res = _shard_spawn("ep", 4, tmp)
        lg8, _ = res[0][8.0]
        V = cfg.vocab_size

        def ep_err(got, want):
            return (float(np.abs(got - want)[..., :V].max()),
                    float(np.abs(want[..., :V]).max()))

        err, scale = ep_err(lg8, ref[8.0][0])
        err16, scale16 = ep_err(res[0]["bf16_pinned"], ref_bf16)
        free16, _ = ep_err(res[0]["bf16"], ref_bf16)
        flips = (res[0]["bf16_differs"], res[0]["bf16_rows"])
        own = cfg.capacity_factor
        print(f"shard ep {SHARD_EP} (experts {cfg.n_experts} padded "
              f"to {cfg.experts_padded}) default profile (1, 4): EP dispatches "
              f"a MoE layer {res[0]['ep']}; float32 capacity 8.0: max |diff| "
              f"{err:.5f} of {scale:.3f} (drops EP {res[0][8.0][1]}, "
              f"global {ref[8.0][1]}); float32 capacity {own}: drops EP "
              f"{res[0][own][1]}, global {ref[own][1]}; bf16 capacity 8.0, "
              f"picks pinned to the one-process run's: max |diff| "
              f"{err16:.5f} of {scale16:.3f} (router picks that would "
              f"differ {flips[0]} of {flips[1]}; unpinned max |diff| "
              f"{free16:.5f}); weight bytes a process "
              f"{[r['held'] for r in res]} (specs "
              f"{[r['spec'] for r in res]}); gathers routed through c10d "
              f"{res[0]['routed']}; {time.perf_counter() - t1:.1f}s")
        if min(res[0]["ep"]) < 1 or err > SHARD_TOL * scale or \
                err16 > SHARD_TOL * scale16 or \
                any(r["held"] != r["spec"] for r in res):
            raise AssertionError("ep: a layer took no EP dispatch, the "
                                 "float32 or pinned bf16 output is off, or "
                                 "the bytes are not the specs'")
        REAL_TALLIES["ep_prefill"] = [r["tally"] for r in res]
        summary["ep"] = {"err": err, "scale": scale,
                         "drops_ep": res[0][own][1],
                         "drops_global": ref[own][1],
                         "bf16_pinned_err": err16, "bf16_scale": scale16,
                         "bf16_unpinned_err": free16,
                         "bf16_picks_differ": flips}

        # 3. training on (2, 2), the checkpoint restored on (2, 1)
        model, opt, pipe = _train_setup()
        state = init_train_state(model, opt, seed=None)
        _, one_losses, one_secs = _train_steps(model, opt, pipe, state,
                                               SHARD_STEPS)
        del model, state
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        res = _shard_spawn("train", 4, tmp, args=((2, 2),))
        got = res[0]["losses"]
        rest = _shard_spawn("restore", 2, tmp, args=(res[0]["ckpt"],))
        print(f"shard train {SHARD_TRAIN} B = {TRAIN_BATCH}, S = {TRAIN_SEQ} "
              f"on (2, 2): losses {got}, one process {one_losses}; s a step "
              f"{[round(x, 2) for x in res[0]['secs']]} (one process "
              f"{[round(x, 2) for x in one_secs]}); weight bytes a process "
              f"{[r['held'] for r in res]} (specs "
              f"{[r['spec'] for r in res]}), m bytes {res[0]['opt_m']}; peak "
              f"{[round(r['peak'] / 2**30, 2) for r in res]} GiB; "
              f"gathers routed through c10d {res[0]['routed']}; "
              f"restored on (2, 1) at step {rest[0]['step']}: parameters "
              f"bit-equal {[r['equal'] for r in rest]}, step 3 loss "
              f"{rest[0]['loss']}; {time.perf_counter() - t1:.1f}s")
        bad = [i for i, (a, b) in enumerate(zip(got, one_losses))
               if abs(a - b) > TRAIN_FUSED_TOL]
        if bad or not all(r["equal"] for r in rest) or \
                abs(rest[0]["loss"] - got[2]) > TRAIN_FUSED_TOL or \
                any(r["held"] != r["spec"] for r in res):
            raise AssertionError(f"train: steps {bad} off, or the restore "
                                 f"differs, or the bytes are not the specs'")
        summary["train"] = {"losses": got, "one": one_losses,
                            "restored_loss": rest[0]["loss"]}
        REAL_TALLIES["train"] = [r["tally"] for r in res]

        # 4. nccl, one card a process
        summary["nccl"] = shard_nccl(tmp, one_losses)
    summary["seconds"] = time.perf_counter() - t0
    print(f"shard: {time.perf_counter() - t0:.1f}s")
    return summary


# -- phase 14: the dry run's traced half ------------------------------------------

# each phase-13 step's tally on every process of its real run
REAL_TALLIES: dict = {}
# the production cells traced at full width: (arch, shape, --mesh)
DRY_CELLS = (("qwen3-14b", "decode_32k", "both"),
             ("mamba2-370m", "prefill_32k", "single"))
DRY_TIMEOUT_S = 900
MEMORY_TOL = 0.10            # traced memory against the card's, relative
BACKGROUND: list = []        # the tracing processes, stopped at exit
HERE = os.path.dirname(os.path.abspath(__file__))


def _dry_step_job(name: str) -> dict:
    """``DRY_STEPS[name]`` traced on fake tensors (in a fake group)."""
    from repro_torch import sharding
    arch, shape, mesh_shape, profile, changes = DRY_STEPS[name]
    cfg = dataclasses.replace(get_config(arch), **changes)
    opt = SHARD_OPT if shape.kind == "train" else None
    return dryrun.trace_step(cfg, shape, mesh_shape, ("data", "model"),
                             sharding.make_rules(profile), opt)


def dry_steps_to(path: str) -> None:
    """Trace every ``DRY_STEPS`` step on one fake group of 4 ranks and
    pickle the records to ``path``."""
    jobs = [(_dry_step_job, (name,)) for name in DRY_STEPS]
    res = dict(zip(DRY_STEPS, dryrun.in_fake_group(jobs, 4)))
    with open(path, "wb") as f:
        pickle.dump(res, f)


def dry_start(tmp: str) -> dict:
    """Start phase 14's tracing in the background, each job a process at
    low priority with no card: the phase-13 steps on a fake group of 4,
    and each ``DRY_CELLS`` cell through the dry-run CLI."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(HERE, "src"))
    jobs = {"steps": [sys.executable, "-c",
                      f"import sys; sys.path.insert(0, {HERE!r}); "
                      f"import chip_smoke; chip_smoke.dry_steps_to("
                      f"{os.path.join(tmp, 'steps.pkl')!r})"]}
    for arch, shape, mesh in DRY_CELLS:
        jobs[f"{arch} {shape}"] = [
            sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            arch, "--shape", shape, "--mesh", mesh, "--out",
            os.path.join(tmp, f"dryrun-{arch}-{shape}.jsonl")]
    out = {"tmp": tmp, "t0": time.perf_counter(), "procs": {}}
    for name, cmd in jobs.items():
        log = open(os.path.join(tmp, name.replace(" ", "_") + ".log"), "w")
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                env=env, cwd=HERE,
                                preexec_fn=lambda: os.nice(19))
        BACKGROUND.append(proc)
        out["procs"][name] = (proc, log)
    return out


def _families(rec: dict) -> str:
    """A record's collectives by family: how many, and their bytes."""
    return ", ".join(f"{k} {rec['collective_counts'][k]} ops "
                     f"{rec['collectives_by_op'][k]:,} B"
                     for k in rec["collectives_by_op"])


def phase_dryrun(started: dict) -> dict:
    """Phase 14: the dry run's traced half on the card's host.  Each
    phase-13 step's collectives by op, counts and bytes and its FLOPs,
    traced on a fake group of 4 (no card), equal to its real run's tally
    on every process; qwen3-14b's decode step's traced argument and temp
    bytes within 10% of the card's peak over that step, its traced temp
    bytes within 10% of the card's step-only excess; the production
    cells' records."""
    from repro_torch import sharding
    t0 = time.perf_counter()
    tmp = started["tmp"]
    for name, (proc, log) in started["procs"].items():
        left = DRY_TIMEOUT_S - (time.perf_counter() - started["t0"])
        try:
            proc.wait(timeout=max(left, 1))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
        if proc.returncode:
            with open(log.name) as f:
                raise AssertionError(f"dryrun {name}: exit {proc.returncode}"
                                     f"\n{f.read()[-4000:]}")
    waited = time.perf_counter() - t0
    with open(os.path.join(tmp, "steps.pkl"), "rb") as f:
        traced = pickle.load(f)
    summary = {"waited_s": waited, "steps": {}}
    for name, want in traced.items():
        real = REAL_TALLIES[name]
        print(f"dryrun {name} {DRY_STEPS[name][0]} on "
              f"{DRY_STEPS[name][2]}: traced (fake group, {want['trace_s']:.1f}"
              f" s): {_families(want)}, FLOPs {want['hlo_flops_raw']:.6g}; "
              f"real (gloo on the card, rank 0, {real[0]['trace_s']:.1f} s): "
              f"{_families(real[0])}, FLOPs {real[0]['hlo_flops_raw']:.6g}")
        for rank, got in enumerate(real):
            if got["collectives_by_op"] != want["collectives_by_op"] or \
                    got["collective_counts"] != want["collective_counts"] \
                    or got["hlo_flops_raw"] != want["hlo_flops_raw"]:
                raise AssertionError(f"dryrun {name}: rank {rank}'s "
                                     f"collectives or FLOPs differ from the "
                                     f"trace's")
        summary["steps"][name] = {
            "by_op": want["collectives_by_op"],
            "counts": want["collective_counts"],
            "flops": [want["hlo_flops_raw"], real[0]["hlo_flops_raw"]]}
    arch, shape, mesh_shape, profile, changes = DRY_STEPS["decode"]
    args = dryrun.reckon_bytes(
        get_config(arch), shape, dryrun.AxisMesh(mesh_shape, ("data",
                                                             "model")),
        sharding.make_rules(profile))["arg_bytes_per_dev"]
    temp = traced["decode"]["temp_bytes_per_dev"]
    traced_b = args + temp
    card = [r["card_peak"] for r in REAL_TALLIES["decode"]]
    excess = [r["card_peak"] - r["card_base"] for r in REAL_TALLIES["decode"]]
    off = max(abs(traced_b - c) / c for c in card)
    off_temp = max(abs(temp - e) / e for e in excess)
    print(f"dryrun memory {arch} decode step on {mesh_shape}: traced "
          f"arguments {args:,} + temp {temp:,} = {traced_b:,} B; the card's "
          f"peak over the step {card} B a process; off by {off:.4f} at most "
          f"(bound {MEMORY_TOL}); traced temp {temp:,} B against the card's "
          f"step-only excess (peak less the bytes allocated at the reset, "
          f"{[r['card_base'] for r in REAL_TALLIES['decode']]} B) {excess} "
          f"B, off by {off_temp:.6f} at most (bound {MEMORY_TOL})")
    if off > MEMORY_TOL or off_temp > MEMORY_TOL:
        raise AssertionError("dryrun: traced memory is off the card's")
    summary["memory"] = {"traced": traced_b, "card": card, "off": off,
                         "temp": temp, "excess": excess,
                         "off_temp": off_temp}
    recs = []
    for arch, shape, _ in DRY_CELLS:
        with open(os.path.join(tmp, f"dryrun-{arch}-{shape}.jsonl")) as f:
            recs += [json.loads(line) for line in f]
    for r in recs:
        if not r.get("ok"):
            raise AssertionError(f"dryrun {r['arch']} {r['shape']} "
                                 f"{r['mesh']}: {r.get('error')}")
        t = r["roofline"]
        print(f"dryrun {r['arch']} {r['shape']} {r['mesh']} (full width): "
              f"collectives {_families(r)}, per-chip "
              f"{r['collective_per_chip_bytes']:,} B, FLOPs "
              f"{r['hlo_flops_raw']:.6g}, temp {r['temp_bytes_per_dev']:,} B"
              f", args {r['arg_bytes_per_dev']:,} B, trace "
              f"{r['trace_s']:.1f} s (build {r['build_s']:.1f} s); terms "
              f"compute {t['compute_s']:.4g} s, memory {t['memory_s']:.4g} "
              f"s, collective {t['collective_s']:.4g} s: {t['dominant']}")
    summary["cells"] = {f"{r['arch']} {r['shape']} {r['mesh']}": {
        "per_chip": r["collective_per_chip_bytes"],
        "dominant": r["roofline"]["dominant"], "trace_s": r["trace_s"]}
        for r in recs}
    shutil.rmtree(tmp, ignore_errors=True)
    summary["seconds"] = time.perf_counter() - t0
    print(f"dryrun: {summary['seconds']:.1f}s (waited {waited:.1f}s for the "
          f"tracing started {time.perf_counter() - started['t0']:.1f}s ago)")
    return summary


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)   # lines survive a kill
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        # a plan cached by an earlier run would skip the sweeps: every run
        # starts from empty plan and cost-model caches
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
            tmp, "autotune.json")
        os.environ["REPRO_TORCH_COSTMODEL_CACHE"] = os.path.join(
            tmp, "costmodel.json")
        try:
            return run()
        finally:
            for proc in BACKGROUND:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def run() -> int:
    device = torch.device("cuda")
    t0 = time.perf_counter()
    kind = phase_device()
    phase_build()
    phase_kernels(device)
    launches, db, n_items, cands, levels = phase_main()
    gen_rows = phase_candidates(device)
    mesh_launches = phase_mesh(db, n_items, cands, levels, device)
    rule_launches, rule_args, _ = phase_serving()
    delta_launches, delta_args = phase_stream()
    launches.update(rule_launches)
    launches.update(delta_launches)
    swept = phase_plans(db, n_items, rule_args, delta_args)
    phase_lm(device)
    phase_families(device)
    dry = dry_start(tempfile.mkdtemp(prefix="chip_smoke_dry_"))
    phase_train(device)
    shard = phase_shard(device)
    shard["dryrun"] = phase_dryrun(dry)
    rows = phase_timing(launches, db, n_items, cands, rule_args, delta_args)
    for row in rows:
        row["sweep_launches"] = swept[row["name"]]
        row["mesh_launches"] = mesh_launches.get(row["name"], 0)
    print(f"total: {time.perf_counter() - t0:.1f}s")
    print("shard: " + json.dumps(shard))
    print(json.dumps({"candidate_kernels": gen_rows}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
