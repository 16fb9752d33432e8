#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

      python3 chip_smoke.py
    python3 chip_smoke.py --tile-sweep

Builds every CUDA kernel of the port from this checkout's sources, holds
each against its plain PyTorch version on the card, serves qwen3-1.7b (28
layers), rwkv6-7b (32 layers), recurrentgemma-2b (26 layers), yi-9b (48),
minitron-4b (32), qwen2-moe-a2.7b (24), qwen3-moe-30b-a3b (48),
minicpm3-4b (62, multi-head latent attention) and pixtral-12b (40, a
prompt of patch embeddings) at their full published widths (bf16, random
weights from a seed) through the port's entry point, encodes frame
embeddings through hubert-xlarge (48, encoder-only), trains qwen3-1.7b,
recurrentgemma-2b and hubert-xlarge at full width and depth, and
minitron-4b, yi-9b, rwkv6-7b, qwen2-moe-a2.7b, qwen3-moe-30b-a3b,
minicpm3-4b and pixtral-12b at full width with the layers one card holds
(TRAIN_CUTS), for
a few steps (AdamW, chunked cross-entropy, remat), checks that each serve
and each train step went through its kernels, and times each kernel beside
its bound.  Its phase ``sharded`` runs qwen3-1.7b's train step on DTensors
over a one-rank mesh against the unsharded step, and the dry-run of four
cells on a "cuda" mesh (phase_sharded).  Its phase ``scheduler`` runs the
port's Dally scheduler and cluster simulator (``repro_torch.core``) on the
card's host over the paper's traces at the paper's cluster scale
(SCHED_CELLS), against makespans and JCTs pinned from the JAX package's
simulator (phase_scheduler).  Its phase ``experiments`` runs the port's
experiments, streamed replay with spill, sweep CLI and online service
(``repro_torch.experiments``, ``repro_torch.service``) on the card's host:
one registered scenario for each artifact schema, dc-256-philly's 10,000
jobs streamed and spilled, that cell's peak RSS streamed with the spill
and materialized (each in a process of its own), the sweep over two
workers against run_one, and
a daemon SIGKILLed and restarted against its uninterrupted run, each
artifact against its digest pinned from the JAX package
(phase_experiments).  Any failure raises, so the exit code is
not 0.  With no CUDA device, or away from the checkout, it exits non-zero
and prints no result.  It imports nothing of JAX and nothing of ``repro``.

Standard output ends with a ``{"kernels": [...]}`` line and then the line
``{"ok": true, "device": {...}}``.

With ``--tile-sweep`` it builds the kernels and runs tile_sweep and
bwd_tile_sweep only: the per-tile (per-step) and fixed cost of the flash
forward's and backward's tensor-core kernels.  With ``--wkv-grad-routes``
it builds the kernels and runs wkv_grad_routes only: rwkv6-7b's train
slice gradients by the route of the WKV forward (the backward on the route
``bwd_route()`` names), the evidence for ``route(..., grad=True)``.  With
``--depth-probe ARCH LAYERS...`` it runs depth_probe only: one train step
of ARCH at each depth in turn until one runs out of memory, the evidence
for its TRAIN_CUTS depth.  With ``--in-turns PARENT_TREE`` (a checkout of
another commit, unpacked into a gitignored directory) it runs
trees_in_turns only: IN_TURNS_TRAIN's train steps and IN_TURNS_SERVE's
prefill and decode from that tree and this one in turns (parent, this,
this, parent), each run a process that builds and imports its own tree.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import inspect
import itertools
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.distributed.tensor import DTensor, distribute_tensor  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core import (ClusterSimulator, ClusterTopology, CommModel,  # noqa: E402
                              make_batch_trace, make_poisson_trace, verify_manifest)
from repro_torch.core.policies import make_policy  # noqa: E402
from repro_torch.data import SyntheticLMDataset, pseudo_embeds  # noqa: E402
from repro_torch.experiments import SimOverrides, artifact_json, run_one  # noqa: E402
from repro_torch.kernels.build import ptxas_summary  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.rglru_scan import kernel as scan_kernel  # noqa: E402
from repro_torch.kernels.rglru_scan import ref as scan_ref  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import kernel as wkv_kernel  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ref as wkv_ref  # noqa: E402
from repro_torch.launch.dryrun import run_cell  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import attention, lm, moe, rglru, rwkv6  # noqa: E402
from repro_torch.models.schema import model_schema  # noqa: E402
from repro_torch.optim import adamw_update, init_train_state, train_state_specs  # noqa: E402
from repro_torch.serve import encode, generate  # noqa: E402
from repro_torch.sharding import make_rules, placements_for, use_mesh_rules  # noqa: E402
from repro_torch.train import batch_specs, make_train_step, useful_flops  # noqa: E402
from repro_torch.train import steps as train_steps  # noqa: E402
from repro_torch.tree import is_spec, leaves, paths, unflatten  # noqa: E402
from repro_torch.types import NVIDIA_PAPER, ShapeConfig  # noqa: E402

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core rate, f32 rate outside
# the tensor cores, HBM3 bandwidth, and the L2 cache's size.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# Tolerance on ||out - ref|| / ||ref||.  In f32 and on the SIMT route in bf16,
# kernel and plain version both compute in f32 and round once to the output
# dtype.  The tensor-core route (bf16 at head dims 128, 256, (96, 64) and
# (80, 80)) also rounds P
# to bf16 before P V, a relative error of at most 2**-9 on each weight, which
# the normalisation by the same rounded weights' sum largely cancels; with the
# output's own rounding that stays under 2**-7.
REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2**-7}
# The flash kernel's shapes on the main paths: each served model's prefill
# shape, qwen3-1.7b (8 x 1024 tokens, 16 heads over 8 kv heads of 128) and
# recurrentgemma-2b (8 x 4096 tokens, 1 kv head of 256, a 2048-token window)
# at the 10 heads its serve launches (gqa_block leaves the 6 padded heads out
# of attention) and at 16, as earlier runs launched it; recurrentgemma-2b's
# train shape (2 x 4096 tokens) likewise at 10 heads and at 16.  FLASH_PATHS:
# the prefill shapes that phase_timings times (a causal prefill over all
# keys, as sdpa_call assumes).
QWEN3_PREFILL = (8, 1024, 1024, 16, 8, 128, 128, True, None, 0, None)
# yi-9b's prefill shape, and qwen3-moe-30b-a3b's (32 heads over 4 kv heads:
# groups of 8); minitron-4b's (its 24 heads padded to 32, over 8 kv heads:
# groups of 4); qwen2-moe-a2.7b's (16 over 16); yi-9b's (and qwen3-moe's),
# minitron-4b's and qwen2-moe's train shapes (the reference's train_4k
# sequence, batch 2).
YI_PREFILL = (8, 1024, 1024, 32, 4, 128, 128, True, None, 0, None)
MINITRON_PREFILL = (8, 1024, 1024, 32, 8, 128, 128, True, None, 0, None)
QWEN2_MOE_PREFILL = (8, 1024, 1024, 16, 16, 128, 128, True, None, 0, None)
YI_TRAIN = (2, 4096, 4096, 32, 4, 128, 128, True, None, 0, None)
MINITRON_TRAIN = (2, 4096, 4096, 32, 8, 128, 128, True, None, 0, None)
QWEN2_MOE_TRAIN = (2, 4096, 4096, 16, 16, 128, 128, True, None, 0, None)
RECURRENTGEMMA_PREFILL = (8, 4096, 4096, 16, 1, 256, 256, True, 2048, 0, None)
RECURRENTGEMMA_PREFILL_10H = (8, 4096, 4096, 10, 1, 256, 256, True, 2048, 0, None)
RECURRENTGEMMA_TRAIN = (2, 4096, 4096, 16, 1, 256, 256, True, 2048, 0, None)
RECURRENTGEMMA_TRAIN_10H = (2, 4096, 4096, 10, 1, 256, 256, True, 2048, 0, None)
# minicpm3-4b's prefill and train shapes: multi-head latent attention at its
# 40 heads padded to 48, one kv head a query head, q and k of 96 (64 + 32
# rotary) and v of 64: bf16 on the tensor cores, f32 on the SIMT route.
MINICPM3_PREFILL = (8, 1024, 1024, 48, 48, 96, 64, True, None, 0, None)
MINICPM3_TRAIN = (2, 4096, 4096, 48, 48, 96, 64, True, None, 0, None)
# hubert-xlarge's: bidirectional, 16 heads over 16 of 80 (the tensor cores
# in bf16, the SIMT route in f32), its encode of 8 x 1024 frames and its
# train shape, and the small case at its head dim that earlier runs held.
# pixtral-12b's (32 heads over 8 of 128) are minitron-4b's.
HUBERT_PREFILL = (8, 1024, 1024, 16, 16, 80, 80, False, None, 0, None)
HUBERT_TRAIN = (2, 4096, 4096, 16, 16, 80, 80, False, None, 0, None)
HUBERT_SMALL = (2, 50, 50, 16, 16, 80, 80, False, None, 0, None)
# Every bf16 call at (80, 80) takes the tensor cores, so the masks that
# hubert never sets are held there too: a ragged case with GQA, a window
# and q_offset; kv_len < Sk; kv_len 0, where every row sees nothing and
# the output and every gradient must be 0.
AT_80_MASKS = [(2, 77, 130, 8, 2, 80, 80, True, 33, 20, None),
               (2, 70, 200, 8, 2, 80, 80, False, None, 0, 150),
               (1, 64, 64, 4, 2, 80, 80, False, None, 0, 0)]
FLASH_PATHS = {"qwen3-1.7b": QWEN3_PREFILL, "recurrentgemma-2b": RECURRENTGEMMA_PREFILL_10H,
               "yi-9b": YI_PREFILL, "minicpm3-4b": MINICPM3_PREFILL,
               "hubert-xlarge": HUBERT_PREFILL}
# (B, Sq, Sk, H, KH, Dk, Dv, causal, window, q_offset, kv_len): the six CASES
# of tests/test_kernels_attention.py, Dk 96 / Dv 64, kv_len < Sk, head dim
# 256, hubert-xlarge's head dim 80 (bidirectional, 16 heads over 16); on the
# tensor-core route (in bf16) a ragged q_offset with GQA, a window spanning
# several tiles, and kv_len 0, where every row sees nothing and must be 0;
# a ragged one with GQA, a window, q_offset and kv_len < Sk (the backward's
# tile edges); then the shapes the main paths give it: the served prefill
# shapes, recurrentgemma's at the 10 heads its serve launches and at 16, and
# recurrentgemma's train shape at the 10 heads its step launches (with the
# lse, as training calls it); the served prefill shapes of yi-9b (and
# qwen3-moe), minitron-4b and qwen2-moe, yi-9b's (and qwen3-moe's) and
# minitron-4b's train shapes, minicpm3-4b's prefill and train shapes at
# (96, 64), and qwen2-moe's train shape; then hubert-xlarge's prefill and
# train shapes at (80, 80), bidirectional, and last the masks at (80, 80)
# (AT_80_MASKS), each after the cases whose inputs, drawn from each case's
# index, it would otherwise move.
KERNEL_CASES = [
    (2, 64, 64, 4, 2, 16, 16, True, None, 0, None),
    (1, 128, 128, 8, 8, 32, 32, True, None, 0, None),
    (1, 128, 128, 4, 1, 32, 32, True, 48, 0, None),
    (2, 37, 93, 6, 3, 16, 16, True, None, 56, None),
    (1, 50, 50, 4, 4, 16, 16, False, None, 0, None),
    (1, 96, 96, 2, 2, 64, 64, True, 32, 0, None),
    (2, 32, 32, 4, 4, 96, 64, True, None, 0, None),
    (2, 70, 200, 8, 2, 128, 128, False, None, 0, 150),
    (1, 100, 100, 4, 2, 256, 256, True, None, 0, None),
    HUBERT_SMALL,
    (2, 37, 93, 8, 2, 128, 128, True, None, 56, None),
    (1, 300, 300, 4, 1, 256, 256, True, 100, 0, None),
    (1, 64, 64, 4, 2, 128, 128, False, None, 0, 0),
    (2, 250, 333, 8, 2, 128, 128, True, 150, 83, 300),
    QWEN3_PREFILL,
    RECURRENTGEMMA_PREFILL_10H,
    RECURRENTGEMMA_PREFILL,
    RECURRENTGEMMA_TRAIN_10H,
    YI_PREFILL,
    MINITRON_PREFILL,
    QWEN2_MOE_PREFILL,
    YI_TRAIN,
    MINITRON_TRAIN,
    MINICPM3_PREFILL,
    MINICPM3_TRAIN,
    QWEN2_MOE_TRAIN,
    HUBERT_PREFILL,
    HUBERT_TRAIN,
    *AT_80_MASKS,
]
# The served prompts: tokens, or for the frontend stubs frames (hubert-xlarge)
# and patch embeddings (pixtral-12b).
SERVE_BATCH, SERVE_NEW = 8, 64
SERVE_PROMPT = {"qwen3-1.7b": 1024, "rwkv6-7b": 1024, "recurrentgemma-2b": 4096,
                "yi-9b": 1024, "minitron-4b": 1024, "qwen2-moe-a2.7b": 1024,
                "qwen3-moe-30b-a3b": 1024, "minicpm3-4b": 1024, "hubert-xlarge": 1024,
                "pixtral-12b": 1024}

# (B, T, H, D, random s0, decay): the three shapes of
# tests/test_kernels_recurrence.py::test_rwkv6_kernel, a ragged T at D 64, the
# rwkv6-7b decode shape and its prefill shape; then, at D 64, a ragged T over
# two chunks with s0, and an edge case whose w is exactly 0, exactly 1 and
# exp(-100) at fixed steps (WKV_EDGE_STEPS, even channels).  decay "sigmoid"
# is that test's sigmoid(N(0,1)); "model" is the model's own
# exp(-exp(N(0,1))); "edges" is "model" with those steps forced.  In bf16 each
# case at D 64 with T >= 2 takes the chunk route, the rest the recurrent
# route (kernel.route()).
WKV_CASES = [
    (1, 16, 2, 8, True, "sigmoid"),
    (2, 64, 3, 16, True, "sigmoid"),
    (1, 48, 4, 32, True, "sigmoid"),
    (2, 37, 4, 64, True, "sigmoid"),
    (8, 1, 64, 64, True, "sigmoid"),
    (8, 1024, 64, 64, False, "sigmoid"),
    (8, 1024, 64, 64, False, "model"),
    (2, 100, 8, 64, True, "model"),
    (1, 130, 4, 64, True, "edges"),
]
WKV_DECODE_CASE, WKV_PREFILL_CASE = WKV_CASES[4], WKV_CASES[5]
# The forward of a gradient (kernel.route(..., grad=True): chunk_exact in
# bf16, recurrent in f32) at the shapes training gives it, the model's
# decay, no s0: rwkv6-7b's train slice (2 x 200 tokens, TRAIN_SLICES) and its
# main train path (2 x 4096, TRAIN_SHAPES), 64 heads of 64; then WKV_CASES'
# edge case (s0, T ragged against the 64-step chunk, w 0, 1 and exp(-100)
# at chunk edges), which a gradient's forward takes as serving does.  Each
# bf16 case also runs the recurrent route on its inputs, whose y error is
# logged beside (phase_wkv_cases).
WKV_GRAD_CASES = [
    (2, 200, 64, 64, False, "model"),
    (2, 4096, 64, 64, False, "model"),
    (1, 130, 4, 64, True, "edges"),
]
# The steps where the edge case forces w: exactly 0, exactly 1, exp(-100)
# (0 in bf16, below f32's normal range in f32): at a chunk's first and last
# step, inside and at the edges of sub-chunks, and in the ragged last chunk.
WKV_EDGE_STEPS = {0.0: (0, 17, 63, 64, 100, 128), 1.0: (5, 15, 16, 47, 65, 127, 129),
                  math.exp(-100.0): (3, 31, 32, 80)}
# Tolerances on y and on s_last, each.  Both sides compute in f32 from the
# same inputs and round y once: in f32 they differ in the order of sums only;
# in bf16 an element of y differs by at most one bf16 ulp, under 2**-7 of its
# value, and s_last, in f32, as in f32.
WKV_ABS_TOL = {torch.float32: 1e-4}
WKV_REL_TOL = {(torch.float32, "y"): 1e-5, (torch.float32, "s_last"): 1e-5,
               (torch.bfloat16, "y"): 2**-7, (torch.bfloat16, "s_last"): 1e-5}

# (B, T, W, random h0, decay): the three shapes of
# tests/test_kernels_recurrence.py::test_rglru_kernel, a ragged T and W, T = 1
# at the model's width, and the recurrentgemma-2b prefill shape.  decay
# "sigmoid" is that test's a = sigmoid(N(0,1)) with b = N(0,1)*0.1; "model"
# is the model's own a and b from _lru_coeffs, with lam drawn by the LRU init.
SCAN_CASES = [
    (1, 32, 32, True, "sigmoid"),
    (2, 128, 64, True, "sigmoid"),
    (3, 64, 96, True, "sigmoid"),
    (2, 37, 100, True, "sigmoid"),
    (8, 1, 2560, True, "sigmoid"),
    (8, 4096, 2560, False, "sigmoid"),
    (8, 4096, 2560, False, "model"),
]
SCAN_PREFILL_CASE = SCAN_CASES[5]
# Tolerances on h and h_last, each: the JAX kernel test's absolute 1e-6 (f32)
# and 3e-2 (bf16), beside a relative bound.  Both sides run the same f32
# steps from the same inputs and round h once to its dtype.
SCAN_ABS_TOL = {torch.float32: 1e-6, torch.bfloat16: 3e-2}
SCAN_REL_TOL = {(torch.float32, "h"): 1e-6, (torch.float32, "h_last"): 1e-6,
                (torch.bfloat16, "h"): 2**-7, (torch.bfloat16, "h_last"): 1e-6}

# (B, Sq, Sk, H, KH, Dk, Dv, causal, window, q_offset, kv_len): the backward
# kernel's cases, every case of KERNEL_CASES at a head-dim pair it takes
# (causal, a window, q_offset with GQA, kv_len 0, ragged lengths), among them
# qwen3-1.7b's train shape, which is its prefill shape, yi-9b's (and
# qwen3-moe's) and minitron-4b's train shapes and the new models' prefill
# shapes (GQA groups of 8, 4 and 1), but recurrentgemma's prefill shapes
# (batch 8) and its train shape, which comes below with the other shapes
# at 256; in bf16 the cases at head dim 128 take the tensor-core route.
# Then head dim 256 (in bf16 on the tensor cores too, f32 SIMT): GQA 16:1
# with a window across the tiles' edges (32 and 64 rows) past q_offset,
# ragged; a window, q_offset and kv_len < Sk with GQA; kv_len 0;
# recurrentgemma-2b's train shape (2 x 4096 tokens, 1 kv head of 256, a
# 2048-token window) at the 10 heads its train step launches, and at 10
# heads padded to 16 as earlier runs timed it.  Then qwen2-moe-a2.7b's
# train shape (16 heads over 16 at 128), and last the cases at hubert-xlarge's
# (80, 80) (bf16 on the tensor cores, f32 SIMT): its prefill and train
# shapes and the small bidirectional case, then the masks (AT_80_MASKS),
# each after the cases whose inputs its index would otherwise move.  Where the heads hold fewer
# real ones (BWD_REAL_HEADS: those 16 hold 10; minitron-4b's 32 hold 24;
# minicpm3-4b's 48 hold 40, at (96, 64), bf16 on the tensor cores),
# dout is 0 on the padded heads, as the reference's masked output gives
# them: their dq must come back exactly 0.
# Tolerance on ||out - ref|| / ||ref|| of each of dq, dk and dv: both sides
# compute in f32 from the same inputs (1e-5: the order of the sums) and
# round once to the inputs' dtype (2**-7 in bf16; the tensor-core route also
# rounds P and dS to bf16 for its products, at most 2**-9 of each element).
RECURRENTGEMMA_EDGES = (2, 77, 130, 16, 1, 256, 256, True, 33, 20, None)
BWD_CASES = [c for c in KERNEL_CASES if (c[5], c[6]) in fa_kernel.BWD_HEAD_DIMS and c not in (
    RECURRENTGEMMA_PREFILL_10H, RECURRENTGEMMA_PREFILL, RECURRENTGEMMA_TRAIN_10H,
    QWEN2_MOE_TRAIN, HUBERT_SMALL, HUBERT_PREFILL, HUBERT_TRAIN, *AT_80_MASKS)] + [
    RECURRENTGEMMA_EDGES,
    (2, 250, 333, 8, 2, 256, 256, True, 150, 83, 300),
    (1, 64, 64, 4, 2, 256, 256, False, None, 0, 0),
    RECURRENTGEMMA_TRAIN_10H,
    RECURRENTGEMMA_TRAIN,
    QWEN2_MOE_TRAIN,
    HUBERT_PREFILL,
    HUBERT_TRAIN,
    HUBERT_SMALL,
    *AT_80_MASKS,
]
BWD_REAL_HEADS = {RECURRENTGEMMA_EDGES: 10, RECURRENTGEMMA_TRAIN: 10, MINITRON_TRAIN: 24,
                  MINICPM3_TRAIN: 40}
QWEN3_TRAIN = QWEN3_PREFILL
BWD_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2**-7}
# Tolerance on max |lse - lse_reference| of the forward's lse, by route.  The
# SIMT route sums exp in f32 as the plain version does (order only); the
# tensor-core route's l sums P rounded to bf16, at most 2**-9 of each term,
# so its log moves by at most log(1 + 2**-9) < 2**-8.
LSE_ABS_TOL = {"simt": 1e-4, "wgmma": 2**-8}

# (B, T, W, random h0, a cotangent on h_last, decay): the scan backward's
# cases, a ragged T and W with and without h0 and dh_last, T = 1 at the
# model's width, and recurrentgemma-2b's train shape with the model's own a
# (h_last takes no gradient in train mode).  The kernel runs the plain
# version's f32 steps in its order (__fmul_rn, __fadd_rn): f32 must agree to
# the bit; in bf16 both round da and db once, within 2**-7 relative.
SCAN_BWD_CASES = [
    (1, 32, 32, True, True, "sigmoid"),
    (2, 37, 100, True, True, "sigmoid"),
    (3, 64, 96, False, True, "sigmoid"),
    (2, 37, 100, True, False, "sigmoid"),
    (8, 1, 2560, True, True, "sigmoid"),
    (2, 4096, 2560, False, False, "model"),
]
SCAN_TRAIN_CASE = SCAN_BWD_CASES[-1]
SCAN_BWD_REL_TOL = {torch.float32: 0.0, torch.bfloat16: 2**-7}

# (B, T, H, D, random s0, a cotangent on s_last, decay): the WKV backward's
# cases, decays as WKV_CASES: WKV_CASES' head dims 8, 16 and 32; at 64 a
# ragged T (37 and 130 are not multiples of the recurrent route's checkpoint
# interval, wkv_kernel.CHECKPOINT_STEPS, nor of the chunk route's chunk,
# wkv_kernel.CHUNK_STEPS) with and without s0 and ds_last; T = 1; T = 2, the
# chunk route's least; the edge decays of WKV_EDGE_STEPS (w exactly 0,
# exactly 1 and exp(-100), at chunk boundaries 63, 64, 127, 128 and 129
# among others) over two chunks and over four, the last ragged; and
# rwkv6-7b's train shape (2 x 4096 tokens, 64 heads of 64) at the model's
# decay, s0 and ds_last absent as in a train step.  In bf16 each case at
# head dim 64 with T >= 2 takes the chunk route (kernel.bwd_route()).
WKV_BWD_CASES = [
    (1, 16, 2, 8, True, True, "sigmoid"),
    (2, 64, 3, 16, True, True, "sigmoid"),
    (1, 48, 4, 32, True, False, "sigmoid"),
    (2, 37, 4, 64, True, True, "sigmoid"),
    (2, 37, 4, 64, False, False, "sigmoid"),
    (3, 1, 4, 64, True, True, "sigmoid"),
    (2, 2, 4, 64, True, True, "sigmoid"),
    (1, 130, 4, 64, True, True, "edges"),
    (2, 200, 4, 64, True, True, "edges"),
    (2, 4096, 64, 64, False, False, "model"),
]
WKV_BWD_TRAIN_CASE = WKV_BWD_CASES[-1]
# Tolerance on ||out - ref|| / ||ref|| of each gradient.  Both sides sum in
# f32 from the same inputs and differ in the order of the sums only (1e-5,
# the flash backward's f32 limit); in bf16 dr, dk, dv and dw are rounded once
# to bf16 (2**-7), and du and ds0, in f32, as in f32.
WKV_BWD_OUTPUTS = ("dr", "dk", "dv", "dw", "du", "ds0")
WKV_BWD_REL_TOL = {torch.float32: dict.fromkeys(WKV_BWD_OUTPUTS, 1e-5),
                   torch.bfloat16: {**dict.fromkeys(WKV_BWD_OUTPUTS[:4], 2**-7),
                                    "du": 1e-5, "ds0": 1e-5}}

# Each kernel by name, with the module whose function of the same name is
# its wrapper and carries its launch counter, and the call that builds it.
KERNELS = {"flash_attention_fwd": fa_kernel, "flash_attention_bwd": fa_kernel,
           "rwkv6_wkv_fwd": wkv_kernel, "rglru_scan_fwd": scan_kernel,
           "rglru_scan_bwd": scan_kernel, "rwkv6_wkv_bwd": wkv_kernel}
BUILDS = {"flash_attention_fwd": fa_kernel.build, "flash_attention_bwd": fa_kernel.build_bwd,
          "rwkv6_wkv_fwd": wkv_kernel.build, "rglru_scan_fwd": scan_kernel.build,
          "rglru_scan_bwd": scan_kernel.build_bwd, "rwkv6_wkv_bwd": wkv_kernel.build_bwd}
# How the profiler names the kernels' device functions (a template with its
# return type first, a plain function such as wkv_fwd_chunk without).
PORT_KERNEL_SYMBOLS = ("void (anonymous namespace)::attn_fwd<",
                       "void (anonymous namespace)::attn_fwd_wgmma<",
                       "void (anonymous namespace)::attn_bwd_delta<",
                       "void (anonymous namespace)::attn_bwd_dkdv<",
                       "void (anonymous namespace)::attn_bwd_dq<",
                       "void (anonymous namespace)::attn_bwd_dkdv_wgmma<",
                       "void (anonymous namespace)::attn_bwd_dq_wgmma<",
                       "void (anonymous namespace)::wkv_fwd<",
                       "(anonymous namespace)::wkv_fwd_chunk(",
                       "void (anonymous namespace)::rglru_fwd<",
                       "void (anonymous namespace)::rglru_bwd_tma<",
                       "void (anonymous namespace)::rglru_bwd<",
                       "void (anonymous namespace)::wkv_bwd_fwd<",
                       "void (anonymous namespace)::wkv_bwd_rev<",
                       "void (anonymous namespace)::wkv_bwd_du<",
                       "(anonymous namespace)::chain::wkv_chain(",
                       "(anonymous namespace)::wkv_bwd_chunk(",
                       "(anonymous namespace)::wkv_bwd_du_chunks(")


def log(msg):
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(numel(v) for v in tree)
    return tree.numel()


def cache_leaves(layers):
    """(name, tensor) of each leaf of a cache's layers: a stacked dict, or a
    list of per-layer dicts (named "layer i name")."""
    if isinstance(layers, dict):
        return list(layers.items())
    return [(f"layer {i} {name}", t) for i, c in enumerate(layers) for name, t in c.items()]


def memory_left(peak) -> str:
    """What a peak of ``peak`` bytes leaves of the card's memory."""
    total = torch.cuda.get_device_properties(0).total_memory
    return f"{(total - peak) / 1e9:.2f} GB left of the card's {total} bytes"


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def reset_launches():
    for name, mod in KERNELS.items():
        getattr(mod, name).launches = 0
    fa_kernel.reset_launches()  # flash's counts by route too
    wkv_kernel.reset_launches()  # and WKV's
    scan_kernel.reset_launches()  # and the scan backward's


def read_launches() -> dict:
    return {name: getattr(mod, name).launches for name, mod in KERNELS.items()}


def read_flash_routes() -> dict:
    return dict(fa_kernel.flash_attention_fwd.launches_by_route)


def read_bwd_routes() -> dict:
    return dict(fa_kernel.flash_attention_bwd.launches_by_route)


def read_wkv_routes() -> dict:
    return dict(wkv_kernel.rwkv6_wkv_fwd.launches_by_route)


def read_scan_bwd_routes() -> dict:
    return dict(scan_kernel.rglru_scan_bwd.launches_by_route)


def read_wkv_bwd_routes() -> dict:
    return dict(wkv_kernel.rwkv6_wkv_bwd.launches_by_route)


def rel_err(out, ref) -> float:
    """||out - ref|| / ||ref||; the plain norm of the difference when ref is 0."""
    diff, norm = (out.float() - ref.float()).norm(), ref.float().norm()
    return (diff / norm if norm > 0 else diff).item()


def case_inputs(case, dtype, seed):
    B, Sq, Sk, H, KH, Dk, Dv = case[:7]
    g = torch.Generator("cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(dtype)
            for shape in ((B, Sq, H, Dk), (B, Sk, KH, Dk), (B, Sk, KH, Dv))]


def case_kwargs(case):
    causal, window, q_offset, kv_len = case[7:]
    return dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)


def visible_pairs(case) -> int:
    """(query, key) pairs the masks leave visible, over the whole batch and heads."""
    B, Sq, Sk, H = case[:4]
    causal, window, q_offset, kv_len = case[7:]
    end = Sk if kv_len is None else kv_len
    n = 0
    for i in range(Sq):
        pos = q_offset + i
        hi = min(end, pos + 1) if causal else end
        lo = max(0, pos - window + 1) if window is not None else 0
        n += max(0, hi - lo)
    return n * B * H


def attention_bound(case, dtype):
    """Least time on the card: each input read once, the output written once,
    and the two products' FLOPs at the peak rate; the larger of the two."""
    B, Sq, Sk, H, KH, Dk, Dv = case[:7]
    item = torch.finfo(dtype).bits // 8
    nbytes = item * (B * Sq * H * Dk + B * Sk * KH * (Dk + Dv) + B * Sq * H * Dv)
    flops = 2 * visible_pairs(case) * (Dk + Dv)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def time_ms(fn, iters) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    """Every kernel at once: one nvcc for each source, all started together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(BUILDS)) as pool:
        futures = {name: pool.submit(build) for name, build in BUILDS.items()}
        builds = {name: f.result() for name, f in futures.items()}
    for b in builds.values():
        log(f"[build] {b.path.name}: {b.seconds:.1f}s (nvcc by source: "
            f"{', '.join(f'{src} {t:.1f}s' for src, t in b.seconds_by_source.items())})")
        for line in ptxas_summary(b.log):
            log(f"[build]   {line}")
    log(f"[build] {len(builds)} kernels in {time.perf_counter() - t0:.1f}s")
    # the forward: one kernel a head-dim pair; the backward: dK/dV and dQ
    for name, want in (("flash_attention_fwd", len(fa_kernel.WGMMA_HEAD_DIMS)),
                       ("flash_attention_bwd", 2 * len(fa_kernel.BWD_WGMMA_HEAD_DIMS))):
        seen, faults = wgmma_ptxas_faults(builds[name].log)
        if seen != want or faults:
            raise AssertionError(f"build: ptxas compiled {seen} {WGMMA_SYMBOL} kernels in "
                                 f"{name} (expected {want}); faults: {faults}")
        log(f"[build] {name}: {seen} {WGMMA_SYMBOL} kernels, no spill, no serialized wgmma")
    # the scan's backward (both paths), the WKV chunk route, the chain of
    # the WKV chunk_exact route (its source's name is in its symbol), the
    # SIMT backward at 256, at (96, 64) and at (80, 80) (f32 only: bf16
    # takes the tensor cores there), and the WKV
    # backward's kernels on both routes (each keeps a row or column of the
    # state in registers; the chunk route's job and its chain)
    for name, pattern in (("rglru_scan_bwd", "rglru_bwd"), ("rwkv6_wkv_fwd", "wkv_fwd_chunk"),
                          ("rwkv6_wkv_fwd", "wkv_fwd_exact"),
                          ("flash_attention_bwd", r"attn_bwd_(dkdv|dq)I.*Li256ELi256E"),
                          ("flash_attention_bwd", MLA_BWD_SYMBOLS),
                          ("flash_attention_bwd", HUBERT_BWD_SYMBOLS),
                          ("rwkv6_wkv_bwd", "wkv_bwd")):
        seen, spills = spilling_entries(builds[name].log, pattern)
        if not seen or spills:
            raise AssertionError(f"build: {name}: {seen} kernels match {pattern!r}; spills: "
                                 f"{spills}")
        log(f"[build] {name}: {seen} kernels match {pattern!r}, no spill")
    # the WKV products on wgmma (the chunk route's, and the chain's of both
    # training routes, in either library), as the flash libraries'
    for name in ("rwkv6_wkv_fwd", "rwkv6_wkv_bwd"):
        serialized = [ln.strip() for ln in builds[name].log.splitlines()
                      if re.search(r"\(C751[23]\)|serialized", ln)]
        if serialized:
            raise AssertionError(f"build: {name}: ptxas serialized wgmma: {serialized}")


# Every tensor-core kernel of the flash libraries has this in its name; the
# SIMT backward's kernels at (96, 64) and at (80, 80) (f32 only) have these
# patterns, which the tensor-core kernels' names ("_wgmma"
# before the template) do not match.
WGMMA_SYMBOL = "_wgmma"
MLA_BWD_SYMBOLS = r"attn_bwd_(dkdv|dq)I.*Li96ELi64E"
HUBERT_BWD_SYMBOLS = r"attn_bwd_(dkdv|dq)I.*Li80ELi80E"


def wgmma_ptxas_faults(log_text):
    """(the kernels with WGMMA_SYMBOL in their name that ptxas compiled, the
    faults it reported for them): a spill store or load in one of them, or a
    note that it serialized wgmma instructions (C7512, C7513 and their kin,
    which say "serialized"), which only those kernels issue."""
    seen, faults = spilling_entries(log_text, WGMMA_SYMBOL)
    return seen, faults + [line.strip() for line in log_text.splitlines()
                           if re.search(r"\(C751[23]\)|serialized", line)]


def spilling_entries(log_text, pattern):
    """(the kernels whose ptxas name matches the regex ``pattern``, the ptxas
    lines that report a spill store or load in one of them)."""
    entry, seen, spills = "", 0, []
    for line in log_text.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry = m[1]
            seen += bool(re.search(pattern, entry))
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            if re.search(pattern, entry) and (int(m[1]) or int(m[2])):
                spills.append(f"{entry}: {line.strip()}")
    return seen, spills


def phase_kernel_cases():
    """Each case in f32 and bf16: the kernel against its plain version; then
    the kernel again with its lse, which must leave the output as it was to
    the bit and match lse_reference within LSE_ABS_TOL on each route."""
    worst, worst_lse = {}, {}
    for n, case in enumerate(KERNEL_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = case_inputs(case, dtype, seed=n)
            route = fa_kernel.route(dtype, case[5], case[6])
            before = read_flash_routes()
            out = fa_kernel.flash_attention_fwd(q, k, v, **case_kwargs(case))
            mid = read_flash_routes()
            ref = fa_ops.chunked_attention(q, k, v, **case_kwargs(case))
            torch.cuda.synchronize()
            want = {r: before[r] + (r == route) for r in before}
            if (mid, read_flash_routes()) != (want, want):
                raise AssertionError(f"case {case} {dtype}: launches by route {before} before "
                                     f"the kernel call, {mid} after it and "
                                     f"{read_flash_routes()} after the plain call; expected one "
                                     f"{route} launch and none from the plain call")
            if out.shape != ref.shape or out.dtype != dtype:
                raise AssertionError(f"case {case} {dtype}: {out.shape} {out.dtype}")
            if not torch.isfinite(out.float()).all():
                raise AssertionError(f"case {case} {dtype}: non-finite output")
            err = (out.float() - ref.float()).abs().max().item()
            rel = rel_err(out, ref)
            name = dtype_name(dtype)
            log(f"[kernels] {case} {name}, route {route}: max_abs_err {err:.3e} (tol "
                f"{TOL[dtype]}), rel_err {rel:.3e} (tol {REL_TOL[dtype]:.3e})")
            if err > TOL[dtype]:
                raise AssertionError(f"case {case} {name}: max_abs_err {err} > {TOL[dtype]}")
            if rel > REL_TOL[dtype]:
                raise AssertionError(f"case {case} {name}: rel_err {rel} > {REL_TOL[dtype]}")
            worst[name] = max(worst.get(name, 0.0), err)
            n_lse = fa_kernel.flash_attention_fwd.lse_launches
            again, lse = fa_kernel.flash_attention_fwd(q, k, v, with_lse=True, **case_kwargs(case))
            lse_ref = fa_ref.lse_reference(q, k, v, **case_kwargs(case))
            torch.cuda.synchronize()
            if fa_kernel.flash_attention_fwd.lse_launches != n_lse + 1:
                raise AssertionError(f"case {case} {name}: the call with lse was not counted")
            if not torch.equal(again, out):
                raise AssertionError(f"case {case} {name}: writing the lse changed the output")
            if lse.shape != lse_ref.shape or not torch.isfinite(lse).all():
                raise AssertionError(f"case {case} {name}: lse {tuple(lse.shape)}, finite "
                                     f"{bool(torch.isfinite(lse).all())}")
            lse_err = (lse - lse_ref).abs().max().item()
            log(f"[kernels] {case} {name}, route {route}: lse max_abs_err {lse_err:.3e} (tol "
                f"{LSE_ABS_TOL[route]:.3e}), output with lse equal to the bit")
            if lse_err > LSE_ABS_TOL[route]:
                raise AssertionError(f"case {case} {name}: lse max_abs_err {lse_err} > "
                                     f"{LSE_ABS_TOL[route]}")
            worst_lse[route] = max(worst_lse.get(route, 0.0), lse_err)
    log(f"[kernels] largest error over {len(KERNEL_CASES)} cases: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + "; lse by route: " + ", ".join(f"{k} {v:.3e}" for k, v in worst_lse.items()))
    return worst


def wkv_inputs(case, dtype, seed):
    """r, k, v ~ N(0,1)*0.5 and u ~ N(0,1)*0.5, as the JAX package's kernel test;
    s0 ~ N(0,1)*0.1 or None; w from the case's decay (WKV_CASES)."""
    B, T, H, D, with_s0, decay = case
    g = torch.Generator("cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.float32)
    r, k, v = (randn(B, T, H, D) * 0.5 for _ in range(3))
    w = torch.sigmoid(randn(B, T, H, D)) if decay == "sigmoid" \
        else torch.exp(-torch.exp(randn(B, T, H, D)))
    if decay == "edges":
        for value, steps in WKV_EDGE_STEPS.items():
            w[:, [t for t in steps if t < T], :, 0::2] = value
    u = randn(H, D) * 0.5
    s0 = randn(B, H, D, D) * 0.1 if with_s0 else None
    return [x.to(dtype) for x in (r, k, v, w)] + [u, s0]


def wkv_bound(case, dtype):
    """Least time on the card: r, k, v, w, u and s0 read once, y and s_last
    written once; 4 D^2 FLOP per (b, h, t) at the peak rate.  The larger of
    the two, and the FLOPs' time at the f32 rate outside the tensor cores."""
    B, T, H, D, with_s0, _ = case
    item = torch.finfo(dtype).bits // 8
    state = 4 * B * H * D * D
    nbytes = item * 5 * B * T * H * D + 4 * H * D + state * (2 if with_s0 else 1)
    flops = 4 * B * T * H * D * D
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"),
            flops, nbytes, flops / PEAK_F32_FLOPS * 1e3)


def phase_wkv_cases():
    """Each case in f32 and bf16: the WKV kernel against its plain version.
    Each case's kernel call must add exactly one to launches_by_route, on the
    route kernel.route() names, and the plain call none.  WKV_CASES as a
    serve launches them, WKV_GRAD_CASES as the forward of a gradient
    (grad=True), each held alike; on a gradient's case that route() sends
    elsewhere than the recurrent route (bf16: chunk_exact), the recurrent
    route runs too, after the checks, and its errors are logged beside."""
    worst, by_route = {}, {}
    cases = ([(1000 + n, case, False) for n, case in enumerate(WKV_CASES)]
             + [(1100 + n, case, True) for n, case in enumerate(WKV_GRAD_CASES)])
    for seed, case, grad in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = wkv_inputs(case, dtype, seed=seed)
            route = wkv_kernel.route(dtype, case[3], case[1], grad)
            before = read_wkv_routes()
            outs = dict(zip(("y", "s_last"), wkv_kernel.rwkv6_wkv_fwd(*args, grad=grad)))
            mid = read_wkv_routes()
            refs = dict(zip(("y", "s_last"), wkv_ref.rwkv6_reference(*args)))
            torch.cuda.synchronize()
            name = dtype_name(dtype) + (", the forward of a gradient" if grad else "")
            want = {r: before[r] + (r == route) for r in before}
            if (mid, read_wkv_routes()) != (want, want):
                raise AssertionError(f"wkv case {case} {name}: launches by route {before} "
                                     f"before the kernel call, {mid} after it and "
                                     f"{read_wkv_routes()} after the plain call; expected one "
                                     f"{route} launch and none from the plain call")
            for what, out in outs.items():
                ref = refs[what]
                want = dtype if what == "y" else torch.float32
                if out.shape != ref.shape or out.dtype != want:
                    raise AssertionError(f"wkv case {case} {name} {what}: "
                                         f"{tuple(out.shape)} {out.dtype}")
                if not torch.isfinite(out.float()).all():
                    raise AssertionError(f"wkv case {case} {name} {what}: non-finite output")
                err = (out.float() - ref.float()).abs().max().item()
                rel = rel_err(out, ref)
                abs_tol, tol = WKV_ABS_TOL.get(dtype), WKV_REL_TOL[dtype, what]
                log(f"[wkv] {case} {name}, route {route}, {what}: max_abs_err {err:.3e} (tol "
                    f"{abs_tol}), rel_err {rel:.3e} (tol {tol:.3e}), max |ref| "
                    f"{ref.float().abs().max().item():.3f}")
                if abs_tol is not None and err > abs_tol:
                    raise AssertionError(f"wkv case {case} {name} {what}: "
                                         f"max_abs_err {err} > {abs_tol}")
                if rel > tol:
                    raise AssertionError(f"wkv case {case} {name} {what}: rel_err {rel} > {tol}")
                worst[dtype_name(dtype)] = max(worst.get(dtype_name(dtype), 0.0), err)
                by_route[route, what] = max(by_route.get((route, what), 0.0), rel)
            if grad and route != "recurrent":
                beside = dict(zip(("y", "s_last"), wkv_kernel.launch("recurrent", *args)))
                log(f"[wkv] {case} {name}: rel_err of y and s_last, route {route} "
                    f"{rel_err(outs['y'], refs['y']):.3e} and "
                    f"{rel_err(outs['s_last'], refs['s_last']):.3e}, beside the recurrent "
                    f"route's {rel_err(beside['y'], refs['y']):.3e} and "
                    f"{rel_err(beside['s_last'], refs['s_last']):.3e}")
    log(f"[wkv] largest error over {len(cases)} cases: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + "; largest rel_err by route: "
        + ", ".join(f"{r} {w} {v:.3e}" for (r, w), v in by_route.items()))
    return worst


# The seed pairs (weights, tokens) of rwkv6-7b's bf16 train slice that
# wkv_grad_routes and phase_wkv_slice_cases take: the slice's own (0, 4)
# and a second pair (1, 5).
WKV_SLICE_SEEDS = ((0, 4), (1, 5))


def slice_wkv_inputs(weights_seed, tokens_seed):
    """The WKV inputs (r, k, v, w, u, s0) of each layer of rwkv6-7b's train
    slice (TRAIN_SLICES: 2 layers at full width, 2 x 200 tokens, bf16) at a
    seed pair, as the slice's train-mode forward hands them to rwkv6_wkv on
    the plain path (rwkv6.rwkv6_wkv patched to a recorder that calls the
    plain version), each contiguous."""
    arch, cut, batch_size, seq, _ = next(s for s in TRAIN_SLICES if s[0] == "rwkv6-7b")
    cfg = dataclasses.replace(get_config(arch), **cut)
    g = torch.Generator("cuda").manual_seed(tokens_seed)
    toks = torch.randint(0, cfg.vocab, (batch_size, seq + 1), generator=g, device="cuda")
    params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(weights_seed),
                            torch.bfloat16, "cuda")
    seen = []

    def record(*args):
        seen.append([None if x is None else x.detach().contiguous().clone() for x in args])
        return wkv_ref.rwkv6_reference(*args)
    with torch.no_grad(), mock.patch.object(rwkv6, "rwkv6_wkv", record):
        lm.forward(params, cfg, tokens=toks[:, :-1])
    if len(seen) != cfg.n_layers:
        raise AssertionError(f"slice wkv inputs: {len(seen)} WKV calls, expected one a layer")
    return seen


def phase_wkv_slice_cases():
    """The serving chunk route's y (and the chunk_exact route's) on the WKV
    inputs of each layer of rwkv6-7b's bf16 train slice at both seed pairs
    (WKV_SLICE_SEEDS), against the plain version: y within WKV_REL_TOL's
    2**-7 and s_last within its 1e-5, on activations rather than drawn
    inputs.  Each kernel call is one launch on its route."""
    readings = {}
    for weights_seed, tokens_seed in WKV_SLICE_SEEDS:
        for layer, args in enumerate(slice_wkv_inputs(weights_seed, tokens_seed)):
            r = args[0]
            ref_y, ref_s = wkv_ref.rwkv6_reference(*args)
            for rt in ("chunk", "chunk_exact"):
                wkv_kernel._check(*args, grad=rt == "chunk_exact")
                before = read_wkv_routes()
                y, s_last = wkv_kernel.launch(rt, *args)
                after = read_wkv_routes()
                if after != {k: before[k] + (k == rt) for k in before}:
                    raise AssertionError(f"wkv slice case: launches by route {before} -> {after}, "
                                         f"expected one {rt} launch")
                got = {"y": rel_err(y, ref_y), "s_last": rel_err(s_last, ref_s)}
                readings[f"seeds {weights_seed}/{tokens_seed} layer {layer} {rt}"] = got
                log(f"[wkv-slice] rwkv6-7b train slice, seeds {weights_seed} (weights) and "
                    f"{tokens_seed} (tokens), layer {layer}, WKV inputs {tuple(r.shape)} bf16, "
                    f"route {rt}: rel_err y {got['y']:.4e} (tol "
                    f"{WKV_REL_TOL[torch.bfloat16, 'y']:.4e}), s_last {got['s_last']:.4e} (tol "
                    f"{WKV_REL_TOL[torch.bfloat16, 's_last']:.0e}), max |y| "
                    f"{ref_y.float().abs().max().item():.3f}")
                for what, rel in got.items():
                    if not rel <= WKV_REL_TOL[torch.bfloat16, what]:
                        raise AssertionError(f"wkv slice case seeds {weights_seed}/{tokens_seed} "
                                             f"layer {layer} route {rt} {what}: rel_err {rel}")
    return readings


def scan_inputs(case, dtype, seed):
    """a and b in ``dtype`` and h0 (f32, or None) for one of SCAN_CASES."""
    B, T, W, with_h0, decay = case
    g = torch.Generator("cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.float32)
    if decay == "sigmoid":
        a, b = torch.sigmoid(randn(B, T, W)), randn(B, T, W) * 0.1
    else:
        # lam as init_params draws it: sigmoid(lam) ** 8 ~ U(0.9, 0.999)
        a8 = (0.9 + (0.999 - 0.9) * torch.rand(W, generator=g, device="cuda")) ** (1 / 8)
        a, b = rglru._lru_coeffs({"lam": torch.log(a8 / (1 - a8))}, torch.sigmoid(randn(B, T, W)),
                                 torch.sigmoid(randn(B, T, W)), randn(B, T, W))
    h0 = randn(B, W) if with_h0 else None
    return a.to(dtype), b.to(dtype), h0


def scan_bound(case, dtype):
    """Least time on the card: a and b (and h0 when given) read once, h and
    h_last written once; 2 FLOP an element at the f32 rate outside the
    tensor cores, where the kernel does them.  The larger of the two."""
    B, T, W, with_h0, _ = case
    item = torch.finfo(dtype).bits // 8
    nbytes = item * 3 * B * T * W + 4 * B * W * (2 if with_h0 else 1)
    flops = 2 * B * T * W
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def phase_scan_cases():
    """Each case in f32 and bf16: the RG-LRU kernel against its plain version.
    Each case's kernel call must add exactly one to the launch counter and the
    plain version's call none, so an error of exactly 0 comes from two
    different computations."""
    log("[scan] rounding: the kernel takes __fmul_rn then __fadd_rn each step, two "
        "roundings as the plain version's a * h + b, so equal inputs give equal bits")
    kernel = scan_kernel.rglru_scan_fwd
    worst = {}
    for n, case in enumerate(SCAN_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            a, b, h0 = scan_inputs(case, dtype, seed=2000 + n)
            before = kernel.launches
            outs = dict(zip(("h", "h_last"), kernel(a, b, h0)))
            mid = kernel.launches
            refs = dict(zip(("h", "h_last"), scan_ref.rglru_reference(a, b, h0)))
            torch.cuda.synchronize()
            name = dtype_name(dtype)
            if (mid - before, kernel.launches - mid) != (1, 0):
                raise AssertionError(f"scan case {case} {name}: the kernel call launched "
                                     f"{mid - before} times and the plain call "
                                     f"{kernel.launches - mid}, expected 1 and 0")
            for what, out in outs.items():
                ref = refs[what]
                want = dtype if what == "h" else torch.float32
                if out.shape != ref.shape or out.dtype != want:
                    raise AssertionError(f"scan case {case} {name} {what}: "
                                         f"{tuple(out.shape)} {out.dtype}")
                if not torch.isfinite(out.float()).all():
                    raise AssertionError(f"scan case {case} {name} {what}: non-finite output")
                err = (out.float() - ref.float()).abs().max().item()
                rel = rel_err(out, ref)
                abs_tol, tol = SCAN_ABS_TOL[dtype], SCAN_REL_TOL[dtype, what]
                log(f"[scan] {case} {name} {what}: max_abs_err {err:.3e} (tol {abs_tol}), "
                    f"rel_err {rel:.3e} (tol {tol:.3e}), bit-identical elements "
                    f"{(out == ref).float().mean().item():.6f}, max |ref| "
                    f"{ref.float().abs().max().item():.3f}; launches: kernel call 1, plain call 0")
                if err > abs_tol:
                    raise AssertionError(f"scan case {case} {name} {what}: "
                                         f"max_abs_err {err} > {abs_tol}")
                if rel > tol:
                    raise AssertionError(f"scan case {case} {name} {what}: rel_err {rel} > {tol}")
                worst[name] = max(worst.get(name, 0.0), err)
    log(f"[scan] largest error over {len(SCAN_CASES)} cases: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return worst


def scan_bwd_inputs(case, dtype, seed):
    """a, h0 and h (the forward kernel's output) of a scan case, and the
    cotangents dh in ``dtype`` and dh_last (f32, or None)."""
    B, T, W, with_h0, with_dl, decay = case
    a, b, h0 = scan_inputs((B, T, W, with_h0, decay), dtype, seed)
    h, _ = scan_kernel.rglru_scan_fwd(a, b, h0)
    g = torch.Generator("cuda").manual_seed(seed + 1)
    dh = torch.randn((B, T, W), generator=g, device="cuda").to(dtype)
    dh_last = torch.randn((B, W), generator=g, device="cuda") if with_dl else None
    return a, h, h0, dh, dh_last


def phase_scan_bwd_cases():
    """Each scan backward case in f32 and bf16: the backward kernel's da, db
    and dh0 against its plain version on the same inputs.  Each case's kernel
    call must add exactly one to its launch counter and to launches_by_route,
    on the route kernel.bwd_route() names, and the plain call none; f32 must
    agree to the bit (SCAN_BWD_REL_TOL).  Every route must be taken: the bf16
    rows of W = 100 (200 bytes) take the prefetch route, the rest TMA."""
    kernel = scan_kernel.rglru_scan_bwd
    worst, taken = {}, set()
    for n, case in enumerate(SCAN_BWD_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            args = scan_bwd_inputs(case, dtype, seed=5000 + n)
            route = scan_kernel.bwd_route(args[0], args[1], args[3])
            before, routes_before = kernel.launches, read_scan_bwd_routes()
            outs = kernel(*args)
            mid, routes_mid = kernel.launches, read_scan_bwd_routes()
            refs = scan_ref.rglru_scan_bwd_reference(*args)
            torch.cuda.synchronize()
            name = dtype_name(dtype)
            want = {r: routes_before[r] + (r == route) for r in routes_before}
            if (mid - before, kernel.launches - mid) != (1, 0) or (
                    routes_mid, read_scan_bwd_routes()) != (want, want):
                raise AssertionError(f"scan bwd case {case} {name}: the kernel call launched "
                                     f"{mid - before} times ({routes_before} by route before "
                                     f"it, {routes_mid} after) and the plain call "
                                     f"{kernel.launches - mid}, expected one {route} launch "
                                     "and none")
            taken.add(route)
            for what, out, ref in zip(("da", "db", "dh0"), outs, refs):
                want = torch.float32 if what == "dh0" else dtype
                if out.shape != ref.shape or out.dtype != want:
                    raise AssertionError(f"scan bwd case {case} {name} {what}: "
                                         f"{tuple(out.shape)} {out.dtype}")
                if not torch.isfinite(out.float()).all():
                    raise AssertionError(f"scan bwd case {case} {name} {what}: non-finite")
                err = (out.float() - ref.float()).abs().max().item()
                rel = rel_err(out, ref)
                tol = SCAN_BWD_REL_TOL[dtype] if what != "dh0" else 0.0
                log(f"[scan-bwd] {case} {name}, route {route}, {what}: max_abs_err {err:.3e}, "
                    f"rel_err {rel:.3e} "
                    f"(tol {tol:.3e}), bit-identical elements "
                    f"{(out == ref).float().mean().item():.6f}, max |ref| "
                    f"{ref.float().abs().max().item():.3f}; launches: kernel call 1, plain call 0")
                if rel > tol:
                    raise AssertionError(f"scan bwd case {case} {name} {what}: rel_err {rel} > "
                                         f"{tol}")
                worst[name] = max(worst.get(name, 0.0), err)
    if taken != set(scan_kernel.BWD_ROUTES):
        raise AssertionError(f"scan bwd cases took the routes {sorted(taken)}, expected every "
                             f"one of {scan_kernel.BWD_ROUTES}")
    log(f"[scan-bwd] largest error over {len(SCAN_BWD_CASES)} cases: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return worst


def wkv_bwd_inputs(case, dtype, seed):
    """r, k, v, w, u and s0 of a WKV backward case (wkv_inputs), the
    cotangent dy ~ N(0,1) in ``dtype`` and ds_last ~ N(0,1)*0.1 (f32) or
    None."""
    B, T, H, D, with_s0, with_ds, decay = case
    r, k, v, w, u, s0 = wkv_inputs((B, T, H, D, with_s0, decay), dtype, seed)
    g = torch.Generator("cuda").manual_seed(seed + 1)
    dy = torch.randn((B, T, H, D), generator=g, device="cuda").to(dtype)
    ds_last = torch.randn((B, H, D, D), generator=g, device="cuda") * 0.1 if with_ds else None
    return r, k, v, w, u, s0, dy, ds_last


def phase_wkv_bwd_cases():
    """Each WKV backward case in f32 and bf16: the backward kernel's dr, dk,
    dv, dw, du and ds0 against its plain version on the same inputs, within
    WKV_BWD_REL_TOL.  Each case's kernel call must add exactly one to its
    launch counter and to launches_by_route on the route kernel.bwd_route()
    names, and the plain call none; a second kernel call must give the same
    gradients to the bit."""
    kernel = wkv_kernel.rwkv6_wkv_bwd
    worst = {}
    for n, case in enumerate(WKV_BWD_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            args = wkv_bwd_inputs(case, dtype, seed=6000 + n)
            before, routes_before = kernel.launches, read_wkv_bwd_routes()
            outs = kernel(*args)
            mid, routes_mid = kernel.launches, read_wkv_bwd_routes()
            refs = wkv_ref.rwkv6_wkv_bwd_reference(*args)
            after = kernel.launches
            repeat = kernel(*args)
            torch.cuda.synchronize()
            name = dtype_name(dtype)
            route = wkv_kernel.bwd_route(dtype, case[3], case[1])
            want = {r: routes_before[r] + (r == route) for r in routes_before}
            if (mid - before, after - mid, routes_mid) != (1, 0, want):
                raise AssertionError(f"wkv bwd case {case} {name}: the kernel call launched "
                                     f"{mid - before} times ({routes_before} by route before "
                                     f"it, {routes_mid} after) and the plain call "
                                     f"{after - mid}, expected one {route} launch and none")
            if any(not torch.equal(a, b) for a, b in zip(outs, repeat)):
                raise AssertionError(f"wkv bwd case {case} {name}: a second call gave other "
                                     "values")
            for what, out, ref in zip(WKV_BWD_OUTPUTS, outs, refs):
                want = torch.float32 if what in ("du", "ds0") else dtype
                if out.shape != ref.shape or out.dtype != want:
                    raise AssertionError(f"wkv bwd case {case} {name} {what}: "
                                         f"{tuple(out.shape)} {out.dtype}")
                if not torch.isfinite(out.float()).all():
                    raise AssertionError(f"wkv bwd case {case} {name} {what}: non-finite")
                err = (out.float() - ref.float()).abs().max().item()
                rel = rel_err(out, ref)
                tol = WKV_BWD_REL_TOL[dtype][what]
                log(f"[wkv-bwd] {case} {name}, route {route}, {what}: max_abs_err {err:.3e}, "
                    f"rel_err {rel:.3e} (tol {tol:.3e}), max |ref| "
                    f"{ref.float().abs().max().item():.3f}; launches: kernel call 1, plain call "
                    "0; a second call equal to the bit")
                if rel > tol:
                    raise AssertionError(f"wkv bwd case {case} {name} {what}: rel_err {rel} > "
                                         f"{tol}")
                worst[name] = max(worst.get(name, 0.0), err)
            del outs, refs, repeat, args
    log(f"[wkv-bwd] largest error over {len(WKV_BWD_CASES)} cases: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return worst


def prompt_kind(cfg) -> str:
    """What a prompt of cfg is made of: tokens, or a frontend stub's
    embeddings."""
    return {None: "tokens", "audio": "frame embeddings", "vision": "patch embeddings"}[
        cfg.frontend]


def _slice_run(params, cfg, prompt, follow):
    """One path of the slice, with the launches of each part.  ``prompt``:
    {"tokens": (B, P)}, or {"embeds": (B, P, d)} for a frontend stub.  First
    a train-mode forward over the prompt: the final hidden state at every
    position.  Then prefill and teacher-forced decode steps on a cache of its
    own: the logits of each, a copy of the cache's leaves after prefill, and
    the cache's leaves at the end.  An encoder-only model has no cache and
    no decode step (``follow`` is empty): its prefill gives the frame logits."""
    reset_launches()
    hidden, _ = lm.forward(params, cfg, **prompt)
    forward_launches = {**read_launches(), "rwkv6_wkv_fwd by route": read_wkv_routes()}
    reset_launches()
    B, P = next(iter(prompt.values())).shape[:2]
    cache = lm.init_cache(cfg, B, P + follow.shape[1], params["embed"].dtype, "cuda")
    logits, cache = lm.prefill(params, cfg, cache, **prompt)
    out = [logits]
    after_prefill = {} if cache is None else {
        name: t.clone() for name, t in cache_leaves(cache["layers"])}
    for t in range(follow.shape[1]):
        logits, cache = lm.decode_step(params, cfg, cache, follow[:, t:t + 1])
        out.append(logits)
    return (hidden, forward_launches, out,
            {**read_launches(), "rwkv6_wkv_fwd by route": read_wkv_routes()}, after_prefill,
            {} if cache is None else dict(cache_leaves(cache["layers"])))


def wkv_routes(cfg, dtype, tokens, n_multi, n_single, grad=False):
    """WKV launches by route: n_multi over ``tokens`` steps each (a prefill
    or a train-mode forward) and n_single of one step (decode steps); with
    ``grad``, each the forward of a gradient (a train step's)."""
    out = dict.fromkeys(wkv_kernel.ROUTES, 0)
    out[wkv_kernel.route(dtype, cfg.rwkv_head_dim, tokens, grad)] += n_multi
    out[wkv_kernel.route(dtype, cfg.rwkv_head_dim, 1, grad)] += n_single
    return out


# Per served model, at full width: the cut of the slice (layers, window), its
# prompt length, the entry points the plain path swaps for their plain
# versions, and the kernel path's launches in the train-mode forward and in
# prefill plus decode.  qwen3: flash once a layer in prefill, decode runs
# none.  rwkv6: WKV once a layer in prefill and in each decode step.
# recurrentgemma: layers rglru, rglru, attn_local, rglru, so a recurrent
# layer reads the attention kernel's output, and a 128-token window under 256
# prompt tokens, so the ring cache runs; the scan once a recurrent layer and
# flash once in prefill, decode runs neither.  yi-9b, minitron-4b (its 32
# padded heads over 8 kv heads), qwen2-moe-a2.7b, qwen3-moe-30b-a3b and
# minicpm3-4b (MLA: flash at (96, 64) in train mode and prefill, its decode
# plain on the compressed cache): flash once a layer, as qwen3; the MoE
# models' plain path replays the kernel path's expert choice (RouterReplay).
# hubert-xlarge (bidirectional, flash at (80, 80): bf16 on the tensor cores,
# f32 SIMT) over
# 64 frame embeddings: flash once a layer in the forward and in its prefill,
# which gives the frame logits; no cache, no decode step.  pixtral-12b
# prefills 64 patch embeddings, then decodes tokens, as yi-9b.
SLICE_DECODE_STEPS = 4
# The dtypes the slices run in, each with its tolerance (phase_slice).
SLICE_DTYPES = ((torch.float32, 1e-4), (torch.bfloat16, 2e-2))
SLICES = [
    ("qwen3-1.7b", {"n_layers": 2}, 64,
     [(attention, "flash_attention", fa_ops.chunked_attention)],
     {"flash_attention_fwd": 2}, {"flash_attention_fwd": 2}),
    ("rwkv6-7b", {"n_layers": 2}, 64,
     [(rwkv6, "rwkv6_wkv", wkv_ref.rwkv6_reference)],
     {"rwkv6_wkv_fwd": 2}, {"rwkv6_wkv_fwd": 2 * (1 + SLICE_DECODE_STEPS)}),
    ("recurrentgemma-2b", {"n_layers": 4, "local_window": 128}, 256,
     [(attention, "flash_attention", fa_ops.chunked_attention),
      (rglru, "rglru_scan", scan_ref.rglru_reference)],
     {"flash_attention_fwd": 1, "rglru_scan_fwd": 3},
     {"flash_attention_fwd": 1, "rglru_scan_fwd": 3}),
] + [(arch, {"n_layers": 2}, 64, [(attention, "flash_attention", fa_ops.chunked_attention)],
      {"flash_attention_fwd": 2}, {"flash_attention_fwd": 2})
     for arch in ("yi-9b", "minitron-4b", "qwen2-moe-a2.7b", "qwen3-moe-30b-a3b",
                  "minicpm3-4b", "hubert-xlarge", "pixtral-12b")]
# The router the MoE block calls, as the port defines it (RouterReplay wraps it).
ROUTER = moe._router


def routing_differences(probs_p, idx_p, probs_k, idx_k, top_k):
    """(the tokens whose chosen experts differ between the plain path, p,
    and the kernel path, k; the largest share of its bound a difference's
    gap takes).  Each difference must be a near-tie: where the kernel path
    chose expert e and the plain path did not, and the plain path chose e'
    and the kernel path did not, the plain path's own probabilities give
    p(e') - p(e) >= gap, its k-th less its (k+1)-th probability, while the
    kernel path's give p(e) >= p(e'); so gap <= d(e) + d(e'), d the
    difference of that expert's probability between the paths, for every
    such pair.  Raises where one is not."""
    E = probs_p.shape[-1]
    pp, pk = probs_p.reshape(-1, E).double(), probs_k.reshape(-1, E).double()

    def chosen(idx):
        return torch.zeros(pp.shape, dtype=torch.bool, device=pp.device).scatter_(
            1, idx.reshape(-1, top_k), True)
    on_p, on_k = chosen(idx_p), chosen(idx_k)
    differ = (on_p != on_k).any(dim=1)
    n = int(differ.sum())
    if not n:
        return 0, 0.0
    top = torch.topk(pp[differ], top_k + 1, dim=-1).values
    gap = top[:, top_k - 1] - top[:, top_k]
    d = (pp - pk).abs()[differ]
    inf = torch.tensor(float("inf"), dtype=d.dtype, device=d.device)
    bound = (torch.where((on_k & ~on_p)[differ], d, inf).min(dim=1).values
             + torch.where((on_p & ~on_k)[differ], d, inf).min(dim=1).values)
    if (gap > bound).any():
        i = int(torch.argmax((gap - bound)))
        raise AssertionError(f"routing: a token's chosen experts differ between the paths "
                             f"with a gap {gap[i].item():.3e} between its k-th and (k+1)-th "
                             f"probabilities, more than the {bound[i].item():.3e} the paths' "
                             "probabilities differ by at the swapped experts")
    return n, torch.where(bound > 0, gap / bound, 0.0).max().item()


class RouterReplay:
    """The MoE router of the slice's two paths.  ``record`` (patched over
    moe._router on the kernel path) keeps each call's probabilities and
    expert ids; ``replay`` (on the plain path) computes the plain path's
    own router, holds each difference of choice to routing_differences, and
    hands the block the kernel path's expert ids, call by call, with the
    plain path's own probabilities at them as gates (renormalised where the
    config says so).  So both paths send each token to the same experts,
    with the same capacity drops, and what remains between them is the
    numbers' own difference."""

    def __init__(self):
        self.calls, self.replayed, self.differ, self.worst = [], 0, [], 0.0

    def record(self, y, p, moe_cfg):
        gates, idx, probs = ROUTER(y, p, moe_cfg)
        self.calls.append((probs.detach(), idx))
        return gates, idx, probs

    def replay(self, y, p, moe_cfg):
        _, idx, probs = ROUTER(y, p, moe_cfg)
        if self.replayed == len(self.calls):
            raise AssertionError("routing: the plain path calls the router more often than "
                                 f"the kernel path's {len(self.calls)} calls")
        probs_k, idx_k = self.calls[self.replayed]
        self.replayed += 1
        n, worst = routing_differences(probs, idx, probs_k, idx_k, moe_cfg.top_k)
        self.differ.append(n)
        self.worst = max(self.worst, worst)
        gates = torch.gather(probs, -1, idx_k)
        if moe_cfg.router_norm_topk:
            gates = gates / torch.clamp_min(torch.sum(gates, -1, keepdim=True), 1e-9)
        return gates, idx_k, probs


def phase_slice():
    """Full width, a few layers: the kernel path against the plain path, on the card.

    The plain path is the same model with the kernels' entry points swapped
    for their plain versions for this comparison; every kernel's launches
    are counted on each path, and each path fills its own cache.  Tolerance
    on ||a - b|| / ||b||: 1e-4 in f32 (the kernels and the plain versions
    differ in the order of f32 sums), 2e-2 in bf16 (one bf16 rounding of a
    kernel's output, carried through the layers).  Held so: the final hidden
    state at every position of a train-mode forward; the logits after
    prefill and after each decode step; in f32, every cache leaf after
    prefill and at the end.  The full-sequence hidden state reads every
    position of every kernel's output, so in f32, where the flash and WKV
    kernels sum in another order than their plain versions, it must differ
    somewhere; in bf16 the number of elements that differ is logged.  The
    first decode step reads the caches the prefill left, so where the prefill
    logits differ its logits must differ too; a later step may agree exactly
    once every state it reads was made by earlier decode steps
    (recurrentgemma's width-4 conv is refreshed after 3 steps, and its
    recurrence keeps almost nothing of an older state).  An MoE model's
    plain path takes the kernel path's expert choice, call by call, with its
    own probabilities as gates (RouterReplay); its own choice is computed
    too, and every difference must be a near-tie (routing_differences),
    since one token sent elsewhere moves its row by O(1).
    """
    none = dict.fromkeys(KERNELS, 0)
    for arch, cut, prompt_len, patches, fwd_launches, launches in SLICES:
        cfg = dataclasses.replace(get_config(arch), **cut)
        what_cut = ", ".join(f"{k} {v}" for k, v in cut.items())
        g = torch.Generator("cuda").manual_seed(2)
        prompts = torch.randint(0, cfg.vocab, (2, prompt_len), generator=g, device="cuda")
        follow = torch.randint(0, cfg.vocab, (2, SLICE_DECODE_STEPS), generator=g,
                               device="cuda")[:, :SLICE_DECODE_STEPS if cfg.has_decoder else 0]
        for dtype, tol in SLICE_DTYPES:
            label = (f"{arch} full width, {what_cut}, 2x{prompt_len} {prompt_kind(cfg)}, "
                     f"{dtype_name(dtype)}")
            prompt = {"tokens": prompts} if not cfg.frontend else {"embeds": pseudo_embeds(
                2, prompt_len, cfg.d_model, seed=2, step=0, dtype=dtype, device="cuda")}
            # WKV by route: the forward and prefill over the prompt (the chunk
            # route in bf16), each decode step a single step (recurrent)
            n_wkv = fwd_launches.get("rwkv6_wkv_fwd", 0)
            want_fwd = {**none, **fwd_launches, "rwkv6_wkv_fwd by route": wkv_routes(
                cfg, dtype, prompt_len, n_wkv, 0)}
            want = {**none, **launches, "rwkv6_wkv_fwd by route": wkv_routes(
                cfg, dtype, prompt_len, n_wkv, n_wkv * SLICE_DECODE_STEPS)}
            no_wkv = {**none, "rwkv6_wkv_fwd by route": wkv_routes(cfg, dtype, prompt_len, 0, 0)}
            params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(0), dtype, "cuda")
            replay = RouterReplay() if cfg.moe is not None else None
            with contextlib.ExitStack() as stack:
                if replay:
                    stack.enter_context(mock.patch.object(moe, "_router", replay.record))
                (kernel_hidden, kernel_fwd, kernel_path, kernel_launches, kernel_prefill,
                 kernel_final) = _slice_run(params, cfg, prompt, follow)
            with contextlib.ExitStack() as stack:
                for module, attr, plain in patches:
                    stack.enter_context(mock.patch.object(module, attr, plain))
                if replay:
                    stack.enter_context(mock.patch.object(moe, "_router", replay.replay))
                (plain_hidden, plain_fwd, plain_path, plain_launches, plain_prefill,
                 plain_final) = _slice_run(params, cfg, prompt, follow)
            if replay:
                if replay.replayed != len(replay.calls):
                    raise AssertionError(f"slice {label}: the plain path called the router "
                                         f"{replay.replayed} times, the kernel path "
                                         f"{len(replay.calls)}")
                log(f"[slice] {label}: the plain path replayed the kernel path's expert choice "
                    f"in {replay.replayed} router calls; its own choice differs at "
                    f"{sum(replay.differ)} (token, layer) pairs (by call {replay.differ}), each a "
                    f"near-tie (the largest gap over its bound {replay.worst:.3e}, held <= 1)")
            log(f"[slice] {label}: launches {kernel_fwd} in the train-mode forward and "
                f"{kernel_launches} in prefill and decode on the kernel path (expected "
                f"{want_fwd} and {want}), {plain_fwd} and {plain_launches} on the plain "
                "path (expected all 0)")
            if (kernel_fwd, kernel_launches, plain_fwd, plain_launches) != (
                    want_fwd, want, no_wkv, no_wkv):
                raise AssertionError(f"slice {label}: launches {kernel_fwd}, "
                                     f"{kernel_launches}, {plain_fwd} and {plain_launches}, "
                                     f"expected {want_fwd}, {want}, {no_wkv} and {no_wkv}")
            if not torch.isfinite(kernel_hidden).all():
                raise AssertionError(f"slice {label}: non-finite hidden state")
            rel = rel_err(kernel_hidden, plain_hidden)
            differ = (kernel_hidden != plain_hidden).sum().item()
            log(f"[slice] {label}, train-mode forward, final hidden state at all "
                f"{prompt_len} positions: rel_err {rel:.3e} (tol {tol}), {differ} of "
                f"{kernel_hidden.numel()} elements differ")
            if rel > tol:
                raise AssertionError(f"slice {label}: full-sequence rel_err {rel} > {tol}")
            if dtype == torch.float32 and differ == 0:
                raise AssertionError(f"slice {label}: the kernel path's full-sequence hidden "
                                     "state equals the plain path's bit for bit in f32")
            rels = []
            for i, (a, b) in enumerate(zip(kernel_path, plain_path)):
                what = ("prefill" if cfg.has_decoder else "encode (frame)") if i == 0 else \
                    f"decode {i}"
                if not torch.isfinite(a).all():
                    raise AssertionError(f"slice {label} {what}: non-finite logits")
                rels.append(rel_err(a, b))
                log(f"[slice] {label}, {what} logits: rel_err {rels[-1]:.3e} (tol {tol}), "
                    f"max_abs_err {(a - b).abs().max().item():.3e} of |logit| <= "
                    f"{b.abs().max().item():.1f}")
                if rels[-1] > tol:
                    raise AssertionError(f"slice {label} {what}: rel_err {rels[-1]} > {tol}")
            if len(rels) > 1 and rels[0] > 0 and rels[1] == 0:
                raise AssertionError(f"slice {label}: the first decode step's logits agree "
                                     "exactly while the prefill logits do not")
            shared = ({t.data_ptr() for t in kernel_final.values()}
                      & {t.data_ptr() for t in plain_final.values()})
            if shared:
                raise AssertionError(f"slice {label}: the two paths' caches share storage")
            for when, mine, theirs in (("after prefill", kernel_prefill, plain_prefill),
                                       ("final", kernel_final, plain_final)):
                for name, t in mine.items():
                    rel = rel_err(t, theirs[name])
                    held = dtype == torch.float32
                    log(f"[slice] {label}, cache {when} {name}: rel_err {rel:.3e}"
                        + (" (tol 1e-4)" if held else ""))
                    if held and rel > 1e-4:
                        raise AssertionError(f"slice {label}: cache {when} {name} "
                                             f"rel_err {rel} > 1e-4")
            del params


def bwd_inputs(case, dtype, seed):
    """q, k, v and dout of a case in ``dtype``; o, the plain forward's output;
    and lse, the plain version of the forward's, in a buffer from empty_lse
    (rows 16 bytes apart, as the tensor-core route reads them).  dout is 0
    on the heads past BWD_REAL_HEADS[case], where there is an entry."""
    q, k, v = case_inputs(case, dtype, seed)
    o = fa_ops.chunked_attention(q, k, v, **case_kwargs(case))
    g = torch.Generator("cuda").manual_seed(seed + 1)
    dout = torch.randn(o.shape, generator=g, device="cuda", dtype=torch.float32).to(dtype)
    dout[:, :, BWD_REAL_HEADS.get(case, case[3]):] = 0
    lse = fa_kernel.empty_lse(q.shape[0], q.shape[2], q.shape[1], "cuda")
    lse.copy_(fa_ref.lse_reference(q, k, v, **case_kwargs(case)))
    return q, k, v, o, dout, lse


def phase_bwd_cases():
    """Each backward case in f32 and bf16: the backward kernel's dq, dk and dv
    against its plain version on the same inputs, dout and lse.  Each case's
    kernel call must add exactly one to the launch counter, on the route
    route(..., backward=True) names, and the plain call none; a second
    kernel call must give the same dq, dk and dv to the bit."""
    kernel = fa_kernel.flash_attention_bwd
    worst = {}
    for n, case in enumerate(BWD_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, o, dout, lse = bwd_inputs(case, dtype, seed=3000 + n)
            route = fa_kernel.route(dtype, case[5], case[6], backward=True)
            before = read_bwd_routes()
            outs = kernel(q, k, v, o, dout, lse, **case_kwargs(case))
            mid = read_bwd_routes()
            refs = fa_ref.flash_attention_bwd_reference(q, k, v, o, dout, lse=lse,
                                                        **case_kwargs(case))
            after = read_bwd_routes()
            repeat = kernel(q, k, v, o, dout, lse, **case_kwargs(case))
            torch.cuda.synchronize()
            name = dtype_name(dtype)
            want = {r: before[r] + (r == route) for r in before}
            if (mid, after) != (want, want):
                raise AssertionError(f"bwd case {case} {name}: launches by route {before} "
                                     f"before the kernel call, {mid} after it and {after} after "
                                     f"the plain call; expected one {route} launch and none "
                                     "from the plain call")
            if any(not torch.equal(a, b) for a, b in zip(outs, repeat)):
                raise AssertionError(f"bwd case {case} {name}: a second call gave other values")
            real = BWD_REAL_HEADS.get(case, case[3])
            if real < case[3]:
                padded = outs[0][:, :, real:]
                if not torch.all(padded == 0):
                    raise AssertionError(f"bwd case {case} {name}: dq of the padded heads "
                                         f"{real}.. is not 0 (finite: "
                                         f"{bool(torch.isfinite(padded.float()).all())})")
                log(f"[bwd] {case} {name}: dout 0 on heads {real}..{case[3] - 1}, their dq "
                    "exactly 0")
            for what, out, ref, like in zip(("dq", "dk", "dv"), outs, refs, (q, k, v)):
                if out.shape != like.shape or out.dtype != dtype:
                    raise AssertionError(f"bwd case {case} {name} {what}: "
                                         f"{tuple(out.shape)} {out.dtype}")
                if not torch.isfinite(out.float()).all():
                    raise AssertionError(f"bwd case {case} {name} {what}: non-finite output")
                err = (out.float() - ref.float()).abs().max().item()
                rel = rel_err(out, ref)
                log(f"[bwd] {case} {name}, route {route}, {what}: max_abs_err {err:.3e}, rel_err "
                    f"{rel:.3e} (tol {BWD_REL_TOL[dtype]:.3e}), max |ref| "
                    f"{ref.float().abs().max().item():.3f}; launches: kernel call 1, plain call "
                    "0; a second call equal to the bit")
                if rel > BWD_REL_TOL[dtype]:
                    raise AssertionError(f"bwd case {case} {name} {what}: rel_err {rel} > "
                                         f"{BWD_REL_TOL[dtype]}")
                worst[name] = max(worst.get(name, 0.0), err)
    log(f"[bwd] largest error over {len(BWD_CASES)} cases: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return worst


# The autograd wiring's cases: one on each backward route.
AUTOGRAD_CASES = {torch.float32: BWD_CASES[0],
                  torch.bfloat16: (2, 37, 93, 8, 2, 128, 128, True, None, 56, None)}


def phase_autograd_wiring():
    """On CUDA tensors that require grad, on each backward route:
    flash_attention's output has a grad_fn, one forward launch that writes
    the lse, and its backward is one backward launch giving the backward
    kernel's own dq, dk and dv from that forward's output and lse, to the
    bit.  The scan likewise in f32 and bf16, with h0 and a cotangent on
    h_last: rglru_scan's h and h_last have a grad_fn, one forward and one
    backward launch, and the gradients of a, b and h0 equal the backward
    kernel's own.  WKV as the scan, in f32 and bf16, with s0 and a cotangent
    on s_last: rwkv6_wkv's y and s_last have a grad_fn, one forward launch
    on the route kernel.route(..., grad=True) names (recurrent in f32,
    chunk_exact in bf16) and one backward launch on the route
    kernel.bwd_route() names (recurrent in f32, chunk in bf16), and the
    gradients of r, k, v, w, u and s0 equal the backward kernel's own;
    under no_grad the same inputs take the serving
    route (route(), chunk in bf16) once, with no backward and no grad_fn,
    and y equals the serving kernel's own.  The WKV forward kernel called
    directly refuses inputs that require grad."""
    for dtype, case in AUTOGRAD_CASES.items():
        q, k, v, _, dout, _ = bwd_inputs(case, dtype, seed=99)
        leaf = [t.clone().requires_grad_(True) for t in (q, k, v)]
        reset_launches()
        out = fa_ops.flash_attention(*leaf, **case_kwargs(case))
        if out.grad_fn is None:
            raise AssertionError("autograd: flash_attention's output on the card has no grad_fn")
        grads = torch.autograd.grad(out, leaf, dout)
        counts, lse_launches, routes = (read_launches(),
                                        fa_kernel.flash_attention_fwd.lse_launches,
                                        read_bwd_routes())
        o, lse = fa_kernel.flash_attention_fwd(q, k, v, with_lse=True, **case_kwargs(case))
        want = fa_kernel.flash_attention_bwd(q, k, v, o, dout, lse, **case_kwargs(case))
        route = fa_kernel.route(dtype, case[5], case[6], backward=True)
        if (counts["flash_attention_fwd"], lse_launches, counts["flash_attention_bwd"],
                routes[route]) != (1, 1, 1, 1):
            raise AssertionError(f"autograd {dtype_name(dtype)}: launches {counts}, "
                                 f"{lse_launches} with lse, backward by route {routes}; "
                                 f"expected one forward with lse, one {route} backward")
        if not torch.equal(out.detach(), o) or any(
                not torch.equal(a, b) for a, b in zip(grads, want)):
            raise AssertionError(f"autograd {dtype_name(dtype)}: the output or gradients differ "
                                 "from the kernels' own")
    for dtype in (torch.float32, torch.bfloat16):
        a, b, h0 = scan_inputs((2, 37, 100, True, "sigmoid"), dtype, seed=97)
        g = torch.Generator("cuda").manual_seed(96)
        dh = torch.randn(a.shape, generator=g, device="cuda").to(dtype)
        dh_last = torch.randn(h0.shape, generator=g, device="cuda")
        leaf = [t.clone().requires_grad_(True) for t in (a, b, h0)]
        reset_launches()
        out, out_last = rglru.rglru_scan(*leaf)
        if out.grad_fn is None or out_last.grad_fn is None:
            raise AssertionError("autograd: rglru_scan's outputs on the card have no grad_fn")
        grads = torch.autograd.grad((out, out_last), leaf, (dh, dh_last))
        counts = read_launches()
        h, _ = scan_kernel.rglru_scan_fwd(a, b, h0)
        want = scan_kernel.rglru_scan_bwd(a, h, h0, dh, dh_last)
        if (counts["rglru_scan_fwd"], counts["rglru_scan_bwd"]) != (1, 1):
            raise AssertionError(f"autograd scan {dtype_name(dtype)}: launches {counts}, "
                                 "expected one forward and one backward")
        if not torch.equal(out.detach(), h) or any(
                not torch.equal(x, y) for x, y in zip(grads, want)):
            raise AssertionError(f"autograd scan {dtype_name(dtype)}: the output or gradients "
                                 "differ from the kernels' own")
    for dtype in (torch.float32, torch.bfloat16):
        case = (2, 37, 4, 64, True, True, "sigmoid")
        r, k, v, w, u, s0, dy, ds_last = wkv_bwd_inputs(case, dtype, seed=95)
        leaf = [t.clone().requires_grad_(True) for t in (r, k, v, w, u, s0)]
        reset_launches()
        y, s_last = rwkv6.rwkv6_wkv(*leaf)
        if y.grad_fn is None or s_last.grad_fn is None:
            raise AssertionError("autograd: rwkv6_wkv's outputs on the card have no grad_fn")
        grads = torch.autograd.grad((y, s_last), leaf, (dy, ds_last))
        counts, routes, bwd_routes = read_launches(), read_wkv_routes(), read_wkv_bwd_routes()
        y_kernel, _ = wkv_kernel.rwkv6_wkv_fwd(r, k, v, w, u, s0, grad=True)
        want = wkv_kernel.rwkv6_wkv_bwd(r, k, v, w, u, s0, dy, ds_last)
        route = wkv_kernel.route(dtype, case[3], case[1], grad=True)
        bwd_route = wkv_kernel.bwd_route(dtype, case[3], case[1])
        if (counts["rwkv6_wkv_fwd"], routes[route], counts["rwkv6_wkv_bwd"],
                bwd_routes[bwd_route]) != (1, 1, 1, 1):
            raise AssertionError(f"autograd wkv {dtype_name(dtype)}: launches {counts}, forward "
                                 f"by route {routes}, backward by route {bwd_routes}; expected "
                                 f"one {route} forward and one {bwd_route} backward")
        if not torch.equal(y.detach(), y_kernel) or any(
                not torch.equal(x, z) for x, z in zip(grads, want)):
            raise AssertionError(f"autograd wkv {dtype_name(dtype)}: the output or gradients "
                                 "differ from the kernels' own")
        # the same inputs, still requiring grad, with grad mode off (a prefill
        # or an eval on a trainer's parameters): the serving route, no grad_fn
        served = wkv_kernel.route(dtype, case[3], case[1])
        reset_launches()
        with torch.no_grad():
            y_served, s_served = rwkv6.rwkv6_wkv(*leaf)
        counts, routes = read_launches(), read_wkv_routes()
        if (counts["rwkv6_wkv_fwd"], routes[served], counts["rwkv6_wkv_bwd"]) != (1, 1, 0) or (
                y_served.grad_fn is not None or s_served.grad_fn is not None):
            raise AssertionError(f"autograd wkv {dtype_name(dtype)} under no_grad: launches "
                                 f"{counts}, by route {routes}, grad_fn {y_served.grad_fn}; "
                                 f"expected one {served} forward, no backward, no grad_fn")
        if not torch.equal(y_served, wkv_kernel.rwkv6_wkv_fwd(r, k, v, w, u, s0)[0]):
            raise AssertionError(f"autograd wkv {dtype_name(dtype)} under no_grad: the output "
                                 "differs from the serving kernel's own")
    try:
        wkv_kernel.rwkv6_wkv_fwd(*leaf)
    except NotImplementedError:
        pass
    else:
        raise AssertionError("autograd: rwkv6_wkv_fwd called directly took inputs that "
                             "require grad")
    log("[autograd] flash_attention on the card, f32 (simt) and bf16 (wgmma): grad_fn, 1 "
        "forward launch with lse and 1 backward launch, output and gradients equal to the "
        "kernels' own; rglru_scan, f32 and bf16, h0 and a cotangent on h_last: grad_fn, 1 "
        "forward and 1 backward launch, gradients of a, b and h0 equal to the kernel's own; "
        "rwkv6_wkv likewise, s0 and a cotangent on s_last: grad_fn, 1 forward launch "
        "(as route(..., grad=True) names: recurrent in f32, chunk_exact in bf16) and 1 "
        "backward launch (as bwd_route() names: recurrent in f32, chunk in bf16), "
        "gradients of r, k, v, w, u "
        "and s0 equal to the kernel's own, and under no_grad one launch on the serving route "
        "(chunk in bf16) and no grad_fn; rwkv6_wkv_fwd called directly refuses inputs that "
        "require grad")


# One train step of a uniform stack with remat "full" launches its layers'
# forward kernel 3L - L/k times (k layers a checkpointed group, each layer
# checkpointed inside it: PyTorch's nested non-reentrant checkpoints run a
# layer's forward in the step's forward, in its group's recompute and in its
# own, and the group's recompute serves the last layer of the group) and
# the backward kernel L times, L the layers.  STACK_KERNELS: the forward and
# backward kernel of a uniform stack's layer kind.
STACK_KERNELS = {"attn": ("flash_attention_fwd", "flash_attention_bwd"),
                 "rwkv": ("rwkv6_wkv_fwd", "rwkv6_wkv_bwd")}


def train_launches(n_layers, remat_group=8, kernels=STACK_KERNELS["attn"]):
    k = next(g for g in (remat_group, 4, 2, 1) if n_layers % g == 0)
    fwd, bwd = kernels
    return {**dict.fromkeys(KERNELS, 0), fwd: 3 * n_layers - n_layers // k, bwd: n_layers}


def hybrid_train_launches(cfg):
    """A hybrid checkpoints each layer on its own (remat "full"): each kernel
    runs forward in the step's forward and in its layer's recompute, and
    backward once; flash in the attention layers, the scan in the RG-LRU
    layers (tests/test_torch_train.py measures the same with counting
    stand-ins)."""
    kinds = cfg.layer_kinds()
    n_attn = sum(k in ("attn", "attn_local") for k in kinds)
    n_scan = kinds.count("rglru")
    return {**dict.fromkeys(KERNELS, 0),
            "flash_attention_fwd": 2 * n_attn, "flash_attention_bwd": n_attn,
            "rglru_scan_fwd": 2 * n_scan, "rglru_scan_bwd": n_scan}


# Each train slice: the arch, its cut (full width), batch and tokens, and the
# entry points the plain path swaps for their plain versions, which torch
# differentiates.  recurrentgemma: layers rglru, rglru, attn_local, rglru at
# a 128-token window under 256 tokens, so the windowed backward runs.
# yi-9b and minitron-4b (32 padded heads over 8 kv heads) as qwen3, and the
# MoE models (the plain path replaying the kernel path's expert choice,
# RouterReplay, call by call over the gradient's and the step's forwards
# and remat recomputations) and minicpm3-4b (flash at (96, 64): SIMT in
# f32, tensor cores in bf16) likewise.  rwkv6-7b at 2 layers, 2 x 200
# tokens: the chunks of both training routes (wkv_kernel.CHUNK_STEPS steps)
# cross boundaries and the last is ragged; in bf16 its forward on the chunk_exact route, as
# every forward of a gradient there (wkv_kernel.route), and its backward on
# the chunk route (wkv_kernel.bwd_route).  hubert-xlarge (flash at (80, 80),
# bidirectional: bf16 on the tensor cores, f32 SIMT) and pixtral-12b train
# on embeddings
# (pseudo_embeds) and the tokens' labels; their embed leaf, which the loss
# never reads, takes a zero gradient, as jax.grad gives it.
TRAIN_SLICES = [
    ("qwen3-1.7b", {"n_layers": 2}, 2, 64,
     [(attention, "flash_attention", fa_ops.chunked_attention)]),
    ("recurrentgemma-2b", {"n_layers": 4, "local_window": 128}, 2, 256,
     [(attention, "flash_attention", fa_ops.chunked_attention),
      (rglru, "rglru_scan", scan_ref.rglru_reference)]),
] + [(arch, {"n_layers": 2}, 2, 64, [(attention, "flash_attention", fa_ops.chunked_attention)])
     for arch in ("yi-9b", "minitron-4b", "qwen2-moe-a2.7b", "qwen3-moe-30b-a3b",
                  "minicpm3-4b")] + [
    ("rwkv6-7b", {"n_layers": 2}, 2, 200, [(rwkv6, "rwkv6_wkv", wkv_ref.rwkv6_reference)]),
] + [(arch, {"n_layers": 2}, 2, 64, [(attention, "flash_attention", fa_ops.chunked_attention)])
     for arch in ("hubert-xlarge", "pixtral-12b")]
# The dtypes a train slice runs in, each with its tolerance, where a model
# runs in fewer than SLICE_DTYPES: none.  minitron-4b, rwkv6-7b and
# minicpm3-4b run in f32 too since the f32 master hold takes their
# zero-initialised leaves apart (zero_init_leaves, hold_master_leaf).
TRAIN_SLICE_DTYPES = {}
TRAIN_CE_CHUNK = 512
# adamw_update's eps, which make_train_step leaves at its default.
ADAM_EPS = inspect.signature(adamw_update).parameters["eps"].default


def read_train_launches() -> dict:
    """The launches of each kernel, the flash kernels' by route and with lse,
    the scan backward's by route, and both WKV kernels' by route."""
    return {**read_launches(), "flash_attention_fwd by route": read_flash_routes(),
            "flash_attention_fwd with lse": fa_kernel.flash_attention_fwd.lse_launches,
            "flash_attention_bwd by route": read_bwd_routes(),
            "rglru_scan_bwd by route": read_scan_bwd_routes(),
            "rwkv6_wkv_fwd by route": read_wkv_routes(),
            "rwkv6_wkv_bwd by route": read_wkv_bwd_routes()}


def attn_head_dims(cfg):
    """(Dk, Dv) of the flash calls of cfg's attention layers: MLA's nope +
    rope and v dims, else the head dim twice."""
    if cfg.attn_kind == "mla":
        return cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim, cfg.mla.v_head_dim
    return cfg.head_dim, cfg.head_dim


def want_train_launches(cfg, dtype, seq=None):
    """read_train_launches() of a train step (or a gradient) of cfg in dtype
    over sequences of ``seq`` tokens, remat "full": a uniform stack's
    kernels by its layer kind (STACK_KERNELS), each flash kernel's launches
    all on the route of its head dims (attn_head_dims: (96, 64) for MLA,
    the tensor cores in bf16 and the SIMT route in f32), every forward
    launch writing the lse
    (its inputs require grad), every scan backward on the TMA route (the
    model's a, h and dh are whole allocations, and a row of the model's
    width fills 16-byte lines in either dtype), every WKV forward on the route
    wkv_kernel.route() names for the forward of a gradient over ``seq``
    steps (chunk_exact in bf16, recurrent in f32) and every WKV backward on
    the route wkv_kernel.bwd_route() names there (chunk in bf16, recurrent
    in f32)."""
    if cfg.uniform_blocks:
        want = train_launches(cfg.n_layers, kernels=STACK_KERNELS[cfg.layer_kinds()[0]])
    else:
        want = hybrid_train_launches(cfg)
    by_route = {}
    for name, backward in (("flash_attention_fwd", False), ("flash_attention_bwd", True)):
        route = fa_kernel.route(dtype, *attn_head_dims(cfg), backward=backward)
        by_route[f"{name} by route"] = {r: want[name] * (r == route) for r in fa_kernel.ROUTES}
    by_route["rglru_scan_bwd by route"] = {r: want["rglru_scan_bwd"] * (r == "tma")
                                           for r in scan_kernel.BWD_ROUTES}
    n_wkv = want["rwkv6_wkv_fwd"]
    by_route["rwkv6_wkv_fwd by route"] = (wkv_routes(cfg, dtype, seq, n_wkv, 0, grad=True)
                                          if n_wkv else dict.fromkeys(wkv_kernel.ROUTES, 0))
    bwd = wkv_kernel.bwd_route(dtype, cfg.rwkv_head_dim, seq) if seq else "recurrent"
    by_route["rwkv6_wkv_bwd by route"] = {r: want["rwkv6_wkv_bwd"] * (r == bwd)
                                          for r in wkv_kernel.BWD_ROUTES}
    return {**want, **by_route, "flash_attention_fwd with lse": want["flash_attention_fwd"]}


def no_train_launches():
    """read_train_launches() after a run that launched nothing."""
    return {**dict.fromkeys(KERNELS, 0),
            "flash_attention_fwd by route": dict.fromkeys(fa_kernel.ROUTES, 0),
            "flash_attention_fwd with lse": 0,
            "flash_attention_bwd by route": dict.fromkeys(fa_kernel.ROUTES, 0),
            "rglru_scan_bwd by route": dict.fromkeys(scan_kernel.BWD_ROUTES, 0),
            "rwkv6_wkv_fwd by route": dict.fromkeys(wkv_kernel.ROUTES, 0),
            "rwkv6_wkv_bwd by route": dict.fromkeys(wkv_kernel.BWD_ROUTES, 0)}


def to_host(tree):
    """The tree (dicts, lists, tuples) with each tensor copied to the host."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def _train_slice_run(cfg, params, batch):
    """One path of the train slice: the gradients of loss_fn, then one
    make_train_step step from a fresh state, with each part's launches, and
    what the step's AdamW update took (first_step_seen).  Of the state after
    the step it returns the names and the master, all on the host: the
    checks read nothing else, and a path of minitron-4b's slice (1.75e9
    parameters, its f32 master, mu and nu 21 GB) kept on the card beside
    the other path's run would leave too little room for AdamW's temporaries."""
    weights = leaves(params)
    for w in weights:
        w.requires_grad_(True)
    reset_launches()
    loss, _ = lm.loss_fn(params, cfg, batch, remat="full", ce_chunk=TRAIN_CE_CHUNK)
    # embed, under a batch of embeddings, takes a zero gradient, as in the step
    grads = torch.autograd.grad(loss, weights, allow_unused=True, materialize_grads=True)
    grad_launches = read_train_launches()
    step = make_train_step(cfg, remat="full", ce_chunk=TRAIN_CE_CHUNK)
    seen = {}
    reset_launches()
    with mock.patch.object(train_steps, "adamw_update", first_step_seen(seen)):
        state, metrics = step(init_train_state(params), batch)
    launches = read_train_launches()
    state = {"names": paths(state["params"]), "master": state["master"]}
    return to_host((grads, grad_launches, metrics, state, launches, seen))


def twice_equal(label, first, second):
    """Log whether two kernel-path runs of a train slice from the same state
    (_train_slice_run's results) gave the same gradients and masters to the
    bit, and which leaves differ where they do not."""
    names = first[3]["names"]
    differ = [n for n, a, b in zip(names, first[0], second[0]) if not torch.equal(a, b)]
    differ += [f"master {n}" for n, a, b in zip(names, leaves(first[3]["master"]),
                                                leaves(second[3]["master"]))
               if not torch.equal(a, b)]
    log(f"[train-slice] {label}: two kernel-path runs from the same state, gradients and "
        f"masters after the step equal to the bit: {not differ}"
        + (f"; leaves that differ: {differ}" if differ else ""))


def first_step_seen(seen):
    """adamw_update, keeping in ``seen`` what its step's direction is made
    of: the gradients, the step's lr and the clip factor, as it forms them."""
    def update(state, grads, *, lr, clip, **kw):
        state, aux = adamw_update(state, grads, lr=lr, clip=clip, **kw)
        seen.update(grads=leaves(grads), lr=lr(state["step"]).item(),
                    scale=torch.clamp(clip / torch.clamp(aux["grad_norm"], min=1e-12), max=1.0))
        return state, aux
    return update


def first_step_excess(a, b, seen_k, seen_p, leaf, chunk=1 << 24):
    """The two paths' masters a and b of one leaf after the first AdamW step
    from the same master m0, against the difference their own gradients
    make.  A path's step is m0 - lr_1 (u + weight_decay m0) with u = x /
    (|x| + eps), x its clipped gradient, so a - b = lr_1 (u_p - u_k) to
    within f32 rounding: 1e-5 of each step for the moments' roundings and
    bias corrections, an ulp of each master, and f32's least normal for
    results under it.  Holds every element, however near eps its x.
    Returns (the elements beyond that, the largest error over its slack,
    held <= 1); by chunks of ``chunk`` elements, so a vocab-sized leaf needs
    no full-size temporaries."""
    lr = seen_k["lr"]
    if seen_p["lr"] != lr:
        raise AssertionError(f"the paths' first steps take lr {lr} and {seen_p['lr']}")
    over, worst = 0, 0.0
    for ak, bp, gk, gp in zip(*(t.reshape(-1).split(chunk) for t in (
            a, b, seen_k["grads"][leaf], seen_p["grads"][leaf]))):
        gk, gp = gk.to(ak.device), gp.to(ak.device)  # the seen gradients may be on the host
        xk = gk.float() * seen_k["scale"].to(ak.device)
        xp = gp.float() * seen_p["scale"].to(ak.device)
        uk, up = xk / (xk.abs() + ADAM_EPS), xp / (xp.abs() + ADAM_EPS)
        slack = (lr * 1e-5 * (uk.abs() + up.abs()) + 2.0**-23 * (ak.abs() + bp.abs())
                 + torch.finfo(torch.float32).tiny)
        ratio = ((ak - bp) - lr * (up - uk)).abs() / slack
        over += int((ratio > 1).sum())
        worst = max(worst, ratio.max().item())
    return over, worst


def sign_flips(gk, gp, tol):
    """The elements of a bf16 gradient leaf that change sign between the
    paths, and the largest one's |g| over the leaf's largest.  Raises where
    one's |g| is above tol of the leaf's largest."""
    top = gp.float().abs().max()
    flips = gp.float().abs()[torch.sign(gk.float()) != torch.sign(gp.float())]
    if (flips > tol * top).any():
        raise AssertionError(f"a gradient changes sign between the paths at |g| "
                             f"{flips.max().item()}, more than {tol} of the leaf's largest "
                             f"{top.item()}")
    return flips.numel(), (flips.max() / top).item() if flips.numel() else 0.0


def zero_init_leaves(cfg) -> set:
    """The paths of cfg's parameter leaves whose schema initializer is
    "zeros" (``Param.init``): after the first AdamW step such a master leaf
    is lr_1 x / (|x| + eps) alone (weight decay of zero is zero)."""
    schema = model_schema(cfg)
    return {p for p, leaf in zip(paths(schema), leaves(schema)) if leaf.init == "zeros"}


def hold_master_leaf(a, b, gk, gp, seen_k, seen_p, leaf, dtype, tol, zero_init):
    """Hold one master leaf of the train slice after the first step, the
    kernel path's a against the plain path's b (gk, gp: the leaf's
    gradients on each path, moved to a's device for sign_flips): finite,
    every element by first_step_excess; in f32 at tol on ||a - b|| / ||b||,
    but a leaf that starts at zero (``zero_init``) and every bf16 leaf by
    sign_flips at tol instead.  Returns (first_step_excess's largest error
    over its slack, sign_flips' (count, largest ratio) or None where the
    leaf was held at tol, the rel_err in f32 or None in bf16); raises
    AssertionError where a hold fails."""
    if not torch.isfinite(a).all():
        raise AssertionError("not finite")
    over, worst = first_step_excess(a, b, seen_k, seen_p, leaf)
    if over:
        raise AssertionError(f"{over} elements differ from what the two paths' first steps "
                             f"make by more than f32 rounding (up to {worst:.3e} times it)")
    rel = rel_err(a, b) if dtype == torch.float32 else None
    if rel is not None and not zero_init:
        if rel > tol:
            raise AssertionError(f"rel_err {rel}")
        return worst, None, rel
    return worst, sign_flips(gk.to(a.device), gp.to(a.device), tol), rel


def phase_train_slice():
    """Each of TRAIN_SLICES at full width and a few layers (qwen3-1.7b at 2
    layers, 2 x 64 tokens; recurrentgemma-2b at 4, 2 x 256 tokens): the
    kernel path against the plain path (the slice's entry points swapped for
    their plain versions, which torch differentiates), in f32 and bf16.
    Tolerance on ||a - b|| / ||b||: 1e-4 in f32 (the kernels and the plain
    versions differ in the order of f32 sums), 2e-2 in bf16 (one bf16
    rounding of each kernel output, carried through the layers).  Held so:
    the loss, every gradient leaf, and after one make_train_step step the
    loss and grad_norm.  Every element of every master leaf after the step,
    in both dtypes, is held to the difference that the two paths' own
    gradients make through the first AdamW step (first_step_excess: a - b =
    lr_1 (u_p - u_k), u = x / (|x| + eps), to within f32 rounding), and in
    f32 every master leaf that does not start at zero also at tol.  In bf16
    a tolerance on the master leaf would not follow from the gradients' one:
    the first step moves an element by lr_1 x / (|x| + eps), about lr_1
    sign(x), so an element whose gradient changes sign between the paths
    moves the other way, and one whose x is near eps carries its own
    relative error, which the leaf's norm does not bound (a leaf that starts
    at zero is its step alone; one such element in 2560 moves
    recurrentgemma's gate bias by 2 %).  So in bf16 the gradients' sign
    flips are counted and logged, and each must have |g| within tol of the
    leaf's largest (sign_flips).  In f32 a zero-initialised master leaf
    (zero_init_leaves, from the schema) is held so too, by sign_flips at the
    f32 tol, and its rel_err is logged unheld: the f32 hold on such a leaf
    failed minitron-4b's ln2 at 1.62e-4 with every gradient within 1.2e-6
    (ROADMAP C4).  The f32 gradients must differ somewhere
    (they come from two computations). Launches exact on each path: the
    kernel path want_train_launches(cfg, dtype) in each part (qwen3: 5
    forward, each writing the lse, and 2 backward, all on the dtype's route:
    SIMT in f32, tensor cores in bf16; recurrentgemma: 2 forward and 1
    backward, on the dtype's route, 6 scan forward and 3 scan backward;
    rwkv6-7b: 5 WKV forward and 2 WKV backward, on chunk_exact and chunk in
    bf16 and on the recurrent routes in f32), the plain path none.  An MoE model's plain path takes
    the kernel path's expert choice call by call (RouterReplay, as
    phase_slice): the router runs in every forward of a layer, the step's
    and each remat recomputation's, as flash does, so each path makes 2
    want_train_launches(...)["flash_attention_fwd"] router calls (the
    gradient's and the step's); the counts must agree.  In bf16 its kernel
    path runs twice from the same state, and whether the two runs'
    gradients and masters agree to the bit is logged (twice_equal: the MoE
    backward adds through index_put with accumulate).
    """
    none = no_train_launches()
    for arch, cut, batch_size, seq, patches in TRAIN_SLICES:
        cfg = dataclasses.replace(get_config(arch), **cut)
        g = torch.Generator("cuda").manual_seed(4)
        toks = torch.randint(0, cfg.vocab, (batch_size, seq + 1), generator=g, device="cuda")
        what_cut = ", ".join(f"{k} {v}" for k, v in cut.items())
        for dtype, tol in TRAIN_SLICE_DTYPES.get(arch, SLICE_DTYPES):
            label = (f"{arch} full width, {what_cut}, {batch_size}x{seq} {prompt_kind(cfg)}, "
                     f"{dtype_name(dtype)}")
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]} if not cfg.frontend else {
                "embeds": pseudo_embeds(batch_size, seq, cfg.d_model, seed=4, step=0,
                                        dtype=dtype, device="cuda"), "labels": toks[:, 1:]}
            t0 = time.perf_counter()
            want = want_train_launches(cfg, dtype, seq)

            def params():
                return lm.init_params(cfg, torch.Generator("cuda").manual_seed(0), dtype, "cuda")
            replay = RouterReplay() if cfg.moe is not None else None
            with contextlib.ExitStack() as stack:
                if replay:
                    stack.enter_context(mock.patch.object(moe, "_router", replay.record))
                kernel = _train_slice_run(cfg, params(), batch)
            if replay and dtype == torch.bfloat16:
                twice_equal(label, kernel, _train_slice_run(cfg, params(), batch))
            with contextlib.ExitStack() as stack:
                for module, attr, plain in patches:
                    stack.enter_context(mock.patch.object(module, attr, plain))
                if replay:
                    stack.enter_context(mock.patch.object(moe, "_router", replay.replay))
                plain = _train_slice_run(cfg, params(), batch)
            if replay:
                calls = 2 * want["flash_attention_fwd"]
                if (len(replay.calls), replay.replayed) != (calls, calls):
                    raise AssertionError(f"train slice {label}: the kernel path called the router "
                                         f"{len(replay.calls)} times and the plain path "
                                         f"{replay.replayed}, expected {calls} each")
                log(f"[train-slice] {label}: the plain path replayed the kernel path's expert "
                    f"choice in {replay.replayed} router calls, call by call (the gradient's and "
                    "the step's forwards and remat recomputations); its own choice differs at "
                    f"{sum(replay.differ)} (token, layer) pairs (by call {replay.differ}), each a "
                    f"near-tie (the largest gap over its bound {replay.worst:.3e}, held <= 1)")
            log(f"[train-slice] {label}: launches {kernel[1]} in the gradient and {kernel[4]} in "
                f"the step on the kernel path (expected {want} each), {plain[1]} and {plain[4]} "
                "on the plain path (expected all 0)")
            if (kernel[1], kernel[4], plain[1], plain[4]) != (want, want, none, none):
                raise AssertionError(f"train slice {label}: launches {kernel[1]}, {kernel[4]}, "
                                     f"{plain[1]}, {plain[4]}")
            differ = 0
            for path, a, b in zip(kernel[3]["names"], kernel[0], plain[0]):
                a, b = a.cuda(), b.cuda()
                rel = rel_err(a, b)
                differ += int(not torch.equal(a, b))
                log(f"[train-slice] {label}, gradient {path}: rel_err {rel:.3e} (tol {tol})")
                if not torch.isfinite(a.float()).all() or rel > tol:
                    raise AssertionError(f"train slice {label}: gradient {path} rel_err {rel}")
            if dtype == torch.float32 and differ == 0:
                raise AssertionError(f"train slice {label}: the f32 gradients of the two paths "
                                     "agree bit for bit")
            for what in ("loss", "grad_norm"):
                a, b = kernel[2][what], plain[2][what]
                rel = rel_err(a, b)
                log(f"[train-slice] {label}, step {what}: {a.item():.6f} against {b.item():.6f}, "
                    f"rel_err {rel:.3e} (tol {tol})")
                if not torch.isfinite(a) or rel > tol:
                    raise AssertionError(f"train slice {label}: {what} rel_err {rel}")
            flipped, largest, zero_held = {}, 0.0, {}
            zeros = zero_init_leaves(cfg)
            for i, (path, a, b) in enumerate(zip(paths(kernel[3]["master"]),
                                                 leaves(kernel[3]["master"]),
                                                 leaves(plain[3]["master"]))):
                try:
                    worst, flips, rel = hold_master_leaf(
                        a.cuda(), b.cuda(), kernel[0][i], plain[0][i], kernel[5], plain[5], i,
                        dtype, tol, path in zeros)
                except AssertionError as err:
                    raise AssertionError(f"train slice {label}: master {path}: {err}") from None
                largest = max(largest, worst)
                if dtype == torch.float32 and flips is not None:
                    zero_held[path] = (flips[0], round(flips[1], 6), f"{rel:.3e}")
                elif flips and flips[0]:
                    flipped[path] = (flips[0], round(flips[1], 6))
            log(f"[train-slice] {label}: {differ} of {len(kernel[0])} gradient leaves differ "
                "between the paths; every element of every master leaf after the step within "
                f"f32 rounding of the two first steps' difference (largest error over its "
                f"slack {largest:.3e}, held <= 1)"
                + (f", and every master leaf that does not start at zero within {tol}; the "
                   "zero-initialised leaves held by first_step_excess and sign_flips at "
                   f"{tol} instead (sign flips, largest |g| over the leaf's largest, master "
                   f"rel_err unheld): {zero_held or 'none'}" if dtype == torch.float32 else
                   f"; gradient sign flips (count, largest |g| over the leaf's largest): "
                   f"{flipped or 'none'}") + f"; {time.perf_counter() - t0:.1f} s")
            del kernel, plain
            torch.cuda.empty_cache()


# Each main train path at full width: batch x tokens a step.  qwen3-1.7b
# takes 8 x 1024; recurrentgemma-2b, minitron-4b and yi-9b the reference's
# train_4k sequence of 4096 tokens with its global batch of 256 cut to 2 for
# one card, and rwkv6-7b, the MoE models and minicpm3-4b likewise.
# TRAIN_CUTS: the layers a model trains at where its full depth does not
# fit one card (at 16 bytes a parameter, bf16 weight and gradient and f32
# master, mu and nu, minitron-4b's 4.39e9 parameters take 70 GB before the
# CE head's f32 copy and activations; yi-9b's 8.83e9, 141 GB; rwkv6-7b's
# 7.58e9, 121 GB; qwen2-moe-a2.7b's 15.1e9, 242 GB, and qwen3-moe-30b-a3b's
# 30.5e9, 489 GB, about 10 GB a layer beside 10 GB of embedding and head;
# minicpm3-4b's 4.40e9, 70 GB, 1.04 GB a layer).  A depth probe of single
# steps found the MoE models at 4 layers (5 ran out of memory in AdamW,
# whose f32 temporaries of a leaf scale with the stacked experts: 3.44 GiB
# a temporary at 5 layers) and minicpm3-4b at 50 (54 ran out of memory).
# hubert-xlarge's 0.945e9 parameters take 15 GB: it trains at full depth.
# pixtral-12b's 12.25e9, 196 GB, 4.36 GB a layer beside 21.5 GB of embed and
# lm_head (its embed leaf, never read, still takes AdamW's f32 state and
# temporaries): a depth probe (--depth-probe pixtral-12b 6 7 8 9 10 11 12)
# ran one step at 10 layers with a peak of 79.93 GB and 11 ran out of
# memory, but at 10 layers in the whole run, after the other phases, the
# warm-up step ran out of memory in AdamW (4.58 GiB reserved and free in
# pieces); at 9 the probe's peak was 74.10 GB.
TRAIN_SHAPES = {"qwen3-1.7b": (8, 1024), "recurrentgemma-2b": (2, 4096),
                "minitron-4b": (2, 4096), "yi-9b": (2, 4096), "rwkv6-7b": (2, 4096),
                "qwen2-moe-a2.7b": (2, 4096), "qwen3-moe-30b-a3b": (2, 4096),
                "minicpm3-4b": (2, 4096), "hubert-xlarge": (2, 4096), "pixtral-12b": (2, 4096)}
TRAIN_CUTS = {"minitron-4b": {"n_layers": 26}, "yi-9b": {"n_layers": 16},
              "rwkv6-7b": {"n_layers": 14}, "qwen2-moe-a2.7b": {"n_layers": 4},
              "qwen3-moe-30b-a3b": {"n_layers": 4}, "minicpm3-4b": {"n_layers": 50},
              "pixtral-12b": {"n_layers": 9}}
TRAIN_STEPS = 3


def train_batch(data, step, batch_size, cfg):
    """A step's batch from the port's SyntheticLMDataset: its tokens and
    labels, or for a frontend stub pseudo-embeddings drawn from (0, step)
    with the labels, as the train driver makes them at --seed 0."""
    batch = {k: torch.from_numpy(v).long().to("cuda")
             for k, v in data.batch(step, batch_size).items()}
    if not cfg.frontend:
        return batch
    return {"embeds": pseudo_embeds(batch_size, data.seq_len, cfg.d_model, seed=0, step=step,
                                    dtype=torch.bfloat16, device="cuda"),
            "labels": batch["labels"]}


def phase_train(arch):
    """A main train path: arch at full width, all its layers (or those of
    TRAIN_CUTS[arch]), bf16, AdamW with f32 master, mu and nu, batches of
    TRAIN_SHAPES[arch] from the port's SyntheticLMDataset, remat "full",
    ce_chunk 512; one warm-up step, then TRAIN_STEPS timed steps (host clock
    after a sync; the batch is made before the clock starts), the launch
    counters set to 0 before each and read after it (want_train_launches:
    qwen3-1.7b 77 forward, all wgmma and each writing the lse, and 28
    backward, all wgmma; recurrentgemma-2b 16 forward, all wgmma and each
    writing the lse, 8 backward, all wgmma, 36 scan forward and 18 scan
    backward; minitron-4b at 26 layers 65 forward and 26 backward, yi-9b at
    16 layers 46 and 16, as qwen3's; rwkv6-7b at 14 layers, in remat groups
    of 2, 35 WKV forward, all on the chunk_exact route, and 14 WKV backward,
    all on the chunk route; the MoE models and minicpm3-4b at their cut
    depths likewise, minicpm3-4b's flash launches all wgmma at (96, 64);
    hubert-xlarge at 48 layers 138 forward and 48 backward, all wgmma at
    (80, 80), and pixtral-12b at 9 layers (remat groups of 1) 18 and 9,
    all wgmma, both on
    pseudo-embeddings); then one more step under the profiler."""
    cfg = dataclasses.replace(get_config(arch), **TRAIN_CUTS.get(arch, {}))
    batch_size, seq = TRAIN_SHAPES[arch]
    params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(0), torch.bfloat16, "cuda")
    n_params = numel(params)
    state = init_train_state(params)
    data = SyntheticLMDataset(cfg.vocab, seq, seed=0)
    step_fn = make_train_step(cfg, remat="full", ce_chunk=TRAIN_CE_CHUNK)
    state, metrics = step_fn(state, train_batch(data, 0, batch_size, cfg))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = want_train_launches(cfg, torch.bfloat16, seq)
    times, launches, losses = [], [], []
    for i in range(1, 1 + TRAIN_STEPS):
        batch = train_batch(data, i, batch_size, cfg)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = metrics["loss"].item()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches.append(read_train_launches())
        losses.append(loss)
        log(f"[train] {cfg.name} step {i + 1}: {times[-1] * 1e3:.3f} ms, loss {loss:.4f}, "
            f"grad_norm {metrics['grad_norm'].item():.4f}, tokens {int(metrics['tokens'])}, "
            f"launches {launches[-1]}")
        if not (math.isfinite(loss) and torch.isfinite(metrics["grad_norm"])):
            raise AssertionError(f"train {arch}: non-finite loss or grad_norm at step {i + 1}")
        if int(metrics["tokens"]) != batch_size * seq:
            raise AssertionError(f"train {arch}: {int(metrics['tokens'])} tokens in step {i + 1}")
        if launches[-1] != want:
            raise AssertionError(f"train {arch}: launches {launches[-1]} in step {i + 1}, "
                                 f"expected {want}")
    peak = torch.cuda.max_memory_allocated()
    if int(state["step"]) != 1 + TRAIN_STEPS:
        raise AssertionError(f"train {arch}: state step {int(state['step'])}, expected "
                             f"{1 + TRAIN_STEPS}")
    bad = [p for p, t in zip(paths(state["params"]), leaves(state["params"]))
           if not torch.isfinite(t).all()]
    if bad:
        raise AssertionError(f"train {arch}: non-finite parameters {bad}")
    step_s = statistics.median(times)
    tokens = batch_size * seq
    flops = useful_flops(cfg, ShapeConfig("train", seq, batch_size, "train"))
    log(f"[train] {cfg.name}: {n_params} params bf16, {cfg.n_layers} of "
        f"{get_config(arch).n_layers} layers, batch "
        f"{batch_size} x {seq} {prompt_kind(cfg)}, remat full, ce_chunk {TRAIN_CE_CHUNK}: step "
        f"{step_s * 1e3:.3f} ms (median of {TRAIN_STEPS}; {[round(t * 1e3, 3) for t in times]}), "
        f"{tokens / step_s:.1f} tokens/s, useful_flops {flops:.4e} = model-FLOP share "
        f"{flops / step_s / PEAK_BF16_FLOPS:.4f} of {PEAK_BF16_FLOPS:.0e}; "
        f"max_memory_allocated {peak} bytes, {memory_left(peak)}; losses {losses}")
    batch = train_batch(data, 1 + TRAIN_STEPS, batch_size, cfg)
    profile_call(f"{cfg.name} train step", lambda: step_fn(state, batch))
    del state, params
    return dict(step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
                model_flop_share=flops / step_s / PEAK_BF16_FLOPS, peak_bytes=peak,
                n_layers=cfg.n_layers, launches=launches)


# The sharded phase: the sharding slice's train step on a one-rank mesh and
# the dry-run on a "cuda" mesh.  SHARDED_ARCH trains at TRAIN_SHAPES' batch
# (8 x 1024) at full depth; the dry-run prices that cell on the (1, 1) host
# mesh and SHARDED_CELLS on the production meshes, reaching the kernels'
# custom ops (their fake implementations) and no kernel.
SHARDED_ARCH = "qwen3-1.7b"
SHARDED_CELLS = (("qwen3-1.7b", "train_4k", "pod16x16"),
                 ("qwen3-moe-30b-a3b", "decode_32k", "pod16x16"),
                 ("rwkv6-7b", "prefill_32k", "pod2x16x16"))
SHARDED_TOL = SLICE_DTYPES[1][1]  # the train slice's bf16 tolerance on ||a - b|| / ||b||, 2e-2


def _sharded_state(params, cfg, mesh, rules):
    """The train state of ``params`` as DTensors: the params on their specs,
    f32 master, mu and nu on ZeRO-1's (train_state_specs)."""
    pspecs = lm.param_specs(cfg, rules)
    sspecs = train_state_specs(pspecs, lm.abstract_params(cfg), mesh, rules)

    def on(tree, specs):
        return unflatten(tree, [
            distribute_tensor(t, mesh, placements_for(s, mesh, t.ndim), src_data_rank=None)
            for t, s in zip(leaves(tree), leaves(specs, is_spec), strict=True)])
    state = {"params": on(params, pspecs),
             "master": on(unflatten(params, [t.float() for t in leaves(params)]),
                          sspecs["master"]),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    for k in ("mu", "nu"):
        state[k] = on(unflatten(params, [torch.zeros(t.shape, dtype=torch.float32,
                                                     device="cuda") for t in leaves(params)]),
                      sspecs[k])
    return state


def phase_sharded():
    """The sharding slice on the card.

    (a) One SHARDED_ARCH train step at full width and depth, 8 x 1024 tokens,
    bf16, on make_host_mesh() over a real one-rank NCCL group (a file://
    store in a temporary directory; nothing goes over a network), DTensor
    params and ZeRO-1 state under use_mesh_rules, against the unsharded step
    of the same weights and batch, held as phase_train_slice holds its bf16
    paths: the loss, the grad_norm and every gradient leaf at ||a - b|| /
    ||b|| <= SHARDED_TOL, each gradient's sign flips within SHARDED_TOL of
    its leaf's largest (sign_flips), and every element of every master leaf
    within f32 rounding of the difference the two steps' own gradients make
    through the first AdamW step (first_step_excess); every master leaf must
    have moved from its initial value.  Launches exactly those of
    phase_train's step (77 flash forward, all wgmma and each writing the
    lse, and 28 backward, all wgmma).  FlopCounterMode reads the unsharded
    step's FLOPs.
    (b) The dry-run on a "cuda" mesh: the (1, 1) host mesh of the same cell,
    then SHARDED_CELLS, each with status ok.
    (c) The (1, 1) cell's per-device FLOPs equal (a)'s FlopCounterMode count;
    its predicted peak bytes beside (a)'s, their ratio logged, not gated.
    Returns the numbers the run logs."""
    cfg = get_config(SHARDED_ARCH)
    batch_size, seq = TRAIN_SHAPES[SHARDED_ARCH]
    data = SyntheticLMDataset(cfg.vocab, seq, seed=0)
    batch = train_batch(data, 0, batch_size, cfg)
    params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(0), torch.bfloat16, "cuda")
    want = want_train_launches(cfg, torch.bfloat16, seq)

    # the unsharded step, counted by FlopCounterMode
    seen = {}
    state = init_train_state(unflatten(params, [t.clone() for t in leaves(params)]))
    with mock.patch.object(train_steps, "adamw_update", first_step_seen(seen)), \
            FlopCounterMode(display=False) as counter:
        state, metrics = make_train_step(cfg, remat="full", ce_chunk=TRAIN_CE_CHUNK)(state, batch)
    torch.cuda.synchronize()
    flops_real = counter.get_total_flops()
    plain = {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"], "grads": seen["grads"],
             "master": leaves(state["master"])}
    del state, metrics
    torch.cuda.empty_cache()

    # the sharded step, on a one-rank mesh
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1)
        try:
            mesh = make_host_mesh()
            rules = make_rules(cfg, mesh, global_batch=batch_size)
            specs = batch_specs(cfg, ShapeConfig("sharded", seq, batch_size, "train"), rules)
            dbatch = {k: distribute_tensor(v, mesh, placements_for(specs[k], mesh, v.ndim),
                                           src_data_rank=None) for k, v in batch.items()}
            state = _sharded_state(unflatten(params, [t.clone() for t in leaves(params)]),
                                   cfg, mesh, rules)
            args_bytes = sum(t.to_local().nbytes for k in ("params", "master", "mu", "nu")
                             for t in leaves(state[k]))
            seen_s = {}
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            with use_mesh_rules(mesh, rules), \
                    mock.patch.object(train_steps, "adamw_update", first_step_seen(seen_s)):
                state, metrics = make_train_step(cfg, remat="full",
                                                 ce_chunk=TRAIN_CE_CHUNK)(state, dbatch)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            launches = read_train_launches()
            step_peak = torch.cuda.max_memory_allocated() - before + args_bytes
            if launches != want:
                raise AssertionError(f"sharded: launches {launches}, expected {want}")
            local = lambda t: t.to_local() if isinstance(t, DTensor) else t  # noqa: E731
            seen_s = {"grads": [local(g) for g in seen_s["grads"]], "lr": seen_s["lr"],
                      "scale": local(seen_s["scale"])}
            worst = {"loss": rel_err(local(metrics["loss"]), plain["loss"]),
                     "grad_norm": rel_err(local(metrics["grad_norm"]), plain["grad_norm"])}
            for what in ("loss", "grad_norm"):
                if not worst[what] <= SHARDED_TOL:
                    raise AssertionError(f"sharded: {what} rel_err {worst[what]} against the "
                                         f"unsharded step's (tolerance {SHARDED_TOL})")
            flipped, worst["grad"], worst["master_excess"] = {}, 0.0, 0.0
            for i, (name, m, m0) in enumerate(zip(paths(state["params"]),
                                                  leaves(state["master"]), leaves(params),
                                                  strict=True)):
                g, g_plain = seen_s["grads"][i], plain["grads"][i]
                rel = rel_err(g, g_plain)
                worst["grad"] = max(worst["grad"], rel)
                if not (torch.isfinite(g.float()).all() and rel <= SHARDED_TOL):
                    raise AssertionError(f"sharded: gradient {name} rel_err {rel} against the "
                                         f"unsharded step's (tolerance {SHARDED_TOL})")
                try:
                    n_flips, ratio = sign_flips(g, g_plain, SHARDED_TOL)
                except AssertionError as err:
                    raise AssertionError(f"sharded: gradient {name}: {err}") from None
                if n_flips:
                    flipped[name] = (n_flips, round(ratio, 6))
                m = local(m)
                if not torch.isfinite(m).all():
                    raise AssertionError(f"sharded: master {name} is not finite")
                if torch.equal(m, m0.float()):
                    raise AssertionError(f"sharded: master {name} did not move in the step")
                over, excess = first_step_excess(m, plain["master"][i], seen_s, seen, i)
                worst["master_excess"] = max(worst["master_excess"], excess)
                if over:
                    raise AssertionError(f"sharded: master {name}: {over} elements differ from "
                                         "what the two steps' own gradients make by more than "
                                         f"f32 rounding (up to {excess:.3e} times it)")
            placements = sorted({str(t.placements) for t in leaves(state["master"])})
            del state, metrics, seen_s, dbatch
        finally:
            dist.destroy_process_group()
    del plain, seen, params
    torch.cuda.empty_cache()
    log(f"[sharded] (a) {cfg.name}, {cfg.n_layers} layers, {batch_size} x {seq} tokens, bf16, "
        f"on the (1, 1) host mesh (NCCL, one rank): step {step_s * 1e3:.3f} ms (one step, "
        f"the first on DTensors), launches {launches}; against the unsharded step: loss, "
        f"grad_norm and the largest gradient leaf's rel_err {worst} (tolerance {SHARDED_TOL}; "
        f"master_excess: every master element within f32 rounding of what the two steps' own "
        f"gradients make, the largest error over its slack, held <= 1); every master leaf "
        f"moved; gradient sign flips (count, largest |g| over the leaf's largest): "
        f"{flipped or 'none'}; master placements {placements}; "
        f"the step's peak {step_peak} bytes (max_memory_allocated above what was held "
        f"before it, plus its state's {args_bytes} bytes); FlopCounterMode on the unsharded "
        f"step: {flops_real} FLOP")

    # (b) and (c): the dry-run on a "cuda" mesh
    records = [run_cell(cfg, ShapeConfig("sharded", seq, batch_size, "train"), "host1x1")]
    records += [run_cell(a, s, m) for a, s, m in SHARDED_CELLS]
    for rec in records:
        if rec["status"] != "ok":
            raise AssertionError(f"sharded: dry-run {rec['arch']} x {rec['shape']} x "
                                 f"{rec['mesh']}: {rec['status']}: {rec.get('error')}\n"
                                 f"{rec.get('traceback', '')}")
        r, m, ops = rec["roofline"], rec["memory"], rec["ops"]
        log(f"[sharded] (b) dry-run {rec['arch']} x {rec['shape']} x {rec['mesh']} "
            f"({rec['device']} mesh, {rec['kernels']}): trace {rec['lower_s']} s; per device "
            f"{ops['flops']:.6e} FLOP, {ops['bytes']:.6e} bytes, {ops['collective_bytes']:.6e} "
            f"collective bytes {ops['collective_by_group']}, kernels {ops['kernels']}; memory "
            f"{m}; roofline on the H100 SXM data sheet: compute {r['compute_s']:.6g} s, "
            f"memory {r['memory_s']:.6g} s, collective {r['collective_s']:.6g} s, dominant "
            f"{r['dominant']}, fraction {r['roofline_fraction']:.4f}")
    host = records[0]
    if host["ops"]["flops"] != flops_real:
        raise AssertionError(f"sharded: the (1, 1) dry-run counts {host['ops']['flops']} FLOP "
                             f"a device, FlopCounterMode {flops_real} on the real step")
    predicted = host["memory"]["per_device_bytes"]
    log(f"[sharded] (c) (1, 1) FLOPs: dry-run {host['ops']['flops']:.0f} == FlopCounterMode "
        f"{flops_real}; peak bytes: predicted {predicted}, the real step's {step_peak}, ratio "
        f"{predicted / step_peak:.4f} (not gated)")
    return {"flops": flops_real, "predicted_peak": predicted, "step_peak": step_peak,
            "worst": worst, "cells": [(r["arch"], r["shape"], r["mesh"], r["status"])
                                      for r in records]}


# Per served model, the launches each kernel must show in one serve of
# SERVE_BATCH x SERVE_PROMPT prompts and SERVE_NEW new tokens: qwen3-1.7b runs
# flash attention once a layer in prefill (decode uses decode_attention);
# rwkv6-7b runs the WKV kernel once a layer in prefill and in each of the
# SERVE_NEW - 1 decode steps; recurrentgemma-2b runs flash (window 2048) once
# in each of its 8 attn_local layers and the scan once in each of its 18
# rglru layers, in prefill only (decode is plain, as in the JAX package);
# yi-9b, minitron-4b, qwen2-moe-a2.7b, qwen3-moe-30b-a3b and minicpm3-4b run
# flash once a layer in prefill, as qwen3-1.7b (minicpm3-4b's decode attends
# over its compressed cache in plain PyTorch, as the JAX package does);
# hubert-xlarge encodes (its prefill gives the frame logits; it has no
# decode step) through flash at (80, 80) once a layer, on the tensor cores
# in bf16; pixtral-12b prefills its patch embeddings through flash once a layer
# and decodes tokens, as yi-9b.
SERVE_LAUNCHES = {
    "qwen3-1.7b": {**dict.fromkeys(KERNELS, 0), "flash_attention_fwd": 28},
    "rwkv6-7b": {**dict.fromkeys(KERNELS, 0), "rwkv6_wkv_fwd": 32 * SERVE_NEW},
    "recurrentgemma-2b": {**dict.fromkeys(KERNELS, 0), "flash_attention_fwd": 8,
                          "rglru_scan_fwd": 18},
    "yi-9b": {**dict.fromkeys(KERNELS, 0), "flash_attention_fwd": 48},
    "minitron-4b": {**dict.fromkeys(KERNELS, 0), "flash_attention_fwd": 32},
    "qwen2-moe-a2.7b": {**dict.fromkeys(KERNELS, 0), "flash_attention_fwd": 24},
    "qwen3-moe-30b-a3b": {**dict.fromkeys(KERNELS, 0), "flash_attention_fwd": 48},
    "minicpm3-4b": {**dict.fromkeys(KERNELS, 0), "flash_attention_fwd": 62},
    "hubert-xlarge": {**dict.fromkeys(KERNELS, 0), "flash_attention_fwd": 48},
    "pixtral-12b": {**dict.fromkeys(KERNELS, 0), "flash_attention_fwd": 40},
}
# Each served flash launch on the route of its model's head dims in bf16:
# the tensor cores at 128, 256, minicpm3-4b's (96, 64) and hubert-xlarge's
# (80, 80).
SERVE_FLASH_ROUTES = {
    arch: {r: counts["flash_attention_fwd"] * (
        r == fa_kernel.route(torch.bfloat16, *attn_head_dims(get_config(arch))))
        for r in fa_kernel.ROUTES}
    for arch, counts in SERVE_LAUNCHES.items()}
# rwkv6-7b's WKV launches by route: the 32 prefill launches (bf16, head dim 64,
# 1024 steps) in chunks, the 2016 decode steps (T = 1) recurrent.
SERVE_WKV_ROUTES = {arch: dict.fromkeys(wkv_kernel.ROUTES, 0) for arch in SERVE_LAUNCHES}
SERVE_WKV_ROUTES["rwkv6-7b"] = {"chunk": 32, "chunk_exact": 0,
                               "recurrent": 32 * (SERVE_NEW - 1)}


# minicpm3-4b's serve, whose flash launches take the tensor cores at (96,
# 64), is also held against its plain path at full depth (serve_against_plain).
# In bf16 at 62 layers the plain versions disagree among themselves by
# 2.9e-2 to 3.0e-2 of the prefill logits (chunked_attention at chunks of
# 512 and 256, and the naive attention_reference: rounding's own spread,
# PERF.md §6), more than a bf16 slice's 2e-2, so there each logit's
# difference is held within SERVE_SPREAD_FACTOR of the larger of the two
# plain versions' own in this run; in f32 at the f32 slices' 1e-4.
SERVE_AGAINST_PLAIN = "minicpm3-4b"
SERVE_SPREAD_FACTOR = 1.25


def serve_against_plain(params, cfg, prompts, tokens):
    """The served model's kernel path against its plain path (flash swapped
    for chunked_attention), each on a cache of its own: the prefill logits
    and those of SLICE_DECODE_STEPS decode steps fed the served tokens.
    First on the served bf16 weights: each logit's ||a - b|| / ||b|| within
    SERVE_SPREAD_FACTOR of the larger of two other plain versions' against
    the same plain path (chunked_attention at chunks of 256, and the naive
    attention_reference); then on f32 weights drawn from the same seed,
    each within the f32 slices' tolerance.  The kernel path makes one flash
    launch a layer in prefill, the plain paths none."""
    def run(p, dtype, attn=None):
        cache = lm.init_cache(cfg, prompts.shape[0], prompts.shape[1] + SLICE_DECODE_STEPS,
                              dtype, "cuda")
        with mock.patch.object(attention, "flash_attention", attn or attention.flash_attention):
            reset_launches()
            logits, cache = lm.prefill(p, cfg, cache, tokens=prompts)
            out = [logits]
            for t in range(SLICE_DECODE_STEPS):
                logits, cache = lm.decode_step(p, cfg, cache, tokens[:, t:t + 1])
                out.append(logits)
        n = read_launches()["flash_attention_fwd"]
        if n != (0 if attn else cfg.n_layers):
            raise AssertionError(f"serve {cfg.name} against the plain path: {n} flash launches "
                                 f"on the {'plain' if attn else 'kernel'} path")
        if not all(torch.isfinite(x).all() for x in out):
            raise AssertionError(f"serve {cfg.name} {dtype_name(dtype)}: non-finite logits")
        return out

    def rels(a, b):
        return [rel_err(x, y) for x, y in zip(a, b)]

    def fmt(rs):
        return [float(f"{r:.3e}") for r in rs]
    plain = run(params, torch.bfloat16, fa_ops.chunked_attention)
    kernel = rels(run(params, torch.bfloat16), plain)
    at_256 = rels(run(params, torch.bfloat16, functools.partial(
        fa_ops.chunked_attention, q_chunk=256, k_chunk=256)), plain)
    naive = rels(run(params, torch.bfloat16, fa_ref.attention_reference), plain)
    spread = [max(a, b) for a, b in zip(at_256, naive)]
    log(f"[serve] {cfg.name}, {cfg.n_layers} layers, bf16, against the plain path: prefill and "
        f"{SLICE_DECODE_STEPS} decode steps fed the served tokens, logits rel_err {fmt(kernel)} "
        f"(tol {SERVE_SPREAD_FACTOR} x the plain versions' spread); the plain path at chunks of "
        f"256 against it {fmt(at_256)}, the naive reference {fmt(naive)}")
    if any(k > SERVE_SPREAD_FACTOR * w for k, w in zip(kernel, spread)):
        raise AssertionError(f"serve {cfg.name} bf16 against the plain path: logits rel_err "
                             f"{fmt(kernel)} beyond {SERVE_SPREAD_FACTOR} x the plain "
                             f"versions' own {fmt(spread)}")
    dtype, tol = SLICE_DTYPES[0]
    p = lm.init_params(cfg, torch.Generator("cuda").manual_seed(0), dtype, "cuda")
    held = rels(run(p, dtype), run(p, dtype, fa_ops.chunked_attention))
    log(f"[serve] {cfg.name}, {cfg.n_layers} layers, {dtype_name(dtype)}, against the plain "
        f"path: logits rel_err {fmt(held)} (tol {tol}); flash launches {cfg.n_layers} "
        "in prefill on the kernel path, 0 on the plain paths")
    if max(held) > tol:
        raise AssertionError(f"serve {cfg.name} {dtype_name(dtype)} against the plain path: "
                             f"logits rel_err {max(held)} > {tol}")


def serve_prompt(cfg, length):
    """SERVE_BATCH prompts of ``length``: {"tokens"} drawn from seed 1, or
    for a frontend stub {"embeds"} drawn from (1, 0) in bf16, as the serve
    entry point's CLI draws them."""
    if cfg.frontend:
        return {"embeds": pseudo_embeds(SERVE_BATCH, length, cfg.d_model, seed=1, step=0,
                                        dtype=torch.bfloat16, device="cuda")}
    return {"tokens": torch.randint(0, cfg.vocab, (SERVE_BATCH, length),
                                    generator=torch.Generator("cuda").manual_seed(1),
                                    device="cuda")}


def phase_serve(arch):
    """The main path: serve one model at full width through the entry point
    (an encoder-only model encodes instead, phase_encode).  A prompt is
    tokens, or pixtral-12b's patch embeddings.  An MoE model's prefill must
    give the same logits to the bit in the warm-up and in the timed serve:
    its combine adds in a fixed order.  SERVE_AGAINST_PLAIN is then held
    against its plain path (serve_against_plain)."""
    cfg = get_config(arch)
    params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(0), torch.bfloat16, "cuda")
    n_params = numel(params)
    prompt = serve_prompt(cfg, SERVE_PROMPT[arch])
    if not cfg.has_decoder:
        return phase_encode(arch, cfg, params, n_params, prompt)
    prompts, embeds = prompt.get("tokens"), prompt.get("embeds")
    # warm-up: cuBLAS, allocator
    warm = generate(params, cfg, prompts, 2, cache_dtype=torch.bfloat16, embeds=embeds)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    gen = generate(params, cfg, prompts, SERVE_NEW, cache_dtype=torch.bfloat16, embeds=embeds)
    launches, routes, wkv_routes_ = read_launches(), read_flash_routes(), read_wkv_routes()
    lse_launches = fa_kernel.flash_attention_fwd.lse_launches
    peak = torch.cuda.max_memory_allocated()
    steps = SERVE_NEW - 1
    log(f"[serve] {cfg.name}: {n_params} params bf16, {cfg.n_layers} layers, batch "
        f"{SERVE_BATCH} x {SERVE_PROMPT[arch]} {prompt_kind(cfg)} a prompt, {SERVE_NEW} new "
        "tokens")
    log(f"[serve] {cfg.name}: prefill {gen.prefill_s * 1e3:.3f} ms; decode {steps} steps in "
        f"{gen.decode_s * 1e3:.3f} ms = {gen.decode_s * 1e3 / steps:.3f} ms/step = "
        f"{SERVE_BATCH * steps / gen.decode_s:.1f} tokens/s; launches {launches} "
        f"(expected {SERVE_LAUNCHES[arch]}), flash by route {routes} (expected "
        f"{SERVE_FLASH_ROUTES[arch]}), WKV by route {wkv_routes_} (expected "
        f"{SERVE_WKV_ROUTES[arch]}), {lse_launches} flash launches writing an lse; "
        f"max_memory_allocated {peak} bytes, {memory_left(peak)}")
    sample = gen.tokens[0, :16].tolist()
    log(f"[serve] {cfg.name} sample: {sample}")
    if len(set(sample)) == 1:
        # random weights often settle on one token; the logits' spread tells
        # such a model from one whose logits are flat or broken
        lg = gen.prefill_logits
        top = torch.topk(lg, 2, dim=-1).values
        log(f"[serve] {cfg.name}: the sample repeats one token; prefill logits by row: std "
            f"{[round(x, 3) for x in lg.std(-1).tolist()]}, max - min "
            f"{[round(x, 3) for x in (lg.max(-1).values - lg.min(-1).values).tolist()]}, "
            f"top-1 - top-2 {[round(x, 3) for x in (top[:, 0] - top[:, 1]).tolist()]}; "
            f"first token of each row {gen.tokens[:, 0].tolist()}")
    if gen.tokens.shape != (SERVE_BATCH, SERVE_NEW):
        raise AssertionError(f"serve {arch}: tokens of shape {tuple(gen.tokens.shape)}")
    if not ((gen.tokens >= 0) & (gen.tokens < cfg.padded_vocab)).all():
        raise AssertionError(f"serve {arch}: token ids out of the vocabulary")
    if not torch.isfinite(gen.prefill_logits).all():
        raise AssertionError(f"serve {arch}: non-finite prefill logits")
    if launches != SERVE_LAUNCHES[arch]:
        raise AssertionError(f"serve {arch}: kernel launches {launches}, "
                             f"expected {SERVE_LAUNCHES[arch]}")
    if routes != SERVE_FLASH_ROUTES[arch]:
        raise AssertionError(f"serve {arch}: flash launches by route {routes}, "
                             f"expected {SERVE_FLASH_ROUTES[arch]}")
    if wkv_routes_ != SERVE_WKV_ROUTES[arch]:
        raise AssertionError(f"serve {arch}: WKV launches by route {wkv_routes_}, "
                             f"expected {SERVE_WKV_ROUTES[arch]}")
    if lse_launches:
        raise AssertionError(f"serve {arch}: {lse_launches} flash launches wrote an lse")
    if cfg.moe is not None:
        if not torch.equal(warm.prefill_logits, gen.prefill_logits):
            raise AssertionError(f"serve {arch}: two bf16 prefills of the same prompts gave "
                                 "logits that differ")
        log(f"[serve] {cfg.name}: two bf16 prefills of the same prompts (the warm-up's and "
            "the timed serve's) gave the same logits to the bit")
    if arch == SERVE_AGAINST_PLAIN:
        serve_against_plain(params, cfg, prompts, gen.tokens)
    return params, cfg, prompt, launches, routes, wkv_routes_


def phase_encode(arch, cfg, params, n_params, prompt):
    """An encoder-only model's main path: serve.encode over SERVE_BATCH x
    SERVE_PROMPT[arch] frame embeddings (its prefill: a train-mode forward
    and the f32 frame logits, then their argmax), once to warm up, then
    timed, the launch counters set to 0 just before it: flash once a layer,
    on the route of its head dims in bf16 (the tensor cores at (80, 80)), no
    lse, no decode step.  Whether the warm-up's logits equal the timed encode's to
    the bit is logged."""
    embeds = prompt["embeds"]
    warm = encode(params, cfg, embeds)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    enc = encode(params, cfg, embeds)
    launches, routes, wkv_routes_ = read_launches(), read_flash_routes(), read_wkv_routes()
    lse_launches = fa_kernel.flash_attention_fwd.lse_launches
    peak = torch.cuda.max_memory_allocated()
    B, S = embeds.shape[:2]
    log(f"[serve] {cfg.name}: {n_params} params bf16, {cfg.n_layers} layers, batch {B} x {S} "
        f"{prompt_kind(cfg)} a sequence, encoder-only: no decode step")
    log(f"[serve] {cfg.name}: encode (prefill and argmax) {enc.prefill_s * 1e3:.3f} ms = "
        f"{B * S / enc.prefill_s:.1f} frames/s; launches {launches} (expected "
        f"{SERVE_LAUNCHES[arch]}), flash by route {routes} (expected "
        f"{SERVE_FLASH_ROUTES[arch]}), {lse_launches} flash launches writing an lse; "
        f"max_memory_allocated {peak} bytes, {memory_left(peak)}; the warm-up's frame logits "
        f"equal to the bit: {torch.equal(warm.logits, enc.logits)}")
    log(f"[serve] {cfg.name} sample (frame labels): {enc.labels[0, :16].tolist()}")
    if enc.logits.shape != (B, S, cfg.padded_vocab) or enc.logits.dtype != torch.float32:
        raise AssertionError(f"serve {arch}: frame logits {tuple(enc.logits.shape)} "
                             f"{enc.logits.dtype}")
    if not torch.isfinite(enc.logits).all():
        raise AssertionError(f"serve {arch}: non-finite frame logits")
    if not ((enc.labels >= 0) & (enc.labels < cfg.padded_vocab)).all():
        raise AssertionError(f"serve {arch}: frame labels out of the vocabulary")
    if launches != SERVE_LAUNCHES[arch]:
        raise AssertionError(f"serve {arch}: kernel launches {launches}, "
                             f"expected {SERVE_LAUNCHES[arch]}")
    if routes != SERVE_FLASH_ROUTES[arch]:
        raise AssertionError(f"serve {arch}: flash launches by route {routes}, "
                             f"expected {SERVE_FLASH_ROUTES[arch]}")
    if wkv_routes_ != SERVE_WKV_ROUTES[arch]:
        raise AssertionError(f"serve {arch}: WKV launches by route {wkv_routes_}, "
                             f"expected {SERVE_WKV_ROUTES[arch]}")
    if lse_launches:
        raise AssertionError(f"serve {arch}: {lse_launches} flash launches wrote an lse")
    return params, cfg, prompt, launches, routes, wkv_routes_


def phase_profile(params, cfg, prompt):
    """Device time by kernel over one prefill and over one decode step (an
    encoder-only model: its prefill alone).  ``prompt``: as serve_prompt
    makes it; a decode step after a prompt of embeddings reads token 0."""
    B, P = next(iter(prompt.values())).shape[:2]
    cache = lm.init_cache(cfg, B, P + 16, torch.bfloat16, "cuda")

    def run_prefill():
        lm.prefill(params, cfg, cache, **prompt)

    if cache is None:
        run_prefill()
        profile_call(f"{cfg.name} prefill", run_prefill)
        return
    cur = prompt["tokens"][:, :1] if "tokens" in prompt else torch.zeros(
        (B, 1), dtype=torch.long, device="cuda")

    def run_decode():
        lm.decode_step(params, cfg, {"pos": P, "layers": cache["layers"]}, cur)

    for what, fn in (("prefill", run_prefill), ("decode step", run_decode)):
        fn()
        profile_call(f"{cfg.name} {what}", fn)


def profile_call(label, fn):
    """One call of fn under torch.profiler: host clock, device busy and idle
    share, the top eight kernels, and the port's own kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels:
        raise AssertionError(f"profile {label}: the profiler saw no device activity")
    log(f"[profile] {label}: host clock {host_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms in {sum(e.count for e in kernels)} kernels, idle share "
        f"{1 - busy_ms / host_ms:.3f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x "
            f"{e.key[:90]}")
    for e in kernels:  # the port's own kernels, in or out of the top eight
        if e.key.startswith(PORT_KERNEL_SYMBOLS):
            log(f"[profile]   port kernel {e.key[:60]}: {e.count}x, device "
                f"{e.self_device_time_total / 1e3 / e.count:.4f} ms a launch")


# Clock cycles of the sleep kernel that holds the stream while device_ms
# queues its calls (about 25 ms on an H100), and how many times device_ms may
# take a run again with a sleep four times as long before it gives up.
SLEEP_CYCLES = 5 * 10**7
SLEEP_TRIES = 4
# device_ms's tally over the run: measurements, and the timed runs they took.
DEVICE_MS_TALLY = {"measurements": 0, "runs": 0}


def device_ms(fn, iters) -> float:
    """Device time a call, without the host's time between launches: a sleep
    kernel holds the stream while the host queues iters calls between two
    CUDA events, so the card runs them back to back and the events time that
    alone.  If the card had reached the start event before the host queued
    the last call, calls may have waited on the host: the run is taken again
    with a sleep four times as long, SLEEP_TRIES runs at most; then it
    raises."""
    fn()
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES
    for _ in range(SLEEP_TRIES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        held = not start.query()  # still asleep: every call was queued in time
        end.synchronize()
        DEVICE_MS_TALLY["runs"] += 1
        if held:
            DEVICE_MS_TALLY["measurements"] += 1
            return start.elapsed_time(end) / iters
        log(f"[timings] device_ms: the card reached the start event before {iters} calls "
            f"were queued behind a sleep of {cycles} cycles; taken again")
        cycles *= 4
    raise AssertionError(f"device_ms: {iters} calls were not queued within a sleep of "
                         f"{cycles // 4} cycles")


def in_turns(fns, timer=time_ms):
    """Median of 4 runs of each (fn, iters), taken in turns: a b c, c b a, twice."""
    names = list(fns)
    times = {name: [] for name in names}
    for order in (names, names[::-1]) * 2:
        for name in order:
            fn, iters = fns[name]
            times[name].append(timer(fn, iters))
    return {name: statistics.median(t) for name, t in times.items()}, times


def sdpa_call(q, k, v, case):
    """The library's attention on (B, H, S, D) copies of the case's inputs:
    is_causal as the case says (hubert-xlarge's is bidirectional), the
    sliding window as a boolean attn_mask."""
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    Sq, Sk, window = case[1], case[2], case[8]
    if window is None:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=case[7],
                                                      enable_gqa=True)
    i = torch.arange(Sq, device="cuda")[:, None]
    j = torch.arange(Sk, device="cuda")[None, :]
    mask = (j <= i) & (j > i - window)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)


# PyTorch's fused attention backends, in the order fused_sdpa tries them.
FUSED_SDPA = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION")


def fused_sdpa(fn):
    """(fn run under the first of PyTorch's fused attention backends that
    takes its inputs, that backend's name), or (None, {backend: why not})
    where none does.  Where Dv differs from Dk (MLA's 96 and 64) the
    default choice may fall back to the unfused math backend, which would
    be no yardstick; this names the fused backend that ran."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    refused = {}
    for name in FUSED_SDPA:
        def call(backend=getattr(SDPBackend, name)):
            with sdpa_kernel([backend]):
                return fn()
        try:
            call()
        except RuntimeError as err:
            refused[name] = " ".join(str(err).split())[:300]
            continue
        return call, name
    return None, refused


# The head dims whose library yardstick is SDPA's default choice, as earlier
# runs timed it; elsewhere (MLA's (96, 64), hubert-xlarge's (80, 80)) the
# fused backend that ran is named.
DEFAULT_SDPA_DIMS = ((128, 128), (256, 256))


def library_attention(fn, case):
    """The library yardstick for a case: fn (an SDPA call) as it is at
    DEFAULT_SDPA_DIMS, else fused_sdpa(fn); with the backend's name (None
    for the default choice) or the refusals."""
    if (case[5], case[6]) in DEFAULT_SDPA_DIMS:
        return fn, None
    return fused_sdpa(fn)


# Calls a timed run of (kernel, plain version, library) at each flash path's shape.
FLASH_ITERS = {"qwen3-1.7b": (100, 10, 100), "recurrentgemma-2b": (20, 2, 10),
               "yi-9b": (50, 5, 50), "minicpm3-4b": (50, 2, 20),
               "hubert-xlarge": (50, 2, 50)}


def phase_timings():
    """Kernel, plain version and the library call at each served prefill shape
    of the flash kernel, bf16, in turns, by CUDA events around back-to-back
    calls; then kernel and library again by device time a call (device_ms),
    which leaves out the host's time between launches (the kernel wrapper's
    checks, three tensor maps and a ctypes call), so that the two are
    compared on the card's time alone.  At minicpm3-4b's (96, 64) and
    hubert-xlarge's (80, 80) the library is the first fused backend that
    takes the call, named (library_attention), or none."""
    out = {}
    for arch, case in FLASH_PATHS.items():
        q, k, v = case_inputs(case, torch.bfloat16, seed=123)
        kw = case_kwargs(case)
        # yardstick only: the port never calls it
        library, backend = library_attention(sdpa_call(q, k, v, case), case)
        it_kernel, it_plain, it_library = FLASH_ITERS[arch]
        fns = {"kernel": (lambda: fa_kernel.flash_attention_fwd(q, k, v, **kw), it_kernel),
               "plain": (lambda: fa_ops.chunked_attention(q, k, v, **kw), it_plain)}
        if library is None:
            lib_note = f"no fused backend takes it: {json.dumps(backend)}"
        else:
            lib_err = (library().transpose(1, 2).float()
                       - fa_kernel.flash_attention_fwd(q, k, v, **kw).float()).abs().max().item()
            lib_note = (f"max_abs_err against the kernel {lib_err:.3e}"
                        + (f", backend {backend}" if backend else ""))
            fns["library"] = (library, it_library)
        ms, times = in_turns(fns)
        bound_ms, bound_by, flops, nbytes = attention_bound(case, torch.bfloat16)
        lib_ms = f"{ms['library']:.4f} ms" if library else "none"
        log(f"[timings] flash_attention_fwd, {arch} prefill: q {tuple(q.shape)} k,v "
            f"{tuple(k.shape)}, {tuple(v.shape)} bf16 causal {case[7]}, window {case[8]}, route "
            f"{fa_kernel.route(torch.bfloat16, case[5], case[6])}, median of 4: kernel "
            f"{ms['kernel']:.4f} ms; plain {ms['plain']:.4f} ms; "
            f"scaled_dot_product_attention {lib_ms} ({lib_note}); bound {bound_ms:.4f} ms by "
            f"{bound_by} ({flops:.3e} FLOP, {nbytes} bytes)")
        log(f"[timings] all runs (ms): {json.dumps(times)}")
        dev_fns = {name: fns[name] for name in ("kernel", "library") if name in fns}
        dev, dev_times = in_turns(dev_fns, device_ms)
        log(f"[timings] flash_attention_fwd, {arch} prefill, device time a call, median of 4: "
            f"kernel {dev['kernel']:.4f} ms; scaled_dot_product_attention "
            + (f"{dev['library']:.4f} ms" if library else "none")
            + f"; all runs (ms): {json.dumps(dev_times)}")
        out[arch] = dict(ms=ms["kernel"], plain_ms=ms["plain"], bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=ms.get("library"),
                         device_ms=dev["kernel"], library_device_ms=dev.get("library"))
        if (case[5], case[6]) not in DEFAULT_SDPA_DIMS:
            out[arch]["library"] = backend if library else f"none: {json.dumps(backend)}"
    return out


def bwd_bound(case, dtype):
    """Least time on the card for the backward: q, k, v, o, dout and the
    forward's f32 lse read once, dq, dk and dv written once; the five
    products over the visible pairs (S = Q K^T, dP = dout V^T, dV = P^T dout,
    dQ = dS K, dK = dS^T Q) at the peak rate.  The larger of the two."""
    B, Sq, Sk, H, KH, Dk, Dv = case[:7]
    item = torch.finfo(dtype).bits // 8
    nbytes = (item * (2 * B * Sq * H * (Dk + Dv) + 2 * B * Sk * KH * (Dk + Dv))
              + 4 * B * H * Sq)
    flops = 2 * visible_pairs(case) * (3 * Dk + 2 * Dv)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


# Profiler sessions ms_a_launch may take before it gives up.
PROFILE_TRIES = 4


def ms_a_launch(profile_once, symbols, calls):
    """Device ms a launch of each kernel of ``symbols`` ({name: a part of its
    symbol}), from the events (key_averages()) of profile_once(), which makes
    ``calls`` calls under the profiler: each kernel's time over the launches
    the profiler recorded.  It does not record every launch (it has missed
    the first call's first kernels, and every launch of one kernel in a
    session), so the divisor is the launches recorded, not the calls made,
    and a session that recorded no launch of a kernel is taken again,
    PROFILE_TRIES sessions at most; then it raises."""
    for _ in range(PROFILE_TRIES):
        events = profile_once()
        hits = {name: [e for e in events if symbol in e.key] for name, symbol in symbols.items()}
        counts = {name: sum(e.count for e in hit) for name, hit in hits.items()}
        if any(n != calls for n in counts.values()):
            log(f"[timings] the profiler recorded {counts} launches of {calls} calls")
        if all(counts.values()):
            return {name: sum(e.self_device_time_total for e in hit) / 1e3 / counts[name]
                    for name, hit in hits.items()}
    raise AssertionError(f"the profiler recorded no launch of one of {list(symbols)} in "
                         f"{PROFILE_TRIES} sessions")


def bwd_device_ms(case, calls=5):
    """Device time a launch of each kernel of the backward (delta, dK/dV,
    dQ, on the case's route) at a bf16 case, from the profiler over `calls`
    calls after 3 warm-ups (ms_a_launch)."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v = case_inputs(case, torch.bfloat16, seed=0)
    kw = case_kwargs(case)
    o, lse = fa_kernel.flash_attention_fwd(q, k, v, with_lse=True, **kw)
    dout = torch.randn(o.shape, generator=torch.Generator("cuda").manual_seed(1),
                       device="cuda").to(torch.bfloat16)
    for _ in range(3):
        fa_kernel.flash_attention_bwd(q, k, v, o, dout, lse, **kw)
    torch.cuda.synchronize()

    def profile_once():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fa_kernel.flash_attention_bwd(q, k, v, o, dout, lse, **kw)
            torch.cuda.synchronize()
        return [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    # a kernel's symbol goes on with "_wgmma<Dk, Dv>" on the tensor-core
    # route, with its template arguments ("<") on the SIMT route
    wgmma = fa_kernel.route(torch.bfloat16, case[5], case[6], backward=True) == "wgmma"
    tail = f"_wgmma<{case[5]}, {case[6]}>" if wgmma else "<"
    return ms_a_launch(profile_once, {"delta": "attn_bwd_delta", "dkdv": f"attn_bwd_dkdv{tail}",
                                      "dq": f"attn_bwd_dq{tail}"}, calls)


# Each train path's backward shape, bf16 (recurrentgemma's at the 10 heads
# its step launches; minitron-4b's, 32 heads over 8 kv heads at yi-9b's
# tokens, qwen3-moe's, which is yi-9b's, and qwen2-moe's, 16 heads over 16,
# are held in phase_bwd_cases but not timed; minicpm3-4b's at (96, 64)),
# and the calls a timed run makes of (kernel, plain version, library forward
# + backward, library forward), and the calls of each
# profiler session (bwd_device_ms).  Then recurrentgemma's at 16 heads, as
# earlier runs launched it, timed beside its path to compare with them.
BWD_PATHS = {"qwen3-1.7b": (QWEN3_TRAIN, (20, 3, 20, 20), 5),
             "recurrentgemma-2b": (RECURRENTGEMMA_TRAIN_10H, (10, 1, 5, 5), 5),
             "yi-9b": (YI_TRAIN, (10, 1, 10, 10), 5),
             "minicpm3-4b": (MINICPM3_TRAIN, (10, 1, 5, 5), 5),
             "hubert-xlarge": (HUBERT_TRAIN, (10, 1, 5, 5), 5)}
BWD_AT_16_HEADS = (RECURRENTGEMMA_TRAIN, (10, 1, 5, 5), 5)


def phase_bwd_timings():
    """The backward kernel at each train path's shape (BWD_PATHS), and at
    recurrentgemma's at 16 heads (BWD_AT_16_HEADS, beside its path), bf16 (on
    the tensor cores at both head dims, as route() names it), given the
    forward kernel's output and lse, in turns with its plain version and
    with the library's attention backward (the window as a boolean mask
    where there is one), by CUDA events around
    back-to-back calls; then kernel and library by device time a call
    (device_ms); then each of its kernels' device time a launch (delta,
    dK/dV, dQ: bwd_device_ms).  The library has no backward alone: its time
    is SDPA forward + backward less SDPA forward, a yardstick only (the port
    never calls it)."""
    out = {}
    for arch, (case, iters, calls) in BWD_PATHS.items():
        out[arch] = _bwd_timings(arch, case, iters, calls)
        torch.cuda.empty_cache()
    out["recurrentgemma-2b"]["at_16_heads"] = _bwd_timings(
        "recurrentgemma-2b at 16 heads", *BWD_AT_16_HEADS)
    return out


def _bwd_timings(arch, case, iters, calls):
    kw = case_kwargs(case)
    q, k, v = case_inputs(case, torch.bfloat16, seed=124)
    o, lse = fa_kernel.flash_attention_fwd(q, k, v, with_lse=True, **kw)
    dout = torch.randn(o.shape, generator=torch.Generator("cuda").manual_seed(125),
                       device="cuda").to(torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    dt = dout.transpose(1, 2).contiguous()
    route = fa_kernel.route(torch.bfloat16, case[5], case[6], backward=True)
    window = case[8]
    if window is None:
        mask = {"is_causal": case[7]}
    else:
        i = torch.arange(case[1], device="cuda")[:, None]
        j = torch.arange(case[2], device="cuda")[None, :]
        mask = {"attn_mask": (j <= i) & (j > i - window)}

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **mask)
    sdpa_fwd, backend = library_attention(sdpa_fwd, case)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dt)

    def kernel():
        return fa_kernel.flash_attention_bwd(q, k, v, o, dout, lse, **kw)
    it_kernel, it_plain, it_fwd_bwd, it_fwd = iters
    fns = {"kernel": (kernel, it_kernel),
           "plain": (lambda: fa_ref.flash_attention_bwd_reference(q, k, v, o, dout, lse=lse, **kw),
                     it_plain)}
    if sdpa_fwd is None:
        lib_note = f"no fused backend takes it: {json.dumps(backend)}"
    else:
        lib_err = max((a.transpose(1, 2).float() - b.float()).abs().max().item()
                      for a, b in zip(sdpa_fwd_bwd(), kernel()))
        lib_note = (f"its gradients against the kernel's: max_abs_err {lib_err:.3e}"
                    + (f"; backend {backend}" if backend else ""))
        fns.update(sdpa_fwd_bwd=(sdpa_fwd_bwd, it_fwd_bwd), sdpa_fwd=(sdpa_fwd, it_fwd))
    ms, times = in_turns(fns)
    library = ms["sdpa_fwd_bwd"] - ms["sdpa_fwd"] if sdpa_fwd else None
    bound_ms, bound_by, flops, nbytes = bwd_bound(case, torch.bfloat16)
    lib_ms = (f"{library:.4f} ms (forward + backward {ms['sdpa_fwd_bwd']:.4f} less forward "
              f"{ms['sdpa_fwd']:.4f}; {lib_note})" if sdpa_fwd else f"none ({lib_note})")
    log(f"[timings] flash_attention_bwd, {arch} train, route {route}: q {tuple(q.shape)} "
        f"k,v {tuple(k.shape)}, {tuple(v.shape)} bf16 causal {case[7]}, window {window}, "
        "median of 4: "
        f"kernel {ms['kernel']:.4f} ms; plain {ms['plain']:.4f} ms; "
        f"scaled_dot_product_attention backward {lib_ms}; bound {bound_ms:.4f} ms by "
        f"{bound_by} ({flops:.3e} FLOP, {nbytes} bytes)")
    log(f"[timings] all runs (ms): {json.dumps(times)}")
    dev, dev_times = in_turns({name: fns[name] for name in ("kernel", "sdpa_fwd_bwd", "sdpa_fwd")
                               if name in fns}, device_ms)
    lib_dev = dev["sdpa_fwd_bwd"] - dev["sdpa_fwd"] if sdpa_fwd else None
    log(f"[timings] flash_attention_bwd, {arch} train, device time a call, median of 4: "
        f"kernel {dev['kernel']:.4f} ms; scaled_dot_product_attention backward "
        + (f"{lib_dev:.4f} ms (forward + backward {dev['sdpa_fwd_bwd']:.4f} less forward "
           f"{dev['sdpa_fwd']:.4f})" if sdpa_fwd else "none")
        + f"; all runs (ms): {json.dumps(dev_times)}")
    stages = bwd_device_ms(case, calls)
    log(f"[timings] flash_attention_bwd, {arch} train, device ms a launch by kernel "
        f"(profiler): {json.dumps(stages)}")
    out = dict(ms=ms["kernel"], plain_ms=ms["plain"], bound_ms=bound_ms, bound_by=bound_by,
               library_ms=library, device_ms=dev["kernel"], library_device_ms=lib_dev,
               stage_device_ms=stages)
    if (case[5], case[6]) not in DEFAULT_SDPA_DIMS:
        out["library"] = backend if sdpa_fwd else f"none: {json.dumps(backend)}"
    return out


def phase_wkv_timings():
    """The WKV kernel and its plain version at the rwkv6-7b prefill and decode
    shapes, bf16, in turns, each on the route kernel.route() names (chunk,
    recurrent); at the prefill shape also the recurrent kernel, which that
    shape no longer takes, as a yardstick (through kernel.launch; the
    launches the kernels line reports are read on the main paths, each
    from counters set to 0 just before it).  No single PyTorch call
    computes the recurrence, so there is no library time.  At the prefill
    shape, CUDA events around
    back-to-back calls.  At the decode shape a launch takes microseconds and
    back-to-back calls are bound by the wrapper's host cost, so ms and
    plain_ms are device time a call (device_ms), and host_ms is the kernel's
    time a call by CUDA events around back-to-back calls.  The decode calls
    cycle through input sets whose states fill twice the L2 cache, so each
    call reads its state from HBM, as a served decode step does."""
    out = {}
    for what, case, iters, timer in (("prefill", WKV_PREFILL_CASE, (20, 2), time_ms),
                                     ("decode", WKV_DECODE_CASE, (20, 1), device_ms)):
        B, T, H, D = case[:4]
        route = wkv_kernel.route(torch.bfloat16, D, T)
        n_sets = 1 if timer is time_ms else -(-2 * L2_BYTES // (4 * B * H * D * D))
        sets = [wkv_inputs(case, torch.bfloat16, seed=321 + i) for i in range(n_sets)]
        fns = {"kernel": (lambda: [wkv_kernel.rwkv6_wkv_fwd(*a) for a in sets], iters[0]),
               "plain": (lambda: [wkv_ref.rwkv6_reference(*a) for a in sets], iters[1])}
        if route != "recurrent":
            fns["recurrent"] = (lambda: [wkv_kernel.launch("recurrent", *a) for a in sets],
                                iters[0] // 2)

        def per_call(timed):
            ms, times = timed
            return ({k: v / n_sets for k, v in ms.items()},
                    {k: [t / n_sets for t in v] for k, v in times.items()})
        ms, times = per_call(in_turns(fns, timer))
        bound_ms, bound_by, flops, nbytes, f32_ms = wkv_bound(case, torch.bfloat16)
        clock = "CUDA events" if timer is time_ms else "device time"
        recurrent = (f"; the recurrent kernel at this shape {ms['recurrent']:.4f} ms"
                     if "recurrent" in ms else "")
        log(f"[timings] rwkv6_wkv_fwd {what} {case[:4]} bf16, s0 "
            f"{'given' if case[4] else 'None'}, median of 4, {clock} a call over {n_sets} "
            f"input set(s): kernel (route {route}) {ms['kernel']:.4f} ms{recurrent}; plain "
            f"{ms['plain']:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} ({flops:.3e} FLOP, "
            f"{nbytes} bytes; the FLOPs at the f32 rate {f32_ms:.4f} ms)")
        log(f"[timings] all runs (ms): {json.dumps(times)}")
        out[what] = dict(wkv_route=route, ms=ms["kernel"], plain_ms=ms["plain"],
                         bound_ms=bound_ms, bound_by=bound_by)
        if "recurrent" in ms:
            out[what]["recurrent_ms"] = ms["recurrent"]
        if timer is not time_ms:
            host, host_times = per_call(in_turns({"kernel": fns["kernel"]}))
            log(f"[timings] rwkv6_wkv_fwd {what}, CUDA events around back-to-back calls "
                f"(host-bound), median of 4: {host['kernel']:.4f} ms a call; all runs (ms): "
                f"{json.dumps(host_times)}")
            out[what]["host_ms"] = host["kernel"]
    return out


def phase_scan_timings():
    """The RG-LRU kernel and its plain version at the recurrentgemma-2b prefill
    shape, f32 (what _lru_coeffs hands it), h0 None, by CUDA events around
    back-to-back calls, in turns.  Each call moves about 1 GB, twenty times
    the L2 cache.  No single PyTorch call computes the recurrence, so there
    is no library time."""
    a, b, h0 = scan_inputs(SCAN_PREFILL_CASE, torch.float32, seed=654)
    ms, times = in_turns({
        "kernel": (lambda: scan_kernel.rglru_scan_fwd(a, b, h0), 20),
        "plain": (lambda: scan_ref.rglru_reference(a, b, h0), 2),
    })
    bound_ms, bound_by, flops, nbytes = scan_bound(SCAN_PREFILL_CASE, torch.float32)
    log(f"[timings] rglru_scan_fwd at a, b {tuple(a.shape)} f32, h0 None, median of 4, "
        f"CUDA events: kernel {ms['kernel']:.4f} ms; plain {ms['plain']:.4f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by} ({flops:.3e} FLOP, {nbytes} bytes)")
    log(f"[timings] all runs (ms): {json.dumps(times)}")
    return dict(ms=ms["kernel"], plain_ms=ms["plain"], bound_ms=bound_ms, bound_by=bound_by)


def scan_bwd_bound(case, dtype):
    """Least time on the card for the scan's backward: dh, a and h read once
    (h0 and dh_last when given), da and db written once and dh0; 3 FLOP an
    element at the f32 rate outside the tensor cores.  The larger of the two."""
    B, T, W, with_h0, with_dl, _ = case
    item = torch.finfo(dtype).bits // 8
    nbytes = item * 5 * B * T * W + 4 * B * W * (1 + with_h0 + with_dl)
    flops = 3 * B * T * W
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def phase_scan_bwd_timings():
    """The scan's backward kernel and its plain version at recurrentgemma-2b's
    train shape, f32 (what _lru_coeffs hands the scan), h0 and dh_last None
    as in train mode, by CUDA events around back-to-back calls, in turns.
    Each call moves 419 MB, eight times the L2 cache.  No single PyTorch call
    computes the recurrence's gradient, so there is no library time."""
    args = scan_bwd_inputs(SCAN_TRAIN_CASE, torch.float32, seed=655)
    ms, times = in_turns({
        "kernel": (lambda: scan_kernel.rglru_scan_bwd(*args), 20),
        "plain": (lambda: scan_ref.rglru_scan_bwd_reference(*args), 1),
    })
    bound_ms, bound_by, flops, nbytes = scan_bwd_bound(SCAN_TRAIN_CASE, torch.float32)
    log(f"[timings] rglru_scan_bwd at a, h, dh {tuple(args[0].shape)} f32, h0 and dh_last None, "
        f"median of 4, CUDA events: kernel {ms['kernel']:.4f} ms; plain {ms['plain']:.4f} ms; "
        f"bound {bound_ms:.4f} ms by {bound_by} ({flops:.3e} FLOP, {nbytes} bytes)")
    log(f"[timings] all runs (ms): {json.dumps(times)}")
    return dict(ms=ms["kernel"], plain_ms=ms["plain"], bound_ms=bound_ms, bound_by=bound_by)


def wkv_bwd_bound(case, dtype):
    """Least time on the card for the WKV backward: r, k, v, w and dy read
    once (u, and s0 and ds_last when given), dr, dk, dv and dw written once,
    du and ds0 (f32); 14 D^2 + 8 D FLOP a (b, h, t) (the state's recurrence
    and the gradient's, 3 D^2 each; dr, dk, dv and dw, 2 D^2 each; v . dy, u
    r . k and du's term, 8 D) at the peak rate of the tensor cores, which can
    take them (the chunk route does its products there), as wkv_bound counts
    the forward's.  The larger of the two, and the FLOPs' time at the f32
    rate outside the tensor cores beside it."""
    B, T, H, D, with_s0, with_ds, _ = case
    item = torch.finfo(dtype).bits // 8
    state = 4 * B * H * D * D
    nbytes = (item * 9 * B * T * H * D + 2 * 4 * H * D
              + state * (1 + with_s0 + with_ds))
    flops = (14 * D * D + 8 * D) * B * T * H
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"),
            flops, nbytes, flops / PEAK_F32_FLOPS * 1e3)


# Each WKV route at rwkv6-7b's train shape by the profiler: the symbols of
# its kernels (ms_a_launch), keyed by route.  The chain and the recurrent
# kernel serve two routes each.
WKV_ROUTE_SYMBOLS = {
    ("bwd", "chunk"): {"wkv_chain": "chain::wkv_chain(", "wkv_bwd_chunk": "wkv_bwd_chunk(",
                       "wkv_bwd_du_chunks": "wkv_bwd_du_chunks("},
    ("fwd", "recurrent"): {"wkv_fwd": "wkv_fwd<"},
    ("fwd", "chunk"): {"wkv_fwd_chunk": "wkv_fwd_chunk("},
    ("fwd", "chunk_exact"): {"wkv_chain": "chain::wkv_chain(", "wkv_fwd": "wkv_fwd<"},
    ("bwd", "recurrent"): {"wkv_bwd_fwd": "wkv_bwd_fwd<", "wkv_bwd_rev": "wkv_bwd_rev<",
                           "wkv_bwd_du": "wkv_bwd_du<"},
}


def wkv_device_ms_by_kernel(args, calls=5):
    """Device ms a launch of each kernel of each WKV route in
    WKV_ROUTE_SYMBOLS on the backward's inputs ``args`` (r, k, v, w, u, s0,
    dy, ds_last), by the profiler (the card's activity only): for each route
    a warm-up call and a synchronize, then a first session of ``calls``
    calls that is thrown away, for the profiler has delivered launches of
    one session in the next one's events, then sessions of ``calls`` calls
    (ms_a_launch).  A route whose kernels no session recorded fails the
    phase (ms_a_launch raises)."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for (kind, rt), symbols in WKV_ROUTE_SYMBOLS.items():
        def call():
            if kind == "bwd":
                return wkv_kernel.bwd_launch(rt, *args)
            return wkv_kernel.launch(rt, *args[:6])

        def profile_once():
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    call()
                torch.cuda.synchronize()
            return [e for e in prof.key_averages() if e.self_device_time_total > 0]
        call()
        torch.cuda.synchronize()
        profile_once()  # thrown away: it may hold the last route's late launches
        out[f"{kind} {rt}"] = ms_a_launch(profile_once, symbols, calls)
    return out


def phase_wkv_bwd_timings():
    """The WKV backward at rwkv6-7b's train shape (WKV_BWD_TRAIN_CASE: 2 x
    4096 tokens, 64 heads of 64), bf16, s0 and ds_last None as in a train
    step, on the route bwd_route() names (chunk) and on the recurrent route
    (bwd_launch), beside the forward on each of its three routes there (a
    train step's, route(..., grad=True): chunk_exact; the recurrent route,
    which a train step took before; the serving chunk route), in turns by
    CUDA events around back-to-back calls; the plain version, about 2 s a
    call (a step at a time from the host), by one timed call after a
    warm-up; then the backward's device time a call (device_ms), and each
    route's device time by kernel from the profiler.  No single PyTorch
    call computes the recurrence's gradient, so there is no library time.
    The bound is wkv_bwd_bound's: the bytes', the FLOPs' at the tensor
    cores' rate being less, with the FLOPs' time at the f32 rate beside
    it."""
    args = wkv_bwd_inputs(WKV_BWD_TRAIN_CASE, torch.bfloat16, seed=656)
    B, T, H, D = args[0].shape
    route = wkv_kernel.bwd_route(torch.bfloat16, D, T)
    fwd_route = wkv_kernel.route(torch.bfloat16, D, T, grad=True)
    ms, times = in_turns({
        "kernel": (lambda: wkv_kernel.rwkv6_wkv_bwd(*args), 10),
        "recurrent": (lambda: wkv_kernel.bwd_launch("recurrent", *args), 10),
        "forward, chunk_exact": (lambda: wkv_kernel.launch("chunk_exact", *args[:6]), 10),
        "forward, recurrent": (lambda: wkv_kernel.launch("recurrent", *args[:6]), 10),
        "forward, chunk": (lambda: wkv_kernel.launch("chunk", *args[:6]), 10),
    })
    ms["plain"] = time_ms(lambda: wkv_ref.rwkv6_wkv_bwd_reference(*args), 1)
    dev, dev_times = in_turns({"kernel": (lambda: wkv_kernel.rwkv6_wkv_bwd(*args), 10)},
                              device_ms)
    by_kernel = wkv_device_ms_by_kernel(args)
    bound_ms, bound_by, flops, nbytes, f32_ms = wkv_bwd_bound(WKV_BWD_TRAIN_CASE,
                                                              torch.bfloat16)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    fwd_bound_ms, fwd_bound_by, *_ = wkv_bound(WKV_BWD_TRAIN_CASE[:4] + (False, "model"),
                                               torch.bfloat16)
    log(f"[timings] rwkv6_wkv_bwd at r, k, v, w, dy {tuple(args[0].shape)} bf16, s0 and ds_last "
        f"None, median of 4, CUDA events: kernel (route {route}) {ms['kernel']:.4f} ms (device "
        f"time a call {dev['kernel']:.4f}), the recurrent route {ms['recurrent']:.4f} ms; plain "
        f"{ms['plain']:.4f} ms (one call); bound {bound_ms:.4f} ms by {bound_by} ({nbytes} "
        f"bytes, {bytes_ms:.4f} ms; {flops:.3e} FLOP, {f32_ms:.4f} ms at the f32 rate outside "
        f"the tensor cores); the forward there: "
        f"chunk_exact (a train step's, route(..., grad=True) = {fwd_route}) "
        f"{ms['forward, chunk_exact']:.4f} ms, recurrent {ms['forward, recurrent']:.4f} ms, "
        f"chunk {ms['forward, chunk']:.4f} ms, bound {fwd_bound_ms:.4f} ms by {fwd_bound_by}")
    log(f"[timings] WKV device ms a launch by kernel (profiler), by route at the train shape: "
        f"{json.dumps(by_kernel)}")
    log(f"[timings] all runs (ms): {json.dumps(times)}; device time: {json.dumps(dev_times)}")
    return dict(wkv_bwd_route=route, ms=ms["kernel"], plain_ms=ms["plain"], bound_ms=bound_ms,
                bound_by=bound_by, bytes_bound_ms=bytes_ms, f32_bound_ms=f32_ms,
                device_ms=dev["kernel"],
                recurrent_ms=ms["recurrent"], device_ms_by_kernel=by_kernel,
                train_forward_route=fwd_route, train_forward_ms=ms["forward, chunk_exact"],
                recurrent_forward_ms=ms["forward, recurrent"],
                chunk_forward_ms=ms["forward, chunk"], train_forward_bound_ms=fwd_bound_ms)


# Kv tile rows of the flash kernel's tensor-core route at each head dim, and
# the kv tiles an item that tile_sweep times.
WGMMA_BK = {128: 128, 256: 64}
SWEEP_TILES = (1, 8, 64)


# The scheduler phase: the port's Dally scheduler and cluster simulator
# (repro_torch.core), plain Python and numpy on the card's host, on the
# paper's cluster (NVIDIA_PAPER: 8 machines of 8 GPUs a rack) at the paper's
# scale, each cell built as the JAX package's Scenario.build_sim builds
# "paper-batch" (500 jobs at t = 0) and "paper-poisson" (400 jobs): seed 0,
# a round every 300 s, overlap 0.25, pure data parallelism, no faults, the
# trace submitted up front.  The trace makers draw rng.choice over the
# architectures in the registry's order, the JAX package's (SCHED_ARCHS).  A cell:
# (scenario, trace maker, jobs, racks, policy).
SCHED_ARCHS = tuple(ARCHS)
SCHED_POLICIES = ("gandiva", "tiresias", "dally-manual", "dally-nowait",
                  "dally-fullyconsolidated", "dally")
SCHED_CELLS = ([("paper-batch", "batch", 500, 8, p) for p in SCHED_POLICIES]
               + [("paper-batch", "batch", 500, 16, "dally"),
                  ("paper-poisson", "poisson", 400, 8, "dally"),
                  ("paper-poisson", "poisson", 400, 8, "tiresias")])
# Each cell's makespan and average JCT in seconds, as the JAX package's
# simulator gives them for the same cell on the CPU
# (tests/test_torch_chip_smoke.py holds them equal to the bit).  The card's
# host runs another Python, numpy and libm, so the phase holds them within
# SCHED_REL relative.
SCHED_PINNED = {
    "paper-batch 8 racks gandiva": (2108240.9456814947, 188421.77586386012),
    "paper-batch 8 racks tiresias": (1786922.6535273052, 144680.08174633823),
    "paper-batch 8 racks dally-manual": (1652211.0197049365, 367765.2154408902),
    "paper-batch 8 racks dally-nowait": (1652211.0197049365, 367864.84524668753),
    "paper-batch 8 racks dally-fullyconsolidated": (1652211.0197049365, 262023.33476771414),
    "paper-batch 8 racks dally": (1652211.0197049365, 309597.36767601327),
    "paper-batch 16 racks dally": (1652211.0197049365, 146047.05976817553),
    "paper-poisson 8 racks dally": (1849540.276699309, 228025.7510625115),
    "paper-poisson 8 racks tiresias": (1769275.2977483238, 110435.52345869981),
}
SCHED_REL = 1e-9


def scheduler_cell(trace, n_jobs, n_racks, policy):
    """One cell's simulator, its trace submitted and nothing run yet."""
    archs = [get_config(name) for name in SCHED_ARCHS]
    comm = CommModel.from_configs(archs, profile=NVIDIA_PAPER, overlap_frac=0.25)
    cluster = ClusterTopology(n_racks=n_racks, machines_per_rack=8, gpus_per_machine=8)
    sim = ClusterSimulator(cluster, make_policy(policy), comm, round_period=300.0,
                           checkpoint_overhead=0.0)
    maker = {"batch": make_batch_trace, "poisson": make_poisson_trace}[trace]
    for job in maker(archs, n_jobs=n_jobs, seed=0, profile=NVIDIA_PAPER):
        sim.submit(job)
    return sim


def phase_scheduler():
    """Each of SCHED_CELLS to its end through the simulator's service-mode
    entries (begin, step_events), which count the events: every job
    finished, makespan and average JCT within SCHED_REL of SCHED_PINNED.
    dally at 8 racks runs again through the batch entry run(), and the two
    results() must serialize to the same bytes.  Logs each cell's results
    and its wall seconds and events a second on the host's clock."""
    for scenario, trace, n_jobs, n_racks, policy in SCHED_CELLS:
        key = f"{scenario} {n_racks} racks {policy}"
        sim = scheduler_cell(trace, n_jobs, n_racks, policy)
        t0 = time.perf_counter()
        sim.begin()
        n_events = 0
        while sim.events:
            n_events += sim.step_events(1 << 12)
        res = sim.results()
        wall = time.perf_counter() - t0
        got = {"makespan": res["makespan"], "avg_jct": res["jct"]["avg"]}
        rel = {what: abs(got[what] - want) / abs(want)
               for what, want in zip(got, SCHED_PINNED[key])}
        log(f"[scheduler] {key} ({n_jobs} jobs, {8 * 8 * n_racks} GPUs): n_finished "
            f"{res['n_finished']}, makespan {res['makespan'] / 3600:.6f} h, avg JCT "
            f"{res['jct']['avg'] / 3600:.6f} h (relative to the pins: {rel['makespan']:.3e}, "
            f"{rel['avg_jct']:.3e}), avg comm latency {res['comm_latency']['avg']:.6f} s, "
            f"preemptions {res['preemptions']}; {n_events} events in {wall:.4f} s, "
            f"{n_events / wall:.1f} events/s")
        if res["n_finished"] != n_jobs:
            raise AssertionError(f"scheduler {key}: {res['n_finished']} of {n_jobs} jobs finished")
        for what, want in zip(got, SCHED_PINNED[key]):
            if rel[what] > SCHED_REL:
                raise AssertionError(f"scheduler {key}: {what} {got[what]!r} against the "
                                     f"reference's {want!r}, beyond {SCHED_REL} relative")
        if (policy, n_racks, trace) == ("dally", 8, "batch"):
            again = scheduler_cell(trace, n_jobs, n_racks, policy).run()
            if json.dumps(again, sort_keys=True) != json.dumps(res, sort_keys=True):
                raise AssertionError(f"scheduler {key}: two runs' results() differ")
            log(f"[scheduler] {key}: a second run through run() gives results() equal to the "
                "byte")


# The experiments phase: the port's experiments, streamed replay with spill,
# sweep and online service (repro_torch.experiments, repro_torch.service) on
# the card's host.  It is host code and launches nothing.  EXP_CELLS runs
# run_one at seed 0 under EXP_POLICY on one registered scenario for each
# artifact schema but v6, at the scenario's own scale; EXP_STREAM_CELL
# streams dc-256-philly's 10,000 jobs on 2,048 GPUs from the lazy cursor and
# spills the finished jobs to JSONL shards (schema v6).  A cell: (scenario,
# artifact schema).
EXP_CELLS = (("paper-batch", "v1"), ("congested-spine", "v2"), ("mixed-parallelism", "v3"),
             ("failure-prone", "v4"), ("degraded-cluster", "v5"), ("multi-tenant", "v7"))
EXP_STREAM_CELL = ("dc-256-philly", "v6")
EXP_POLICY = "dally"
# The sweep's CLI on one scenario under two policies, over two workers.
EXP_SWEEP = ("paper-batch", ("dally", "tiresias"))
# The service, by the protocol of tools/service_crash_smoke.py: an inbox of
# EXP_SERVICE_SPECS specs on "smoke" under EXP_SERVICE_OVERRIDES, run once
# uninterrupted and once SIGKILLed once its journal shows a snapshot and every
# submit, then restarted to drain.
EXP_SERVICE_MODELS = ("yi-9b", "qwen3-1.7b", "qwen2-moe-a2.7b", "recurrentgemma-2b",
                      "minicpm3-4b", "qwen3-moe-30b-a3b")
EXP_SERVICE_SPECS = 20
EXP_SERVICE_OVERRIDES = {"contention": "fair-share"}
EXP_KILL_TIMEOUT_S = 120.0
# The streamed cell's spill manifest names its directory, a temporary one:
# its digest is taken with that directory written as EXP_SPILL_DIR.
EXP_SPILL_DIR = "spill"
# Each cell's artifact as the JAX package gives it for the same cell on the
# paper's cluster, and the service's artifact.json as its SchedulerService
# writes it for the same inbox (tests/test_torch_chip_smoke.py recomputes
# each through the reference on the CPU): the sha256 of the artifact's
# canonical bytes (artifact_json), and of each field (exp_fields), so that a
# digest that differs names the first field that does.
EXP_PINNED = {
    "paper-batch": ("6ddc080a288369d4f52acbadd856535480a828aaf8fc3577ee39a27d4dde173e", {
        "config": "33865f0d7cdf", "metrics.avg_utilization": "348e8eaf05b5",
        "metrics.comm_latency": "426bea5e3818", "metrics.jct": "7367083e29fc",
        "metrics.jct_values": "ce3b08274ce5", "metrics.makespan": "79dd418ce285",
        "metrics.n_finished": "0604cd3138fe", "metrics.n_rejected": "5feceb66ffc8",
        "metrics.n_unfinished": "5feceb66ffc8", "metrics.preemptions": "85c7fe931900",
        "metrics.queueing_delay": "2f0745667daa", "metrics.timeline": "2aab4ff32370",
        "metrics.total_comm_time": "66fc70e93455", "metrics.total_t_run": "f67fd7892a16",
        "policy": "6c500384b3df", "scenario": "6e26333956fd", "schema": "24eb7e38f01d",
        "seed": "5feceb66ffc8"
    }),
    "congested-spine": ("6df9cf5ee240b5a8875d64be50ecba09e2c3cc679a3278630b2f34a3370d0e57", {
        "config": "e3d9805ea7d9", "metrics.avg_utilization": "e12cbf9eadab",
        "metrics.comm_latency": "c4bb8485bf9e", "metrics.jct": "d1e55172108a",
        "metrics.jct_values": "cb2c24cfccfe", "metrics.makespan": "79dd418ce285",
        "metrics.n_finished": "26d228663f13", "metrics.n_rejected": "5feceb66ffc8",
        "metrics.n_reprices": "db55da3fc309", "metrics.n_unfinished": "5feceb66ffc8",
        "metrics.preemptions": "bebcee2abff6", "metrics.queueing_delay": "d275829652b9",
        "metrics.timeline": "45c6d34c9ffc", "metrics.total_comm_time": "4e4d1960a8d6",
        "metrics.total_t_run": "6a2c40c36fa4", "policy": "6c500384b3df", "scenario":
        "1de2507d1ad6", "schema": "c7b7550dba83", "seed": "5feceb66ffc8"
    }),
    "mixed-parallelism": ("7a0abd5a397ae1cfc16ef22bb82a8a6c90f6a9815540454fdbddb07a01334893", {
        "config": "6333e12afd36", "metrics.avg_utilization": "a3a5179da62b",
        "metrics.comm_latency": "a65d7ede0810", "metrics.jct": "3e0a97cc868a",
        "metrics.jct_values": "dcdac12e28df", "metrics.makespan": "86064ea4ce55",
        "metrics.n_finished": "26d228663f13", "metrics.n_rejected": "5feceb66ffc8",
        "metrics.n_unfinished": "5feceb66ffc8", "metrics.preemptions": "aa4b0d224e2b",
        "metrics.queueing_delay": "35df32d5684d", "metrics.timeline": "6cf4b8013f8c",
        "metrics.total_comm_time": "927668a75e01", "metrics.total_t_run": "89480b2aa5a1",
        "policy": "6c500384b3df", "scenario": "cec69616e0d9", "schema": "1382d4355616",
        "seed": "5feceb66ffc8"
    }),
    "failure-prone": ("9db7a72de6130d12e405380049baca2acaaf4b91e84a61acf72a271ec2b1e7fa", {
        "config": "180ca8538194", "metrics.avg_utilization": "6e2fa6096065",
        "metrics.comm_latency": "1d7028f4faeb", "metrics.jct": "7f2aa2e8abe1",
        "metrics.jct_values": "77d30ecca267", "metrics.makespan": "66544eb6f05a",
        "metrics.n_finished": "26d228663f13", "metrics.n_job_failures": "2af4dd48399a",
        "metrics.n_machine_failures": "67e0bdb7b6c5", "metrics.n_rejected": "5feceb66ffc8",
        "metrics.n_unfinished": "5feceb66ffc8", "metrics.preemptions": "8670bfe4c727",
        "metrics.queueing_delay": "024ac18f1c4b", "metrics.timeline": "d5b433bffd2f",
        "metrics.total_comm_time": "9c15c99a84a9", "metrics.total_t_run": "7467c0a23c51",
        "policy": "6c500384b3df", "scenario": "edc6787e4c70", "schema": "c1c03a20751c",
        "seed": "5feceb66ffc8"
    }),
    "degraded-cluster": ("c100a23c0c94f8d40b444f52e88af493cced28e7476a4f1ee4760b49e9fcf31b", {
        "config": "7789d1281615", "metrics.avg_utilization": "642335c494c4",
        "metrics.comm_latency": "61721c0efb9c", "metrics.jct": "68ffa03567f1",
        "metrics.jct_values": "521207606ea0", "metrics.makespan": "79dd418ce285",
        "metrics.n_degrade_events": "5ef6514ed330", "metrics.n_degrade_reprices":
        "355d8c0ee4e5", "metrics.n_finished": "983bd614bb5a", "metrics.n_rejected":
        "5feceb66ffc8", "metrics.n_reprices": "308831041ea4", "metrics.n_straggler_evictions":
        "c75de23d89df", "metrics.n_unfinished": "5feceb66ffc8", "metrics.preemptions":
        "c7c1b4da9b9f", "metrics.queueing_delay": "2efd4d79a0ab", "metrics.timeline":
        "f72afbca9fbb", "metrics.total_comm_time": "256b64157736", "metrics.total_t_run":
        "a92f24600642", "policy": "6c500384b3df", "scenario": "9107b10ae22b", "schema":
        "b51cf22bcf03", "seed": "5feceb66ffc8"
    }),
    "multi-tenant": ("1de0ed3452ad44a0f7eccab17489d22a2efddee6f53204cfb510ee1feb50f03c", {
        "config": "c03b014db60b", "metrics.avg_utilization": "b3b1e9249821",
        "metrics.comm_latency": "192be7db2647", "metrics.jct": "43b511a2f70f",
        "metrics.jct_values": "f01d7c60ef91", "metrics.makespan": "289f4e112ac3",
        "metrics.n_finished": "26d228663f13", "metrics.n_rejected": "5feceb66ffc8",
        "metrics.n_unfinished": "5feceb66ffc8", "metrics.preemptions": "2fe98face818",
        "metrics.queueing_delay": "10f28898e595", "metrics.tenants": "c2eb7c8140e5",
        "metrics.timeline": "658b7cff949d", "metrics.total_comm_time": "2e401a5b8a35",
        "metrics.total_t_run": "ebc856f2ac3f", "policy": "6c500384b3df", "scenario":
        "6e7214c0a811", "schema": "091537ceeecd", "seed": "5feceb66ffc8"
    }),
    "dc-256-philly": ("d1ceff9861beaa94fbb8a86f8acf0998402a994c31d865add2a00a992dfb5f58", {
        "config": "dffaae39d180", "metrics.avg_utilization": "071a84fc0c47",
        "metrics.comm_latency": "2df843cb28b8", "metrics.jct": "d7cb4f3c14bd",
        "metrics.jct_values": "9e7e90768a6a", "metrics.makespan": "799741163a68",
        "metrics.n_finished": "39e5b4830d4d", "metrics.n_rejected": "5feceb66ffc8",
        "metrics.n_unfinished": "5feceb66ffc8", "metrics.preemptions": "c1698979b983",
        "metrics.queueing_delay": "0ace21c402ef", "metrics.spill": "7e52de7d55ab",
        "metrics.timeline": "33e73b30475b", "metrics.total_comm_time": "7d588f3a6b81",
        "metrics.total_t_run": "27e6338f1a04", "policy": "6c500384b3df", "scenario":
        "ad80b5aa12c0", "schema": "a45c2ca81e1d", "seed": "5feceb66ffc8"
    }),
    "service": ("315ff2ac9ed7ff9cce953fda596cb92ccbef8d0bab1e433b23c3f0eafbb28084", {
        "config": "38b701a68149", "metrics.avg_utilization": "ab28577ca199",
        "metrics.comm_latency": "30cea6083227", "metrics.jct": "73eeec803008",
        "metrics.jct_values": "52f7f09b3750", "metrics.makespan": "f71c865025d0",
        "metrics.n_finished": "f5ca38f748a1", "metrics.n_rejected": "5feceb66ffc8",
        "metrics.n_reprices": "5feceb66ffc8", "metrics.n_unfinished": "5feceb66ffc8",
        "metrics.preemptions": "5feceb66ffc8", "metrics.queueing_delay": "c4f0c8ceb6d7",
        "metrics.timeline": "c0a09c74c7c5", "metrics.total_comm_time": "961a35c8ad9d",
        "metrics.total_t_run": "d06017fe6726", "n_submitted": "f5ca38f748a1", "overrides":
        "822087895018", "policy": "6c500384b3df", "scenario": "aaba7feeeca6", "schema":
        "4a6822ee3dbe", "seed": "5feceb66ffc8"
    }),
}


def exp_artifact(art):
    """art with its spill manifest's directory, if it has one, written as
    EXP_SPILL_DIR."""
    spill = art["metrics"].get("spill")
    if spill is None:
        return art
    return {**art, "metrics": {**art["metrics"], "spill": {**spill, "dir": EXP_SPILL_DIR}}}


def exp_digest(art):
    """(sha256 of the artifact's canonical bytes, exp_fields) of an artifact."""
    art = exp_artifact(art)
    return hashlib.sha256(artifact_json(art).encode()).hexdigest(), exp_fields(art)


def exp_fields(art):
    """{field: the first 12 hex digits of the sha256 of its sorted JSON}, for
    each key of the artifact but "metrics" and each key of its metrics."""
    out = {}
    for key, value in sorted(art.items()):
        items = sorted(value.items()) if key == "metrics" else [(None, value)]
        for sub, v in items:
            name = key if sub is None else f"{key}.{sub}"
            out[name] = hashlib.sha256(json.dumps(v, sort_keys=True).encode()).hexdigest()[:12]
    return out


def exp_hold(key, art):
    """Fail unless art's digest is EXP_PINNED[key]'s; name the first field
    that differs."""
    digest, fields = exp_digest(art)
    want, want_fields = EXP_PINNED[key]
    if digest == want:
        return digest
    differ = [f for f in sorted(set(fields) | set(want_fields))
              if fields.get(f) != want_fields.get(f)]
    raise AssertionError(f"experiments {key}: artifact sha256 {digest} against the pin {want}; "
                         f"the first field that differs: {differ[0] if differ else None} "
                         f"(all that differ: {differ})")


@contextlib.contextmanager
def counting_events():
    """Each simulator that run() drives in this context counts the events it
    processes through its event_hook; yields the list of counts, one a run."""
    counts, run = [], ClusterSimulator.run

    def counted(sim, *args, **kw):
        n, hook = [0], sim.event_hook

        def count(s, kind):
            n[0] += 1
            if hook is not None:
                hook(s, kind)
        sim.event_hook = count
        try:
            return run(sim, *args, **kw)
        finally:
            sim.event_hook = hook
            counts.append(n[0])
    with mock.patch.object(ClusterSimulator, "run", counted):
        yield counts


def exp_run(scenario, **overrides):
    """run_one of a cell at seed 0 under EXP_POLICY, with its events counted:
    (artifact, events, wall seconds on the host's clock)."""
    with counting_events() as counts:
        t0 = time.perf_counter()
        art = run_one(scenario, EXP_POLICY, 0, overrides=SimOverrides(**overrides))
        wall = time.perf_counter() - t0
    return art, counts[0], wall


def exp_env():
    """The environment of a subprocess that imports this checkout's port."""
    src = str(Path(__file__).resolve().parent / "src")
    return {**os.environ, "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}


def exp_cells():
    """EXP_CELLS and EXP_STREAM_CELL, each held to its pin; the streamed
    cell's shards to their manifest.  Returns {scenario: artifact}."""
    arts = {}
    for scenario, schema in EXP_CELLS:
        art, events, wall = exp_run(scenario)
        if art["schema"] != f"repro.experiments.artifact/{schema}":
            raise AssertionError(f"experiments {scenario}: schema {art['schema']}, not {schema}")
        digest = exp_hold(scenario, art)
        m = art["metrics"]
        log(f"[experiments] {scenario} ({schema}, {EXP_POLICY}, seed 0): n_finished "
            f"{m['n_finished']}, makespan {m['makespan']!r} s, avg JCT {m['jct']['avg']!r} s; "
            f"{events} events in {wall:.4f} s, {events / wall:.1f} events/s; artifact sha256 "
            f"{digest} equals the pin")
        arts[scenario] = art
    scenario, schema = EXP_STREAM_CELL
    with tempfile.TemporaryDirectory(prefix="exp-spill-") as spill:
        art, events, wall = exp_run(scenario, stream=True, spill_dir=spill)
        manifest = art["metrics"]["spill"]
        bad = verify_manifest(manifest)
        if bad is not None:
            raise AssertionError(f"experiments {scenario}: spill manifest: {bad}")
        if art["schema"] != f"repro.experiments.artifact/{schema}":
            raise AssertionError(f"experiments {scenario}: schema {art['schema']}, not {schema}")
        digest = exp_hold(scenario, art)
    m = art["metrics"]
    log(f"[experiments] {scenario} ({schema}, streamed, spilled, {EXP_POLICY}, seed 0): "
        f"{art['config']['n_jobs']} jobs on {art['config']['n_racks'] * 64} GPUs, n_finished "
        f"{m['n_finished']}, makespan {m['makespan']!r} s, avg JCT {m['jct']['avg']!r} s; "
        f"{manifest['n_jobs']} records in {len(manifest['shards'])} shard(s), verify_manifest "
        f"passes; {events} events in {wall:.4f} s, {events / wall:.1f} events/s; artifact "
        f"sha256 {digest} equals the pin")
    arts[scenario] = art
    return arts


# The processes of exp_memory: one that only imports the sweep (the baseline
# every process of the port starts from, torch included), and the sweep's CLI
# on EXP_STREAM_CELL materialized and streamed with the spill on.
EXP_MEMORY_RUNS = {"materialized": (), "streamed": ("--stream", "--spill")}
# A small process that runs the command in its arguments and exits with its
# code.  Linux carries a process's peak RSS (ru_maxrss) into each child it
# starts, across fork and execve; this process's is gigabytes by this phase,
# so exp_memory starts each measured process through EXP_STARTER, whose own
# peak is a few MB.
EXP_STARTER = "import subprocess, sys; sys.exit(subprocess.call(sys.argv[1:]))"


def exp_memory(*extra):
    """The streamed cell's memory, each run in a process of its own so that
    its peak RSS is its own: the sweep's CLI on EXP_STREAM_CELL at one worker,
    materialized and streamed with the spill on, beside a process that only
    imports the sweep; all three side by side, each started through
    EXP_STARTER.  Each sweep.json row records its process's peak
    (peak_rss_mb).  The streamed artifact is held to its
    pin and its shards to their manifest, and both runs must finish the same
    jobs at the same makespan and JCT.  extra: more flags of the sweep."""
    scenario, _ = EXP_STREAM_CELL
    baseline = "import repro_torch.experiments.sweep as s; print(s._peak_rss_mb())"
    start = [sys.executable, "-c", EXP_STARTER, sys.executable]
    with tempfile.TemporaryDirectory(prefix="exp-memory-") as work:
        t0 = time.perf_counter()
        argv = {"baseline": ["-c", baseline]}
        for kind, flags in EXP_MEMORY_RUNS.items():
            argv[kind] = ["-m", "repro_torch.experiments.sweep", "--scenarios", scenario,
                          "--policies", EXP_POLICY, "--workers", "1", "--out",
                          str(Path(work) / kind), *flags, *extra]
        # each in a session of its own, so that killing its group stops the
        # starter and the process it started
        procs = {kind: subprocess.Popen(start + a, env=exp_env(), stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True,
                                        start_new_session=True)
                 for kind, a in argv.items()}
        outs = {}
        try:
            for kind, proc in procs.items():
                outs[kind], err = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    raise AssertionError(f"experiments memory {kind}: exit {proc.returncode}: "
                                         f"{err[-2000:]}")
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        wall = time.perf_counter() - t0
        rows, arts = {}, {}
        for kind in EXP_MEMORY_RUNS:
            out = Path(work) / kind
            rows[kind] = json.loads((out / "sweep.json").read_text())["runs"][0]
            arts[kind] = json.loads((out / f"{scenario}__{EXP_POLICY}__seed0.json").read_text())
        bad = verify_manifest(arts["streamed"]["metrics"]["spill"])
        if bad is not None:
            raise AssertionError(f"experiments memory {scenario}: spill manifest: {bad}")
        digest = exp_hold(scenario, arts["streamed"])
        for key in ("n_finished", "makespan", "jct"):
            if arts["materialized"]["metrics"][key] != arts["streamed"]["metrics"][key]:
                raise AssertionError(f"experiments memory {scenario}: metrics.{key} of the "
                                     "materialized run differs from the streamed run's")
    peaks = {"baseline": float(outs["baseline"]), **{k: r["peak_rss_mb"] for k, r in rows.items()}}
    log(f"[experiments] {scenario} memory, one process a run, each through EXP_STARTER, side by "
        f"side in {wall:.4f} s: peak RSS of importing the sweep {peaks['baseline']!r} MB; materialized "
        f"{peaks['materialized']!r} MB ({rows['materialized']['wall_s']:.4f} s); streamed with "
        f"the spill on {peaks['streamed']!r} MB ({rows['streamed']['wall_s']:.4f} s, "
        f"{rows['streamed']['spilled_jobs']} records spilled); the streamed artifact sha256 "
        f"{digest} equals the pin, and both runs finish the same jobs at the same makespan "
        "and JCT")
    return peaks


def exp_sweep(arts):
    """The sweep's CLI in a subprocess over two workers: each artifact it
    writes equals the bytes of an in-process run_one of the same cell."""
    scenario, policies = EXP_SWEEP
    with tempfile.TemporaryDirectory(prefix="exp-sweep-") as out:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "repro_torch.experiments.sweep",
                               "--scenarios", scenario, "--policies", ",".join(policies),
                               "--workers", "2", "--out", out], capture_output=True, text=True,
                              env=exp_env(), timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"experiments sweep: exit {proc.returncode}: {proc.stderr}")
        for policy in policies:
            art = (arts[scenario] if policy == EXP_POLICY and scenario in arts
                   else run_one(scenario, policy, 0))
            got = (Path(out) / f"{scenario}__{policy}__seed0.json").read_text()
            if got != artifact_json(art):
                raise AssertionError(f"experiments sweep: {scenario} {policy}'s artifact differs "
                                     "from run_one's")
    log(f"[experiments] sweep --scenarios {scenario} --policies {','.join(policies)} --workers 2 "
        f"in {wall:.4f} s: each artifact equals run_one's, byte for byte")


def exp_specs():
    """The service's inbox: tools/service_crash_smoke.py's mixed workload,
    arrivals spread over simulated hours so the daemon is mid-schedule when
    it is killed."""
    return [{"name": f"smoke-{i:03d}", "model": EXP_SERVICE_MODELS[i % len(EXP_SERVICE_MODELS)],
             "n_gpus": [1, 2, 4, 8, 2, 16][i % 6], "gpu_hours": 0.3 + (i % 5) * 0.5,
             "arrival": i * 400.0} for i in range(EXP_SERVICE_SPECS)]


def exp_daemon(state, inbox, *extra):
    """The command line of the port's daemon on the service's scenario."""
    return [sys.executable, "-m", "repro_torch.service", "--state-dir", str(state),
            "--inbox", str(inbox), "--scenario", "smoke", "--events-per-tick", "5",
            "--snapshot-every", "25", "--tick-sleep", "0.01",
            "--overrides", json.dumps(EXP_SERVICE_OVERRIDES), *extra]


def exp_journal_counts(journal):
    counts = {"submit": 0, "snapshot": 0}
    if journal.exists():
        for line in journal.read_text().splitlines():
            try:
                kind = json.loads(line).get("type")
            except json.JSONDecodeError:
                continue  # a torn tail
            counts[kind] = counts.get(kind, 0) + 1
    return counts


def exp_service():
    """The port's daemon over an inbox of EXP_SERVICE_SPECS specs: once to
    its end and, beside it, once SIGKILLed after its journal shows a
    snapshot and every submit, then restarted with --exit-when-idle.  The
    two artifact.json digests must be equal, and equal to the pin."""
    specs = exp_specs()
    with tempfile.TemporaryDirectory(prefix="exp-service-") as work:
        work = Path(work)
        for run_dir in ("ref", "crash"):
            (work / run_dir / "inbox").mkdir(parents=True)
            for spec in specs:
                (work / run_dir / "inbox" / f"{spec['name']}.json").write_text(json.dumps(spec))
        state, journal = work / "crash" / "state", work / "crash" / "state" / "journal.jsonl"
        with open(work / "ref.out", "wb") as ref_out:
            t0 = time.perf_counter()
            ref_proc = subprocess.Popen(exp_daemon(work / "ref" / "state", work / "ref" / "inbox",
                                                   "--exit-when-idle"),
                                        env=exp_env(), stdout=ref_out, stderr=subprocess.STDOUT)
            proc = subprocess.Popen(exp_daemon(state, work / "crash" / "inbox", "--throttle",
                                               "0.05"), env=exp_env(), stdout=subprocess.DEVNULL)
            wall = None
            try:
                deadline = time.time() + EXP_KILL_TIMEOUT_S
                while True:
                    if wall is None and ref_proc.poll() is not None:
                        wall = time.perf_counter() - t0
                    counts = exp_journal_counts(journal)
                    if counts["snapshot"] >= 1 and counts["submit"] == EXP_SERVICE_SPECS:
                        break
                    if proc.poll() is not None:
                        raise AssertionError(f"experiments service: the daemon exited "
                                             f"({proc.returncode}) before it could be killed; "
                                             f"journal {counts}")
                    if time.time() > deadline:
                        raise AssertionError(f"experiments service: no snapshot within "
                                             f"{EXP_KILL_TIMEOUT_S} s; journal {counts}")
                    time.sleep(0.1)
                proc.send_signal(signal.SIGKILL)
                ref_proc.wait(timeout=600)
            finally:
                for p in (proc, ref_proc):
                    if p.poll() is None:
                        p.kill()
                    p.wait()
        if wall is None:
            wall = time.perf_counter() - t0
        if ref_proc.returncode != 0:
            raise AssertionError(f"experiments service: the uninterrupted daemon exited "
                                 f"{ref_proc.returncode}: {(work / 'ref.out').read_text()[-2000:]}")
        ref = json.loads((work / "ref" / "state" / "artifact.json").read_text())
        digest = exp_hold("service", ref)
        at_kill = exp_journal_counts(journal)
        subprocess.run(exp_daemon(state, work / "crash" / "inbox", "--exit-when-idle"),
                       check=True, env=exp_env(), timeout=600, capture_output=True)
        got = hashlib.sha256((state / "artifact.json").read_bytes()).hexdigest()
        want = hashlib.sha256((work / "ref" / "state" / "artifact.json").read_bytes()).hexdigest()
        if got != want:
            raise AssertionError(f"experiments service: the recovered artifact.json {got} "
                                 f"differs from the uninterrupted run's {want}")
    m = ref["metrics"]
    log(f"[experiments] service on smoke, {EXP_SERVICE_SPECS} specs, overrides "
        f"{json.dumps(EXP_SERVICE_OVERRIDES)}: uninterrupted run in {wall:.4f} s, n_finished "
        f"{m['n_finished']}, makespan {m['makespan']!r} s; SIGKILLed with its journal at "
        f"{at_kill}, restarted: artifact.json sha256 {got} equals the uninterrupted run's and "
        f"the pin ({digest})")


def phase_experiments():
    """The port's experiments, streamed replay with spill, sweep and online
    service on the card's host, held to the JAX package's artifacts by their
    digests (EXP_PINNED).  The memory runs, the sweep and the service run
    side by side, the memory runs from the start: each waits mostly on
    processes that start by importing torch."""
    with ThreadPoolExecutor(3) as pool:
        memory = pool.submit(exp_memory)
        arts = exp_cells()
        runs = [memory, pool.submit(exp_sweep, arts), pool.submit(exp_service)]
        for run in runs:
            run.result()


def tile_sweep():
    """Fixed and per-tile cost of the flash kernel's tensor-core route.  For
    each head dim of the route (128 with 8 kv heads, 256 with 1 kv head), the
    kernel's device time a call (device_ms over 20 calls, median of 4), bf16,
    non-causal, at three shapes of one wave: 8 batches x 16 heads x 128 query
    rows is 128 items, no more than the SMs, so each block runs one item, with
    1, 8 and 64 kv tiles an item.  Then
      per-tile cost  c = (t(64) - t(8)) / 56,
      fixed cost of an item  f = t(1) - c,
    which tell how much of a served shape's time is its items' fixed cost."""
    for d, kh in ((128, 8), (256, 1)):
        t = {}
        for n in SWEEP_TILES:
            case = (8, 128, n * WGMMA_BK[d], 16, kh, d, d, False, None, 0, None)
            q, k, v = case_inputs(case, torch.bfloat16, seed=0)
            kw = case_kwargs(case)
            t[n] = statistics.median(
                device_ms(lambda: fa_kernel.flash_attention_fwd(q, k, v, **kw), 20)
                for _ in range(4))
            flops = 2 * visible_pairs(case) * 2 * d
            log(f"[sweep] head dim {d}, {n} kv tiles an item, one wave of 128 items: "
                f"{t[n]:.4f} ms, {flops / t[n] / 1e9:.0f} TFLOP/s")
        c = (t[64] - t[8]) / 56
        log(f"[sweep] head dim {d}: per-tile cost {c * 1e3:.3f} us "
            f"({4 * 128 * WGMMA_BK[d] * d * 132 / c / 1e9:.0f} TFLOP/s were all 132 SMs at "
            f"it), fixed cost of an item {(t[1] - c) * 1e3:.3f} us")


# For each head dim D of the tensor-core backward: bwd_tile_sweep's shapes
# (B, Sq, Sk, H, KH) of the dK/dV and the dQ kernel, the length it sweeps
# left None, and the kv rows of a dQ step (Tiles<D> in
# flash_attention_bwd_sm90.cu).
BWD_SWEEP = {128: ((8, None, 128, 16, 8), (8, 128, None, 16, 8), 64),
             256: ((8, None, 64, 32, 16), (8, 128, None, 16, 1), 32)}


def bwd_tile_sweep():
    """Per-step and fixed cost of the backward's tensor-core kernels, bf16 at
    each head dim D of the route, non-causal, batch 8, each kernel's blocks
    in one wave: the dK/dV kernel with one kv tile a kv head (64 blocks of
    128 rows at D 128, 128 blocks of 64 at D 256), 2 query heads over each,
    at Sq 4096 and 8192 (128 and 256 q steps of 64 rows a block); the dQ
    kernel at Sq 128 (128 blocks) with Sk 4096 and 8192 (Sk / KROWS kv steps
    a block).  Per step c = (t(long) - t(short)) / steps more, and the
    tensor rate it implies for one SM: a dK/dV step is 4 products of 2 x 64
    x 64 x D FLOP in each of 2 consumers at D 128 and 4 of 2 x 64 x 64 x D
    split between them at D 256 (the same FLOP), a dQ step 3 products of
    2 x 64 x KROWS x D in each of 2 consumers.  Then the device time by
    kernel at each train path's shape (BWD_PATHS)."""
    for d, (dkdv, dq, krows) in BWD_SWEEP.items():
        for kernel, shape, steps, flops in (
                ("dkdv", dkdv, lambda n: 2 * n // 64, 2 * 4 * 2 * 64 * 64 * 128),
                ("dq", dq, lambda n: n // krows, 2 * 3 * 2 * 64 * krows * d)):
            cases = [tuple(n if x is None else x for x in shape) + (d, d, False, None, 0, None)
                     for n in (4096, 8192)]
            t = [bwd_device_ms(c)[kernel] for c in cases]
            n0, n1 = steps(4096), steps(8192)
            c = (t[1] - t[0]) / (n1 - n0)
            log(f"[sweep] backward at head dim {d}, {kernel}: {t[0]:.4f} ms at {n0} steps a "
                f"block, {t[1]:.4f} ms at {n1}; per step {c * 1e3:.3f} us = "
                f"{flops / c / 1e9:.3f} TFLOP/s on one SM (the card's peak is "
                f"{PEAK_BF16_FLOPS / 132 / 1e12:.3f}); fixed {(t[0] - n0 * c) * 1e3:.3f} us")
    for arch, (case, _, _) in BWD_PATHS.items():
        log(f"[sweep] backward, {arch} train shape, device ms a launch by kernel: "
            f"{json.dumps(bwd_device_ms(case))}")


def depth_probe(arch, depths):
    """One train step of arch at TRAIN_SHAPES[arch] at each of ``depths``
    layers in turn, as phase_train takes it (bf16, f32 AdamW state, remat
    full, from a fresh state): each depth's step time (host clock, the
    first step, so with its warm-up) and peak memory, until a depth runs out
    of memory.  The evidence for a TRAIN_CUTS depth."""
    batch_size, seq = TRAIN_SHAPES[arch]
    for n in depths:
        cfg = dataclasses.replace(get_config(arch), n_layers=n)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                    torch.bfloat16, "cuda")
            state = init_train_state(params)
            step_fn = make_train_step(cfg, remat="full", ce_chunk=TRAIN_CE_CHUNK)
            batch = train_batch(SyntheticLMDataset(cfg.vocab, seq, seed=0), 0, batch_size, cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = metrics["loss"].item()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            log(f"[depth-probe] {arch} at {n} of {get_config(arch).n_layers} layers, "
                f"{numel(params)} params, {batch_size} x {seq}: one step "
                f"{(time.perf_counter() - t0) * 1e3:.3f} ms, loss {loss:.4f}, "
                f"max_memory_allocated {peak} bytes, {memory_left(peak)}")
        except torch.cuda.OutOfMemoryError as err:
            log(f"[depth-probe] {arch} at {n} layers: out of memory "
                f"({str(err).splitlines()[0][:200]})")
            break
        finally:
            params = state = batch = metrics = None
    torch.cuda.empty_cache()


# --in-turns PARENT: the paths whose host clock moved beyond PERF.md §5's
# noise in a whole run, read from the parent tree and this one in turns on one
# card (parent, this, this, parent), each run a process of its own that
# imports its tree's chip_smoke.py and runs its phase_train and phase_serve
# (the serves without serve_against_plain).
IN_TURNS_TRAIN = ("qwen3-1.7b", "hubert-xlarge", "minicpm3-4b", "recurrentgemma-2b")
IN_TURNS_SERVE = ("qwen3-1.7b", "rwkv6-7b", "recurrentgemma-2b", "qwen2-moe-a2.7b",
                  "qwen3-moe-30b-a3b", "minicpm3-4b", "pixtral-12b")
_IN_TURNS_RUN = """
import json, re, sys
import torch
tree, out_path, train, serve = sys.argv[1:]
sys.path.insert(0, tree)
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
lines, log = [], cs.log
cs.log = lambda msg: (lines.append(msg), log(msg))
cs.SERVE_AGAINST_PLAIN = None
cs.phase_build()
out = {"train_ms": {}, "prefill_ms": {}, "decode_ms": {}}
for arch in train.split(","):
    out["train_ms"][arch] = cs.phase_train(arch)["step_ms"]
    torch.cuda.empty_cache()
for arch in serve.split(","):
    n = len(lines)
    cs.phase_serve(arch)
    torch.cuda.empty_cache()
    m = next(m for m in (re.search(r"prefill ([0-9.]+) ms; decode .* = ([0-9.]+) ms/step", x)
                         for x in lines[n:]) if m)
    out["prefill_ms"][arch], out["decode_ms"][arch] = float(m[1]), float(m[2])
with open(out_path, "w") as f:
    json.dump(out, f)
"""


def trees_in_turns(parent):
    """IN_TURNS_TRAIN's median train step and IN_TURNS_SERVE's prefill and
    decode ms a step (host clock, as phase_train and phase_serve read
    them) of the tree at ``parent`` and of this one, in turns: parent,
    this, this, parent, each in a process of its own.  Logs each run's
    readings and, by reading, the four values in that order."""
    here = str(Path(__file__).resolve().parent)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, tree) in enumerate((("parent", parent), ("change", here),
                                           ("change", here), ("parent", parent))):
            out = Path(tmp) / f"{i}.json"
            subprocess.run([sys.executable, "-c", _IN_TURNS_RUN, str(Path(tree).resolve()),
                            str(out), ",".join(IN_TURNS_TRAIN), ",".join(IN_TURNS_SERVE)],
                           check=True)
            runs.append(json.loads(out.read_text()))
            log(f"[in-turns] run {i + 1}, {label} ({tree}): {json.dumps(runs[-1])}")
    table = {f"{kind} {arch}": [r[kind][arch] for r in runs]
             for kind in ("train_ms", "prefill_ms", "decode_ms") for arch in runs[0][kind]}
    for what, v in table.items():
        log(f"[in-turns] {what}: parent {v[0]:.3f}, change {v[1]:.3f}, change {v[2]:.3f}, "
            f"parent {v[3]:.3f}; change over parent (means) {(v[1] + v[2]) / (v[0] + v[3]):.4f}")
    return table


def wkv_grad_routes():
    """The evidence for a train step's WKV forward route
    (wkv_kernel.route(..., grad=True)), reproducible by --wkv-grad-routes:
    rwkv6-7b's train slice (TRAIN_SLICES: 2 layers at full width, 2 x 200
    tokens), the gradients of loss_fn with the WKV forward launched on the
    chunk route or the chunk_exact route (bf16 only), on the recurrent
    route, or by the plain version, each with the backward kernel on each
    of its routes (chunk, bf16 only, and recurrent), against the plain
    path's (torch differentiating the plain version): each leaf's rel_err,
    the largest named, and in bf16 the largest |g| over its leaf's largest
    where a gradient changes sign between the paths (sign_flips, which the
    train slice holds to 2e-2).  At both seed pairs of WKV_SLICE_SEEDS; then
    phase_wkv_slice_cases, the forward routes' y on the slice's own WKV
    inputs."""
    arch, cut, batch_size, seq, patches = next(s for s in TRAIN_SLICES if s[0] == "rwkv6-7b")
    cfg = dataclasses.replace(get_config(arch), **cut)

    def on_route(rt):
        def fwd(r, k, v, w, u, s0=None, grad=False):
            wkv_kernel._check(r, k, v, w, u, s0)
            return wkv_kernel.launch(rt, r, k, v, w, u, s0)
        return fwd
    forwards = {"chunk": on_route("chunk"), "chunk_exact": on_route("chunk_exact"),
                "recurrent": on_route("recurrent"),
                "plain": lambda r, k, v, w, u, s0=None, grad=False: wkv_ref.rwkv6_reference(
                    r, k, v, w, u, s0)}
    for weights_seed, tokens_seed in WKV_SLICE_SEEDS:
        g = torch.Generator("cuda").manual_seed(tokens_seed)
        toks = torch.randint(0, cfg.vocab, (batch_size, seq + 1), generator=g, device="cuda")
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        for dtype in (torch.bfloat16, torch.float32):
            def grads():
                params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(weights_seed),
                                        dtype, "cuda")
                weights = leaves(params)
                for w in weights:
                    w.requires_grad_(True)
                loss, _ = lm.loss_fn(params, cfg, batch, remat="full", ce_chunk=TRAIN_CE_CHUNK)
                return dict(zip(paths(params), torch.autograd.grad(loss, weights)))
            with contextlib.ExitStack() as stack:
                for module, attr, plain in patches:
                    stack.enter_context(mock.patch.object(module, attr, plain))
                want = grads()
            for (name, fwd), bwd_rt in itertools.product(forwards.items(), wkv_kernel.BWD_ROUTES):
                if dtype != torch.bfloat16 and "chunk" in (name[:5], bwd_rt):
                    continue  # the chunked routes take bf16 only
                with mock.patch.object(wkv_ops, "rwkv6_wkv_fwd", fwd), mock.patch.object(
                        wkv_ops, "rwkv6_wkv_bwd", functools.partial(wkv_kernel.bwd_launch, bwd_rt)):
                    got = grads()
                rels = {p: rel_err(got[p], want[p]) for p in want}
                worst, tol = max(rels, key=rels.get), dict(SLICE_DTYPES)[dtype]
                flips = ""
                if dtype == torch.bfloat16:
                    ratios = {p: sign_flips(got[p], want[p], math.inf)[1] for p in want}
                    top = max(ratios, key=ratios.get)
                    flips = (f"; largest sign flip {ratios[top]:.4e} of its leaf's largest |g| "
                             f"({top})")
                log(f"[grad-routes] {arch} at {cut['n_layers']} layers, {batch_size}x{seq} "
                    f"tokens, seeds {weights_seed} (weights) and {tokens_seed} (tokens), "
                    f"{dtype_name(dtype)}, WKV forward {name}, backward {bwd_rt}: gradients "
                    f"against the plain path's, largest rel_err {rels[worst]:.4e} ({worst}), "
                    f"{sum(r > tol for r in rels.values())} of {len(rels)} leaves above the "
                    f"slice's {tol}{flips}; "
                    f"every leaf: {json.dumps({p: round(r, 6) for p, r in rels.items()})}")
                del got
            del want
            torch.cuda.empty_cache()
    phase_wkv_slice_cases()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    sweep = sys.argv[1:] == ["--tile-sweep"]
    routes = sys.argv[1:] == ["--wkv-grad-routes"]
    probe = (len(sys.argv) > 3 and sys.argv[1] == "--depth-probe" and sys.argv[2] in TRAIN_SHAPES
             and all(a.isdigit() for a in sys.argv[3:]))
    turns = (len(sys.argv) == 3 and sys.argv[1] == "--in-turns"
             and (Path(sys.argv[2]) / "chip_smoke.py").is_file())
    if sys.argv[1:] and not (sweep or routes or probe or turns):
        print(f"usage: {sys.argv[0]} [--tile-sweep | --wkv-grad-routes | --depth-probe ARCH "
              "LAYERS... | --in-turns PARENT_TREE]", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")

    seconds = {}  # each phase's wall time, by name

    def run(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[name] = round(seconds.get(name, 0.0) + time.perf_counter() - t0, 1)
        return out

    if turns:  # each run builds its own tree's kernels
        trees_in_turns(sys.argv[2])
        log(f"[done] {time.perf_counter() - t_start:.1f} s")
        return 0
    if probe:  # no kernel is built for it but those the path compiles at first use
        depth_probe(sys.argv[2], [int(a) for a in sys.argv[3:]])
        log(f"[done] {time.perf_counter() - t_start:.1f} s")
        return 0
    run("build", phase_build)
    if sweep or routes:
        if sweep:
            tile_sweep()
            bwd_tile_sweep()
        else:
            wkv_grad_routes()
        log(f"[done] {time.perf_counter() - t_start:.1f} s")
        return 0
    run("scheduler", phase_scheduler)
    run("experiments", phase_experiments)
    fa_worst = run("kernel cases", phase_kernel_cases)
    bwd_worst = run("bwd cases", phase_bwd_cases)
    run("autograd wiring", phase_autograd_wiring)
    wkv_worst = run("wkv cases", phase_wkv_cases)
    wkv_slice = run("wkv cases", phase_wkv_slice_cases)
    scan_worst = run("scan cases", phase_scan_cases)
    scan_bwd_worst = run("scan bwd cases", phase_scan_bwd_cases)
    wkv_bwd_worst = run("wkv bwd cases", phase_wkv_bwd_cases)
    run("slices", phase_slice)
    run("train slices", phase_train_slice)
    # The timings come before the serve and train phases: after a profiled
    # step of some 20,000 kernels the profiler's later sessions of a few
    # launches come back partial or empty, and ms_a_launch gives up after
    # PROFILE_TRIES empty sessions.
    fa_t = run("timings", phase_timings)
    bwd_t = run("timings", phase_bwd_timings)
    wkv_t = run("timings", phase_wkv_timings)
    scan_t = run("timings", phase_scan_timings)
    scan_bwd_t = run("timings", phase_scan_bwd_timings)
    wkv_bwd_t = run("timings", phase_wkv_bwd_timings)
    log(f"[timings] device_ms: {DEVICE_MS_TALLY['measurements']} measurements in "
        f"{DEVICE_MS_TALLY['runs']} timed runs")
    torch.cuda.empty_cache()
    run("sharded", phase_sharded)
    torch.cuda.empty_cache()
    by_path, routes_by_path, wkv_routes_by_path = {}, {}, {}
    for arch in SERVE_LAUNCHES:
        (params, cfg, prompt, by_path[arch], routes_by_path[arch],
         wkv_routes_by_path[arch]) = run(f"serve {arch}", phase_serve, arch)
        run(f"serve {arch}", phase_profile, params, cfg, prompt)
        del params  # free one model's weights before the next
        torch.cuda.empty_cache()
    train = {}
    for arch in TRAIN_SHAPES:  # one model's weights and state at a time
        train[arch] = run(f"train {arch}", phase_train, arch)
        torch.cuda.empty_cache()
    log(f"[done] {time.perf_counter() - t_start:.1f} s; by phase (s): {json.dumps(seconds)}")

    def launches(kernel, timed=None):
        """Each serve's launches of kernel, with timed[model] where given."""
        return (sum(counts[kernel] for counts in by_path.values()),
                [{"model": arch, "launches": counts[kernel], **(timed or {}).get(arch, {})}
                 for arch, counts in by_path.items()])

    def train_paths(kernel, timed=None):
        """Each train path's launches of kernel over its timed steps (by route
        for the flash kernels and the scan backward), with timed[model] where
        given."""
        entries = []
        for arch, t in train.items():
            n = sum(c[kernel] for c in t["launches"])
            if not n:
                continue
            entry = {"model": arch, "path": f"train, {t['n_layers']} layers, {TRAIN_STEPS} steps",
                     "launches": n,
                     "launches_per_step": t["launches"][0][kernel], **(timed or {}).get(arch, {})}
            if f"{kernel} by route" in t["launches"][0]:
                entry["launches_by_route"] = {
                    r: sum(c[f"{kernel} by route"][r] for c in t["launches"])
                    for r in t["launches"][0][f"{kernel} by route"]}
            entries.append(entry)
        return sum(e["launches"] for e in entries), entries

    def by_route(entries):
        return {r: sum(e["launches_by_route"][r] for e in entries) for r in fa_kernel.ROUTES}

    log(f"[train] summary: {json.dumps(train)}")
    fa_launches, fa_by_path = launches("flash_attention_fwd", fa_t)
    for entry in fa_by_path:
        entry["launches_by_route"] = routes_by_path[entry["model"]]
    n_train, fa_train = train_paths("flash_attention_fwd")
    fa_launches += n_train
    fa_by_path += fa_train
    bwd_launches, bwd_by_path = train_paths("flash_attention_bwd", bwd_t)
    wkv_launches, wkv_by_path = launches("rwkv6_wkv_fwd")
    for entry in wkv_by_path:
        entry["launches_by_route"] = wkv_routes_by_path[entry["model"]]
    n_train, wkv_train = train_paths("rwkv6_wkv_fwd")
    wkv_launches += n_train
    wkv_by_path += wkv_train
    wkv_bwd_launches, wkv_bwd_by_path = train_paths("rwkv6_wkv_bwd", {"rwkv6-7b": wkv_bwd_t})
    scan_launches, scan_by_path = launches("rglru_scan_fwd")
    n_train, scan_train = train_paths("rglru_scan_fwd")
    scan_launches += n_train
    scan_by_path += scan_train
    scan_bwd_launches, scan_bwd_by_path = train_paths("rglru_scan_bwd")
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_fwd_sm90.cu",
        "sources": {"wgmma": "src/repro_torch/kernels/flash_attention/csrc/"
                             "flash_attention_fwd_sm90.cu",
                    "simt": "src/repro_torch/kernels/flash_attention/csrc/"
                            "flash_attention_fwd.cu"},
        "replaces": "src/repro/kernels/flash_attention/kernel.py:82",
        "launches": fa_launches,
        "launches_by_route": by_route(fa_by_path),
        "by_path": fa_by_path,
        "max_abs_err": max(fa_worst.values()),
        "max_abs_err_by_dtype": fa_worst,
        **fa_t["qwen3-1.7b"],  # the first path's shape; by_path has each path's
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd_sm90.cu",
        "sources": {"wgmma": "src/repro_torch/kernels/flash_attention/csrc/"
                             "flash_attention_bwd_sm90.cu",
                    "simt": "src/repro_torch/kernels/flash_attention/csrc/"
                            "flash_attention_bwd.cu"},
        "replaces": "src/repro/kernels/flash_attention/kernel.py:82 (forward only: the Pallas "
                    "kernel has no backward; jax.grad differentiates the plain chunked "
                    "attention, src/repro/kernels/flash_attention/ops.py:36)",
        "launches": bwd_launches,
        "launches_by_route": by_route(bwd_by_path),
        "by_path": bwd_by_path,
        "max_abs_err": max(bwd_worst.values()),
        "max_abs_err_by_dtype": bwd_worst,
        **bwd_t["qwen3-1.7b"],  # the first path's shape; by_path has each path's
    }, {
        "name": "rwkv6_wkv_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6_wkv/csrc/rwkv6_wkv_fwd_sm90.cu",
        "sources": {"chunk": "src/repro_torch/kernels/rwkv6_wkv/csrc/rwkv6_wkv_fwd_sm90.cu",
                    "chunk_exact": "src/repro_torch/kernels/rwkv6_wkv/csrc/"
                                   "rwkv6_wkv_fwd_exact_sm90.cu (and rwkv6_wkv_chain_sm90.cuh)",
                    "recurrent": "src/repro_torch/kernels/rwkv6_wkv/csrc/rwkv6_wkv_fwd.cu"},
        "replaces": "src/repro/kernels/rwkv6_wkv/kernel.py:47",
        "launches": wkv_launches,
        "launches_by_route": {r: sum(e["launches_by_route"][r] for e in wkv_by_path)
                              for r in wkv_kernel.ROUTES},
        "by_path": wkv_by_path,
        "max_abs_err": max(wkv_worst.values()),
        "max_abs_err_by_dtype": wkv_worst,
        **wkv_t["prefill"],
        "library_ms": None,
        "decode": wkv_t["decode"],
        "train_shape": {k: wkv_bwd_t[k] for k in (
            "train_forward_route", "train_forward_ms", "recurrent_forward_ms",
            "chunk_forward_ms", "train_forward_bound_ms")},
        "slice_cases_rel_err": wkv_slice,
    }, {
        "name": "rglru_scan_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan_fwd.cu",
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:45",
        "launches": scan_launches,
        "by_path": scan_by_path,
        "max_abs_err": max(scan_worst.values()),
        "max_abs_err_by_dtype": scan_worst,
        **scan_t,
        "library_ms": None,
    }, {
        "name": "rglru_scan_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan_bwd.cu",
        "sources": {r: "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan_bwd.cu"
                    for r in scan_kernel.BWD_ROUTES},
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:45 (forward only: the Pallas "
                    "kernel has no backward; jax.grad differentiates the scan, "
                    "src/repro/kernels/rglru_scan/ref.py:14)",
        "launches": scan_bwd_launches,
        "launches_by_route": {r: sum(e["launches_by_route"][r] for e in scan_bwd_by_path)
                              for r in scan_kernel.BWD_ROUTES},
        "by_path": scan_bwd_by_path,
        "max_abs_err": max(scan_bwd_worst.values()),
        "max_abs_err_by_dtype": scan_bwd_worst,
        **scan_bwd_t,
        "library_ms": None,
    }, {
        "name": "rwkv6_wkv_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6_wkv/csrc/rwkv6_wkv_bwd_sm90.cu",
        "sources": {"chunk": "src/repro_torch/kernels/rwkv6_wkv/csrc/rwkv6_wkv_bwd_sm90.cu "
                             "(and rwkv6_wkv_chain_sm90.cuh)",
                    "recurrent": "src/repro_torch/kernels/rwkv6_wkv/csrc/rwkv6_wkv_bwd.cu"},
        "replaces": "src/repro/kernels/rwkv6_wkv/kernel.py:47 (forward only: the Pallas "
                    "kernel has no backward; jax.grad differentiates the plain recurrence, "
                    "src/repro/kernels/rwkv6_wkv/ref.py:14)",
        "launches": wkv_bwd_launches,
        "launches_by_route": {r: sum(e["launches_by_route"][r] for e in wkv_bwd_by_path)
                              for r in wkv_kernel.BWD_ROUTES},
        "by_path": wkv_bwd_by_path,
        "max_abs_err": max(wkv_bwd_worst.values()),
        "max_abs_err_by_dtype": wkv_bwd_worst,
        **wkv_bwd_t,
        "library_ms": None,
    }]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
