#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

      python3 chip_smoke.py
    python3 chip_smoke.py --tile-sweep

Builds every CUDA kernel of the port from this checkout's sources, holds
each against its plain PyTorch version on the card, serves qwen3-1.7b (28
layers), rwkv6-7b (32 layers) and recurrentgemma-2b (26 layers) at their
full published widths (bf16, random weights from a seed) through the
port's entry point, trains qwen3-1.7b at full width for a few steps
(AdamW, chunked cross-entropy, remat), checks that each serve and each
train step went through its kernels, and times each kernel beside its
bound.  Any failure raises, so the exit code is
not 0.  With no CUDA device, or away from the checkout, it exits non-zero
and prints no result.  It imports nothing of JAX and nothing of ``repro``.

Standard output ends with a ``{"kernels": [...]}`` line and then the line
``{"ok": true, "device": {...}}``.

With ``--tile-sweep`` it builds the kernels and runs tile_sweep only: the
flash kernel's tensor-core route, its per-tile and per-item cost.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.kernels.build import ptxas_summary  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.rglru_scan import kernel as scan_kernel  # noqa: E402
from repro_torch.kernels.rglru_scan import ref as scan_ref  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import kernel as wkv_kernel  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ref as wkv_ref  # noqa: E402
from repro_torch.models import attention, lm, rglru, rwkv6  # noqa: E402
from repro_torch.optim import init_train_state  # noqa: E402
from repro_torch.serve import generate  # noqa: E402
from repro_torch.train import make_train_step, useful_flops  # noqa: E402
from repro_torch.tree import leaves, paths  # noqa: E402
from repro_torch.types import ShapeConfig  # noqa: E402

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core rate, f32 rate outside
# the tensor cores, HBM3 bandwidth, and the L2 cache's size.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# Tolerance on ||out - ref|| / ||ref||.  In f32 and on the SIMT route in bf16,
# kernel and plain version both compute in f32 and round once to the output
# dtype.  The tensor-core route (bf16 at head dims 128 and 256) also rounds P
# to bf16 before P V, a relative error of at most 2**-9 on each weight, which
# the normalisation by the same rounded weights' sum largely cancels; with the
# output's own rounding that stays under 2**-7.
REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2**-7}
# Each served model's prefill shape of the flash kernel, timed by
# phase_timings (a causal prefill over all keys, as sdpa_call assumes): qwen3-1.7b
# (8 x 1024 tokens, 16 heads over 8 kv heads of 128) and recurrentgemma-2b (8 x
# 4096 tokens, 10 heads padded to 16, 1 kv head of 256, a 2048-token window).
QWEN3_PREFILL = (8, 1024, 1024, 16, 8, 128, 128, True, None, 0, None)
RECURRENTGEMMA_PREFILL = (8, 4096, 4096, 16, 1, 256, 256, True, 2048, 0, None)
FLASH_PATHS = {"qwen3-1.7b": QWEN3_PREFILL, "recurrentgemma-2b": RECURRENTGEMMA_PREFILL}
# (B, Sq, Sk, H, KH, Dk, Dv, causal, window, q_offset, kv_len): the six CASES
# of tests/test_kernels_attention.py, Dk 96 / Dv 64, kv_len < Sk, head dim
# 256, hubert-xlarge's head dim 80 (bidirectional, 16 heads over 16); on the
# tensor-core route (in bf16) a ragged q_offset with GQA, a window spanning
# several tiles, and kv_len 0, where every row sees nothing and must be 0;
# then the two served prefill shapes.
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
    (2, 50, 50, 16, 16, 80, 80, False, None, 0, None),
    (2, 37, 93, 8, 2, 128, 128, True, None, 56, None),
    (1, 300, 300, 4, 1, 256, 256, True, 100, 0, None),
    (1, 64, 64, 4, 2, 128, 128, False, None, 0, 0),
    QWEN3_PREFILL,
    RECURRENTGEMMA_PREFILL,
]
SERVE_BATCH, SERVE_NEW = 8, 64
SERVE_PROMPT = {"qwen3-1.7b": 1024, "rwkv6-7b": 1024, "recurrentgemma-2b": 4096}

# (B, T, H, D, random s0, decay): the three shapes of
# tests/test_kernels_recurrence.py::test_rwkv6_kernel, a ragged T at D 64, the
# rwkv6-7b decode shape and its prefill shape.  decay "sigmoid" is that
# test's sigmoid(N(0,1)); "model" is the model's own exp(-exp(N(0,1))).
WKV_CASES = [
    (1, 16, 2, 8, True, "sigmoid"),
    (2, 64, 3, 16, True, "sigmoid"),
    (1, 48, 4, 32, True, "sigmoid"),
    (2, 37, 4, 64, True, "sigmoid"),
    (8, 1, 64, 64, True, "sigmoid"),
    (8, 1024, 64, 64, False, "sigmoid"),
    (8, 1024, 64, 64, False, "model"),
]
WKV_DECODE_CASE, WKV_PREFILL_CASE = WKV_CASES[4], WKV_CASES[5]
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
# qwen3-1.7b's train shape, which is its prefill shape.  Tolerance on
# ||out - ref|| / ||ref|| of each of dq, dk and dv: both sides compute in f32
# from the same inputs (1e-5: the order of the sums) and round once to the
# inputs' dtype (2**-7 in bf16).
BWD_CASES = [c for c in KERNEL_CASES if (c[5], c[6]) in fa_kernel.BWD_HEAD_DIMS]
QWEN3_TRAIN = QWEN3_PREFILL
BWD_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2**-7}

# Each kernel by name, with the module whose function of the same name is
# its wrapper and carries its launch counter, and the call that builds it.
KERNELS = {"flash_attention_fwd": fa_kernel, "flash_attention_bwd": fa_kernel,
           "rwkv6_wkv_fwd": wkv_kernel, "rglru_scan_fwd": scan_kernel}
BUILDS = {"flash_attention_fwd": fa_kernel.build, "flash_attention_bwd": fa_kernel.build_bwd,
          "rwkv6_wkv_fwd": wkv_kernel.build, "rglru_scan_fwd": scan_kernel.build}
# How the profiler names the kernels' device functions.
PORT_KERNEL_SYMBOLS = ("void (anonymous namespace)::attn_fwd<",
                       "void (anonymous namespace)::attn_fwd_wgmma<",
                       "void (anonymous namespace)::attn_bwd_stats<",
                       "void (anonymous namespace)::attn_bwd_dkdv<",
                       "void (anonymous namespace)::attn_bwd_dq<",
                       "void (anonymous namespace)::wkv_fwd<",
                       "void (anonymous namespace)::rglru_fwd<")


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


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def reset_launches():
    for name, mod in KERNELS.items():
        getattr(mod, name).launches = 0
    fa_kernel.reset_launches()  # flash's counts by route too


def read_launches() -> dict:
    return {name: getattr(mod, name).launches for name, mod in KERNELS.items()}


def read_flash_routes() -> dict:
    return dict(fa_kernel.flash_attention_fwd.launches_by_route)


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
        log(f"[build] {b.path.name}: nvcc {b.seconds:.1f}s")
        for line in ptxas_summary(b.log):
            log(f"[build]   {line}")
    log(f"[build] {len(builds)} kernels in {time.perf_counter() - t0:.1f}s")
    seen, faults = wgmma_ptxas_faults(builds["flash_attention_fwd"].log)
    if seen != len(fa_kernel.WGMMA_HEAD_DIMS) or faults:
        raise AssertionError(f"build: ptxas compiled {seen} instantiations of {WGMMA_SYMBOL} "
                             f"(expected {len(fa_kernel.WGMMA_HEAD_DIMS)}); faults: {faults}")
    log(f"[build] {seen} instantiations of {WGMMA_SYMBOL}: no spill, no serialized wgmma")


# Every tensor-core instantiation of the flash kernel has this in its name.
WGMMA_SYMBOL = "attn_fwd_wgmma"


def wgmma_ptxas_faults(log_text):
    """(instantiations of WGMMA_SYMBOL that ptxas compiled, the faults it
    reported for them): a spill store or load in one of them, or a note that
    it serialized wgmma instructions (C7512, C7513 and their kin, which say
    "serialized"), which only that kernel issues."""
    entry, seen, faults = "", 0, []
    for line in log_text.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry = m[1]
            seen += WGMMA_SYMBOL in entry
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            if WGMMA_SYMBOL in entry and (int(m[1]) or int(m[2])):
                faults.append(f"{entry}: {line.strip()}")
        elif re.search(r"\(C751[23]\)|serialized", line):
            faults.append(line.strip())
    return seen, faults


def phase_kernel_cases():
    """Each case in f32 and bf16: the kernel against its plain version."""
    worst = {}
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
    log(f"[kernels] largest error over {len(KERNEL_CASES)} cases: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return worst


def wkv_inputs(case, dtype, seed):
    """r, k, v ~ N(0,1)*0.5 and u ~ N(0,1)*0.5, as the JAX package's kernel test;
    s0 ~ N(0,1)*0.1 or None; w from the case's decay."""
    B, T, H, D, with_s0, decay = case
    g = torch.Generator("cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.float32)
    r, k, v = (randn(B, T, H, D) * 0.5 for _ in range(3))
    w = torch.sigmoid(randn(B, T, H, D)) if decay == "sigmoid" \
        else torch.exp(-torch.exp(randn(B, T, H, D)))
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
    """Each case in f32 and bf16: the WKV kernel against its plain version."""
    worst = {}
    for n, case in enumerate(WKV_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            args = wkv_inputs(case, dtype, seed=1000 + n)
            outs = dict(zip(("y", "s_last"), wkv_kernel.rwkv6_wkv_fwd(*args)))
            refs = dict(zip(("y", "s_last"), wkv_ref.rwkv6_reference(*args)))
            torch.cuda.synchronize()
            name = dtype_name(dtype)
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
                log(f"[wkv] {case} {name} {what}: max_abs_err {err:.3e} (tol {abs_tol}), "
                    f"rel_err {rel:.3e} (tol {tol:.3e}), max |ref| "
                    f"{ref.float().abs().max().item():.3f}")
                if abs_tol is not None and err > abs_tol:
                    raise AssertionError(f"wkv case {case} {name} {what}: "
                                         f"max_abs_err {err} > {abs_tol}")
                if rel > tol:
                    raise AssertionError(f"wkv case {case} {name} {what}: rel_err {rel} > {tol}")
                worst[name] = max(worst.get(name, 0.0), err)
    log(f"[wkv] largest error over {len(WKV_CASES)} cases: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return worst


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


def _slice_run(params, cfg, prompts, follow):
    """One path of the slice, with the launches of each part.  First a
    train-mode forward over the prompts: the final hidden state at every
    position.  Then prefill and teacher-forced decode steps on a cache of its
    own: the logits of each, a copy of the cache's leaves after prefill, and
    the cache's leaves at the end."""
    reset_launches()
    hidden, _ = lm.forward(params, cfg, tokens=prompts)
    forward_launches = read_launches()
    reset_launches()
    cache = lm.init_cache(cfg, prompts.shape[0], prompts.shape[1] + follow.shape[1],
                          params["embed"].dtype, "cuda")
    logits, cache = lm.prefill(params, cfg, cache, tokens=prompts)
    out = [logits]
    after_prefill = {name: t.clone() for name, t in cache_leaves(cache["layers"])}
    for t in range(follow.shape[1]):
        logits, cache = lm.decode_step(params, cfg, cache, follow[:, t:t + 1])
        out.append(logits)
    return (hidden, forward_launches, out, read_launches(), after_prefill,
            dict(cache_leaves(cache["layers"])))


# Per served model, at full width: the cut of the slice (layers, window), its
# prompt length, the entry points the plain path swaps for their plain
# versions, and the kernel path's launches in the train-mode forward and in
# prefill plus decode.  qwen3: flash once a layer in prefill, decode runs
# none.  rwkv6: WKV once a layer in prefill and in each decode step.
# recurrentgemma: layers rglru, rglru, attn_local, rglru, so a recurrent
# layer reads the attention kernel's output, and a 128-token window under 256
# prompt tokens, so the ring cache runs; the scan once a recurrent layer and
# flash once in prefill, decode runs neither.
SLICE_DECODE_STEPS = 4
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
]


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
    recurrence keeps almost nothing of an older state).
    """
    none = dict.fromkeys(KERNELS, 0)
    for arch, cut, prompt_len, patches, fwd_launches, launches in SLICES:
        cfg = dataclasses.replace(get_config(arch), **cut)
        want_fwd, want = {**none, **fwd_launches}, {**none, **launches}
        what_cut = ", ".join(f"{k} {v}" for k, v in cut.items())
        g = torch.Generator("cuda").manual_seed(2)
        prompts = torch.randint(0, cfg.vocab, (2, prompt_len), generator=g, device="cuda")
        follow = torch.randint(0, cfg.vocab, (2, SLICE_DECODE_STEPS), generator=g,
                               device="cuda")
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            label = f"{arch} full width, {what_cut}, 2x{prompt_len} tokens, {dtype_name(dtype)}"
            params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(0), dtype, "cuda")
            (kernel_hidden, kernel_fwd, kernel_path, kernel_launches, kernel_prefill,
             kernel_final) = _slice_run(params, cfg, prompts, follow)
            with contextlib.ExitStack() as stack:
                for module, attr, plain in patches:
                    stack.enter_context(mock.patch.object(module, attr, plain))
                (plain_hidden, plain_fwd, plain_path, plain_launches, plain_prefill,
                 plain_final) = _slice_run(params, cfg, prompts, follow)
            log(f"[slice] {label}: launches {kernel_fwd} in the train-mode forward and "
                f"{kernel_launches} in prefill and decode on the kernel path (expected "
                f"{want_fwd} and {want}), {plain_fwd} and {plain_launches} on the plain "
                "path (expected all 0)")
            if (kernel_fwd, kernel_launches, plain_fwd, plain_launches) != (
                    want_fwd, want, none, none):
                raise AssertionError(f"slice {label}: launches {kernel_fwd}, "
                                     f"{kernel_launches}, {plain_fwd} and {plain_launches}, "
                                     f"expected {want_fwd}, {want}, {none} and {none}")
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
                what = "prefill" if i == 0 else f"decode {i}"
                if not torch.isfinite(a).all():
                    raise AssertionError(f"slice {label} {what}: non-finite logits")
                rels.append(rel_err(a, b))
                log(f"[slice] {label}, {what} logits: rel_err {rels[-1]:.3e} (tol {tol}), "
                    f"max_abs_err {(a - b).abs().max().item():.3e} of |logit| <= "
                    f"{b.abs().max().item():.1f}")
                if rels[-1] > tol:
                    raise AssertionError(f"slice {label} {what}: rel_err {rels[-1]} > {tol}")
            if rels[0] > 0 and rels[1] == 0:
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
    """q, k, v and dout of a case in ``dtype``, and o, the plain forward's output."""
    q, k, v = case_inputs(case, dtype, seed)
    o = fa_ops.chunked_attention(q, k, v, **case_kwargs(case))
    g = torch.Generator("cuda").manual_seed(seed + 1)
    dout = torch.randn(o.shape, generator=g, device="cuda", dtype=torch.float32).to(dtype)
    return q, k, v, o, dout


def phase_bwd_cases():
    """Each backward case in f32 and bf16: the backward kernel's dq, dk and dv
    against its plain version on the same inputs and dout.  Each case's
    kernel call must add exactly one to the launch counter and the plain
    call none."""
    kernel = fa_kernel.flash_attention_bwd
    worst = {}
    for n, case in enumerate(BWD_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, o, dout = bwd_inputs(case, dtype, seed=3000 + n)
            before = kernel.launches
            outs = kernel(q, k, v, o, dout, **case_kwargs(case))
            mid = kernel.launches
            refs = fa_ref.flash_attention_bwd_reference(q, k, v, o, dout, **case_kwargs(case))
            torch.cuda.synchronize()
            name = dtype_name(dtype)
            if (mid - before, kernel.launches - mid) != (1, 0):
                raise AssertionError(f"bwd case {case} {name}: the kernel call launched "
                                     f"{mid - before} times and the plain call "
                                     f"{kernel.launches - mid}, expected 1 and 0")
            for what, out, ref, like in zip(("dq", "dk", "dv"), outs, refs, (q, k, v)):
                if out.shape != like.shape or out.dtype != dtype:
                    raise AssertionError(f"bwd case {case} {name} {what}: "
                                         f"{tuple(out.shape)} {out.dtype}")
                if not torch.isfinite(out.float()).all():
                    raise AssertionError(f"bwd case {case} {name} {what}: non-finite output")
                err = (out.float() - ref.float()).abs().max().item()
                rel = rel_err(out, ref)
                log(f"[bwd] {case} {name} {what}: max_abs_err {err:.3e}, rel_err {rel:.3e} "
                    f"(tol {BWD_REL_TOL[dtype]:.3e}), max |ref| "
                    f"{ref.float().abs().max().item():.3f}; launches: kernel call 1, plain call 0")
                if rel > BWD_REL_TOL[dtype]:
                    raise AssertionError(f"bwd case {case} {name} {what}: rel_err {rel} > "
                                         f"{BWD_REL_TOL[dtype]}")
                worst[name] = max(worst.get(name, 0.0), err)
    log(f"[bwd] largest error over {len(BWD_CASES)} cases: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return worst


def phase_autograd_wiring():
    """On CUDA tensors that require grad: flash_attention's output has a
    grad_fn, one forward launch, and its backward is one backward launch
    giving the backward kernel's own dq, dk and dv; the WKV and scan entry
    points, which have no backward kernel yet, raise."""
    case = BWD_CASES[0]
    q, k, v, _, dout = bwd_inputs(case, torch.float32, seed=99)
    leaf = [t.clone().requires_grad_(True) for t in (q, k, v)]
    reset_launches()
    out = fa_ops.flash_attention(*leaf, **case_kwargs(case))
    if out.grad_fn is None:
        raise AssertionError("autograd: flash_attention's output on the card has no grad_fn")
    grads = torch.autograd.grad(out, leaf, dout)
    counts = read_launches()
    want = fa_kernel.flash_attention_bwd(q, k, v, out.detach(), dout, **case_kwargs(case))
    if (counts["flash_attention_fwd"], counts["flash_attention_bwd"]) != (1, 1):
        raise AssertionError(f"autograd: launches {counts}, expected one forward, one backward")
    if any(not torch.equal(a, b) for a, b in zip(grads, want)):
        raise AssertionError("autograd: the gradients differ from the backward kernel's")
    refused = []
    wkv_args = wkv_inputs(WKV_CASES[0], torch.float32, seed=98)
    scan_args = list(scan_inputs(SCAN_CASES[0], torch.float32, seed=97))
    for name, fn, args in (("rwkv6_wkv", rwkv6.rwkv6_wkv, wkv_args),
                           ("rglru_scan", rglru.rglru_scan, scan_args)):
        args[0] = args[0].clone().requires_grad_(True)
        try:
            fn(*args)
        except NotImplementedError:
            refused.append(name)
    if refused != ["rwkv6_wkv", "rglru_scan"]:
        raise AssertionError(f"autograd: only {refused} refused inputs that require grad")
    log("[autograd] flash_attention on the card: grad_fn, 1 forward and 1 backward launch, "
        "gradients equal to the backward kernel's; rwkv6_wkv and rglru_scan refuse inputs "
        "that require grad")


# One train step with remat "full" launches the forward kernel 3L - L/k
# times (k layers a checkpointed group, each layer checkpointed inside it:
# PyTorch's nested non-reentrant checkpoints run a layer's forward in the
# step's forward, in its group's recompute and in its own, and the group's
# recompute serves the last layer of the group) and the backward kernel L
# times, L the attention layers.
def train_launches(n_layers, remat_group=8):
    k = next(g for g in (remat_group, 4, 2, 1) if n_layers % g == 0)
    return {**dict.fromkeys(KERNELS, 0),
            "flash_attention_fwd": 3 * n_layers - n_layers // k,
            "flash_attention_bwd": n_layers}


TRAIN_SLICE = ("qwen3-1.7b", {"n_layers": 2}, 2, 64)  # arch, cut, batch, tokens
TRAIN_CE_CHUNK = 512


def _train_slice_run(cfg, params, batch):
    """One path of the train slice: the gradients of loss_fn, then one
    make_train_step step from a fresh state, with each part's launches."""
    weights = leaves(params)
    for w in weights:
        w.requires_grad_(True)
    reset_launches()
    loss, _ = lm.loss_fn(params, cfg, batch, remat="full", ce_chunk=TRAIN_CE_CHUNK)
    grads = torch.autograd.grad(loss, weights)
    grad_launches = read_launches()
    step = make_train_step(cfg, remat="full", ce_chunk=TRAIN_CE_CHUNK)
    reset_launches()
    state, metrics = step(init_train_state(params), batch)
    return grads, grad_launches, metrics, state, read_launches()


def phase_train_slice():
    """qwen3-1.7b at full width and 2 layers, 2 x 64 tokens: the kernel path
    against the plain path (attention.flash_attention swapped for
    chunked_attention, which torch differentiates), in f32 and bf16.
    Tolerance on ||a - b|| / ||b||: 1e-4 in f32 (the kernels and the plain
    versions differ in the order of f32 sums), 2e-2 in bf16 (one bf16
    rounding of each kernel output, carried through the layers).  Held so:
    the loss, every gradient leaf, and after one make_train_step step the
    loss, grad_norm and every master leaf.  The first AdamW step moves an
    element by about lr * sign(g), so in bf16, where the two paths' gradients
    differ by up to tol of the leaf, an element whose gradient changes sign
    between them moves the other way: master is held on the elements whose
    gradients agree in sign, the count of the others is logged, and each of
    those must have |g| within tol of the leaf's largest (a sign flip beyond
    that fails); in f32 master is held on every element.  The f32 gradients must
    differ somewhere (they come from two computations).  Launches exact on
    each path: the kernel path train_launches(2) in each part, the plain
    path none."""
    arch, cut, batch_size, seq = TRAIN_SLICE
    cfg = dataclasses.replace(get_config(arch), **cut)
    none, want = dict.fromkeys(KERNELS, 0), train_launches(cfg.n_layers)
    g = torch.Generator("cuda").manual_seed(4)
    toks = torch.randint(0, cfg.vocab, (batch_size, seq + 1), generator=g, device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        label = f"{arch} full width, n_layers 2, {batch_size}x{seq} tokens, {dtype_name(dtype)}"

        def params():
            return lm.init_params(cfg, torch.Generator("cuda").manual_seed(0), dtype, "cuda")
        kernel = _train_slice_run(cfg, params(), batch)
        with mock.patch.object(attention, "flash_attention", fa_ops.chunked_attention):
            plain = _train_slice_run(cfg, params(), batch)
        log(f"[train-slice] {label}: launches {kernel[1]} in the gradient and {kernel[4]} in the "
            f"step on the kernel path (expected {want} each), {plain[1]} and {plain[4]} on the "
            "plain path (expected all 0)")
        if (kernel[1], kernel[4], plain[1], plain[4]) != (want, want, none, none):
            raise AssertionError(f"train slice {label}: launches {kernel[1]}, {kernel[4]}, "
                                 f"{plain[1]}, {plain[4]}")
        differ = 0
        for path, a, b in zip(paths(kernel[3]["params"]), kernel[0], plain[0]):
            rel = rel_err(a, b)
            differ += int(not torch.equal(a, b))
            log(f"[train-slice] {label}, gradient {path}: rel_err {rel:.3e} (tol {tol})")
            if not torch.isfinite(a.float()).all() or rel > tol:
                raise AssertionError(f"train slice {label}: gradient {path} rel_err {rel}")
        if dtype == torch.float32 and differ == 0:
            raise AssertionError(f"train slice {label}: the f32 gradients of the two paths agree "
                                 "bit for bit")
        for what in ("loss", "grad_norm"):
            a, b = kernel[2][what], plain[2][what]
            rel = rel_err(a, b)
            log(f"[train-slice] {label}, step {what}: {a.item():.6f} against {b.item():.6f}, "
                f"rel_err {rel:.3e} (tol {tol})")
            if not torch.isfinite(a) or rel > tol:
                raise AssertionError(f"train slice {label}: {what} rel_err {rel}")
        left_out = {}
        for path, a, b, gk, gp in zip(paths(kernel[3]["master"]), leaves(kernel[3]["master"]),
                                      leaves(plain[3]["master"]), kernel[0], plain[0]):
            held = torch.ones_like(a, dtype=torch.bool)
            if dtype == torch.bfloat16:
                held = torch.sign(gk.float()) == torch.sign(gp.float())
                top = gp.float().abs().max()
                flips = gp.float().abs()[~held]
                if flips.numel():
                    left_out[path] = (flips.numel(), round((flips.max() / top).item(), 6))
                if (flips > tol * top).any():
                    raise AssertionError(f"train slice {label}: {path}'s gradient changes sign "
                                         f"between the paths at |g| {flips.max().item()}, more "
                                         f"than {tol} of the leaf's largest {top.item()}")
            rel = rel_err(a[held], b[held])
            if not torch.isfinite(a).all() or rel > tol:
                raise AssertionError(f"train slice {label}: master {path} rel_err {rel}")
        log(f"[train-slice] {label}: {differ} of {len(kernel[0])} gradient leaves differ between "
            f"the paths; every master leaf after the step within {tol}; elements whose gradient "
            f"changes sign between the paths, left out (count, largest |g| over the leaf's "
            f"largest): {left_out or 'none'}")
        del kernel, plain


TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 3


def train_batch(data, step):
    return {k: torch.from_numpy(v).long().to("cuda")
            for k, v in data.batch(step, TRAIN_BATCH).items()}


def phase_train():
    """The main train path: qwen3-1.7b at full width, 28 layers, bf16, AdamW
    with f32 master, mu and nu, batches of 8 x 1024 from the port's
    SyntheticLMDataset, remat "full", ce_chunk 512; one warm-up step, then
    TRAIN_STEPS timed steps (host clock after a sync; the batch is made
    before the clock starts), the launch counters set to 0 before each and
    read after it; then one more step under the profiler."""
    cfg = get_config("qwen3-1.7b")
    params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(0), torch.bfloat16, "cuda")
    n_params = numel(params)
    state = init_train_state(params)
    data = SyntheticLMDataset(cfg.vocab, TRAIN_SEQ, seed=0)
    step_fn = make_train_step(cfg, remat="full", ce_chunk=TRAIN_CE_CHUNK)
    state, metrics = step_fn(state, train_batch(data, 0))  # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = train_launches(cfg.n_layers)
    want_routes = {"wgmma": want["flash_attention_fwd"], "simt": 0}
    times, launches, routes, losses = [], [], [], []
    for i in range(1, 1 + TRAIN_STEPS):
        batch = train_batch(data, i)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = metrics["loss"].item()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches.append(read_launches())
        routes.append(read_flash_routes())
        losses.append(loss)
        log(f"[train] step {i + 1}: {times[-1] * 1e3:.3f} ms, loss {loss:.4f}, grad_norm "
            f"{metrics['grad_norm'].item():.4f}, tokens {int(metrics['tokens'])}, launches "
            f"{launches[-1]}, flash by route {routes[-1]}")
        if not (math.isfinite(loss) and torch.isfinite(metrics["grad_norm"])):
            raise AssertionError(f"train: non-finite loss or grad_norm at step {i + 1}")
        if int(metrics["tokens"]) != TRAIN_BATCH * TRAIN_SEQ:
            raise AssertionError(f"train: {int(metrics['tokens'])} tokens in step {i + 1}")
        if launches[-1] != want or routes[-1] != want_routes:
            raise AssertionError(f"train: launches {launches[-1]} by route {routes[-1]} in step "
                                 f"{i + 1}, expected {want} and {want_routes}")
    peak = torch.cuda.max_memory_allocated()
    if int(state["step"]) != 1 + TRAIN_STEPS:
        raise AssertionError(f"train: state step {int(state['step'])}, expected {1 + TRAIN_STEPS}")
    bad = [p for p, t in zip(paths(state["params"]), leaves(state["params"]))
           if not torch.isfinite(t).all()]
    if bad:
        raise AssertionError(f"train: non-finite parameters {bad}")
    step_s = statistics.median(times)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = useful_flops(cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"))
    log(f"[train] {cfg.name}: {n_params} params bf16, {cfg.n_layers} layers, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, remat full, ce_chunk {TRAIN_CE_CHUNK}: step "
        f"{step_s * 1e3:.3f} ms (median of {TRAIN_STEPS}; {[round(t * 1e3, 3) for t in times]}), "
        f"{tokens / step_s:.1f} tokens/s, useful_flops {flops:.4e} = model-FLOP share "
        f"{flops / step_s / PEAK_BF16_FLOPS:.4f} of {PEAK_BF16_FLOPS:.0e}; "
        f"max_memory_allocated {peak} bytes; losses {losses}")
    batch = train_batch(data, 1 + TRAIN_STEPS)
    profile_call(f"{cfg.name} train step", lambda: step_fn(state, batch))
    del state, params
    return dict(step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
                model_flop_share=flops / step_s / PEAK_BF16_FLOPS, peak_bytes=peak,
                launches=launches, routes=routes)


# Per served model, the launches each kernel must show in one serve of
# SERVE_BATCH x SERVE_PROMPT prompts and SERVE_NEW new tokens: qwen3-1.7b runs
# flash attention once a layer in prefill (decode uses decode_attention);
# rwkv6-7b runs the WKV kernel once a layer in prefill and in each of the
# SERVE_NEW - 1 decode steps; recurrentgemma-2b runs flash (window 2048) once
# in each of its 8 attn_local layers and the scan once in each of its 18
# rglru layers, in prefill only (decode is plain, as in the JAX package).
SERVE_LAUNCHES = {
    "qwen3-1.7b": {"flash_attention_fwd": 28, "flash_attention_bwd": 0, "rwkv6_wkv_fwd": 0,
                   "rglru_scan_fwd": 0},
    "rwkv6-7b": {"flash_attention_fwd": 0, "flash_attention_bwd": 0,
                 "rwkv6_wkv_fwd": 32 * SERVE_NEW, "rglru_scan_fwd": 0},
    "recurrentgemma-2b": {"flash_attention_fwd": 8, "flash_attention_bwd": 0, "rwkv6_wkv_fwd": 0,
                          "rglru_scan_fwd": 18},
}
# Every served flash launch is bf16 at head dim 128 or 256: the tensor-core route.
SERVE_FLASH_ROUTES = {arch: {"wgmma": counts["flash_attention_fwd"], "simt": 0}
                      for arch, counts in SERVE_LAUNCHES.items()}


def phase_serve(arch):
    """The main path: serve one model at full width through the entry point."""
    cfg = get_config(arch)
    params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(0), torch.bfloat16, "cuda")
    n_params = numel(params)
    prompts = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT[arch]),
                            generator=torch.Generator("cuda").manual_seed(1), device="cuda")
    generate(params, cfg, prompts, 2, cache_dtype=torch.bfloat16)  # warm-up: cuBLAS, allocator
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    gen = generate(params, cfg, prompts, SERVE_NEW, cache_dtype=torch.bfloat16)
    launches, routes = read_launches(), read_flash_routes()
    peak = torch.cuda.max_memory_allocated()
    steps = SERVE_NEW - 1
    log(f"[serve] {cfg.name}: {n_params} params bf16, {cfg.n_layers} layers, batch "
        f"{SERVE_BATCH} x {SERVE_PROMPT[arch]}-token prompts, {SERVE_NEW} new tokens")
    log(f"[serve] {cfg.name}: prefill {gen.prefill_s * 1e3:.3f} ms; decode {steps} steps in "
        f"{gen.decode_s * 1e3:.3f} ms = {gen.decode_s * 1e3 / steps:.3f} ms/step = "
        f"{SERVE_BATCH * steps / gen.decode_s:.1f} tokens/s; launches {launches} "
        f"(expected {SERVE_LAUNCHES[arch]}), flash by route {routes} (expected "
        f"{SERVE_FLASH_ROUTES[arch]}); max_memory_allocated {peak} bytes")
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
    return params, cfg, prompts, launches, routes


def phase_profile(params, cfg, prompts):
    """Device time by kernel over one prefill and over one decode step."""
    cache = lm.init_cache(cfg, prompts.shape[0], prompts.shape[1] + 16, torch.bfloat16, "cuda")
    cur = prompts[:, :1]

    def run_prefill():
        lm.prefill(params, cfg, cache, tokens=prompts)

    def run_decode():
        lm.decode_step(params, cfg, {"pos": prompts.shape[1], "layers": cache["layers"]}, cur)

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
    is_causal for a causal case, the sliding window as a boolean attn_mask."""
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    Sq, Sk, window = case[1], case[2], case[8]
    if window is None:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    i = torch.arange(Sq, device="cuda")[:, None]
    j = torch.arange(Sk, device="cuda")[None, :]
    mask = (j <= i) & (j > i - window)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)


# Calls a timed run of (kernel, plain version, library) at each flash path's shape.
FLASH_ITERS = {"qwen3-1.7b": (100, 10, 100), "recurrentgemma-2b": (20, 2, 10)}


def phase_timings():
    """Kernel, plain version and the library call at each served prefill shape
    of the flash kernel, bf16, in turns, by CUDA events around back-to-back
    calls; then kernel and library again by device time a call (device_ms),
    which leaves out the host's time between launches (the kernel wrapper's
    checks, three tensor maps and a ctypes call), so that the two are
    compared on the card's time alone."""
    out = {}
    for arch, case in FLASH_PATHS.items():
        q, k, v = case_inputs(case, torch.bfloat16, seed=123)
        kw = case_kwargs(case)
        library = sdpa_call(q, k, v, case)  # yardstick only: the port never calls it
        lib_err = (library().transpose(1, 2).float()
                   - fa_kernel.flash_attention_fwd(q, k, v, **kw).float()).abs().max().item()
        it_kernel, it_plain, it_library = FLASH_ITERS[arch]
        ms, times = in_turns({
            "kernel": (lambda: fa_kernel.flash_attention_fwd(q, k, v, **kw), it_kernel),
            "plain": (lambda: fa_ops.chunked_attention(q, k, v, **kw), it_plain),
            "library": (library, it_library),
        })
        bound_ms, bound_by, flops, nbytes = attention_bound(case, torch.bfloat16)
        log(f"[timings] flash_attention_fwd, {arch} prefill: q {tuple(q.shape)} k,v "
            f"{tuple(k.shape)} bf16 causal, window {case[8]}, median of 4: kernel "
            f"{ms['kernel']:.4f} ms; plain {ms['plain']:.4f} ms; "
            f"scaled_dot_product_attention {ms['library']:.4f} ms (max_abs_err against the "
            f"kernel {lib_err:.3e}); bound {bound_ms:.4f} ms by {bound_by} ({flops:.3e} "
            f"FLOP, {nbytes} bytes)")
        log(f"[timings] all runs (ms): {json.dumps(times)}")
        dev, dev_times = in_turns({"kernel": (lambda: fa_kernel.flash_attention_fwd(q, k, v, **kw),
                                              it_kernel),
                                   "library": (library, it_library)}, device_ms)
        log(f"[timings] flash_attention_fwd, {arch} prefill, device time a call, median of 4: "
            f"kernel {dev['kernel']:.4f} ms; scaled_dot_product_attention "
            f"{dev['library']:.4f} ms; all runs (ms): {json.dumps(dev_times)}")
        out[arch] = dict(ms=ms["kernel"], plain_ms=ms["plain"], bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=ms["library"],
                         device_ms=dev["kernel"], library_device_ms=dev["library"])
    return out


def bwd_bound(case, dtype):
    """Least time on the card for the backward: q, k, v, o and dout read
    once, dq, dk and dv written once; the five products over the visible
    pairs (S = Q K^T, dP = dout V^T, dV = P^T dout, dQ = dS K, dK = dS^T Q)
    at the peak rate.  The larger of the two; and the FLOPs with stage (a)'s
    recompute of Q K^T."""
    B, Sq, Sk, H, KH, Dk, Dv = case[:7]
    item = torch.finfo(dtype).bits // 8
    nbytes = item * (2 * B * Sq * H * (Dk + Dv) + 2 * B * Sk * KH * (Dk + Dv))
    pairs = visible_pairs(case)
    flops = 2 * pairs * (3 * Dk + 2 * Dv)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops,
            nbytes, (flops + 2 * pairs * Dk) / PEAK_BF16_FLOPS * 1e3)


def phase_bwd_timings():
    """The backward kernel at qwen3-1.7b's train shape, bf16, in turns with its
    plain version and with the library's attention backward, by CUDA events
    around back-to-back calls.  The library has no backward alone: its time
    is SDPA forward + backward less SDPA forward, a yardstick only (the port
    never calls it)."""
    case = QWEN3_TRAIN
    kw = case_kwargs(case)
    q, k, v = case_inputs(case, torch.bfloat16, seed=124)
    o = fa_kernel.flash_attention_fwd(q, k, v, **kw)
    dout = torch.randn(o.shape, generator=torch.Generator("cuda").manual_seed(125),
                       device="cuda").to(torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    dt = dout.transpose(1, 2).contiguous()

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dt)
    mine = fa_kernel.flash_attention_bwd(q, k, v, o, dout, **kw)
    lib_err = max((a.transpose(1, 2).float() - b.float()).abs().max().item()
                  for a, b in zip(sdpa_fwd_bwd(), mine))
    ms, times = in_turns({
        "kernel": (lambda: fa_kernel.flash_attention_bwd(q, k, v, o, dout, **kw), 10),
        "plain": (lambda: fa_ref.flash_attention_bwd_reference(q, k, v, o, dout, **kw), 3),
        "sdpa_fwd_bwd": (sdpa_fwd_bwd, 20),
        "sdpa_fwd": (sdpa_fwd, 20),
    })
    library = ms["sdpa_fwd_bwd"] - ms["sdpa_fwd"]
    bound_ms, bound_by, flops, nbytes, with_a_ms = bwd_bound(case, torch.bfloat16)
    log(f"[timings] flash_attention_bwd, qwen3-1.7b train: q {tuple(q.shape)} k,v "
        f"{tuple(k.shape)} bf16 causal, median of 4: kernel {ms['kernel']:.4f} ms; plain "
        f"{ms['plain']:.4f} ms; scaled_dot_product_attention backward {library:.4f} ms (forward "
        f"+ backward {ms['sdpa_fwd_bwd']:.4f} less forward {ms['sdpa_fwd']:.4f}; its gradients "
        f"against the kernel's: max_abs_err {lib_err:.3e}); bound {bound_ms:.4f} ms by "
        f"{bound_by} ({flops:.3e} FLOP, {nbytes} bytes; {with_a_ms:.4f} ms with stage (a)'s "
        "recompute of Q K^T)")
    log(f"[timings] all runs (ms): {json.dumps(times)}")
    return dict(ms=ms["kernel"], plain_ms=ms["plain"], bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library)


def phase_wkv_timings():
    """The WKV kernel and its plain version at the rwkv6-7b prefill and decode
    shapes, bf16, in turns.  No single PyTorch call computes the recurrence,
    so there is no library time.  At the prefill shape, CUDA events around
    back-to-back calls.  At the decode shape a launch takes microseconds and
    back-to-back calls are bound by the wrapper's host cost, so ms and
    plain_ms are device time a call (device_ms), and host_ms is the kernel's
    time a call by CUDA events around back-to-back calls.  The decode calls
    cycle through input sets whose states fill twice the L2 cache, so each
    call reads its state from HBM, as a served decode step does."""
    out = {}
    for what, case, iters, timer in (("prefill", WKV_PREFILL_CASE, (10, 2), time_ms),
                                     ("decode", WKV_DECODE_CASE, (20, 1), device_ms)):
        B, _, H, D = case[:4]
        n_sets = 1 if timer is time_ms else -(-2 * L2_BYTES // (4 * B * H * D * D))
        sets = [wkv_inputs(case, torch.bfloat16, seed=321 + i) for i in range(n_sets)]
        fns = {"kernel": (lambda: [wkv_kernel.rwkv6_wkv_fwd(*a) for a in sets], iters[0]),
               "plain": (lambda: [wkv_ref.rwkv6_reference(*a) for a in sets], iters[1])}

        def per_call(timed):
            ms, times = timed
            return ({k: v / n_sets for k, v in ms.items()},
                    {k: [t / n_sets for t in v] for k, v in times.items()})
        ms, times = per_call(in_turns(fns, timer))
        bound_ms, bound_by, flops, nbytes, f32_ms = wkv_bound(case, torch.bfloat16)
        clock = "CUDA events" if timer is time_ms else "device time"
        log(f"[timings] rwkv6_wkv_fwd {what} {case[:4]} bf16, s0 "
            f"{'given' if case[4] else 'None'}, median of 4, {clock} a call over {n_sets} "
            f"input set(s): kernel {ms['kernel']:.4f} ms; plain {ms['plain']:.4f} ms; bound "
            f"{bound_ms:.4f} ms by {bound_by} ({flops:.3e} FLOP, {nbytes} bytes; the FLOPs "
            f"at the f32 rate {f32_ms:.4f} ms)")
        log(f"[timings] all runs (ms): {json.dumps(times)}")
        out[what] = dict(ms=ms["kernel"], plain_ms=ms["plain"], bound_ms=bound_ms,
                         bound_by=bound_by)
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


# Kv tile rows of the flash kernel's tensor-core route at each head dim, and
# the kv tiles an item that tile_sweep times.
WGMMA_BK = {128: 128, 256: 64}
SWEEP_TILES = (1, 8, 64)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    sweep = sys.argv[1:] == ["--tile-sweep"]
    if sys.argv[1:] and not sweep:
        print(f"usage: {sys.argv[0]} [--tile-sweep]", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")

    phase_build()
    if sweep:
        tile_sweep()
        log(f"[done] {time.perf_counter() - t_start:.1f} s")
        return 0
    fa_worst = phase_kernel_cases()
    bwd_worst = phase_bwd_cases()
    phase_autograd_wiring()
    wkv_worst = phase_wkv_cases()
    scan_worst = phase_scan_cases()
    phase_slice()
    phase_train_slice()
    by_path, routes_by_path = {}, {}
    for arch in SERVE_LAUNCHES:
        params, cfg, prompts, by_path[arch], routes_by_path[arch] = phase_serve(arch)
        phase_profile(params, cfg, prompts)
        del params  # free one model's weights before the next
        torch.cuda.empty_cache()
    train = phase_train()
    torch.cuda.empty_cache()
    fa_t = phase_timings()
    bwd_t = phase_bwd_timings()
    wkv_t = phase_wkv_timings()
    scan_t = phase_scan_timings()
    log(f"[timings] device_ms: {DEVICE_MS_TALLY['measurements']} measurements in "
        f"{DEVICE_MS_TALLY['runs']} timed runs")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    def launches(kernel, timed=None):
        return (sum(counts[kernel] for counts in by_path.values()),
                [{"model": arch, "launches": counts[kernel], **(timed or {}).get(arch, {})}
                 for arch, counts in by_path.items()])

    log(f"[train] summary: {json.dumps({k: v for k, v in train.items() if k != 'routes'})}")
    fa_launches, fa_by_path = launches("flash_attention_fwd", fa_t)
    for entry in fa_by_path:
        entry["launches_by_route"] = routes_by_path[entry["model"]]

    def train_path(kernel):
        n = sum(c[kernel] for c in train["launches"])
        return n, {"model": "qwen3-1.7b", "path": f"train, {TRAIN_STEPS} steps", "launches": n,
                   "launches_per_step": train["launches"][0][kernel]}
    n_train, train_entry = train_path("flash_attention_fwd")
    fa_launches += n_train
    fa_by_path.append({**train_entry, "launches_by_route": {
        r: sum(c[r] for c in train["routes"]) for r in fa_kernel.ROUTES}})
    bwd_launches, bwd_entry = train_path("flash_attention_bwd")
    wkv_launches, wkv_by_path = launches("rwkv6_wkv_fwd")
    scan_launches, scan_by_path = launches("rglru_scan_fwd")
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
        "launches_by_route": {r: sum(c[r] for c in routes_by_path.values())
                              + fa_by_path[-1]["launches_by_route"][r]
                              for r in fa_kernel.ROUTES},
        "by_path": fa_by_path,
        "max_abs_err": max(fa_worst.values()),
        "max_abs_err_by_dtype": fa_worst,
        **fa_t["qwen3-1.7b"],  # the first path's shape; by_path has each path's
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:82 (forward only: the Pallas "
                    "kernel has no backward; jax.grad differentiates the plain chunked "
                    "attention, src/repro/kernels/flash_attention/ops.py:36)",
        "launches": bwd_launches,
        "by_path": [bwd_entry],
        "max_abs_err": max(bwd_worst.values()),
        "max_abs_err_by_dtype": bwd_worst,
        **bwd_t,
    }, {
        "name": "rwkv6_wkv_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6_wkv/csrc/rwkv6_wkv_fwd.cu",
        "replaces": "src/repro/kernels/rwkv6_wkv/kernel.py:47",
        "launches": wkv_launches,
        "by_path": wkv_by_path,
        "max_abs_err": max(wkv_worst.values()),
        "max_abs_err_by_dtype": wkv_worst,
        **wkv_t["prefill"],
        "library_ms": None,
        "decode": wkv_t["decode"],
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
    }]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
