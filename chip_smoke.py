#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from this checkout's sources, holds
each against its plain PyTorch version on the card, serves qwen3-1.7b (28
layers) and rwkv6-7b (32 layers) at their full published widths (bf16,
random weights from a seed) through the port's entry point, checks that
each serve went through its kernels, and times each kernel beside its
bound.  Any failure raises, so the exit code is
not 0.  With no CUDA device, or away from the checkout, it exits non-zero
and prints no result.  It imports nothing of JAX and nothing of ``repro``.

Standard output ends with a ``{"kernels": [...]}`` line and then the line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
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
from repro_torch.kernels.build import ptxas_summary  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import kernel as wkv_kernel  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ref as wkv_ref  # noqa: E402
from repro_torch.models import attention, lm, rwkv6  # noqa: E402
from repro_torch.serve import generate  # noqa: E402

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core rate, f32 rate outside
# the tensor cores, HBM3 bandwidth, and the L2 cache's size.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# Tolerance on ||out - ref|| / ||ref||.  Kernel and plain version both compute
# in f32 and round once to the output dtype, so in bf16 an element differs by
# at most one bf16 ulp, under 2**-7 of its value.
REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2**-7}
# (B, Sq, Sk, H, KH, Dk, Dv, causal, window, q_offset, kv_len): the six CASES
# of tests/test_kernels_attention.py, Dk 96 / Dv 64, kv_len < Sk, head dim 256
# and the qwen3-1.7b prefill shape.
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
    (8, 1024, 1024, 16, 8, 128, 128, True, None, 0, None),
]
PREFILL_CASE = KERNEL_CASES[-1]
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 1024, 64

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

# Each kernel by name, with the module that builds it; the module's function
# of the same name is its wrapper and carries its launch counter.
KERNELS = {"flash_attention_fwd": fa_kernel, "rwkv6_wkv_fwd": wkv_kernel}
# How the profiler names the kernels' device functions.
PORT_KERNEL_SYMBOLS = ("void (anonymous namespace)::attn_fwd<",
                       "void (anonymous namespace)::wkv_fwd<")


def log(msg):
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(numel(v) for v in tree.values())
    return tree.numel()


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def reset_launches():
    for name, mod in KERNELS.items():
        getattr(mod, name).launches = 0


def read_launches() -> dict:
    return {name: getattr(mod, name).launches for name, mod in KERNELS.items()}


def rel_err(out, ref) -> float:
    return ((out.float() - ref.float()).norm() / ref.float().norm()).item()


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
    """Both kernels at once: one nvcc for each source."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        futures = [pool.submit(mod.build) for mod in KERNELS.values()]
        builds = [f.result() for f in futures]
    for b in builds:
        log(f"[build] {b.path.name}: {b.seconds:.1f}s")
        for line in ptxas_summary(b.log):
            log(f"[build]   {line}")
    log(f"[build] both kernels in {time.perf_counter() - t0:.1f}s")


def phase_kernel_cases():
    """Each case in f32 and bf16: the kernel against its plain version."""
    worst = {}
    for n, case in enumerate(KERNEL_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = case_inputs(case, dtype, seed=n)
            out = fa_kernel.flash_attention_fwd(q, k, v, **case_kwargs(case))
            ref = fa_ops.chunked_attention(q, k, v, **case_kwargs(case))
            torch.cuda.synchronize()
            if out.shape != ref.shape or out.dtype != dtype:
                raise AssertionError(f"case {case} {dtype}: {out.shape} {out.dtype}")
            if not torch.isfinite(out.float()).all():
                raise AssertionError(f"case {case} {dtype}: non-finite output")
            err = (out.float() - ref.float()).abs().max().item()
            rel = rel_err(out, ref)
            name = dtype_name(dtype)
            log(f"[kernels] {case} {name}: max_abs_err {err:.3e} (tol {TOL[dtype]}), "
                f"rel_err {rel:.3e} (tol {REL_TOL[dtype]:.3e})")
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


def _slice_run(params, cfg, prompts, follow):
    """Prefill, then teacher-forced decode steps; the logits of each, and the cache."""
    cache = lm.init_cache(cfg, prompts.shape[0], prompts.shape[1] + follow.shape[1],
                          params["embed"].dtype, "cuda")
    logits, cache = lm.prefill(params, cfg, cache, tokens=prompts)
    out = [logits]
    for t in range(follow.shape[1]):
        logits, cache = lm.decode_step(params, cfg, cache, follow[:, t:t + 1])
        out.append(logits)
    return out, cache


# Per served model, at full width with 2 layers, 2 x 64 prompt tokens and 4
# decode steps: the module name the plain path patches, its plain version,
# the kernel, and the kernel path's launches (qwen3: one a layer in prefill,
# decode runs none; rwkv6: one a layer in prefill and in each decode step).
SLICES = [
    ("qwen3-1.7b", attention, "flash_attention", fa_ops.chunked_attention,
     "flash_attention_fwd", 2),
    ("rwkv6-7b", rwkv6, "rwkv6_wkv", wkv_ref.rwkv6_reference, "rwkv6_wkv_fwd", 2 * (1 + 4)),
]


def phase_slice():
    """Full width, 2 layers: the kernel path against the plain path, on the card.

    The plain path is the same model with the module's kernel entry point
    swapped for its plain version for this comparison; the kernel's launches
    are counted on each path.  Tolerance on ||a - b|| / ||b|| of the logits:
    1e-4 in f32 (the kernel and the plain version differ in the order of f32
    sums), 2e-2 in bf16 (one bf16 rounding of the kernel's output, carried
    through a layer); 1e-4 on the final recurrent state in f32.
    """
    for arch, module, attr, plain, kernel, want in SLICES:
        cfg = dataclasses.replace(get_config(arch), n_layers=2)
        g = torch.Generator("cuda").manual_seed(2)
        prompts = torch.randint(0, cfg.vocab, (2, 64), generator=g, device="cuda")
        follow = torch.randint(0, cfg.vocab, (2, 4), generator=g, device="cuda")
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(0), dtype, "cuda")
            reset_launches()
            kernel_path, kernel_cache = _slice_run(params, cfg, prompts, follow)
            kernel_launches = read_launches()[kernel]
            reset_launches()
            with mock.patch.object(module, attr, plain):
                plain_path, plain_cache = _slice_run(params, cfg, prompts, follow)
            plain_launches = read_launches()[kernel]
            log(f"[slice] {arch} {dtype_name(dtype)}: {kernel} launches {kernel_launches} on "
                f"the kernel path (expected {want}), {plain_launches} on the plain path "
                "(expected 0)")
            if (kernel_launches, plain_launches) != (want, 0):
                raise AssertionError(f"slice {arch} {dtype}: launches {kernel_launches} and "
                                     f"{plain_launches}, expected {want} and 0")
            for i, (a, b) in enumerate(zip(kernel_path, plain_path)):
                what = "prefill" if i == 0 else f"decode {i}"
                if not torch.isfinite(a).all():
                    raise AssertionError(f"slice {arch} {dtype} {what}: non-finite logits")
                rel = rel_err(a, b)
                log(f"[slice] {arch} full width, 2 layers, 2x64 tokens, {dtype_name(dtype)}, "
                    f"{what} logits: rel_err {rel:.3e} (tol {tol}), max_abs_err "
                    f"{(a - b).abs().max().item():.3e} of |logit| <= {b.abs().max().item():.1f}")
                if rel > tol:
                    raise AssertionError(f"slice {arch} {dtype} {what}: rel_err {rel} > {tol}")
            if "s" in kernel_cache["layers"] and dtype == torch.float32:
                rel = rel_err(kernel_cache["layers"]["s"], plain_cache["layers"]["s"])
                log(f"[slice] {arch} float32, final cache s: rel_err {rel:.3e} (tol 1e-4)")
                if rel > 1e-4:
                    raise AssertionError(f"slice {arch}: final state rel_err {rel} > 1e-4")
            del params


# Per served model, the launches each kernel must show in one serve of
# SERVE_BATCH x SERVE_PROMPT prompts and SERVE_NEW new tokens: qwen3-1.7b runs
# flash attention once a layer in prefill (decode uses decode_attention);
# rwkv6-7b runs the WKV kernel once a layer in prefill and in each of the
# SERVE_NEW - 1 decode steps.
SERVE_LAUNCHES = {
    "qwen3-1.7b": {"flash_attention_fwd": 28, "rwkv6_wkv_fwd": 0},
    "rwkv6-7b": {"flash_attention_fwd": 0, "rwkv6_wkv_fwd": 32 * SERVE_NEW},
}


def phase_serve(arch):
    """The main path: serve one model at full width through the entry point."""
    cfg = get_config(arch)
    params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(0), torch.bfloat16, "cuda")
    n_params = numel(params)
    prompts = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                            generator=torch.Generator("cuda").manual_seed(1), device="cuda")
    generate(params, cfg, prompts, 2, cache_dtype=torch.bfloat16)  # warm-up: cuBLAS, allocator
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    gen = generate(params, cfg, prompts, SERVE_NEW, cache_dtype=torch.bfloat16)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    steps = SERVE_NEW - 1
    log(f"[serve] {cfg.name}: {n_params} params bf16, {cfg.n_layers} layers, batch "
        f"{SERVE_BATCH} x {SERVE_PROMPT}-token prompts, {SERVE_NEW} new tokens")
    log(f"[serve] {cfg.name}: prefill {gen.prefill_s * 1e3:.3f} ms; decode {steps} steps in "
        f"{gen.decode_s * 1e3:.3f} ms = {gen.decode_s * 1e3 / steps:.3f} ms/step = "
        f"{SERVE_BATCH * steps / gen.decode_s:.1f} tokens/s; launches {launches} "
        f"(expected {SERVE_LAUNCHES[arch]}); max_memory_allocated {peak} bytes")
    log(f"[serve] {cfg.name} sample: {gen.tokens[0, :16].tolist()}")
    if gen.tokens.shape != (SERVE_BATCH, SERVE_NEW):
        raise AssertionError(f"serve {arch}: tokens of shape {tuple(gen.tokens.shape)}")
    if not ((gen.tokens >= 0) & (gen.tokens < cfg.padded_vocab)).all():
        raise AssertionError(f"serve {arch}: token ids out of the vocabulary")
    if not torch.isfinite(gen.prefill_logits).all():
        raise AssertionError(f"serve {arch}: non-finite prefill logits")
    if launches != SERVE_LAUNCHES[arch]:
        raise AssertionError(f"serve {arch}: kernel launches {launches}, "
                             f"expected {SERVE_LAUNCHES[arch]}")
    return params, cfg, prompts, launches


def phase_profile(params, cfg, prompts):
    """Device time by kernel over one prefill and over one decode step."""
    from torch.profiler import ProfilerActivity, profile
    cache = lm.init_cache(cfg, prompts.shape[0], prompts.shape[1] + 16, torch.bfloat16, "cuda")
    cur = prompts[:, :1]

    def run_prefill():
        lm.prefill(params, cfg, cache, tokens=prompts)

    def run_decode():
        lm.decode_step(params, cfg, {"pos": prompts.shape[1], "layers": cache["layers"]}, cur)

    for what, fn in (("prefill", run_prefill), ("decode step", run_decode)):
        fn()
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
            raise AssertionError(f"profile {cfg.name} {what}: the profiler saw no device activity")
        log(f"[profile] {cfg.name} {what}: host clock {host_ms:.3f} ms, device busy "
            f"{busy_ms:.3f} ms in {sum(e.count for e in kernels)} kernels, idle share "
            f"{1 - busy_ms / host_ms:.3f}")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x "
                f"{e.key[:90]}")
        for e in kernels:  # the port's own kernels, in or out of the top eight
            if e.key.startswith(PORT_KERNEL_SYMBOLS):
                log(f"[profile]   port kernel {e.key[:60]}: {e.count}x, device "
                    f"{e.self_device_time_total / 1e3 / e.count:.4f} ms a launch")


def device_ms(fn, iters) -> float:
    """Device time a call: the profiler's device time over iters calls, summed
    over every kernel and copy they launch, divided by iters.  Unlike time_ms
    it leaves out the host's time between launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    if busy_us <= 0:
        raise AssertionError("device_ms: the profiler saw no device activity")
    return busy_us / 1e3 / iters


def in_turns(fns, timer=time_ms):
    """Median of 4 runs of each (fn, iters), taken in turns: a b c, c b a, twice."""
    names = list(fns)
    times = {name: [] for name in names}
    for order in (names, names[::-1]) * 2:
        for name in order:
            fn, iters = fns[name]
            times[name].append(timer(fn, iters))
    return {name: statistics.median(t) for name, t in times.items()}, times


def phase_timings():
    """Kernel, plain version and the library call at the prefill shape, in turns."""
    q, k, v = case_inputs(PREFILL_CASE, torch.bfloat16, seed=123)
    kw = case_kwargs(PREFILL_CASE)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ms, times = in_turns({
        "kernel": (lambda: fa_kernel.flash_attention_fwd(q, k, v, **kw), 20),
        "plain": (lambda: fa_ops.chunked_attention(q, k, v, **kw), 10),
        # yardstick only: the port never calls it
        "library": (lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 50),
    })
    bound_ms, bound_by, flops, nbytes = attention_bound(PREFILL_CASE, torch.bfloat16)
    log(f"[timings] flash_attention_fwd at q {tuple(q.shape)} k,v {tuple(k.shape)} bf16 "
        f"causal, median of 4: kernel {ms['kernel']:.4f} ms; plain {ms['plain']:.4f} ms; "
        f"scaled_dot_product_attention {ms['library']:.4f} ms; bound {bound_ms:.4f} ms "
        f"by {bound_by} ({flops:.3e} FLOP, {nbytes} bytes)")
    log(f"[timings] all runs (ms): {json.dumps(times)}")
    return ms, bound_ms, bound_by


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")

    phase_build()
    fa_worst = phase_kernel_cases()
    wkv_worst = phase_wkv_cases()
    phase_slice()
    by_path = {}
    for arch in SERVE_LAUNCHES:
        params, cfg, prompts, by_path[arch] = phase_serve(arch)
        phase_profile(params, cfg, prompts)
        del params  # free one model's weights before the next
        torch.cuda.empty_cache()
    fa_ms, fa_bound_ms, fa_bound_by = phase_timings()
    wkv_t = phase_wkv_timings()
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    def launches(kernel):
        return (sum(counts[kernel] for counts in by_path.values()),
                [{"model": arch, "launches": counts[kernel]} for arch, counts in by_path.items()])

    fa_launches, fa_by_path = launches("flash_attention_fwd")
    wkv_launches, wkv_by_path = launches("rwkv6_wkv_fwd")
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:82",
        "launches": fa_launches,
        "by_path": fa_by_path,
        "max_abs_err": max(fa_worst.values()),
        "max_abs_err_by_dtype": fa_worst,
        "ms": fa_ms["kernel"],
        "plain_ms": fa_ms["plain"],
        "bound_ms": fa_bound_ms,
        "bound_by": fa_bound_by,
        "library_ms": fa_ms["library"],
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
    }]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
