#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from this checkout's sources, holds
each against its plain PyTorch version on the card, serves qwen3-1.7b at its
full published width (28 layers, bf16, random weights from a seed) through
the port's entry point, checks that the serve went through the kernels, and
times each kernel beside its bound.  Any failure raises, so the exit code is
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
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.build import ptxas_summary  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402
from repro_torch.serve import generate  # noqa: E402

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core rate and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

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
    b = fa_kernel.build()
    log(f"[build] {b.path.name}: {b.seconds:.1f}s")
    for line in ptxas_summary(b.log):
        log(f"[build]   {line}")


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
            rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
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


def _slice_run(params, cfg, prompts, follow):
    """Prefill, then teacher-forced decode steps; the logits of each."""
    cache = lm.init_cache(cfg, prompts.shape[0], prompts.shape[1] + follow.shape[1],
                          params["embed"].dtype, "cuda")
    logits, cache = lm.prefill(params, cfg, cache, tokens=prompts)
    out = [logits]
    for t in range(follow.shape[1]):
        logits, cache = lm.decode_step(params, cfg, cache, follow[:, t:t + 1])
        out.append(logits)
    return out


def phase_slice():
    """Full width, 2 layers: the kernel path against the plain path, on the card.

    The plain path is the same model with the attention module's
    ``flash_attention`` swapped for the plain version for this comparison.
    Tolerance on ||a - b|| / ||b|| of the logits: 1e-4 in f32 (the kernel and
    the plain version differ in the order of f32 sums), 2e-2 in bf16 (one
    bf16 rounding of the attention output, carried through a layer).
    """
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), n_layers=2)
    g = torch.Generator("cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab, (2, 64), generator=g, device="cuda")
    follow = torch.randint(0, cfg.vocab, (2, 4), generator=g, device="cuda")
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(0), dtype, "cuda")
        kernel_path = _slice_run(params, cfg, prompts, follow)
        with mock.patch.object(attention, "flash_attention", fa_ops.chunked_attention):
            plain_path = _slice_run(params, cfg, prompts, follow)
        for i, (a, b) in enumerate(zip(kernel_path, plain_path)):
            what = "prefill" if i == 0 else f"decode {i}"
            if not torch.isfinite(a).all():
                raise AssertionError(f"slice {dtype} {what}: non-finite logits")
            rel = ((a - b).norm() / b.norm()).item()
            if i in (0, len(kernel_path) - 1):
                log(f"[slice] full width, 2 layers, 2x64 tokens, {dtype_name(dtype)}, "
                    f"{what} logits: rel_err {rel:.3e} (tol {tol}), max_abs_err "
                    f"{(a - b).abs().max().item():.3e} of |logit| <= {b.abs().max().item():.1f}")
            if rel > tol:
                raise AssertionError(f"slice {dtype} {what}: rel_err {rel} > {tol}")
        del params


def phase_serve():
    """The main path: serve qwen3-1.7b at full width through the entry point."""
    cfg = get_config("qwen3-1.7b")
    params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(0), torch.bfloat16, "cuda")
    n_params = numel(params)
    prompts = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                            generator=torch.Generator("cuda").manual_seed(1), device="cuda")
    generate(params, cfg, prompts, 2, cache_dtype=torch.bfloat16)  # warm-up: cuBLAS, allocator
    torch.cuda.reset_peak_memory_stats()
    fa_kernel.flash_attention_fwd.launches = 0
    gen = generate(params, cfg, prompts, SERVE_NEW, cache_dtype=torch.bfloat16)
    launches = fa_kernel.flash_attention_fwd.launches
    peak = torch.cuda.max_memory_allocated()
    steps = SERVE_NEW - 1
    log(f"[serve] {cfg.name}: {n_params} params bf16, {cfg.n_layers} layers, batch "
        f"{SERVE_BATCH} x {SERVE_PROMPT}-token prompts, {SERVE_NEW} new tokens")
    log(f"[serve] prefill {gen.prefill_s * 1e3:.3f} ms; decode {steps} steps in "
        f"{gen.decode_s * 1e3:.3f} ms = {gen.decode_s * 1e3 / steps:.3f} ms/step = "
        f"{SERVE_BATCH * steps / gen.decode_s:.1f} tokens/s; flash_attention_fwd launches "
        f"{launches} (prefill, one a layer; decode runs none); max_memory_allocated {peak} bytes")
    log(f"[serve] sample: {gen.tokens[0, :16].tolist()}")
    if gen.tokens.shape != (SERVE_BATCH, SERVE_NEW):
        raise AssertionError(f"serve: tokens of shape {tuple(gen.tokens.shape)}")
    if not ((gen.tokens >= 0) & (gen.tokens < cfg.padded_vocab)).all():
        raise AssertionError("serve: token ids out of the vocabulary")
    if not torch.isfinite(gen.prefill_logits).all():
        raise AssertionError("serve: non-finite prefill logits")
    # prefill runs one launch per layer; decode uses decode_attention, no kernel
    if launches != cfg.n_layers:
        raise AssertionError(f"serve: {launches} kernel launches, expected {cfg.n_layers}")
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
            raise AssertionError(f"profile {what}: the profiler saw no device activity")
        log(f"[profile] {what}: host clock {host_ms:.3f} ms, device busy {busy_ms:.3f} ms "
            f"in {sum(e.count for e in kernels)} kernels, idle share {1 - busy_ms / host_ms:.3f}")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x "
                f"{e.key[:90]}")


def phase_timings():
    """Kernel, plain version and the library call at the prefill shape, in turns."""
    q, k, v = case_inputs(PREFILL_CASE, torch.bfloat16, seed=123)
    kw = case_kwargs(PREFILL_CASE)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    fns = {
        "kernel": (lambda: fa_kernel.flash_attention_fwd(q, k, v, **kw), 20),
        "plain": (lambda: fa_ops.chunked_attention(q, k, v, **kw), 10),
        # yardstick only: the port never calls it
        "library": (lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 50),
    }
    times = {name: [] for name in fns}
    for order in (("kernel", "plain", "library"), ("library", "plain", "kernel")) * 2:
        for name in order:
            fn, iters = fns[name]
            times[name].append(time_ms(fn, iters))
    ms = {name: statistics.median(t) for name, t in times.items()}
    bound_ms, bound_by, flops, nbytes = attention_bound(PREFILL_CASE, torch.bfloat16)
    log(f"[timings] flash_attention_fwd at q {tuple(q.shape)} k,v {tuple(k.shape)} bf16 "
        f"causal, median of 4: kernel {ms['kernel']:.4f} ms; plain {ms['plain']:.4f} ms; "
        f"scaled_dot_product_attention {ms['library']:.4f} ms; bound {bound_ms:.4f} ms "
        f"by {bound_by} ({flops:.3e} FLOP, {nbytes} bytes)")
    log(f"[timings] all runs (ms): {json.dumps(times)}")
    return ms, bound_ms, bound_by


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
    worst = phase_kernel_cases()
    phase_slice()
    params, cfg, prompts, launches = phase_serve()
    phase_profile(params, cfg, prompts)
    del params
    ms, bound_ms, bound_by = phase_timings()
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:82",
        "launches": launches,
        "max_abs_err": max(worst.values()),
        "max_abs_err_by_dtype": worst,
        "ms": ms["kernel"],
        "plain_ms": ms["plain"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": ms["library"],
    }]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
