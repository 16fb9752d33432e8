"""Wrappers of the hand-written CUDA kernels for the RWKV6 WKV recurrence,
forward and backward.

The forward kernels replace the Pallas TPU kernel
``repro/kernels/rwkv6_wkv/kernel.py::rwkv6_wkv_kernel``.  They are built with
``nvcc`` into one shared library with a plain C interface at first use and
called through ``ctypes`` on PyTorch's current stream.  The library exports
one entry point a route, and ``route()`` below, the rule's only copy, picks
it:

* ``"chunk"``: bf16 at head dim 64 (rwkv6-7b's) for T >= 2 with no gradient
  to take, the prefill, in chunks of 64 steps on the tensor cores
  (``csrc/rwkv6_wkv_fwd_sm90.cu``: wgmma, mma.sync, TMA);
* ``"chunk_exact"``: the same shapes when the launch is the forward of a
  gradient (training): the chunk-start states chained on the tensor cores
  with three-piece splits (``csrc/rwkv6_wkv_chain_sm90.cuh``), then each
  chunk walked from its state by the recurrent route's kernel, one block a
  (b, h, chunk), so that y is the recurrent route's f32 recurrence rounded
  once (``csrc/rwkv6_wkv_fwd_exact_sm90.cu``);
* ``"recurrent"``: everything else, a step at a time in f32 on the CUDA
  cores (``csrc/rwkv6_wkv_fwd.cu``): T = 1 (every decode step), f32 at every
  head dim (its callers hold it to 1e-5 of the plain version), and bf16 at
  head dims 8, 16 and 32.

No route falls back to another.  The backward (a library of its own) is the
forward's gradient, which the Pallas kernel does not have (on the TPU
``jax.grad`` differentiates the plain recurrence); ``bwd_route()`` picks its
entry point: ``"chunk"`` for bf16 at head dim 64 with T >= 2 (the chained
chunk states and gradients, then one block a (b, h, chunk),
``csrc/rwkv6_wkv_bwd_sm90.cu``), ``"recurrent"`` for the rest
(``csrc/rwkv6_wkv_bwd.cu``).  The forward wrapper called directly refuses
inputs that require grad; ``ops.rwkv6_wkv`` (``rwkv6_wkv_op``) runs both
kernels.  These wrappers take CUDA tensors only and raise on anything the
kernels do not take; the CPU's plain versions are ``ref.rwkv6_reference``
and ``ref.rwkv6_wkv_bwd_reference``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..build import Built, build_shared_library

_CSRC = Path(__file__).parent / "csrc"
SOURCES = [_CSRC / "rwkv6_wkv_fwd.cu", _CSRC / "rwkv6_wkv_fwd_sm90.cu",
           _CSRC / "rwkv6_wkv_fwd_exact_sm90.cu"]
BWD_SOURCES = [_CSRC / "rwkv6_wkv_bwd.cu", _CSRC / "rwkv6_wkv_bwd_sm90.cu"]
# Head sizes the recurrent kernel is instantiated for; keep in step with the .cu.
HEAD_DIMS = frozenset({8, 16, 32, 64})
# The route rule: bf16 at these head dims runs in chunks when T >= CHUNK_MIN_T.
CHUNK_HEAD_DIMS = frozenset({64})
CHUNK_MIN_T = 2
ROUTES = ("chunk", "chunk_exact", "recurrent")
BWD_ROUTES = ("chunk", "recurrent")
# Steps a chunk of the chained routes (kC in the chain header, which
# rwkv6_wkv_fwd_chunk_steps() and rwkv6_wkv_bwd_chunk_steps() return; the
# wrappers size the chunk states' scratch by it).
CHUNK_STEPS = 64
# Steps between the backward's checkpoints of the state (kC in the .cu, which
# rwkv6_wkv_bwd_checkpoint_steps() returns; the wrapper sizes the scratch by it).
CHECKPOINT_STEPS = 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1


def _chunked(dtype, D: int, T: int) -> bool:
    return dtype == torch.bfloat16 and D in CHUNK_HEAD_DIMS and T >= CHUNK_MIN_T


def route(dtype, D: int, T: int, grad: bool = False) -> str:
    """The forward kernel a launch goes to: for bf16 at CHUNK_HEAD_DIMS with
    T >= CHUNK_MIN_T, ``"chunk_exact"`` when ``grad`` is true and
    ``"chunk"`` when it is false; else ``"recurrent"``.  ``grad``: the
    launch is the forward of a gradient (``rwkv6_wkv_op`` in grad mode with an
    input that requires grad, ``ops.rwkv6_wkv_cuda``), which the backward
    kernel differentiates as the exact f32 recurrence; the chunk_exact route
    gives y as the recurrent route computes it from each chunk's state,
    rounded once, where the chunk route's further bf16 roundings (of r . P,
    of S_c, of the decayed r and k, of A) moved the bf16 gradients of
    rwkv6-7b's 2-layer train slice on the H100 by 2.2e-2 and, at a second
    seed, 1.2e-1 from the plain path's, beyond the slice's 2e-2 (PERF.md).
    The wrapper calls the entry point it names; nothing else decides."""
    if not _chunked(dtype, D, T):
        return "recurrent"
    return "chunk_exact" if grad else "chunk"


def bwd_route(dtype, D: int, T: int) -> str:
    """The backward kernel a launch goes to: ``"chunk"`` for bf16 at
    CHUNK_HEAD_DIMS with T >= CHUNK_MIN_T (rwkv6-7b's training), else
    ``"recurrent"`` (f32, the smaller head dims, T = 1).  The wrapper calls
    the entry point it names; nothing else decides."""
    return "chunk" if _chunked(dtype, D, T) else "recurrent"


def build() -> Built:
    """Compile the forward's three routes, one library, from the sources in
    this checkout (cached by hash)."""
    return build_shared_library("rwkv6_wkv_fwd", SOURCES)


def build_bwd() -> Built:
    """Compile the backward's two routes, a library of their own, from the
    sources in this checkout (cached by hash)."""
    return build_shared_library("rwkv6_wkv_bwd", BWD_SOURCES)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().path))
    # r, k, v, w, u, s0 (may be null), y, s_last, [dtype,] B, T, H, D, stream
    lib.rwkv6_wkv_fwd_recurrent.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.rwkv6_wkv_fwd_chunk.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    # the same, and the chunk states' scratch after s_last
    lib.rwkv6_wkv_fwd_chunk_exact.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    for entry in (lib.rwkv6_wkv_fwd_recurrent, lib.rwkv6_wkv_fwd_chunk,
                  lib.rwkv6_wkv_fwd_chunk_exact, lib.rwkv6_wkv_fwd_chunk_steps):
        entry.restype = ctypes.c_int
    lib.rwkv6_wkv_fwd_error_string.argtypes = [ctypes.c_int]
    lib.rwkv6_wkv_fwd_error_string.restype = ctypes.c_char_p
    _check_chunk_steps("rwkv6_wkv_fwd", lib.rwkv6_wkv_fwd_chunk_steps())
    return lib


def _check_chunk_steps(who, steps):
    if steps != CHUNK_STEPS:
        raise RuntimeError(f"{who}: the library's chunks are {steps} steps, the wrapper sizes "
                           f"its scratch for {CHUNK_STEPS}")


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_bwd().path))
    lib.rwkv6_wkv_bwd.argtypes = (
        [ctypes.c_void_p] * 17     # r, k, v, w, u, s0 (may be null), dy, ds_last (may be
                                   # null), dr, dk, dv, dw, du, ds0, ck, vdy, du_part
        + [ctypes.c_int] * 5       # dtype, B, T, H, D
        + [ctypes.c_void_p])       # stream
    lib.rwkv6_wkv_bwd_chunk.argtypes = (
        [ctypes.c_void_p] * 17     # r, k, v, w, u, s0 (may be null), dy, ds_last (may be
                                   # null), dr, dk, dv, dw, du, ds0, states, grads, du_part
        + [ctypes.c_int] * 4       # B, T, H, D
        + [ctypes.c_void_p])       # stream
    for entry in (lib.rwkv6_wkv_bwd, lib.rwkv6_wkv_bwd_chunk,
                  lib.rwkv6_wkv_bwd_checkpoint_steps, lib.rwkv6_wkv_bwd_chunk_steps):
        entry.restype = ctypes.c_int
    lib.rwkv6_wkv_bwd_chunk_error_string.argtypes = [ctypes.c_int]
    lib.rwkv6_wkv_bwd_chunk_error_string.restype = ctypes.c_char_p
    _check_chunk_steps("rwkv6_wkv_bwd", lib.rwkv6_wkv_bwd_chunk_steps())
    lib.rwkv6_wkv_bwd_error_string.argtypes = [ctypes.c_int]
    lib.rwkv6_wkv_bwd_error_string.restype = ctypes.c_char_p
    steps = lib.rwkv6_wkv_bwd_checkpoint_steps()
    if steps != CHECKPOINT_STEPS:
        raise RuntimeError(f"rwkv6_wkv_bwd: the library checkpoints every {steps} steps, "
                           f"the wrapper sizes its scratch for {CHECKPOINT_STEPS}")
    return lib


def _check_tensor(who, name, t, device):
    if t.device.type != "cuda":
        raise ValueError(f"{who}: {name} is on {t.device}, not a CUDA device")
    if t.device != device:
        raise ValueError(f"{who}: {name} is on {t.device}, r on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")


def _check_inputs(who, r, like_r, states, u):
    """r (B, T, H, D), f32 or bf16, and each tensor of ``like_r`` ({name:
    tensor}) alike, on one CUDA device, contiguous; u f32 (H, D) there; each
    of ``states`` ({name: tensor or None}) f32 (B, H, D, D) there, or None."""
    for name, t in (("r", r), *like_r.items()):
        _check_tensor(who, name, t, r.device)
        if t.dtype != r.dtype:
            raise TypeError(f"{who}: {name} is {t.dtype}, r is {r.dtype}")
        if t.shape != r.shape:
            raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, r {tuple(r.shape)}")
    if r.dim() != 4:
        raise ValueError(f"{who}: r must be 4-D (B, T, H, D), got {tuple(r.shape)}")
    if r.dtype not in _DTYPE_CODE:
        raise TypeError(f"{who}: dtype {r.dtype} not supported (float32 or bfloat16)")
    B, T, H, D = r.shape
    if min(B, T, H) < 1 or max(B, T, H) > _INT32_MAX:
        raise ValueError(f"{who}: B, T and H must lie in [1, 2**31), got {(B, T, H)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{who}: head dim {D} not supported; supported: {sorted(HEAD_DIMS)}")
    _check_tensor(who, "u", u, r.device)
    if u.dtype != torch.float32 or u.shape != (H, D):
        raise ValueError(f"{who}: u must be float32 of shape {(H, D)}, "
                         f"got {u.dtype} {tuple(u.shape)}")
    for name, t in states.items():
        if t is None:
            continue
        _check_tensor(who, name, t, r.device)
        if t.dtype != torch.float32 or t.shape != (B, H, D, D):
            raise ValueError(f"{who}: {name} must be float32 of shape {(B, H, D, D)}, "
                             f"got {t.dtype} {tuple(t.shape)}")


def _check_aligned(who, rt, tensors):
    """The chunked routes read whole 16-byte lines (TMA, vector loads)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{who}: {name} must start on a 16-byte boundary for the "
                             f"{rt} route")


def _check(r, k, v, w, u, s0, grad=False):
    _check_inputs("rwkv6_wkv_fwd", r, {"k": k, "v": v, "w": w}, {"s0": s0}, u)
    rt = route(r.dtype, r.shape[3], r.shape[1], grad)
    if rt != "recurrent":
        _check_aligned("rwkv6_wkv_fwd", rt, {"r": r, "k": k, "v": v, "w": w})


def _chunk_states(B, T, H, D, device):
    """Scratch of f32 D x D matrices, one a (b, h, chunk of CHUNK_STEPS)."""
    return torch.empty((B * H * -(-T // CHUNK_STEPS) * D * D,), dtype=torch.float32,
                       device=device)


def rwkv6_wkv_fwd(r, k, v, w, u, s0=None, grad=False):
    """Launch the kernel that ``route()`` names.  r/k/v/w: (B, T, H, D), f32
    or bf16; u: (H, D) f32; s0: (B, H, D, D) f32, or None for a zero state;
    grad: the launch is the forward of a gradient (``route()``).

    Returns (y (B, T, H, D) in r.dtype, s_last (B, H, D, D) f32).  Adds one to
    ``rwkv6_wkv_fwd.launches`` and to
    ``rwkv6_wkv_fwd.launches_by_route[route(...)]`` for each launch.  Raises
    NotImplementedError when grad mode is on and an input requires grad: its
    output would silently carry no gradient; ``ops.rwkv6_wkv`` (``rwkv6_wkv_op``)
    gives one.
    """
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (r, k, v, w, u, s0)):
        raise NotImplementedError("rwkv6_wkv_fwd: called directly on inputs that require "
                                  "grad, its output would carry no gradient; call "
                                  "ops.rwkv6_wkv, whose rwkv6_wkv_op runs the backward kernel")
    _check(r, k, v, w, u, s0, grad)
    return launch(route(r.dtype, r.shape[3], r.shape[1], grad), r, k, v, w, u, s0)


def launch(rt, r, k, v, w, u, s0):
    """One launch of route ``rt``'s kernel on inputs that ``_check`` passed,
    counted as ``rwkv6_wkv_fwd`` describes.  ``rwkv6_wkv_fwd`` calls it on
    the route ``route()`` names; chip_smoke.py also times the recurrent
    kernel through it at the prefill shape, beside the chunk route."""
    B, T, H, D = r.shape
    y = torch.empty_like(r)
    s_last = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    lib = _library()
    extra = []  # the recurrent entry takes the dtype; the chunk_exact one its scratch
    if rt == "recurrent":
        extra = [_DTYPE_CODE[r.dtype]]
    elif rt == "chunk_exact":
        states = _chunk_states(B, T, H, D, r.device)
        extra = [states.data_ptr()]
    with torch.cuda.device(r.device):
        err = getattr(lib, f"rwkv6_wkv_fwd_{rt}")(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            None if s0 is None else s0.data_ptr(), y.data_ptr(), s_last.data_ptr(),
            *extra, B, T, H, D, torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        msg = lib.rwkv6_wkv_fwd_error_string(err).decode()
        raise RuntimeError(f"rwkv6_wkv_fwd: launch failed with CUDA error {err}: {msg}")
    rwkv6_wkv_fwd.launches += 1
    rwkv6_wkv_fwd.launches_by_route[rt] += 1
    return y, s_last


def rwkv6_wkv_bwd(r, k, v, w, u, s0, dy, ds_last=None):
    """Launch the backward kernels on the route ``bwd_route()`` names.  r,
    k, v, w, u, s0: as ``rwkv6_wkv_fwd`` was given them (s0 None for a zero
    state); dy: the gradient of y, in r's shape and dtype; ds_last: the
    gradient of s_last, (B, H, D, D) f32, or None for zero.

    Returns (dr, dk, dv, dw) in r's dtype and shape, du (H, D) f32 and ds0
    (B, H, D, D) f32 (see ``ref.rwkv6_wkv_bwd_reference``).  Allocates the
    route's scratch for the call: the recurrent route's checkpoints of the
    state, B H ceil(T / CHECKPOINT_STEPS) D^2 f32; the chunk route's states
    and gradients at the chunks' edges, 2 B H ceil(T / CHUNK_STEPS) D^2 f32.
    Adds one to ``rwkv6_wkv_bwd.launches`` and to
    ``rwkv6_wkv_bwd.launches_by_route[bwd_route(...)]`` for each launch.
    """
    _check_inputs("rwkv6_wkv_bwd", r, {"k": k, "v": v, "w": w, "dy": dy},
                  {"s0": s0, "ds_last": ds_last}, u)
    return bwd_launch(bwd_route(r.dtype, r.shape[3], r.shape[1]), r, k, v, w, u, s0, dy,
                      ds_last)


def bwd_launch(rt, r, k, v, w, u, s0, dy, ds_last=None):
    """One launch of backward route ``rt`` on inputs that ``_check_inputs``
    passed, counted as ``rwkv6_wkv_bwd`` describes.  ``rwkv6_wkv_bwd`` calls
    it on the route ``bwd_route()`` names; chip_smoke.py also times the
    recurrent route through it at rwkv6-7b's train shape, beside the chunk
    route."""
    who = "rwkv6_wkv_bwd"
    B, T, H, D = r.shape
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    f32 = dict(dtype=torch.float32, device=r.device)
    du = torch.empty((H, D), **f32)
    ds0 = torch.empty((B, H, D, D), **f32)
    lib = _bwd_library()
    if rt == "chunk":  # states, grads, du_part
        _check_aligned(who, rt, {"r": r, "k": k, "v": v, "w": w, "dy": dy})
        scratch = (_chunk_states(B, T, H, D, r.device), _chunk_states(B, T, H, D, r.device),
                   torch.empty((B * H * -(-T // CHUNK_STEPS) * D,), **f32))
        entry, error_string, dtype = (lib.rwkv6_wkv_bwd_chunk,
                                      lib.rwkv6_wkv_bwd_chunk_error_string, [])
    else:  # ck, vdy, du_part
        scratch = (torch.empty((B * H * -(-T // CHECKPOINT_STEPS) * D * D,), **f32),
                   torch.empty((B * H * T,), **f32), torch.empty((B * H * D,), **f32))
        entry, error_string, dtype = (lib.rwkv6_wkv_bwd, lib.rwkv6_wkv_bwd_error_string,
                                      [_DTYPE_CODE[r.dtype]])
    with torch.cuda.device(r.device):
        err = entry(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            None if s0 is None else s0.data_ptr(), dy.data_ptr(),
            None if ds_last is None else ds_last.data_ptr(), dr.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dw.data_ptr(), du.data_ptr(), ds0.data_ptr(),
            *(x.data_ptr() for x in scratch), *dtype, B, T, H, D,
            torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"{who}: launch failed with CUDA error {err}: {msg}")
    rwkv6_wkv_bwd.launches += 1
    rwkv6_wkv_bwd.launches_by_route[rt] += 1
    return dr, dk, dv, dw, du, ds0


def reset_launches():
    """Set the launch counters to 0."""
    rwkv6_wkv_fwd.launches = 0
    rwkv6_wkv_fwd.launches_by_route = dict.fromkeys(ROUTES, 0)
    rwkv6_wkv_bwd.launches = 0
    rwkv6_wkv_bwd.launches_by_route = dict.fromkeys(BWD_ROUTES, 0)


reset_launches()
