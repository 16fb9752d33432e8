"""Wrapper of the hand-written CUDA kernels for the RWKV6 WKV recurrence.

The kernels replace the Pallas TPU kernel
``repro/kernels/rwkv6_wkv/kernel.py::rwkv6_wkv_kernel``.  They are built with
``nvcc`` into one shared library with a plain C interface at first use and
called through ``ctypes`` on PyTorch's current stream.  The library exports
one entry point a route, and ``route()`` below, the rule's only copy, picks
it:

* ``"chunk"``: bf16 at head dim 64 (rwkv6-7b's) for T >= 2, the prefill, in
  chunks of 64 steps on the tensor cores (``csrc/rwkv6_wkv_fwd_sm90.cu``:
  wgmma, mma.sync, TMA);
* ``"recurrent"``: everything else, a step at a time in f32 on the CUDA
  cores (``csrc/rwkv6_wkv_fwd.cu``): T = 1 (every decode step), f32 at every
  head dim (its callers hold it to 1e-5 of the plain version), bf16 at head
  dims 8, 16 and 32.

Neither route falls back to the other.  This wrapper takes CUDA tensors only
and raises on anything the kernels do not take; the CPU's plain version is
``ref.rwkv6_reference``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..build import Built, build_shared_library

_CSRC = Path(__file__).parent / "csrc"
SOURCES = [_CSRC / "rwkv6_wkv_fwd.cu", _CSRC / "rwkv6_wkv_fwd_sm90.cu"]
# Head sizes the recurrent kernel is instantiated for; keep in step with the .cu.
HEAD_DIMS = frozenset({8, 16, 32, 64})
# The route rule: bf16 at these head dims runs in chunks when T >= CHUNK_MIN_T.
CHUNK_HEAD_DIMS = frozenset({64})
CHUNK_MIN_T = 2
ROUTES = ("chunk", "recurrent")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1


def route(dtype, D: int, T: int) -> str:
    """The kernel a launch goes to: ``"chunk"`` for bf16 at CHUNK_HEAD_DIMS
    with T >= CHUNK_MIN_T, else ``"recurrent"``.  The wrapper calls the entry
    point it names; nothing else decides."""
    chunk = dtype == torch.bfloat16 and D in CHUNK_HEAD_DIMS and T >= CHUNK_MIN_T
    return "chunk" if chunk else "recurrent"


def build() -> Built:
    """Compile both routes, one library, from the sources in this checkout
    (cached by hash)."""
    return build_shared_library("rwkv6_wkv_fwd", SOURCES)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().path))
    # r, k, v, w, u, s0 (may be null), y, s_last, [dtype,] B, T, H, D, stream
    lib.rwkv6_wkv_fwd_recurrent.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.rwkv6_wkv_fwd_chunk.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    for entry in (lib.rwkv6_wkv_fwd_recurrent, lib.rwkv6_wkv_fwd_chunk):
        entry.restype = ctypes.c_int
    lib.rwkv6_wkv_fwd_error_string.argtypes = [ctypes.c_int]
    lib.rwkv6_wkv_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_tensor(name, t, device):
    if t.device.type != "cuda":
        raise ValueError(f"rwkv6_wkv_fwd: {name} is on {t.device}, not a CUDA device")
    if t.device != device:
        raise ValueError(f"rwkv6_wkv_fwd: {name} is on {t.device}, r on {device}")
    if not t.is_contiguous():
        raise ValueError(f"rwkv6_wkv_fwd: {name} must be contiguous")


def _check(r, k, v, w, u, s0):
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        _check_tensor(name, t, r.device)
        if t.dtype != r.dtype:
            raise TypeError(f"rwkv6_wkv_fwd: {name} is {t.dtype}, r is {r.dtype}")
        if t.shape != r.shape:
            raise ValueError(f"rwkv6_wkv_fwd: {name} has shape {tuple(t.shape)}, "
                             f"r {tuple(r.shape)}")
    if r.dim() != 4:
        raise ValueError(f"rwkv6_wkv_fwd: r must be 4-D (B, T, H, D), got {tuple(r.shape)}")
    if r.dtype not in _DTYPE_CODE:
        raise TypeError(f"rwkv6_wkv_fwd: dtype {r.dtype} not supported "
                        "(float32 or bfloat16)")
    B, T, H, D = r.shape
    if min(B, T, H) < 1 or max(B, T, H) > _INT32_MAX:
        raise ValueError(f"rwkv6_wkv_fwd: B, T and H must lie in [1, 2**31), "
                         f"got {(B, T, H)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"rwkv6_wkv_fwd: head dim {D} not supported; "
                         f"supported: {sorted(HEAD_DIMS)}")
    _check_tensor("u", u, r.device)
    if u.dtype != torch.float32 or u.shape != (H, D):
        raise ValueError(f"rwkv6_wkv_fwd: u must be float32 of shape {(H, D)}, "
                         f"got {u.dtype} {tuple(u.shape)}")
    if s0 is not None:
        _check_tensor("s0", s0, r.device)
        if s0.dtype != torch.float32 or s0.shape != (B, H, D, D):
            raise ValueError(f"rwkv6_wkv_fwd: s0 must be float32 of shape {(B, H, D, D)}, "
                             f"got {s0.dtype} {tuple(s0.shape)}")
    if route(r.dtype, D, T) == "chunk":
        for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
            if t.data_ptr() % 16:
                raise ValueError(f"rwkv6_wkv_fwd: {name} must start on a 16-byte boundary "
                                 "for the chunk route (TMA)")


def rwkv6_wkv_fwd(r, k, v, w, u, s0=None):
    """Launch the kernel that ``route()`` names.  r/k/v/w: (B, T, H, D), f32
    or bf16; u: (H, D) f32; s0: (B, H, D, D) f32, or None for a zero state.

    Returns (y (B, T, H, D) in r.dtype, s_last (B, H, D, D) f32).  Adds one to
    ``rwkv6_wkv_fwd.launches`` and to
    ``rwkv6_wkv_fwd.launches_by_route[route(...)]`` for each launch.  Raises
    NotImplementedError when grad mode is on and an input requires grad: the
    kernels have no backward yet, and their output would silently carry none.
    """
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (r, k, v, w, u, s0)):
        raise NotImplementedError("rwkv6_wkv_fwd: the WKV kernel has no backward yet "
                                  "(ROADMAP.md B4); its output would carry no gradient")
    _check(r, k, v, w, u, s0)
    return launch(route(r.dtype, r.shape[3], r.shape[1]), r, k, v, w, u, s0)


def launch(rt, r, k, v, w, u, s0):
    """One launch of route ``rt``'s kernel on inputs that ``_check`` passed,
    counted as ``rwkv6_wkv_fwd`` describes.  ``rwkv6_wkv_fwd`` calls it on
    the route ``route()`` names; chip_smoke.py also times the recurrent
    kernel through it at the prefill shape, beside the chunk route."""
    B, T, H, D = r.shape
    y = torch.empty_like(r)
    s_last = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    lib = _library()
    dtype = [] if rt == "chunk" else [_DTYPE_CODE[r.dtype]]
    with torch.cuda.device(r.device):
        err = getattr(lib, f"rwkv6_wkv_fwd_{rt}")(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            None if s0 is None else s0.data_ptr(), y.data_ptr(), s_last.data_ptr(),
            *dtype, B, T, H, D, torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        msg = lib.rwkv6_wkv_fwd_error_string(err).decode()
        raise RuntimeError(f"rwkv6_wkv_fwd: launch failed with CUDA error {err}: {msg}")
    rwkv6_wkv_fwd.launches += 1
    rwkv6_wkv_fwd.launches_by_route[rt] += 1
    return y, s_last


def reset_launches():
    """Set the launch counters to 0."""
    rwkv6_wkv_fwd.launches = 0
    rwkv6_wkv_fwd.launches_by_route = dict.fromkeys(ROUTES, 0)


reset_launches()
