"""Wrapper of the hand-written CUDA kernel for the RWKV6 WKV recurrence.

The kernel (``csrc/rwkv6_wkv_fwd.cu``) replaces the Pallas TPU kernel
``repro/kernels/rwkv6_wkv/kernel.py::rwkv6_wkv_kernel``.  It is built with
``nvcc`` into a shared library with a plain C interface at first use and
called through ``ctypes`` on PyTorch's current stream.  This wrapper takes
CUDA tensors only and raises on anything the kernel does not take; the
CPU's plain version is ``ref.rwkv6_reference``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..build import Built, build_shared_library

SOURCES = [Path(__file__).parent / "csrc" / "rwkv6_wkv_fwd.cu"]
# Head sizes the kernel is instantiated for; keep in step with the .cu.
HEAD_DIMS = frozenset({8, 16, 32, 64})
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1


def build() -> Built:
    """Compile the kernel from the sources in this checkout (cached by hash)."""
    return build_shared_library("rwkv6_wkv_fwd", SOURCES)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().path))
    lib.rwkv6_wkv_fwd.argtypes = (
        [ctypes.c_void_p] * 8          # r, k, v, w, u, s0 (may be null), y, s_last
        + [ctypes.c_int] * 5           # dtype, B, T, H, D
        + [ctypes.c_void_p])           # stream
    lib.rwkv6_wkv_fwd.restype = ctypes.c_int
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


def rwkv6_wkv_fwd(r, k, v, w, u, s0=None):
    """Launch the kernel.  r/k/v/w: (B, T, H, D), f32 or bf16; u: (H, D) f32;
    s0: (B, H, D, D) f32, or None for a zero state.

    Returns (y (B, T, H, D) in r.dtype, s_last (B, H, D, D) f32).  Adds one to
    ``rwkv6_wkv_fwd.launches`` for each launch.  Raises NotImplementedError
    when grad mode is on and an input requires grad: the kernel has no
    backward yet, and its output would silently carry none.
    """
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (r, k, v, w, u, s0)):
        raise NotImplementedError("rwkv6_wkv_fwd: the WKV kernel has no backward yet "
                                  "(ROADMAP.md B4); its output would carry no gradient")
    _check(r, k, v, w, u, s0)
    B, T, H, D = r.shape
    y = torch.empty_like(r)
    s_last = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    lib = _library()
    with torch.cuda.device(r.device):
        err = lib.rwkv6_wkv_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            None if s0 is None else s0.data_ptr(), y.data_ptr(), s_last.data_ptr(),
            _DTYPE_CODE[r.dtype], B, T, H, D,
            torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        msg = lib.rwkv6_wkv_fwd_error_string(err).decode()
        raise RuntimeError(f"rwkv6_wkv_fwd: launch failed with CUDA error {err}: {msg}")
    rwkv6_wkv_fwd.launches += 1
    return y, s_last


rwkv6_wkv_fwd.launches = 0
