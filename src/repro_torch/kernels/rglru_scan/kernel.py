"""Wrapper of the hand-written CUDA kernel for the RG-LRU recurrence.

The kernel (``csrc/rglru_scan_fwd.cu``) replaces the Pallas TPU kernel
``repro/kernels/rglru_scan/kernel.py::rglru_scan_kernel``.  It is built with
``nvcc`` into a shared library with a plain C interface at first use and
called through ``ctypes`` on PyTorch's current stream.  This wrapper takes
CUDA tensors only and raises on anything the kernel does not take; the
CPU's plain version is ``ref.rglru_reference``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..build import Built, build_shared_library

SOURCES = [Path(__file__).parent / "csrc" / "rglru_scan_fwd.cu"]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_W_MAX = 2**31 - 1 - 128  # keep in step with the .cu's kThreads


def build() -> Built:
    """Compile the kernel from the sources in this checkout (cached by hash)."""
    return build_shared_library("rglru_scan_fwd", SOURCES)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().path))
    lib.rglru_scan_fwd.argtypes = (
        [ctypes.c_void_p] * 5          # a, b, h0 (may be null), h, h_last
        + [ctypes.c_int] * 4           # dtype, B, T, W
        + [ctypes.c_void_p])           # stream
    lib.rglru_scan_fwd.restype = ctypes.c_int
    lib.rglru_scan_fwd_error_string.argtypes = [ctypes.c_int]
    lib.rglru_scan_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_tensor(name, t, device):
    if t.device.type != "cuda":
        raise ValueError(f"rglru_scan_fwd: {name} is on {t.device}, not a CUDA device")
    if t.device != device:
        raise ValueError(f"rglru_scan_fwd: {name} is on {t.device}, a on {device}")
    if not t.is_contiguous():
        raise ValueError(f"rglru_scan_fwd: {name} must be contiguous")


def _check(a, b, h0):
    for name, t in (("a", a), ("b", b)):
        _check_tensor(name, t, a.device)
    if b.dtype != a.dtype or b.shape != a.shape:
        raise ValueError(f"rglru_scan_fwd: b is {b.dtype} {tuple(b.shape)}, "
                         f"a {a.dtype} {tuple(a.shape)}")
    if a.dim() != 3:
        raise ValueError(f"rglru_scan_fwd: a must be 3-D (B, T, W), got {tuple(a.shape)}")
    if a.dtype not in _DTYPE_CODE:
        raise TypeError(f"rglru_scan_fwd: dtype {a.dtype} not supported "
                        "(float32 or bfloat16)")
    B, T, W = a.shape
    if min(B, T, W) < 1 or max(B, T) > 2**31 - 1 or W > _W_MAX:
        raise ValueError(f"rglru_scan_fwd: B, T and W must be at least 1 and fit "
                         f"the kernel's int32 grid, got {(B, T, W)}")
    if h0 is not None:
        _check_tensor("h0", h0, a.device)
        if h0.dtype != torch.float32 or h0.shape != (B, W):
            raise ValueError(f"rglru_scan_fwd: h0 must be float32 of shape {(B, W)}, "
                             f"got {h0.dtype} {tuple(h0.shape)}")


def rglru_scan_fwd(a, b, h0=None):
    """Launch the kernel.  a, b: (B, T, W), f32 or bf16; h0: (B, W) f32, or
    None for a zero state.

    Returns (h (B, T, W) in a.dtype, h_last (B, W) f32).  Adds one to
    ``rglru_scan_fwd.launches`` for each launch.
    """
    _check(a, b, h0)
    B, T, W = a.shape
    h = torch.empty_like(a)
    h_last = torch.empty((B, W), dtype=torch.float32, device=a.device)
    lib = _library()
    with torch.cuda.device(a.device):
        err = lib.rglru_scan_fwd(
            a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
            h.data_ptr(), h_last.data_ptr(), _DTYPE_CODE[a.dtype], B, T, W,
            torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        msg = lib.rglru_scan_fwd_error_string(err).decode()
        raise RuntimeError(f"rglru_scan_fwd: launch failed with CUDA error {err}: {msg}")
    rglru_scan_fwd.launches += 1
    return h, h_last


rglru_scan_fwd.launches = 0
