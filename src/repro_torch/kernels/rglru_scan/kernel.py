"""Wrappers of the hand-written CUDA kernels for the RG-LRU recurrence,
forward and backward.

The forward (``csrc/rglru_scan_fwd.cu``) replaces the Pallas TPU kernel
``repro/kernels/rglru_scan/kernel.py::rglru_scan_kernel``; the backward
(``csrc/rglru_scan_bwd.cu``) is its gradient, which the Pallas kernel does
not have (on the TPU ``jax.grad`` differentiates the scan).  Each is built
with ``nvcc`` into a shared library of its own with a plain C interface at
first use and called through ``ctypes`` on PyTorch's current stream.  The
backward's library exports one entry point a route, and ``bwd_route()``
below, the rule's only copy, picks it:

* ``"tma"``: a, h and dh on 16-byte boundaries and a row of W elements a
  multiple of 16 bytes (recurrentgemma-2b's train shape among them), a ring
  in shared memory filled by TMA;
* ``"prefetch"``: any other contiguous tensors, the next 16 steps held in
  registers.

These wrappers take CUDA tensors only and raise on anything the kernels do
not take; the CPU's plain versions are ``ref.rglru_reference`` and
``ref.rglru_scan_bwd_reference``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..build import Built, build_shared_library

SOURCES = [Path(__file__).parent / "csrc" / "rglru_scan_fwd.cu"]
BWD_SOURCES = [Path(__file__).parent / "csrc" / "rglru_scan_bwd.cu"]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_W_MAX = 2**31 - 1 - 128  # keep in step with the .cu's widest block
BWD_ROUTES = ("tma", "prefetch")


def build() -> Built:
    """Compile the kernel from the sources in this checkout (cached by hash)."""
    return build_shared_library("rglru_scan_fwd", SOURCES)


def build_bwd() -> Built:
    """Compile the backward kernels, a library of their own, from the sources
    in this checkout (cached by hash)."""
    return build_shared_library("rglru_scan_bwd", BWD_SOURCES)


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


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_bwd().path))
    for rt in BWD_ROUTES:
        entry = getattr(lib, f"rglru_scan_bwd_{rt}")
        entry.argtypes = (
            [ctypes.c_void_p] * 8      # a, h, h0 (may be null), dh, dh_last (may be null),
                                       # da, db, dh0
            + [ctypes.c_int] * 4       # dtype, B, T, W
            + [ctypes.c_void_p])       # stream
        entry.restype = ctypes.c_int
    lib.rglru_scan_bwd_error_string.argtypes = [ctypes.c_int]
    lib.rglru_scan_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_tensor(who, name, t, device):
    if t.device.type != "cuda":
        raise ValueError(f"{who}: {name} is on {t.device}, not a CUDA device")
    if t.device != device:
        raise ValueError(f"{who}: {name} is on {t.device}, a on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")


def _check(who, a, like_a, states):
    """a (B, T, W), f32 or bf16, and each tensor of ``like_a`` ({name:
    tensor}) alike, on one CUDA device, contiguous; each of ``states``
    ({name: tensor or None}) f32 (B, W) there, or None."""
    _check_tensor(who, "a", a, a.device)
    for name, t in like_a.items():
        _check_tensor(who, name, t, a.device)
        if t.dtype != a.dtype or t.shape != a.shape:
            raise ValueError(f"{who}: {name} is {t.dtype} {tuple(t.shape)}, "
                             f"a {a.dtype} {tuple(a.shape)}")
    if a.dim() != 3:
        raise ValueError(f"{who}: a must be 3-D (B, T, W), got {tuple(a.shape)}")
    if a.dtype not in _DTYPE_CODE:
        raise TypeError(f"{who}: dtype {a.dtype} not supported (float32 or bfloat16)")
    B, T, W = a.shape
    if min(B, T, W) < 1 or max(B, T) > 2**31 - 1 or W > _W_MAX:
        raise ValueError(f"{who}: B, T and W must be at least 1 and fit "
                         f"the kernel's int32 grid, got {(B, T, W)}")
    for name, t in states.items():
        if t is None:
            continue
        _check_tensor(who, name, t, a.device)
        if t.dtype != torch.float32 or t.shape != (B, W):
            raise ValueError(f"{who}: {name} must be float32 of shape {(B, W)}, "
                             f"got {t.dtype} {tuple(t.shape)}")


def rglru_scan_fwd(a, b, h0=None):
    """Launch the kernel.  a, b: (B, T, W), f32 or bf16; h0: (B, W) f32, or
    None for a zero state.

    Returns (h (B, T, W) in a.dtype, h_last (B, W) f32).  Adds one to
    ``rglru_scan_fwd.launches`` for each launch.  Raises NotImplementedError
    when grad mode is on and an input requires grad: its output would
    silently carry no gradient; ``ops.rglru_scan`` (``rglru_scan_op``) gives one.
    """
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (a, b, h0)):
        raise NotImplementedError("rglru_scan_fwd: called directly on inputs that require "
                                  "grad, its output would carry no gradient; call "
                                  "ops.rglru_scan, whose rglru_scan_op runs the backward kernel")
    _check("rglru_scan_fwd", a, {"b": b}, {"h0": h0})
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



def bwd_route(a, h, dh) -> str:
    """The backward kernel a launch goes to: ``"tma"`` when a, h and dh each
    start on a 16-byte boundary and a row of W elements is a multiple of 16
    bytes (a TMA tensor map's rules; da and db are fresh allocations, which
    start on one), else ``"prefetch"``.  The wrapper calls the entry point it
    names; nothing else decides."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (a, h, dh))
    return "tma" if aligned and a.shape[-1] * a.element_size() % 16 == 0 else "prefetch"


def rglru_scan_bwd(a, h, h0, dh, dh_last=None):
    """Launch the backward kernel that ``bwd_route()`` names.  a, h0: as
    ``rglru_scan_fwd`` was given them (h0 None for a zero state); h: its
    output (B, T, W) in a.dtype; dh: the gradient of h, in h's shape and
    dtype; dh_last: the gradient of h_last, (B, W) f32, or None for zero.

    Returns (da, db) in a.dtype, a's shape, and dh0 (B, W) in f32 (see
    ``ref.rglru_scan_bwd_reference``).  Adds one to
    ``rglru_scan_bwd.launches`` and to
    ``rglru_scan_bwd.launches_by_route[bwd_route(...)]`` for each launch.
    """
    who = "rglru_scan_bwd"
    _check(who, a, {"h": h, "dh": dh}, {"h0": h0, "dh_last": dh_last})
    B, T, W = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty((B, W), dtype=torch.float32, device=a.device)
    lib = _bwd_library()
    rt = bwd_route(a, h, dh)
    with torch.cuda.device(a.device):
        err = getattr(lib, f"rglru_scan_bwd_{rt}")(
            a.data_ptr(), h.data_ptr(), None if h0 is None else h0.data_ptr(), dh.data_ptr(),
            None if dh_last is None else dh_last.data_ptr(), da.data_ptr(), db.data_ptr(),
            dh0.data_ptr(), _DTYPE_CODE[a.dtype], B, T, W,
            torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        msg = lib.rglru_scan_bwd_error_string(err).decode()
        raise RuntimeError(f"{who}: launch failed on the {rt} route with CUDA error {err}: "
                           f"{msg}")
    rglru_scan_bwd.launches += 1
    rglru_scan_bwd.launches_by_route[rt] += 1
    return da, db, dh0


def reset_launches():
    """Set the launch counters to 0."""
    rglru_scan_fwd.launches = 0
    rglru_scan_bwd.launches = 0
    rglru_scan_bwd.launches_by_route = dict.fromkeys(BWD_ROUTES, 0)


reset_launches()
