"""Wrapper of the hand-written CUDA flash-attention forward kernels.

The kernels replace the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention_kernel``.  They
are built with ``nvcc`` into one shared library with a plain C interface at
first use and called through ``ctypes`` on PyTorch's current stream.  The
library's entry point picks one of two kernels by ``route``:

* ``"wgmma"``: bf16 at (Dk, Dv) in ``WGMMA_HEAD_DIMS``, the served shapes,
  on the tensor cores (``csrc/flash_attention_fwd_sm90.cu``: wgmma, TMA);
* ``"simt"``: everything else, f32 FMAs on the CUDA cores
  (``csrc/flash_attention_fwd.cu``).  f32 stays there on purpose: its
  callers hold it to 1e-5 of the plain version, which TF32 would not meet.

The route is fixed by dtype and head dims; neither falls back to the other.
This wrapper takes CUDA tensors only and raises on anything the kernels do
not take; the CPU's plain version is ``ops.chunked_attention``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..build import Built, build_shared_library

SOURCES = [Path(__file__).parent / "csrc" / name
           for name in ("flash_attention_fwd.cu", "flash_attention_fwd_sm90.cu")]
# (Dk, Dv) pairs the kernels take; keep in step with the ``dispatch`` lines of
# the .cu files.  bf16 at WGMMA_HEAD_DIMS takes the tensor-core route.
HEAD_DIMS = frozenset({(16, 16), (32, 32), (64, 64), (80, 80), (96, 64), (128, 128),
                       (256, 256)})
WGMMA_HEAD_DIMS = frozenset({(128, 128), (256, 256)})
ROUTES = ("wgmma", "simt")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1


def route(dtype, dk: int, dv: int) -> str:
    """The kernel a launch goes to: ``"wgmma"`` for bf16 at WGMMA_HEAD_DIMS,
    else ``"simt"``.  The library's entry point applies the same rule."""
    return "wgmma" if dtype == torch.bfloat16 and (dk, dv) in WGMMA_HEAD_DIMS else "simt"


def build() -> Built:
    """Compile both kernels, one library, from the sources in this checkout
    (cached by hash)."""
    return build_shared_library("flash_attention_fwd", SOURCES)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().path))
    lib.flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 4          # q, k, v, o
        + [ctypes.c_int] * 12          # dtype, B, Sq, Sk, H, KH, Dk, Dv,
                                       # causal, window, q_offset, kv_len
        + [ctypes.c_float, ctypes.c_void_p])  # scale, stream
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_fwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, window, kv_len):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention_fwd: {name} is on {t.device}, not a CUDA device")
        if t.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention_fwd: {name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention_fwd: {name} must be 4-D (B, S, heads, D), "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_fwd: {name} must be contiguous")
        if any(s > _INT32_MAX for s in t.shape):
            raise ValueError(f"flash_attention_fwd: {name} has a dim beyond int32")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention_fwd: dtype {q.dtype} not supported "
                        f"(float32 or bfloat16)")
    B, _, H, Dk = q.shape
    Bk, Sk, KH, Dk2 = k.shape
    if (Bk, Dk2) != (B, Dk) or tuple(v.shape[:3]) != (B, Sk, KH):
        raise ValueError(f"flash_attention_fwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    if KH == 0 or H % KH:
        raise ValueError(f"flash_attention_fwd: {H} query heads are not a multiple "
                         f"of {KH} kv heads")
    if (Dk, v.shape[3]) not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head dims (Dk={Dk}, Dv={v.shape[3]}) "
                         f"not supported; supported: {sorted(HEAD_DIMS)}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_fwd: window must be >= 1, got {window}")
    if kv_len is not None and kv_len < 0:
        raise ValueError(f"flash_attention_fwd: kv_len must be >= 0, got {kv_len}")
    if route(q.dtype, Dk, v.shape[3]) == "wgmma":
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention_fwd: {name} must start on a 16-byte "
                                 "boundary for the tensor-core route (TMA)")


def flash_attention_fwd(q, k, v, *, causal=True, window=None, q_offset=0, kv_len=None):
    """Launch the kernel.  q: (B, Sq, H, Dk); k: (B, Sk, KH, Dk); v: (B, Sk, KH, Dv).

    Returns (B, Sq, H, Dv) in q.dtype.  Adds one to ``flash_attention_fwd.launches``
    and to ``flash_attention_fwd.launches_by_route[route(...)]`` for each launch.
    """
    _check(q, k, v, window, kv_len)
    B, Sq, H, Dk = q.shape
    Sk, KH, Dv = k.shape[1], k.shape[2], v.shape[3]
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPE_CODE[q.dtype], B, Sq, Sk, H, KH, Dk, Dv,
            int(causal), -1 if window is None else window, q_offset,
            Sk if kv_len is None else min(kv_len, Sk),
            1.0 / (Dk ** 0.5), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        msg = lib.flash_attention_fwd_error_string(err).decode()
        raise RuntimeError(f"flash_attention_fwd: launch failed with CUDA error {err}: {msg}")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.launches_by_route[route(q.dtype, Dk, Dv)] += 1
    return o


def reset_launches():
    """Set the launch counters to 0."""
    flash_attention_fwd.launches = 0
    flash_attention_fwd.launches_by_route = dict.fromkeys(ROUTES, 0)


reset_launches()
