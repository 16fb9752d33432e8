"""Wrappers of the hand-written CUDA flash-attention kernels, forward and backward.

The kernels replace the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention_kernel``.  They
are built with ``nvcc`` into two shared libraries with a plain C interface
(forward, backward) at first use and called through ``ctypes`` on PyTorch's
current stream.  Each library exports one entry point a route, and
``route()`` below, the rule's only copy, picks it:

* ``"wgmma"``: bf16 at (Dk, Dv) in ``WGMMA_HEAD_DIMS`` (forward: the served
  shapes) or ``BWD_WGMMA_HEAD_DIMS`` (backward: the trained shapes), 128
  and 256, MLA's (96, 64) and hubert-xlarge's (80, 80), on the tensor cores
  (``csrc/flash_attention_fwd_sm90.cu``, ``csrc/flash_attention_bwd_sm90.cu``:
  wgmma, TMA);
* ``"simt"``: everything else, f32 FMAs on the CUDA cores
  (``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``).  f32
  stays there on purpose: its callers hold it to 1e-5 of the plain version,
  which TF32 would not meet.

Neither route falls back to the other.  The backward is the gradient of
what the forward computes, at (Dk, Dv) in ``BWD_HEAD_DIMS``; it reads each
row's log-sum-exp, which the forward writes when asked (``with_lse``).  The
Pallas kernel has no backward: on the TPU ``jax.grad`` differentiates the
plain chunked attention.

These wrappers take CUDA tensors only and raise on anything the kernels do
not take; the CPU's plain versions are ``ops.chunked_attention``,
``ref.lse_reference`` and ``ref.flash_attention_bwd_reference``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..build import Built, build_shared_library

_CSRC = Path(__file__).parent / "csrc"
SOURCES = [_CSRC / "flash_attention_fwd.cu", _CSRC / "flash_attention_fwd_sm90.cu"]
BWD_SOURCES = [_CSRC / "flash_attention_bwd.cu", _CSRC / "flash_attention_bwd_sm90.cu"]
# (Dk, Dv) pairs the kernels take: the SIMT dispatch has a line for each, and
# compiles it for every pair not on the tensor cores (route_condition).
HEAD_DIMS = frozenset({(16, 16), (32, 32), (64, 64), (80, 80), (96, 64), (128, 128),
                       (256, 256)})
# (Dk, Dv) pairs the backward takes: every pair the forward takes.
BWD_HEAD_DIMS = HEAD_DIMS
# The route rule: bf16 at these pairs runs on the tensor cores.
WGMMA_HEAD_DIMS = frozenset({(80, 80), (96, 64), (128, 128), (256, 256)})
BWD_WGMMA_HEAD_DIMS = frozenset({(80, 80), (96, 64), (128, 128), (256, 256)})
ROUTES = ("wgmma", "simt")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1


def route(dtype, dk: int, dv: int, *, backward: bool = False) -> str:
    """The kernel a launch goes to: ``"wgmma"`` for bf16 at WGMMA_HEAD_DIMS
    (BWD_WGMMA_HEAD_DIMS for the backward), else ``"simt"``.  The wrappers
    call the entry point it names; nothing else decides."""
    dims = BWD_WGMMA_HEAD_DIMS if backward else WGMMA_HEAD_DIMS
    return "wgmma" if dtype == torch.bfloat16 and (dk, dv) in dims else "simt"


def route_condition(dims) -> str:
    """route()'s rule for bf16 at the pairs ``dims``, as the C++ condition on
    a SIMT launch's DK and DV that its library's build defines as
    BF16_ON_WGMMA: the SIMT sources compile no kernel where it holds, since
    route() never sends a launch there."""
    return " || ".join(f"(DK == {dk} && DV == {dv})" for dk, dv in sorted(dims))


def build() -> Built:
    """Compile the forward's two routes, one library, from the sources in
    this checkout (cached by hash)."""
    return build_shared_library("flash_attention_fwd", SOURCES,
                                {"BF16_ON_WGMMA": route_condition(WGMMA_HEAD_DIMS)})


def build_bwd() -> Built:
    """Compile the backward's two routes and its delta pre-pass, a library of
    their own, from the sources in this checkout (cached by hash)."""
    return build_shared_library("flash_attention_bwd", BWD_SOURCES,
                                {"BF16_ON_WGMMA": route_condition(BWD_WGMMA_HEAD_DIMS)})


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().path))
    # q, k, v, o, lse, lse_ld, [dtype,] B, Sq, Sk, H, KH, Dk, Dv, causal, window,
    # q_offset, kv_len, scale, stream
    lib.flash_attention_fwd_wgmma.argtypes = [_P] * 5 + [_I] * 12 + [_F, _P]
    lib.flash_attention_fwd_simt.argtypes = [_P] * 5 + [_I] * 13 + [_F, _P]
    for entry in (lib.flash_attention_fwd_wgmma, lib.flash_attention_fwd_simt):
        entry.restype = _I
    lib.flash_attention_fwd_error_string.argtypes = [_I]
    lib.flash_attention_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_bwd().path))
    # o, dout, delta, ld, dtype, B, Sq, H, Dv, stream
    lib.flash_attention_bwd_delta.argtypes = [_P] * 3 + [_I] * 6 + [_P]
    # q, k, v, dout, dq, dk, dv, lse, delta, ld, [dtype,] B, Sq, Sk, H, KH, Dk, Dv,
    # causal, window, q_offset, kv_len, scale, stream
    lib.flash_attention_bwd_wgmma.argtypes = [_P] * 9 + [_I] * 12 + [_F, _P]
    lib.flash_attention_bwd_simt.argtypes = [_P] * 9 + [_I] * 13 + [_F, _P]
    for entry in (lib.flash_attention_bwd_delta, lib.flash_attention_bwd_wgmma,
                  lib.flash_attention_bwd_simt):
        entry.restype = _I
    lib.flash_attention_bwd_error_string.argtypes = [_I]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def empty_lse(B: int, H: int, Sq: int, device) -> torch.Tensor:
    """An f32 (B, H, Sq) buffer for each row's lse (or delta) whose rows
    start 16 bytes apart, as TMA reads them: a view of (B, H, Sq rounded up
    to 4)."""
    pitch = -(-Sq // 4) * 4
    return torch.empty((B, H, pitch), dtype=torch.float32, device=device)[..., :Sq]


def _check_tensors(who, named, like):
    """Each (name, tensor) on ``like``'s CUDA device, in its dtype, 4-D,
    contiguous, every dim within int32."""
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{who}: {name} is on {t.device}, not a CUDA device")
        if t.device != like.device:
            raise ValueError(f"{who}: {name} is on {t.device}, q on {like.device}")
        if t.dtype != like.dtype:
            raise TypeError(f"{who}: {name} is {t.dtype}, q is {like.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{who}: {name} must be 4-D (B, S, heads, D), "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
        if any(s > _INT32_MAX for s in t.shape):
            raise ValueError(f"{who}: {name} has a dim beyond int32")


def _check_common(q, k, v, window, kv_len, who, head_dims):
    _check_tensors(who, (("q", q), ("k", k), ("v", v)), q)
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{who}: dtype {q.dtype} not supported (float32 or bfloat16)")
    B, _, H, Dk = q.shape
    Bk, Sk, KH, Dk2 = k.shape
    if (Bk, Dk2) != (B, Dk) or tuple(v.shape[:3]) != (B, Sk, KH):
        raise ValueError(f"{who}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    if KH == 0 or H % KH:
        raise ValueError(f"{who}: {H} query heads are not a multiple of {KH} kv heads")
    if (Dk, v.shape[3]) not in head_dims:
        raise ValueError(f"{who}: head dims (Dk={Dk}, Dv={v.shape[3]}) "
                         f"not supported; supported: {sorted(head_dims)}")
    if window is not None and window < 1:
        raise ValueError(f"{who}: window must be >= 1, got {window}")
    if kv_len is not None and kv_len < 0:
        raise ValueError(f"{who}: kv_len must be >= 0, got {kv_len}")


def _check_aligned(who, named):
    """TMA reads each (name, tensor) from a 16-byte aligned address."""
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{who}: {name} must start on a 16-byte boundary for the "
                             "tensor-core route (TMA)")


def _check(q, k, v, window, kv_len):
    _check_common(q, k, v, window, kv_len, "flash_attention_fwd", HEAD_DIMS)
    if route(q.dtype, q.shape[3], v.shape[3]) == "wgmma":
        _check_aligned("flash_attention_fwd", (("q", q), ("k", k), ("v", v)))


def _check_lse(who, lse, like, shape):
    """lse: f32 of ``shape`` (B, H, Sq) on like's device, its rows lse.stride(1)
    elements apart and each row contiguous, as ``empty_lse`` makes it."""
    if lse.device != like.device:
        raise ValueError(f"{who}: lse is on {lse.device}, q on {like.device}")
    if lse.dtype != torch.float32:
        raise TypeError(f"{who}: lse is {lse.dtype}, not torch.float32")
    if tuple(lse.shape) != shape:
        raise ValueError(f"{who}: lse has shape {tuple(lse.shape)}, expected {shape}")
    ld = lse.stride(1)
    if lse.stride(2) != 1 or ld < shape[2] or lse.stride(0) != shape[1] * ld:
        raise ValueError(f"{who}: lse must be (B, H, Sq) rows of contiguous floats, got "
                         f"strides {lse.stride()}")


def _masks(Sk, causal, window, q_offset, kv_len):
    """The masks as the C entry points take them."""
    return [int(causal), -1 if window is None else window, q_offset,
            Sk if kv_len is None else min(kv_len, Sk)]


def flash_attention_fwd(q, k, v, *, causal=True, window=None, q_offset=0, kv_len=None,
                        with_lse=False):
    """Launch the kernel.  q: (B, Sq, H, Dk); k: (B, Sk, KH, Dk); v: (B, Sk, KH, Dv).

    Returns (B, Sq, H, Dv) in q.dtype; with ``with_lse``, also each row's
    log-sum-exp over the keys it sees, f32 (B, H, Sq) from ``empty_lse`` (0
    where a row sees none), which the backward reads.  Adds one to
    ``flash_attention_fwd.launches`` and to
    ``flash_attention_fwd.launches_by_route[route(...)]`` for each launch, and
    to ``flash_attention_fwd.lse_launches`` for each that writes the lse.
    """
    _check(q, k, v, window, kv_len)
    B, Sq, H, Dk = q.shape
    Sk, KH, Dv = k.shape[1], k.shape[2], v.shape[3]
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = empty_lse(B, H, Sq, q.device) if with_lse else None
    if o.numel() == 0:
        if with_lse:
            lse.zero_()
        return (o, lse) if with_lse else o
    r = route(q.dtype, Dk, Dv)
    lib = _library()
    dtype = [] if r == "wgmma" else [_DTYPE_CODE[q.dtype]]
    with torch.cuda.device(q.device):
        err = getattr(lib, f"flash_attention_fwd_{r}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), 0 if lse is None else lse.stride(1),
            *dtype, B, Sq, Sk, H, KH, Dk, Dv, *_masks(Sk, causal, window, q_offset, kv_len),
            1.0 / (Dk ** 0.5), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        msg = lib.flash_attention_fwd_error_string(err).decode()
        raise RuntimeError(f"flash_attention_fwd: launch failed with CUDA error {err}: {msg}")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.launches_by_route[r] += 1
    flash_attention_fwd.lse_launches += with_lse
    return (o, lse) if with_lse else o


def flash_attention_bwd(q, k, v, o, dout, lse, *, causal=True, window=None, q_offset=0,
                        kv_len=None):
    """Launch the backward kernels.  q, k, v and the masks as
    ``flash_attention_fwd`` was given them; o and lse: its output (B, Sq, H,
    Dv) and its lse (B, H, Sq); dout: the gradient of o, in o's shape and
    dtype.

    Returns (dq, dk, dv) in q.dtype, the shapes of q, k and v.  Adds one to
    ``flash_attention_bwd.launches`` and to
    ``flash_attention_bwd.launches_by_route[route(..., backward=True)]`` for
    each call that launches (the delta pre-pass, then the route's dK/dV and
    dQ kernels, in order on the current stream).
    """
    who = "flash_attention_bwd"
    _check_common(q, k, v, window, kv_len, who, BWD_HEAD_DIMS)
    _check_tensors(who, (("o", o), ("dout", dout)), q)
    B, Sq, H, Dk = q.shape
    Sk, KH, Dv = k.shape[1], k.shape[2], v.shape[3]
    for name, t in (("o", o), ("dout", dout)):
        if tuple(t.shape) != (B, Sq, H, Dv):
            raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, expected "
                             f"{(B, Sq, H, Dv)}")
    _check_lse(who, lse, q, (B, H, Sq))
    r = route(q.dtype, Dk, Dv, backward=True)
    if r == "wgmma":
        _check_aligned(who, (("q", q), ("k", k), ("v", v), ("dout", dout), ("lse", lse)))
        if lse.stride(1) % 4:
            raise ValueError(f"{who}: lse rows must start 16 bytes apart for the tensor-core "
                             f"route (TMA), got a row stride of {lse.stride(1)} floats")
    if q.numel() == 0 or k.numel() == 0:  # nothing to launch: every gradient is 0
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ld = lse.stride(1)
    delta = torch.empty((B, H, ld), dtype=torch.float32, device=q.device)
    lib = _bwd_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    dtype = [] if r == "wgmma" else [_DTYPE_CODE[q.dtype]]
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_delta(o.data_ptr(), dout.data_ptr(), delta.data_ptr(), ld,
                                            _DTYPE_CODE[q.dtype], B, Sq, H, Dv, stream)
        if err == 0:
            err = getattr(lib, f"flash_attention_bwd_{r}")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                ld, *dtype, B, Sq, Sk, H, KH, Dk, Dv,
                *_masks(Sk, causal, window, q_offset, kv_len), 1.0 / (Dk ** 0.5), stream)
    if err != 0:
        msg = lib.flash_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"{who}: launch failed with CUDA error {err}: {msg}")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_route[r] += 1
    return dq, dk, dv


def reset_launches():
    """Set the launch counters to 0."""
    for wrapper in (flash_attention_fwd, flash_attention_bwd):
        wrapper.launches = 0
        wrapper.launches_by_route = dict.fromkeys(ROUTES, 0)
    flash_attention_fwd.lse_launches = 0


reset_launches()
