"""The flash-attention backward's plain version and its wiring, on the CPU.

``flash_attention_bwd_reference`` (the backward kernel's plain version) is
held against ``jax.vjp`` of the JAX package's ``chunked_attention`` and
``attention_reference`` and against ``torch.autograd`` of the port's
``chunked_attention``, in f32, on the same numpy inputs.  Tolerance 1e-5
relative (||a - b|| / ||b||) and 1e-5 absolute per element: every side
computes in f32 from the same inputs and differs only in the order of its
sums (the gradients are of magnitude about 1).  ``FlashAttention`` is checked
by ``torch.autograd.gradcheck`` in float64 with both kernel calls stood in
by their plain versions.  The CUDA kernels cannot run here; the wrappers'
checks, the head-dim rule and the refusals of WKV and scan are tested
without a card.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_reference as jax_reference
from repro.kernels.flash_attention.ops import chunked_attention as jax_chunked
from repro_torch.kernels.flash_attention import (FlashAttention, attention_reference,
                                                 chunked_attention, flash_attention_bwd,
                                                 flash_attention_bwd_reference)
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rglru_scan import kernel as scan_kernel
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.rwkv6_wkv import kernel as wkv_kernel
from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv

TOL = 1e-5
# B, Sq, Sk, H, KH, D, causal, window, q_offset, kv_len
CASES = [
    (2, 64, 64, 4, 2, 16, True, None, 0, None),       # GQA
    (1, 128, 128, 4, 1, 16, True, 48, 0, None),       # GQA + sliding window
    (2, 37, 93, 6, 3, 16, True, None, 56, None),      # ragged continuation
    (1, 50, 50, 4, 4, 64, False, None, 0, None),      # bidirectional
    (1, 96, 96, 2, 2, 64, True, 32, 0, None),         # window at D 64
    (2, 35, 100, 8, 2, 16, False, None, 0, 75),       # kv_len < Sk, ragged
    (1, 64, 64, 4, 2, 16, False, None, 0, 0),         # kv_len 0: no row sees a key
    (1, 16, 16, 2, 1, 16, True, None, -4, None),      # the first 4 rows see no key
    (1, 40, 40, 4, 2, 128, True, None, 0, None),      # qwen3's head dim
]


def _inputs(seed, case):
    B, Sq, Sk, H, KH, D = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Sk, KH, D), (B, Sk, KH, D), (B, Sq, H, D))]


def _kw(case):
    causal, window, q_offset, kv_len = case[6:]
    return dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)


def _sees_nothing(case):
    """Some row sees no key (jax's attention_reference has no defined gradient there)."""
    B, Sq, Sk, H, KH, D, causal, window, q_offset, kv_len = case
    return kv_len == 0 or (causal and q_offset < 0)


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    norm = np.linalg.norm(b)
    rel = np.linalg.norm(a - b) / norm if norm > 0 else np.linalg.norm(a - b)
    assert rel <= tol, f"relative error {rel:.3e} > {tol}"
    np.testing.assert_allclose(a, b, atol=tol, rtol=0)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_vjp(case):
    q, k, v, do = _inputs(CASES.index(case), case)
    kw = _kw(case)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o = chunked_attention(tq, tk, tv, **kw)
    grads = flash_attention_bwd_reference(tq, tk, tv, o, tdo, **kw)
    assert [g.dtype for g in grads] == [torch.float32] * 3
    refs = [lambda q, k, v: jax_chunked(q, k, v, q_chunk=32, k_chunk=32, **kw)]
    if not _sees_nothing(case):
        refs.append(lambda q, k, v: jax_reference(q, k, v, **kw))
    for fn in refs:
        out, theirs = jax.jit(lambda *a, fn=fn: (lambda o, vjp: (o, vjp(a[3])))(
            *jax.vjp(fn, *a[:3])))(*map(jnp.asarray, (q, k, v, do)))
        _close(o.numpy(), out)
        for mine, want in zip(grads, theirs):
            _close(mine.numpy(), want)
    if _sees_nothing(case):
        dq = grads[0].numpy()
        rows = slice(None) if case[9] == 0 else slice(0, -case[8])
        assert np.all(dq[:, rows] == 0)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_torch_autograd(case):
    q, k, v, do = map(torch.from_numpy, _inputs(100 + CASES.index(case), case))
    kw = _kw(case)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = chunked_attention(*leaves, q_chunk=32, k_chunk=48, **kw)
    autograd = torch.autograd.grad(o, leaves, do)
    for mine, theirs in zip(flash_attention_bwd_reference(q, k, v, o.detach(), do, **kw),
                            autograd):
        _close(mine.numpy(), theirs.numpy())


@pytest.mark.parametrize("case", [(1, 8, 8, 4, 2, 8, True, None, 0, None),
                                  (1, 6, 9, 2, 1, 8, True, 4, 3, 8),
                                  (2, 5, 5, 2, 2, 8, False, None, 0, 3),
                                  (1, 6, 6, 2, 1, 8, True, None, -3, None)])
def test_function_gradcheck_with_plain_stand_ins(case, monkeypatch):
    """FlashAttention's wiring, in float64: what forward saves, the order of
    the gradients backward returns, None for the masks.  Each kernel call is
    stood in by its plain version, and each is counted."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(q, k, v, **kw):
        calls["fwd"] += 1
        return attention_reference(q, k, v, **kw)

    def bwd(q, k, v, o, dout, **kw):
        calls["bwd"] += 1
        return flash_attention_bwd_reference(q, k, v, o, dout, **kw)

    monkeypatch.setattr(fa_ops, "flash_attention_fwd", fwd)
    monkeypatch.setattr(fa_ops, "flash_attention_bwd", bwd)
    q, k, v, _ = _inputs(200, case)
    args = [torch.from_numpy(a).double().requires_grad_(True) for a in (q, k, v)]
    causal, window, q_offset, kv_len = case[6:]
    out = FlashAttention.apply(*args, causal, window, q_offset, kv_len)
    assert out.grad_fn is not None and calls == {"fwd": 1, "bwd": 0}
    out.sum().backward()
    assert calls == {"fwd": 1, "bwd": 1}
    assert torch.autograd.gradcheck(
        lambda q, k, v: FlashAttention.apply(q, k, v, causal, window, q_offset, kv_len),
        args, eps=1e-6, atol=1e-7, rtol=1e-6)


class _OnCuda:
    """A CPU tensor that reports a CUDA device, so the wrappers' checks run here."""
    device = torch.device("cuda", 0)

    def __init__(self, t, requires_grad=False):
        self._t, self.requires_grad = t, requires_grad

    dtype = property(lambda self: self._t.dtype)
    shape = property(lambda self: self._t.shape)

    def dim(self):
        return self._t.dim()

    def is_contiguous(self):
        return self._t.is_contiguous()

    def data_ptr(self):
        return self._t.data_ptr()


@pytest.fixture
def no_build(monkeypatch):
    """Any attempt to build a kernel fails the test."""
    def refuse():
        raise AssertionError("a kernel was built")
    for mod, name in ((fa_kernel, "build"), (fa_kernel, "build_bwd"),
                      (wkv_kernel, "build"), (scan_kernel, "build")):
        monkeypatch.setattr(mod, name, refuse)
    fa_kernel._bwd_library.cache_clear()


def test_backward_wrapper_refuses_cpu_tensors(no_build):
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash_attention_bwd(q, q, q, q, q)


@pytest.mark.parametrize("dk, dv", [(80, 80), (96, 64), (256, 256), (48, 48)])
def test_backward_wrapper_refuses_unsupported_head_dims(dk, dv, no_build):
    q, v = _OnCuda(torch.zeros(1, 8, 2, dk)), _OnCuda(torch.zeros(1, 8, 2, dv))
    with pytest.raises(ValueError, match=r"flash_attention_bwd: head dims .* not supported "
                                         r"yet .*ROADMAP.md B4"):
        flash_attention_bwd(q, q, v, v, v)


@pytest.mark.parametrize("dims", sorted(fa_kernel.BWD_HEAD_DIMS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_wrapper_takes_its_head_dims(dims, dtype):
    q = _OnCuda(torch.zeros(1, 8, 4, dims[0], dtype=dtype))
    v = _OnCuda(torch.zeros(1, 8, 2, dims[1], dtype=dtype))
    o = _OnCuda(torch.zeros(1, 8, 4, dims[1], dtype=dtype))
    fa_kernel._check_common(q, _OnCuda(torch.zeros(1, 8, 2, dims[0], dtype=dtype)), v,
                            None, None, "flash_attention_bwd", fa_kernel.BWD_HEAD_DIMS)
    fa_kernel._check_tensors("flash_attention_bwd", (("o", o), ("dout", o)), q)


def test_backward_wrapper_checks_the_gradient_shape(no_build):
    q, k = _OnCuda(torch.zeros(1, 8, 4, 16)), _OnCuda(torch.zeros(1, 8, 2, 16))
    with pytest.raises(ValueError, match="dout has shape"):
        flash_attention_bwd(q, k, k, q, _OnCuda(torch.zeros(1, 8, 2, 16)))


def test_backward_head_dims_have_dispatch_lines():
    """A pair the wrapper takes but no kernel is instantiated for would fail
    only on the card, as cudaErrorInvalidValue; here it fails on the CPU."""
    src = (Path(fa_kernel.__file__).parent / "csrc" / "flash_attention_bwd.cu").read_text()
    body = src[src.index("cudaError_t dispatch("):]
    lines = re.findall(r"if \(dk == (\d+) && dv == (\d+)\) return launch<T, (\d+), (\d+),",
                       body[:body.index("\n}\n")])
    assert all((a, b) == (c, d) for a, b, c, d in lines)
    assert {(int(a), int(b)) for a, b, _, _ in lines} == fa_kernel.BWD_HEAD_DIMS


def test_reset_launches_zeroes_the_backward_counter():
    fa_kernel.flash_attention_bwd.launches = 5
    fa_kernel.reset_launches()
    assert fa_kernel.flash_attention_bwd.launches == 0


def _wkv_args(requires_grad):
    B, T, H, D = 1, 4, 2, 16
    t = [_OnCuda(torch.zeros(B, T, H, D)) for _ in range(4)]
    t[1].requires_grad = requires_grad
    return t + [_OnCuda(torch.zeros(H, D)), None]


def _scan_args(requires_grad):
    return [_OnCuda(torch.zeros(1, 4, 8), requires_grad), _OnCuda(torch.zeros(1, 4, 8)), None]


@pytest.mark.parametrize("wrapper, make", [(wkv_kernel.rwkv6_wkv_fwd, _wkv_args),
                                           (scan_kernel.rglru_scan_fwd, _scan_args)],
                         ids=["wkv", "scan"])
def test_recurrence_kernels_refuse_inputs_that_require_grad(wrapper, make, no_build):
    """No backward kernel yet: never a silently detached output."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md B4"):
        wrapper(*make(True))
    for args, grad_mode in ((make(True), False), (make(False), True)):
        with torch.set_grad_enabled(grad_mode), pytest.raises(Exception) as err:
            wrapper(*args)  # passes the refusal; the stand-in then fails to allocate
        assert not isinstance(err.value, NotImplementedError)


def test_recurrences_stay_differentiable_on_the_cpu():
    rng = np.random.default_rng(5)
    B, T, H, D, W = 1, 6, 2, 8, 12
    r, k, v = (torch.tensor(rng.standard_normal((B, T, H, D)) * 0.5, dtype=torch.float32,
                            requires_grad=True) for _ in range(3))
    w = torch.sigmoid(torch.tensor(rng.standard_normal((B, T, H, D)), dtype=torch.float32))
    u = torch.tensor(rng.standard_normal((H, D)) * 0.5, dtype=torch.float32, requires_grad=True)
    y, s_last = rwkv6_wkv(r, k, v, w, u)
    a = torch.sigmoid(torch.tensor(rng.standard_normal((B, T, W)), dtype=torch.float32))
    b = torch.tensor(rng.standard_normal((B, T, W)), dtype=torch.float32, requires_grad=True)
    h, h_last = rglru_scan(a, b)
    (y.sum() + s_last.sum() + h.sum() + h_last.sum()).backward()
    for t in (r, k, v, u, b):
        assert t.grad is not None and torch.isfinite(t.grad).all() and t.grad.abs().sum() > 0
