"""The WKV backward against the JAX package, on the CPU.

``rwkv6_wkv_bwd_reference`` (the backward kernel's plain version) against
``jax.vjp`` of the JAX package's ``rwkv6_reference`` in f32, within 1e-5
relative (||a - b|| / ||b||: both sum in f32, in another order), and
against ``torch.autograd`` of the port's ``rwkv6_reference`` in float64,
within 1e-12, on the same numpy inputs: head dims 8 to 64, a ragged T, T = 1,
s0 and a cotangent on s_last given and absent, and w exactly 0, exactly 1
and exp(-100).  A numpy emulation of the kernel's schedule (a forward walk
that checkpoints the state every CHECKPOINT_STEPS steps, each chunk's states
walked again from its checkpoint, a reverse walk in the row layout and one
in the column layout) against the plain version.  ``rwkv6_wkv_op`` by
``torch.autograd.gradcheck`` in float64 with both kernel calls stood in by
their plain versions.  The CUDA kernels cannot run here; the backward
wrapper's checks and its call of the entry point are tested without a card.
Then the model: rwkv6's gradient through ``rwkv6_wkv_op`` against torch's own
through the plain version, and a train step's launches under remat.
"""
import contextlib
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_wkv import rwkv6_reference as jax_reference
from repro_torch.configs import get_config
from repro_torch.kernels.rwkv6_wkv import (rwkv6_reference, rwkv6_wkv_bwd,
                                           rwkv6_wkv_bwd_reference, rwkv6_wkv_op)
from repro_torch.kernels.rwkv6_wkv import kernel as wkv_kernel
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.models import lm, rwkv6
from repro_torch.optim import init_train_state
from repro_torch.train import make_train_step
from repro_torch.tree import leaves, paths

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

# (B, T, H, D, s0 given, a cotangent on s_last, decay): decay "sigmoid" is
# sigmoid(N(0,1)), "model" the model's exp(-exp(N(0,1))), "edges" the model's
# with w forced to 0, 1 and exp(-100) at EDGE_STEPS on the even channels.
CASES = {
    "d8": (1, 16, 2, 8, True, True, "sigmoid"),
    "d16": (2, 24, 3, 16, True, False, "sigmoid"),
    "d32": (1, 20, 2, 32, False, True, "sigmoid"),
    "d64-ragged": (2, 37, 2, 64, True, True, "sigmoid"),
    "d64-bare": (2, 37, 2, 64, False, False, "model"),
    "t1": (3, 1, 2, 64, True, True, "sigmoid"),
    "edges": (1, 130, 2, 16, True, True, "edges"),
}
EDGE_STEPS = chip_smoke.WKV_EDGE_STEPS
OUTPUTS = ("dr", "dk", "dv", "dw", "du", "ds0")


def _inputs(case, seed):
    """r, k, v, w, u, s0 (or None), dy, ds_last (or None) in numpy f32."""
    B, T, H, D, with_s0, with_ds, decay = case
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, D)).astype(np.float32) * 0.5 for _ in range(3))
    x = rng.standard_normal((B, T, H, D))
    w = (1 / (1 + np.exp(-x)) if decay == "sigmoid" else np.exp(-np.exp(x))).astype(np.float32)
    if decay == "edges":
        for value, steps in EDGE_STEPS.items():
            w[:, [t for t in steps if t < T], :, 0::2] = value
    u = rng.standard_normal((H, D)).astype(np.float32) * 0.5
    s0 = rng.standard_normal((B, H, D, D)).astype(np.float32) * 0.1 if with_s0 else None
    dy = rng.standard_normal((B, T, H, D)).astype(np.float32)
    ds_last = rng.standard_normal((B, H, D, D)).astype(np.float32) * 0.1 if with_ds else None
    return r, k, v, w, u, s0, dy, ds_last


def _torch(arrays, dtype=torch.float32):
    return [None if a is None else torch.from_numpy(a).to(dtype) for a in arrays]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    norm = np.linalg.norm(b)
    return np.linalg.norm(a - b) / norm if norm else np.linalg.norm(a - b)


@pytest.fixture(scope="module")
def jax_grads():
    """Each case's gradients by jax.vjp of the JAX package's plain version
    (s0 and ds_last absent as zeros)."""
    out = {}
    for n, (name, case) in enumerate(CASES.items()):
        r, k, v, w, u, s0, dy, ds_last = _inputs(case, seed=n)
        B, _, H, D = r.shape
        zeros = np.zeros((B, H, D, D), np.float32)
        _, vjp = jax.vjp(jax_reference, *(jnp.asarray(a) for a in (
            r, k, v, w, u, zeros if s0 is None else s0)))
        grads = vjp((jnp.asarray(dy), jnp.asarray(zeros if ds_last is None else ds_last)))
        out[name] = [np.asarray(g) for g in grads]
    return out


def test_cases_cover_the_head_dims_and_the_edges():
    """Head dims 8 to 64, a T that is not a multiple of the checkpoint
    interval, T = 1, s0 and ds_last each given and absent, and every edge
    decay inside the edge case's steps."""
    cases = CASES.values()
    assert {c[3] for c in cases} == set(wkv_kernel.HEAD_DIMS)
    assert any(c[1] % wkv_kernel.CHECKPOINT_STEPS and c[1] > wkv_kernel.CHECKPOINT_STEPS
               for c in cases)
    assert any(c[1] == 1 for c in cases)
    assert {(c[4], c[5]) for c in cases} == {(True, True), (True, False), (False, True),
                                             (False, False)}
    w = _inputs(CASES["edges"], seed=0)[3]
    assert (w == 0).any() and (w == 1).any() and ((w > 0) & (w < 1e-38)).any()


@pytest.mark.parametrize("name", list(CASES))
def test_reference_matches_jax_vjp(jax_grads, name):
    n = list(CASES).index(name)
    mine = rwkv6_wkv_bwd_reference(*_torch(_inputs(CASES[name], seed=n)))
    for what, a, b in zip(OUTPUTS, mine, jax_grads[name]):
        assert a.dtype == torch.float32 and a.shape == b.shape, what
        assert np.isfinite(a.numpy()).all(), what
        assert _rel(a.numpy(), b) <= 1e-5, (what, _rel(a.numpy(), b))


@pytest.mark.parametrize("name", list(CASES))
def test_reference_matches_torch_autograd_in_float64(name):
    """The port's forward, which computes in float64 for float64 inputs,
    differentiated by torch; s0 absent is a zero leaf on torch's side."""
    n = list(CASES).index(name)
    r, k, v, w, u, s0, dy, ds_last = _torch(_inputs(CASES[name], seed=n), torch.float64)
    B, _, H, D = r.shape
    zeros = torch.zeros((B, H, D, D), dtype=torch.float64)
    leaf = [t.clone().requires_grad_(True) for t in (r, k, v, w, u, zeros if s0 is None else s0)]
    y, s_last = rwkv6_reference(*leaf)
    assert y.dtype == s_last.dtype == torch.float64
    want = torch.autograd.grad((y, s_last), leaf, (dy, zeros if ds_last is None else ds_last))
    mine = rwkv6_wkv_bwd_reference(r, k, v, w, u, s0, dy, ds_last)
    for what, a, b in zip(OUTPUTS, mine, want):
        assert a.dtype == torch.float64
        assert _rel(a.numpy(), b.numpy()) <= 1e-12, what


def test_reference_takes_absent_state_and_cotangent_as_zeros():
    r, k, v, w, u, _, dy, _ = _torch(_inputs(CASES["d8"], seed=1))
    B, _, H, D = r.shape
    zeros = torch.zeros((B, H, D, D))
    without = rwkv6_wkv_bwd_reference(r, k, v, w, u, None, dy, None)
    with_zeros = rwkv6_wkv_bwd_reference(r, k, v, w, u, zeros, dy, zeros)
    for a, b in zip(without, with_zeros):
        assert torch.equal(a, b)


def test_reference_rounds_the_four_gradients_once_to_bf16():
    """bf16 r, k, v, w and dy: the same f32 arithmetic as on their f32
    values, dr, dk, dv and dw rounded once to bf16, du and ds0 kept in f32."""
    r, k, v, w, u, s0, dy, ds_last = _torch(_inputs(CASES["d64-ragged"], seed=2))
    r, k, v, w, dy = (t.to(torch.bfloat16) for t in (r, k, v, w, dy))
    bf16 = rwkv6_wkv_bwd_reference(r, k, v, w, u, s0, dy, ds_last)
    f32 = rwkv6_wkv_bwd_reference(*(t.float() for t in (r, k, v, w)), u, s0, dy.float(),
                                  ds_last)
    for what, a, b in zip(OUTPUTS, bf16, f32):
        if what in ("du", "ds0"):
            assert a.dtype == torch.float32 and torch.equal(a, b), what
        else:
            assert a.dtype == torch.bfloat16 and torch.equal(a, b.to(torch.bfloat16)), what


# --- the kernel's schedule, emulated --------------------------------------

def kernel_schedule(r, k, v, w, u, s0, dy, ds_last, C=wkv_kernel.CHECKPOINT_STEPS):
    """What csrc/rwkv6_wkv_bwd.cu does, in numpy f32, for each (b, h).

    wkv_bwd_fwd: thread i walks row i of S forward from s0, writing S at the
    start of each chunk of C steps to the checkpoints, dr_t and v_t . dy_t,
    and summing r k (v . dy) over each chunk, then over the chunks.
    wkv_bwd_rev: the chunks from the last; each chunk's states walked again
    from its checkpoint, then the chunk's steps backwards in the row layout
    (dw, dk, G's rows) and in the column layout (dv, G's columns).
    wkv_bwd_du: du summed over b in order.  Returns the six gradients and,
    for the checks, whether every recomputed state equalled the forward
    walk's and the two layouts' G agreed to the bit.
    """
    f = np.float32
    B, T, H, D = r.shape
    n_chunks = -(-T // C)
    dr, dk, dv, dw = (np.zeros((B, T, H, D), f) for _ in range(4))
    ds0 = np.zeros((B, H, D, D), f)
    du_part = np.zeros((B, H, D), f)
    states_agree, layouts_agree = True, True
    for b in range(B):
        for h in range(H):
            rr, kk, vv, ww, dd = (x[b, :, h].astype(f) for x in (r, k, v, w, dy))
            uu = u[h].astype(f)
            S = np.zeros((D, D), f) if s0 is None else s0[b, h].astype(f).copy()
            ck, vdy, walked = [], np.zeros(T, f), []
            du = f(0)
            for c in range(n_chunks):
                ck.append(S.copy())
                du_chunk = f(0)
                for t in range(c * C, min(T, (c + 1) * C)):
                    walked.append(S.copy())
                    vdy[t] = np.dot(vv[t], dd[t])
                    dr[b, t, h] = S @ dd[t] + uu * kk[t] * vdy[t]
                    du_chunk += rr[t] * kk[t] * vdy[t]
                    S = ww[t][:, None] * S + kk[t][:, None] * vv[t][None, :]
                du += du_chunk
            du_part[b, h] = du
            G = np.zeros((D, D), f) if ds_last is None else ds_last[b, h].astype(f).copy()
            Gc = G.T.copy()  # the column layout: Gc[j] is column j
            for c in reversed(range(n_chunks)):
                t0, n = c * C, min(C, T - c * C)
                S, states = ck[c].copy(), []
                for s in range(n):
                    states.append(S.copy())
                    t = t0 + s
                    S = ww[t][:, None] * S + kk[t][:, None] * vv[t][None, :]
                states_agree &= all(np.array_equal(a, walked[t0 + s])
                                    for s, a in enumerate(states))
                for s in reversed(range(n)):
                    t = t0 + s
                    dw[b, t, h] = (states[s] * G).sum(1)
                    dk[b, t, h] = uu * rr[t] * vdy[t] + G @ vv[t]
                    G = ww[t][:, None] * G + rr[t][:, None] * dd[t][None, :]
                    urk = np.dot(uu * rr[t], kk[t])
                    dv[b, t, h] = dd[t] * urk + Gc @ kk[t]
                    Gc = ww[t][None, :] * Gc + dd[t][:, None] * rr[t][None, :]
                    layouts_agree &= np.array_equal(G, Gc.T)
            ds0[b, h] = Gc.T
    return (dr, dk, dv, dw, du_part.sum(0), ds0), states_agree, layouts_agree


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_schedule_matches_the_reference(name):
    """The schedule's gradients within 1e-5 of the plain version's, its
    recomputed states equal to the forward walk's, and its two copies of G
    equal to the bit: no state is rebuilt from a later one, so w = 0
    anywhere costs nothing."""
    n = list(CASES).index(name)
    arrays = _inputs(CASES[name], seed=n)
    got, states_agree, layouts_agree = kernel_schedule(*arrays)
    assert states_agree and layouts_agree
    for what, a, b in zip(OUTPUTS, got, rwkv6_wkv_bwd_reference(*_torch(arrays))):
        assert np.isfinite(a).all(), what
        assert _rel(a, b.numpy()) <= 1e-5, (what, _rel(a, b.numpy()))


def test_checkpoint_scratch_at_the_train_shape():
    """B H ceil(T / C) D^2 f32 checkpoints: 1.07 GB at rwkv6-7b's train
    shape, the figure csrc/rwkv6_wkv_bwd.cu's header gives."""
    B, T, H, D = chip_smoke.WKV_BWD_TRAIN_CASE[:4]
    n = B * H * -(-T // wkv_kernel.CHECKPOINT_STEPS) * D * D * 4
    assert n == 1_073_741_824
    src = (Path(wkv_kernel.__file__).parent / "csrc" / "rwkv6_wkv_bwd.cu").read_text()
    assert f"constexpr int kC = {wkv_kernel.CHECKPOINT_STEPS};" in src


# --- rwkv6_wkv_op with plain stand-ins -----------------------------------------

@pytest.fixture
def plain_kernels(monkeypatch):
    """rwkv6_wkv_op's two kernel calls stood in by their plain versions, counted."""
    calls = {"fwd": 0, "bwd": 0, "grad": []}

    def fwd(r, k, v, w, u, s0, grad=False):
        calls["fwd"] += 1
        calls["grad"].append(grad)
        return rwkv6_reference(r, k, v, w, u, s0)

    def bwd(r, k, v, w, u, s0, dy, ds_last):
        calls["bwd"] += 1
        return rwkv6_wkv_bwd_reference(r, k, v, w, u, s0, dy, ds_last)

    monkeypatch.setattr(wkv_ops, "rwkv6_wkv_fwd", fwd)
    monkeypatch.setattr(wkv_ops, "rwkv6_wkv_bwd", bwd)
    return calls


@pytest.mark.parametrize("case", [(1, 5, 2, 4, True, True, "sigmoid"),
                                  (2, 3, 1, 4, False, True, "edges")], ids=str)
def test_function_gradcheck_with_plain_stand_ins(case, plain_kernels):
    """rwkv6_wkv_op's wiring, in float64: what forward saves, the order of the
    gradients backward returns, ds0 only where s0 takes a gradient."""
    r, k, v, w, u, s0, _, _ = _inputs(case, seed=11)
    args = [torch.from_numpy(x).double().requires_grad_(True) for x in (r, k, v, w, u)]
    if s0 is not None:
        args.append(torch.from_numpy(s0).double().requires_grad_(True))
    extra = [None] if s0 is None else []
    y, s_last = rwkv6_wkv_op(*args, *extra, True)
    assert y.grad_fn is not None and plain_kernels == {"fwd": 1, "bwd": 0, "grad": [True]}
    (y.sum() + s_last.sum()).backward()
    assert plain_kernels == {"fwd": 1, "bwd": 1, "grad": [True]}
    assert torch.autograd.gradcheck(lambda *x: rwkv6_wkv_op(*x, *extra, True), args,
                                    eps=1e-6, atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("used", ["y", "s_last"])
def test_function_takes_an_unused_output_as_zero(used, plain_kernels):
    """Autograd leaves the cotangent of an unused output undefined (s_last's
    in a train step): the backward takes it as zero, as the plain version's
    autograd does."""
    arrays = _inputs(CASES["d16"], seed=12)[:6]
    mine = [torch.from_numpy(x).requires_grad_(True) for x in arrays]
    theirs = [x.detach().clone().requires_grad_(True) for x in mine]
    out = dict(zip(("y", "s_last"), rwkv6_wkv_op(*mine, True)))
    ref = dict(zip(("y", "s_last"), rwkv6_reference(*theirs)))
    got = torch.autograd.grad(out[used].square().sum(), mine)
    # s_last reads neither r nor u: torch leaves those gradients undefined
    want = torch.autograd.grad(ref[used].square().sum(), theirs, allow_unused=True)
    for x, y, t in zip(got, want, theirs):
        torch.testing.assert_close(x, torch.zeros_like(t) if y is None else y,
                                   rtol=1e-5, atol=1e-5)


def test_function_saves_nothing_without_grad(plain_kernels):
    args = _torch(_inputs(CASES["d8"], seed=13)[:6])
    y, s_last = wkv_ops.rwkv6_wkv_cuda(*args)
    assert y.grad_fn is None and s_last.grad_fn is None
    assert plain_kernels["fwd"] == 1 and plain_kernels["grad"] == [False]


@pytest.mark.parametrize("mode", [torch.no_grad, torch.inference_mode])
def test_a_call_without_grad_mode_serves_on_inputs_that_require_grad(mode, plain_kernels):
    """A prefill or an eval on a trainer's parameters (requires_grad set,
    grad mode off) takes the serving route and saves nothing, although
    ctx.needs_input_grad, which follows requires_grad alone, is true there;
    the same call in grad mode makes a gradient."""
    leaf = [t.requires_grad_(True) for t in _torch(_inputs(CASES["d8"], seed=15)[:5])]
    with mode():
        y, s_last = wkv_ops.rwkv6_wkv_cuda(*leaf)
    assert y.grad_fn is None and s_last.grad_fn is None
    y, _ = wkv_ops.rwkv6_wkv_cuda(*leaf)
    assert y.grad_fn is not None
    assert plain_kernels == {"fwd": 2, "bwd": 0, "grad": [False, True]}


def test_function_returns_no_ds0_where_s0_takes_none(plain_kernels):
    r, k, v, w, u, s0 = _torch(_inputs(CASES["d8"], seed=14)[:6])
    leaf = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
    y, _ = rwkv6_wkv_op(*leaf, s0, True)
    y.sum().backward()
    assert all(t.grad is not None for t in leaf) and plain_kernels["bwd"] == 1


# --- the backward wrapper ----------------------------------------------------

class _OnCuda:
    """A CPU tensor that reports a CUDA device, so the wrapper's checks run here."""
    device = torch.device("cuda", 0)
    requires_grad = False

    def __init__(self, t):
        self._t = t

    dtype = property(lambda self: self._t.dtype)
    shape = property(lambda self: self._t.shape)

    def dim(self):
        return self._t.dim()

    def is_contiguous(self):
        return self._t.is_contiguous()


@pytest.fixture
def no_build(monkeypatch):
    """Any attempt to build a kernel fails the test."""
    def refuse():
        raise AssertionError("a kernel was built")
    monkeypatch.setattr(wkv_kernel, "build", refuse)
    monkeypatch.setattr(wkv_kernel, "build_bwd", refuse)
    wkv_kernel._bwd_library.cache_clear()
    wkv_kernel.reset_launches()


def test_backward_wrapper_refuses_cpu_tensors(no_build):
    args = _torch(_inputs(CASES["d8"], seed=3))
    with pytest.raises(ValueError, match="rwkv6_wkv_bwd: r is on cpu, not a CUDA device"):
        rwkv6_wkv_bwd(*args)
    assert rwkv6_wkv_bwd.launches == 0
    assert rwkv6_wkv_bwd.launches_by_route == {"chunk": 0, "recurrent": 0}


def _bwd_args(**change):
    """r, k, v, w, u, s0, dy, ds_last of a (2, 4, 2, 16) f32 case as
    _OnCuda; ``change`` replaces some of them."""
    x = torch.zeros(2, 4, 2, 16)
    args = {"r": x, "k": x, "v": x, "w": x, "u": torch.zeros(2, 16),
            "s0": torch.zeros(2, 2, 16, 16), "dy": x, "ds_last": torch.zeros(2, 2, 16, 16)}
    args.update(change)
    return [None if t is None else _OnCuda(t) for t in args.values()]


@pytest.mark.parametrize("change, error, match", [
    ({"dy": torch.zeros(2, 4, 2, 16, dtype=torch.bfloat16)}, TypeError, "dy is torch.bfloat16"),
    ({"k": torch.zeros(2, 5, 2, 16)}, ValueError, r"k has shape \(2, 5, 2, 16\)"),
    ({n: torch.zeros(2, 4, 2, 16, dtype=torch.float64) for n in ("r", "k", "v", "w", "dy")},
     TypeError, "dtype torch.float64"),
    ({n: torch.zeros(2, 4, 2, 12) for n in ("r", "k", "v", "w", "dy")}, ValueError,
     "head dim 12 not supported"),
    ({"u": torch.zeros(2, 16, dtype=torch.bfloat16)}, ValueError, "u must be float32"),
    ({"s0": torch.zeros(2, 2, 16, 15)}, ValueError, r"s0 must be float32 of shape"),
    ({"ds_last": torch.zeros(2, 2, 16, 16, dtype=torch.bfloat16)}, ValueError,
     "ds_last must be float32"),
    ({"dy": torch.zeros(2, 4, 16, 2).transpose(2, 3)}, ValueError, "dy must be contiguous"),
], ids=["dy-dtype", "k-shape", "f64", "head-dim", "u-dtype", "s0-shape", "ds_last-dtype",
        "dy-strided"])
def test_backward_wrapper_refuses_bad_input_before_building(no_build, change, error, match):
    with pytest.raises(error, match=match):
        rwkv6_wkv_bwd(*_bwd_args(**change))
    assert rwkv6_wkv_bwd.launches == 0


class _Library:
    """A counting stand-in for the backward library: it records each call's
    arguments and returns ``err``."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

    def rwkv6_wkv_bwd(self, *args):
        self.calls.append(("recurrent", args))
        return self.err

    def rwkv6_wkv_bwd_chunk(self, *args):
        self.calls.append(("chunk", args))
        return self.err

    def rwkv6_wkv_bwd_error_string(self, err):
        return b"an error the stand-in names"

    rwkv6_wkv_bwd_chunk_error_string = rwkv6_wkv_bwd_error_string


@pytest.fixture
def library(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(wkv_kernel, "_bwd_library", lambda: lib)
    monkeypatch.setattr(wkv_kernel, "_check_inputs", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: type("Stream", (), {"cuda_stream": 0})())
    wkv_kernel.reset_launches()
    return lib


@pytest.mark.parametrize("dtype, code", [(torch.float32, 0), (torch.bfloat16, 1)])
def test_backward_wrapper_calls_the_entry_point_and_counts_it(library, dtype, code):
    """One call of the entry point bwd_route() names a launch: 17 pointers
    (s0 and ds_last None where absent), then the recurrent entry's dtype
    (``code``; the chunk entry, bf16 at head dim 64, takes none), B, T, H, D
    and the stream; one added to launches and to launches_by_route on that
    route; outputs in r's dtype, du and ds0 in f32."""
    r, k, v, w, u, s0, dy, ds_last = _torch(_inputs(CASES["d64-bare"], seed=4))
    r, k, v, w, dy = (t.to(dtype) for t in (r, k, v, w, dy))
    outs = rwkv6_wkv_bwd(r, k, v, w, u, s0, dy, ds_last)
    rt = wkv_kernel.bwd_route(dtype, 64, r.shape[1])
    assert rt == ("chunk" if dtype == torch.bfloat16 else "recurrent")
    assert len(library.calls) == 1 and library.calls[0][0] == rt
    args = library.calls[0][1]
    dtype_arg = () if rt == "chunk" else (code,)
    assert len(args) == 17 + len(dtype_arg) + 4 + 1
    assert args[5] is None and args[7] is None
    assert args[17:17 + len(dtype_arg) + 4] == (*dtype_arg, *r.shape)
    assert [o.dtype for o in outs] == [dtype] * 4 + [torch.float32] * 2
    assert [tuple(o.shape) for o in outs] == [tuple(r.shape)] * 4 + [(2, 64), (2, 2, 64, 64)]
    assert rwkv6_wkv_bwd.launches == 1
    assert rwkv6_wkv_bwd.launches_by_route == {r_: int(r_ == rt) for r_ in ("chunk", "recurrent")}
    wkv_kernel.reset_launches()
    assert rwkv6_wkv_bwd.launches == 0
    assert rwkv6_wkv_bwd.launches_by_route == {"chunk": 0, "recurrent": 0}


def test_backward_wrapper_raises_on_a_failed_launch_and_counts_nothing(library):
    library.err = 700
    with pytest.raises(RuntimeError, match="CUDA error 700: an error the stand-in names"):
        rwkv6_wkv_bwd(*_torch(_inputs(CASES["d8"], seed=5)))
    assert rwkv6_wkv_bwd.launches == 0


# --- the model -------------------------------------------------------------

@pytest.fixture
def counting(monkeypatch):
    """rwkv6's WKV entry point sent through rwkv6_wkv_op on the CPU, each kernel
    call stood in by its plain version and counted."""
    n = {"fwd": 0, "bwd": 0, "grad": 0}

    def fwd(r, k, v, w, u, s0, grad=False):
        n["fwd"] += 1
        n["grad"] += grad
        return rwkv6_reference(r, k, v, w, u, s0)

    def bwd(*args):
        n["bwd"] += 1
        return rwkv6_wkv_bwd_reference(*args)

    monkeypatch.setattr(wkv_ops, "rwkv6_wkv_fwd", fwd)
    monkeypatch.setattr(wkv_ops, "rwkv6_wkv_bwd", bwd)
    monkeypatch.setattr(rwkv6, "rwkv6_wkv", wkv_ops.rwkv6_wkv_cuda)
    return n


def _reduced(n_layers):
    return dataclasses.replace(get_config("rwkv6-7b").reduced(), n_layers=n_layers)


def test_model_gradient_through_the_function_matches_torchs(monkeypatch):
    """rwkv6 at 2 reduced layers, f32: the loss's gradient through rwkv6_wkv_op
    (plain stand-ins) against torch's own through the plain version, 1e-5.
    w's gradient reaches decay_base and decay_w1 / decay_w2 through the cast
    and exp(-exp(.)), and u's reaches the f32 leaf u."""
    cfg = _reduced(2)
    toks = torch.randint(0, cfg.vocab, (2, 12), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": toks}

    def grads():
        params = lm.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
        weights = leaves(params)
        for t in weights:
            t.requires_grad_(True)
        loss, _ = lm.loss_fn(params, cfg, batch, remat="full", ce_chunk=8)
        return dict(zip(paths(params), torch.autograd.grad(loss, weights)))
    theirs = grads()
    monkeypatch.setattr(wkv_ops, "rwkv6_wkv_fwd",
                        lambda *a, grad=False: rwkv6_reference(*a))
    monkeypatch.setattr(wkv_ops, "rwkv6_wkv_bwd", rwkv6_wkv_bwd_reference)
    monkeypatch.setattr(rwkv6, "rwkv6_wkv", wkv_ops.rwkv6_wkv_cuda)
    mine = grads()
    assert mine.keys() == theirs.keys()
    for path in mine:
        assert _rel(mine[path].numpy(), theirs[path].numpy()) <= 1e-5, path
    for path in ("blocks/decay_base", "blocks/decay_w1", "blocks/decay_w2", "blocks/u"):
        assert mine[path].abs().max() > 0, path
    assert mine["blocks/u"].dtype == mine["blocks/decay_base"].dtype == torch.float32


@pytest.mark.parametrize("n_layers, remat, want", [
    (14, "full", (35, 14)),   # groups of 2: 3 L - L / 2, chip_smoke.py's cut depth
    (15, "full", (30, 15)),   # groups of 1: 3 L - L
    (16, "full", (46, 16)),   # groups of 8: 3 L - L / 8
    (2, "full", (5, 2)),      # the train slice: one group of 2
    (6, "full", (15, 6)),     # groups of 2
    (4, "none", (4, 4)),
])
def test_remat_launch_counts(counting, n_layers, remat, want):
    """One train step's WKV launches under the nested non-reentrant
    checkpoints, as tests/test_torch_train.py measures flash's: the counts
    chip_smoke.py's want_train_launches expects of rwkv6."""
    cfg = _reduced(n_layers)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    toks = torch.randint(0, cfg.vocab, (1, 8), generator=torch.Generator().manual_seed(1))
    step = make_train_step(cfg, remat=remat, ce_chunk=8)
    step(init_train_state(params), {"tokens": toks, "labels": toks})
    assert (counting["fwd"], counting["bwd"]) == want
    assert counting["grad"] == counting["fwd"]  # each a gradient's forward
    if remat == "full":
        expect = chip_smoke.want_train_launches(cfg, torch.bfloat16, 8)
        assert (expect["rwkv6_wkv_fwd"], expect["rwkv6_wkv_bwd"]) == want


def test_forward_of_a_gradient_takes_the_recurrent_route(monkeypatch):
    """route(..., grad=True) is "chunk_exact" wherever the chunk route would
    serve (bf16 at head dim 64, T >= 2), and stays "recurrent" in f32 and
    wherever serving is recurrent; the wrapper launches it there: the entry
    point it calls follows ``grad`` and the dtype alone."""
    for T in (2, 37, 4096):
        assert wkv_kernel.route(torch.bfloat16, 64, T) == "chunk"
        assert wkv_kernel.route(torch.bfloat16, 64, T, grad=True) == "chunk_exact"
        assert wkv_kernel.route(torch.float32, 64, T, grad=True) == "recurrent"
    assert wkv_kernel.route(torch.bfloat16, 64, 1, grad=True) == "recurrent"
    assert wkv_kernel.route(torch.bfloat16, 32, 37, grad=True) == "recurrent"
    launched = []
    monkeypatch.setattr(wkv_kernel, "_check", lambda *a: None)
    monkeypatch.setattr(wkv_kernel, "launch", lambda rt, *a: launched.append(rt))
    case = (1, 37, 2, 64, False, False, "model")
    args = _torch(_inputs(case, seed=6)[:6], torch.bfloat16)
    wkv_kernel.rwkv6_wkv_fwd(*args)
    wkv_kernel.rwkv6_wkv_fwd(*args, grad=True)
    wkv_kernel.rwkv6_wkv_fwd(*_torch(_inputs(case, seed=6)[:6]), grad=True)
    assert launched == ["chunk", "chunk_exact", "recurrent"]
