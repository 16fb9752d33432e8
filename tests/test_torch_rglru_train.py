"""The port's recurrentgemma-2b training against the JAX package's, on the CPU.

The RG-LRU scan's backward: ``rglru_scan_bwd_reference`` (the backward
kernel's plain version) against ``jax.vjp`` of the JAX package's
``rglru_reference`` and against ``torch.autograd`` of the port's, on the
same numpy inputs, cotangents on h and h_last and a nonzero h0.  Tolerance
1e-6 relative (||a - b|| / ||b||) and absolute in f32: every side runs the
same f32 steps in the same order (up to a fused multiply-add).  In bf16
2**-7 relative: the kernel's plain version reads the forward's h rounded to
bf16 where autograd reads the f32 state, and rounds da and db once.
``rglru_scan_op`` is checked by ``torch.autograd.gradcheck`` in float64 with
both kernel calls stood in by their plain versions.  The CUDA kernels
cannot run here; the wrappers' checks are tested without a card.

Then the slice: a recurrentgemma ``make_train_step`` against the reference's
on ``recurrentgemma-2b.reduced()`` (2e-4, as tests/test_torch_train.py
holds qwen3's), the prefill and decode steps (2e-4 on logits, greedy tokens
equal), and the training CLI's SIGTERM checkpoint and resume.
"""
import contextlib
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.data import SyntheticLMDataset as JaxDataset
from repro.kernels.rglru_scan import rglru_reference as jax_reference
from repro.models import lm as jax_lm
from repro.optim import init_train_state as jax_init_train_state
from repro.train import make_decode_step as jax_make_decode_step
from repro.train import make_prefill_step as jax_make_prefill_step
from repro.train import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.kernels.rglru_scan import (rglru_reference, rglru_scan_bwd,
                                            rglru_scan_bwd_reference, rglru_scan_fwd,
                                            rglru_scan_op)
from repro_torch.kernels.rglru_scan import kernel as scan_kernel
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.launch import train as train_mod
from repro_torch.models import lm
from repro_torch.optim import init_train_state
from repro_torch.train import make_decode_step, make_prefill_step, make_train_step
from repro_torch.tree import leaves, paths

NAME = "recurrentgemma-2b"
TOL = 2e-4
REL_TOL = {"float32": 1e-6, "bfloat16": 2**-7}
# B, T, W, h0 given, a cotangent on h_last: ragged T and W, one step, no
# state either way
SCAN_CASES = [(2, 37, 100, True, True), (1, 1, 64, True, True), (2, 23, 48, False, False),
              (3, 16, 8, True, False)]


def _scan_inputs(case, seed):
    """a = sigmoid(N(0,1)), b = N(0,1)*0.1, h0 = N(0,1) as the JAX kernel test;
    the cotangents dh and dh_last N(0,1)."""
    B, T, W, with_h0, with_dl = case
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, W))))).astype(np.float32)
    b = (rng.standard_normal((B, T, W)) * 0.1).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32) if with_h0 else None
    dh = rng.standard_normal((B, T, W)).astype(np.float32)
    dl = rng.standard_normal((B, W)).astype(np.float32) if with_dl else None
    return a, b, h0, dh, dl


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_rel(a, b, tol):
    a, b = _f32(a).astype(np.float64), _f32(b).astype(np.float64)
    norm = np.linalg.norm(b)
    rel = np.linalg.norm(a - b) / norm if norm > 0 else np.linalg.norm(a - b)
    assert rel <= tol, f"relative error {rel:.3e} > {tol}"


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_f32(a), _f32(b), atol=tol, rtol=tol)


def _port_bwd(case, dtype, seed):
    """The plain backward of the port's scan on a case: (da, db, dh0), and
    the inputs it took, as numpy f32."""
    a, b, h0, dh, dl = _scan_inputs(case, seed)
    td = getattr(torch, dtype)
    ta, tb, tdh = _t(a, td), _t(b, td), _t(dh, td)
    h, _ = rglru_reference(ta, tb, _t(h0))
    return rglru_scan_bwd_reference(ta, h, _t(h0), tdh, _t(dl)), (ta, tb, tdh)


# --- the scan's backward -----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SCAN_CASES, ids=str)
def test_scan_backward_matches_jax_vjp(case, dtype):
    a, b, h0, dh, dl = _scan_inputs(case, seed=sum(case[:3]))
    (da, db, dh0), (ta, tb, tdh) = _port_bwd(case, dtype, seed=sum(case[:3]))
    jd = getattr(jnp, dtype)
    # the same rounded inputs on both sides
    ja, jb, jdh = (jnp.asarray(x.float().numpy()).astype(jd) for x in (ta, tb, tdh))
    jh0 = jnp.zeros((case[0], case[2]), jnp.float32) if h0 is None else jnp.asarray(h0)
    _, vjp = jax.vjp(jax_reference, ja, jb, jh0)
    jl = jnp.zeros_like(jh0) if dl is None else jnp.asarray(dl)
    jda, jdb, jdh0 = vjp((jdh, jl))
    assert da.dtype == db.dtype == getattr(torch, dtype) and da.shape == ta.shape
    assert dh0.dtype == torch.float32 and dh0.shape == (case[0], case[2])
    tol = REL_TOL[dtype]
    for mine, theirs in ((da, jda), (db, jdb), (dh0, jdh0)):
        _close_rel(mine, theirs, tol)
        if dtype == "float32":
            np.testing.assert_allclose(_f32(mine), _f32(theirs), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SCAN_CASES, ids=str)
def test_scan_backward_matches_torch_autograd(case, dtype):
    a, b, h0, dh, dl = _scan_inputs(case, seed=7 + sum(case[:3]))
    (da, db, dh0), (ta, tb, tdh) = _port_bwd(case, dtype, seed=7 + sum(case[:3]))
    leaf = [ta.clone().requires_grad_(True), tb.clone().requires_grad_(True),
            (torch.zeros(case[0], case[2]) if h0 is None else _t(h0)).requires_grad_(True)]
    h, h_last = rglru_reference(*leaf)
    grads = torch.autograd.grad(
        (h, h_last), leaf, (tdh, torch.zeros_like(h_last) if dl is None else _t(dl)))
    for mine, theirs in zip((da, db, dh0), grads):
        _close_rel(mine, theirs, REL_TOL[dtype])


def test_scan_backward_takes_no_cotangent_on_h_last_as_zero():
    a, b, h0, dh, _ = _scan_inputs(SCAN_CASES[0], seed=3)
    h, _ = rglru_reference(_t(a), _t(b), _t(h0))
    without = rglru_scan_bwd_reference(_t(a), h, _t(h0), _t(dh), None)
    with_zero = rglru_scan_bwd_reference(_t(a), h, _t(h0), _t(dh), torch.zeros_like(_t(h0)))
    for x, y in zip(without, with_zero):
        assert torch.equal(x, y)


@pytest.fixture
def plain_kernels(monkeypatch):
    """rglru_scan_op's two kernel calls stood in by their plain versions, counted."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(a, b, h0):
        calls["fwd"] += 1
        return rglru_reference(a, b, h0)

    def bwd(a, h, h0, dh, dh_last):
        calls["bwd"] += 1
        return rglru_scan_bwd_reference(a, h, h0, dh, dh_last)

    monkeypatch.setattr(scan_ops, "rglru_scan_fwd", fwd)
    monkeypatch.setattr(scan_ops, "rglru_scan_bwd", bwd)
    return calls


@pytest.mark.parametrize("case", [(1, 5, 3, True, True), (2, 4, 2, False, True)], ids=str)
def test_function_gradcheck_with_plain_stand_ins(case, plain_kernels):
    """rglru_scan_op's wiring, in float64: what forward saves, the order of the
    gradients backward returns, dh0 only where h0 takes a gradient."""
    a, b, h0, _, _ = _scan_inputs(case, seed=11)
    args = [torch.from_numpy(x).double().requires_grad_(True) for x in (a, b)]
    if h0 is not None:
        args.append(torch.from_numpy(h0).double().requires_grad_(True))
    h, h_last = rglru_scan_op(*args, *([None] if h0 is None else []), True)
    assert h.grad_fn is not None and plain_kernels == {"fwd": 1, "bwd": 0}
    (h.sum() + h_last.sum()).backward()
    assert plain_kernels == {"fwd": 1, "bwd": 1}
    assert torch.autograd.gradcheck(
        lambda *x: rglru_scan_op(*x, *([None] if h0 is None else []), True), args,
        eps=1e-6, atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("used", ["h", "h_last"])
def test_function_takes_an_unused_output_as_zero(used, plain_kernels):
    """Autograd leaves the cotangent of an unused output undefined: the
    backward takes it as zero, as the plain version's autograd does."""
    a, b, h0, _, _ = _scan_inputs(SCAN_CASES[3], seed=12)
    mine = [torch.from_numpy(x).requires_grad_(True) for x in (a, b, h0)]
    theirs = [x.detach().clone().requires_grad_(True) for x in mine]
    out = dict(zip(("h", "h_last"), rglru_scan_op(*mine, True)))
    ref = dict(zip(("h", "h_last"), rglru_reference(*theirs)))
    got = torch.autograd.grad(out[used].square().sum(), mine)
    want = torch.autograd.grad(ref[used].square().sum(), theirs)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)


def test_function_saves_nothing_without_grad(plain_kernels):
    a, b, h0, _, _ = _scan_inputs(SCAN_CASES[3], seed=13)
    h, h_last = scan_ops.rglru_scan_cuda(_t(a), _t(b), _t(h0))
    assert h.grad_fn is None and h_last.grad_fn is None and plain_kernels["fwd"] == 1


@pytest.mark.parametrize("grad_mode", ["no_grad", "inference_mode", "enable_grad"])
def test_entry_saves_only_for_a_gradient(grad_mode, plain_kernels, monkeypatch):
    """rglru_scan on the card (rglru_scan_cuda) saves a, h and h0 only when
    the call makes a gradient: grad mode on and an input that requires
    grad.  Under no_grad or inference_mode on inputs that require grad,
    ctx.needs_input_grad is still true, but nothing is saved."""
    saved = []
    save = torch.autograd.function.FunctionCtx.save_for_backward

    def counted_save(ctx, *tensors):
        saved.extend(tensors)
        return save(ctx, *tensors)
    monkeypatch.setattr(torch.autograd.function.FunctionCtx, "save_for_backward", counted_save)
    a, b, h0, _, _ = _scan_inputs(SCAN_CASES[3], seed=14)
    args = [_t(x).requires_grad_(True) for x in (a, b, h0)]
    context = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
               "enable_grad": torch.enable_grad}[grad_mode]
    with context():
        h, h_last = scan_ops.rglru_scan_cuda(*args)
    grad = grad_mode == "enable_grad"
    assert len(saved) == 3 * grad and plain_kernels == {"fwd": 1, "bwd": 0}
    assert (h.grad_fn is not None) == (h_last.grad_fn is not None) == grad


# --- the wrappers' checks ----------------------------------------------------

class _OnCuda:
    """A CPU tensor that reports a CUDA device, so the wrappers' checks run here."""
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
    monkeypatch.setattr(scan_kernel, "build", refuse)
    monkeypatch.setattr(scan_kernel, "build_bwd", refuse)
    scan_kernel._bwd_library.cache_clear()


def test_backward_wrapper_refuses_cpu_tensors(no_build):
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="rglru_scan_bwd: a is on cpu, not a CUDA device"):
        rglru_scan_bwd(x, x, None, x)
    assert rglru_scan_bwd.launches == 0


def _bwd_args(**change):
    """a, h, h0, dh, dh_last of a (2, 4, 8) f32 case as _OnCuda; ``change``
    replaces one of them."""
    args = {"a": torch.zeros(2, 4, 8), "h": torch.zeros(2, 4, 8), "h0": torch.zeros(2, 8),
            "dh": torch.zeros(2, 4, 8), "dh_last": torch.zeros(2, 8)}
    args.update(change)
    return [None if t is None else _OnCuda(t) for t in args.values()]


@pytest.mark.parametrize("change, error, match", [
    ({"h": torch.zeros(2, 5, 8)}, ValueError, "h is torch.float32 .2, 5, 8., a torch.float32"),
    ({"dh": torch.zeros(2, 4, 8, dtype=torch.bfloat16)}, ValueError, "dh is torch.bfloat16"),
    ({n: torch.zeros(2, 4, 8, dtype=torch.float64) for n in ("a", "h", "dh")}, TypeError,
     "dtype torch.float64"),
    ({"h0": torch.zeros(2, 8, dtype=torch.bfloat16)}, ValueError, "h0 must be float32"),
    ({"dh_last": torch.zeros(2, 9)}, ValueError, r"dh_last must be float32 of shape \(2, 8\)"),
    ({"dh": torch.zeros(2, 8, 4).transpose(1, 2)}, ValueError, "dh must be contiguous"),
    ({"a": torch.zeros(2, 0, 8), "h": torch.zeros(2, 0, 8), "dh": torch.zeros(2, 0, 8)},
     ValueError, "B, T and W must be at least 1"),
], ids=["h shape", "dh dtype", "f64", "h0 dtype", "dh_last shape", "strided", "T 0"])
def test_backward_wrapper_refuses_bad_input(change, error, match, no_build):
    with pytest.raises(error, match=f"rglru_scan_bwd: {match}"):
        rglru_scan_bwd(*_bwd_args(**change))


def test_backward_wrapper_passes_good_input_to_the_allocation(no_build):
    """Past the checks, the stand-in fails to allocate on this CPU (no build)."""
    for args in (_bwd_args(), _bwd_args(h0=None, dh_last=None)):
        with pytest.raises(Exception) as err:
            rglru_scan_bwd(*args)
        assert "rglru_scan_bwd:" not in str(err.value)


def test_function_refuses_cpu_tensors_and_wrong_dtypes(no_build):
    """rglru_scan_op is the card's path: on CPU tensors its forward kernel call
    refuses them, and on a wrong h0 the kernel's wrapper it calls names the fault."""
    a, b = torch.rand(1, 4, 8, requires_grad=True), torch.rand(1, 4, 8)
    with pytest.raises(ValueError, match="rglru_scan_fwd: a is on cpu, not a CUDA device"):
        rglru_scan_op(a, b, None, True)
    with pytest.raises(ValueError, match="rglru_scan_fwd: h0 must be float32"):
        rglru_scan_fwd(_OnCuda(a.detach()), _OnCuda(b), _OnCuda(torch.zeros(1, 8).double()))


def _offset(shape, dtype, elems):
    """A contiguous tensor of ``shape`` that starts ``elems`` elements into
    a fresh allocation (which starts on a 64-byte boundary)."""
    n = int(np.prod(shape))
    return torch.zeros(n + elems, dtype=dtype)[elems:].view(shape)


@pytest.mark.parametrize("dtype, W, elems, want", [
    (torch.float32, 2560, 0, "tma"),        # recurrentgemma-2b's width
    (torch.bfloat16, 2560, 0, "tma"),
    (torch.float32, 100, 0, "tma"),         # 400-byte rows
    (torch.bfloat16, 100, 0, "prefetch"),   # 200-byte rows
    (torch.float32, 2, 0, "prefetch"),      # 8-byte rows
    (torch.float32, 2560, 1, "prefetch"),   # 4 bytes off a 16-byte boundary
    (torch.bfloat16, 2560, 4, "prefetch"),  # 8 bytes off
    (torch.bfloat16, 2560, 8, "tma"),       # 16 bytes in: on a boundary
], ids=str)
def test_backward_route_follows_alignment_and_row_bytes(dtype, W, elems, want):
    """bwd_route() takes TMA only where a tensor map can cover a, h and dh:
    each on a 16-byte boundary, a row a multiple of 16 bytes.  Any one of the
    three off its boundary sends the launch to the prefetch route."""
    shape = (2, 5, W)
    moved = _offset(shape, dtype, elems)
    whole = torch.zeros(shape, dtype=dtype)
    assert scan_kernel.bwd_route(moved, moved, moved) == want
    for i in range(3):
        args = [whole] * 3
        args[i] = moved
        assert scan_kernel.bwd_route(*args) == want


class _ScanLibrary:
    """Counting stand-ins for the backward library's entry points: each
    records its route and its dtype, B, T and W."""

    def __init__(self):
        self.calls = []

        def entry(name):
            def call(*args):
                self.calls.append((name, args[8:12]))
                return 0
            return call
        self.rglru_scan_bwd_tma = entry("tma")
        self.rglru_scan_bwd_prefetch = entry("prefetch")


def test_backward_wrapper_calls_the_entry_point_route_names_and_counts_it(monkeypatch):
    """With the library and the device stood in, each call reaches the entry
    point bwd_route() names and adds one to launches and to
    launches_by_route on that route only; reset_launches() zeroes both."""
    lib = _ScanLibrary()
    monkeypatch.setattr(scan_kernel, "_bwd_library", lambda: lib)
    monkeypatch.setattr(scan_kernel, "_check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: type("Stream", (), {"cuda_stream": 0})())
    scan_kernel.reset_launches()
    calls = [(torch.float32, 2560, 0), (torch.bfloat16, 100, 0), (torch.float32, 2560, 1),
             (torch.bfloat16, 2560, 0), (torch.float32, 96, 0)]
    for dtype, W, elems in calls:
        x = _offset((2, 3, W), dtype, elems)
        da, db, dh0 = rglru_scan_bwd(x, x, None, x, None)
        assert da.shape == db.shape == x.shape and da.dtype == dtype
        assert dh0.shape == (2, W) and dh0.dtype == torch.float32
    want = [scan_kernel.bwd_route(*[_offset((2, 3, W), dtype, elems)] * 3)
            for dtype, W, elems in calls]
    assert [name for name, _ in lib.calls] == want == ["tma", "prefetch", "prefetch", "tma",
                                                       "tma"]
    assert [args for _, args in lib.calls] == [
        (0, 2, 3, 2560), (1, 2, 3, 100), (0, 2, 3, 2560), (1, 2, 3, 2560), (0, 2, 3, 96)]
    assert rglru_scan_bwd.launches == len(calls)
    assert rglru_scan_bwd.launches_by_route == {"tma": 3, "prefetch": 2}
    scan_kernel.reset_launches()
    assert (rglru_scan_bwd.launches, rglru_scan_bwd.launches_by_route) == (
        0, dict.fromkeys(scan_kernel.BWD_ROUTES, 0))


# --- the slice: train, prefill and decode steps ------------------------------

STEP_KW = dict(lr=1e-2, warmup=2, total=10, ce_chunk=8)
B, S, DECODE_STEPS = 2, 24, 4  # the prompt is longer than the reduced window (16)


@pytest.fixture(scope="module")
def models():
    """(jax cfg, jax params, port cfg): one set of seeded f32 weights as jax arrays."""
    cfg = get_config(NAME).reduced()
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    return JAX_ARCHS[NAME].reduced(), jparams, cfg


def _port(jparams):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)


@pytest.fixture(scope="module")
def jax_step(models):
    """One JAX train step on one batch, shared by the port's remat modes
    (jax.checkpoint changes no value)."""
    jcfg, jparams, _ = models
    batch = JaxDataset(jcfg.vocab, 16, seed=0).batch(0, B)
    jstep = jax.jit(jax_make_train_step(jcfg, remat="none", **STEP_KW))
    return batch, jstep(jax_init_train_state(jparams), jax.tree.map(jnp.asarray, batch))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_matches_reference(models, jax_step, remat):
    _, jparams, cfg = models
    batch, (jstate, jm) = jax_step
    state, m = make_train_step(cfg, remat=remat, **STEP_KW)(
        init_train_state(_port(jparams)),
        {k: torch.from_numpy(np.asarray(v)).long() for k, v in batch.items()})
    assert int(m["tokens"]) == int(jm["tokens"]) == B * 16
    _close(m["loss"].item(), float(jm["loss"]))
    _close(m["grad_norm"].item(), float(jm["grad_norm"]))
    assert int(state["step"]) == int(jstate["step"]) == 1
    assert isinstance(state["master"]["blocks"], list)  # a hybrid: one dict a layer
    for path, mine, theirs in zip(paths(state), leaves(state), jax.tree.leaves(jstate)):
        assert tuple(mine.shape) == theirs.shape, path
        _close(mine.detach().numpy(), theirs)


def test_prefill_and_decode_steps_match_reference(models):
    """make_prefill_step over a prompt longer than the window, then 4 greedy
    make_decode_step steps: logits within 2e-4, the tokens equal."""
    jcfg, jparams, cfg = models
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jprefill = jax.jit(jax_make_prefill_step(jcfg))
    jdecode = jax.jit(jax_make_decode_step(jcfg))
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    jlogits, jcache = jprefill(jparams, jax_lm.init_cache(jcfg, B, 32, jnp.float32),
                              {"tokens": jnp.asarray(tokens)})
    params = _port(jparams)
    logits, cache = prefill(params, lm.init_cache(cfg, B, 32, torch.float32, "cpu"),
                            {"tokens": torch.from_numpy(tokens).long()})
    _close(logits, jlogits)
    jtoks, toks = [], []
    for _ in range(DECODE_STEPS):
        jcur = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        cur = torch.argmax(logits, -1)[:, None]
        jtoks.append(np.asarray(jcur))
        toks.append(cur.numpy())
        jlogits, jcache = jdecode(jparams, jcache, {"tokens": jcur})
        logits, cache = decode(params, cache, {"tokens": cur})
        _close(logits, jlogits)
    assert cache["pos"] == int(jcache["pos"]) == S + DECODE_STEPS
    np.testing.assert_array_equal(np.concatenate(toks, 1), np.concatenate(jtoks, 1))


# --- the training CLI on recurrentgemma --------------------------------------

CLI_ARGS = ["--arch", NAME, "--reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
            "--remat", "full", "--log-every", "100"]


@pytest.fixture
def signals():
    """The training CLI installs SIGTERM and SIGINT handlers; put back the ones found."""
    found = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield found
    for s, h in found.items():
        signal.signal(s, h)


def test_train_driver_sigterm_checkpoint_and_resume(tmp_path, monkeypatch, signals):
    """SIGTERM arrives while step 2's batch is made: the step finishes, a
    checkpoint at step 3 is written and main returns 0; a second run resumes
    from it and runs only the remaining steps to 5.  The resumed run's state
    equals a straight run's to 5."""
    class Preempted(SyntheticLMDataset):
        def batch(self, step, batch_size, **kw):
            if step == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return super().batch(step, batch_size, **kw)

    ckpt, straight = str(tmp_path / "ck"), str(tmp_path / "straight")
    with monkeypatch.context() as m:
        m.setattr(train_mod, "SyntheticLMDataset", Preempted)
        assert train_mod.main(CLI_ARGS + ["--steps", "5", "--ckpt-dir", ckpt]) == 0
    mgr = CheckpointManager(ckpt)
    assert mgr.latest_step() == 3
    assert {signal.getsignal(s) for s in signals} == set(signals.values())
    assert train_mod.main(CLI_ARGS + ["--steps", "5", "--ckpt-dir", ckpt]) == 0
    assert mgr.latest_step() == 5
    assert train_mod.main(CLI_ARGS + ["--steps", "5", "--ckpt-dir", straight]) == 0
    a = np.load(f"{ckpt}/step_00000005/arrays.npz")
    b = np.load(f"{straight}/step_00000005/arrays.npz")
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key])
