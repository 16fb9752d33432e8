"""The WKV kernel's two chunked training routes, on the CPU.

The forward of a gradient in bf16 at head dim 64 takes the ``chunk_exact``
route (``csrc/rwkv6_wkv_fwd_exact_sm90.cu``) and its backward the ``chunk``
route (``csrc/rwkv6_wkv_bwd_sm90.cu``).  Both run only on the card.  Their
schedule is emulated here in plain PyTorch as the kernels take it: the
chain (``csrc/rwkv6_wkv_chain_sm90.cuh``) walks chunks of 64 steps, each
decay a running product of w from the nearest boundary of a chunk or of a
16-step sub-chunk, the decayed operand (k . P(s + 1, e) for the state, r .
P(c, t) for the gradient) in three bf16 pieces times an operand exact in
bf16 (v, dy), accumulated in the working dtype; then the forward walks each
chunk from its state a step at a time, as the recurrence, and the
backward's job takes each chunk apart at its sub-chunks' boundaries (their
states and gradients in products with split operands, the sums inside a
sub-chunk by running products).  The emulation runs in f32 and in float64
against the JAX package's ``rwkv6_reference`` and ``jax.vjp`` of it, within
1e-5 relative, on the same numpy inputs: w exactly 0, exactly 1 and
exp(-100) at chunk and sub-chunk edges, a T that is not a multiple of 64, T
= 2, s0 and ds_last given and absent.  With bf16 inputs each route's
outputs, rounded once, stay within the recurrence's own rounding, where one
bf16 rounding of the decayed operand would miss it.  Then the route rules
over every case ``chip_smoke.py`` launches, the wrappers' entry-point calls
and counts under stand-ins, and rwkv6's remat launch counts by route.
"""
import contextlib
import dataclasses
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_wkv import rwkv6_reference as jax_reference
from repro_torch.configs import get_config
from repro_torch.kernels.rwkv6_wkv import kernel as wkv_kernel
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.kernels.rwkv6_wkv import rwkv6_reference, rwkv6_wkv_bwd_reference
from repro_torch.models import lm, rwkv6
from repro_torch.optim import init_train_state
from repro_torch.train import make_train_step

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

C, SUB = 64, 16  # steps a chunk and a sub-chunk, as in the chain
EDGE_STEPS = chip_smoke.WKV_EDGE_STEPS  # w 0, 1, exp(-100) at chunk and sub-chunk edges

# (B, T, H, D, s0 given, a cotangent on s_last, decay), as chip_smoke's
# WKV_BWD_CASES: "edges" is the model's decay with EDGE_STEPS forced on the
# even channels.
CASES = {
    "edges-130": (1, 130, 2, 64, True, True, "edges"),
    "edges-200-bare": (2, 200, 1, 64, False, False, "edges"),
    "full-128": (1, 128, 2, 64, True, False, "model"),
    "T-2": (2, 2, 2, 64, True, True, "sigmoid"),
    "T-2-bare": (1, 2, 3, 64, False, True, "model"),
}


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
    """r, k, v, w and dy in ``dtype``; u, s0 and ds_last in f32."""
    return [None if a is None else torch.from_numpy(a).to(
        dtype if i in (0, 1, 2, 3, 6) else torch.float32) for i, a in enumerate(arrays)]


def _within_one_rounding(out, ref):
    """Both sides round f32 sums that agree to f32 rounding once to bf16:
    each element equal, or one bf16 step apart where the two sums straddle a
    rounding boundary, which few do."""
    out, ref = out.float(), ref.float()
    step = torch.where(ref == 0, torch.full_like(ref, 2.0**-133),
                       2.0 ** (torch.floor(torch.log2(ref.abs())) - 7))
    assert ((out - ref).abs() <= step).all()
    assert (out != ref).float().mean() <= 1e-3


def _within_one_rounding_of_exact(out, exact):
    """A bf16 output of an f32 sum against the float64 value: each element
    within one bf16 step of it, plus 2**-24 of the largest |value| (the f32
    rounding of the sum's terms, which shows where the sum cancels)."""
    out, exact = out.double(), exact.double()
    step = torch.where(exact == 0, torch.full_like(exact, 2.0**-133),
                       2.0 ** (torch.floor(torch.log2(exact.abs())) - 7))
    assert ((out - exact).abs() <= step + 2.0**-24 * exact.abs().max()).all()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    norm = np.linalg.norm(b)
    return np.linalg.norm(a - b) / norm if norm else np.linalg.norm(a - b)


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def _split3(x):
    """hi + mid + lo, each rounded to bf16, as the chain splits its operand."""
    hi = _bf16(x)
    mid = _bf16(x - hi)
    return hi + mid + _bf16(x - hi - mid)


def _padded(x, n_chunks, fill, dtype):
    """(B, T, H, D) -> (B, H, n_chunks C, D) in ``dtype``: past T ``fill``
    (zeros; w = 1), as the kernels take the ragged last chunk."""
    B, T, H, D = x.shape
    out = torch.full((B, n_chunks * C, H, D), fill, dtype=dtype)
    out[:, :T] = x.to(dtype)
    return out.permute(0, 2, 1, 3)


def chain(a, b, w, init, direction, *, pieces=3):
    """The chain in one direction over (B, H, n C, D) operands: X starts at
    ``init`` (or zeros); chunk by chunk (forwards for direction 0, the state,
    backwards for 1, the gradient), X is recorded at the chunk's edge, then
    X <- diag(P(c, e)) X + (decayed a)^T b, the decayed a rounded in
    ``pieces`` bf16 pieces (3: the kernels' split; 1: one rounding; 0: none).
    Returns (X at each chunk's edge, X at the end)."""
    B, H, Tp, D = a.shape
    n = Tp // C
    X = torch.zeros((B, H, D, D), dtype=a.dtype) if init is None else init.to(a.dtype)
    edges = [None] * n
    for c in (range(n) if direction == 0 else reversed(range(n))):
        edges[c] = X
        sl = slice(c * C, (c + 1) * C)
        ws, as_ = (x[:, :, sl].reshape(B, H, 4, SUB, D) for x in (w, a))
        pr = torch.empty_like(ws)  # P(t + 1, b_q + 16) or P(b_q, t), running products
        run = torch.ones_like(ws[..., 0, :])
        for tau in (reversed(range(SUB)) if direction == 0 else range(SUB)):
            pr[..., tau, :] = run
            run = run * ws[..., tau, :]
        g = run  # P(b_q, b_q + 16)
        other = torch.ones_like(g)  # P(b_q + 16, e) or P(c, b_q)
        for q in range(4):
            for p in range(4):
                if (p > q) if direction == 0 else (p < q):
                    other[:, :, q] = other[:, :, q] * g[:, :, p]
        d = ((as_ * pr) * other[..., None, :]).reshape(B, H, C, D)
        d = {3: _split3, 1: _bf16, 0: lambda x: x}[pieces](d)
        decay = g[:, :, 0] * g[:, :, 1] * g[:, :, 2] * g[:, :, 3]
        X = decay[..., None] * X + d.transpose(-1, -2) @ b[:, :, sl]
    return edges, X


def _chunked(x):
    """(B, H, n C, D) -> (B, H, n, C, D)."""
    B, H, Tp, D = x.shape
    return x.reshape(B, H, Tp // C, C, D)


def exact_forward(r, k, v, w, u, s0=None, *, dtype=torch.float32, pieces=3):
    """The chunk_exact route: the chain's state at each chunk's start, then
    each chunk (all at once) walked a step at a time from it, y rounded once
    to r.dtype.  Returns (y, s_last in ``dtype``)."""
    B, T, H, D = r.shape
    n = -(-T // C)
    rr, kk, vv = (_padded(x, n, 0.0, dtype) for x in (r, k, v))
    ww = _padded(w, n, 1.0, dtype)
    states, s_last = chain(kk, vv, ww, s0, 0, pieces=pieces)
    S = torch.stack(states, dim=2)  # (B, H, n, D, D)
    rc, kc, vc, wc = (_chunked(x) for x in (rr, kk, vv, ww))
    uu = u.to(dtype)[None, :, None, :]
    ys = []
    for t in range(C):
        rt, kt, vt, wt = (x[:, :, :, t] for x in (rc, kc, vc, wc))
        ys.append(torch.einsum("bhni,bhnij->bhnj", rt, S)
                  + (uu * rt * kt).sum(-1, keepdim=True) * vt)
        S = wt[..., None] * S + kt[..., None] * vt[..., None, :]
    y = torch.stack(ys, dim=3).reshape(B, H, n * C, D)[:, :, :T]
    return y.permute(0, 2, 1, 3).to(r.dtype), s_last


# Z's six piece products: (piece of G_E, piece of the decayed k), of three each.
Z_PIECES = ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1))


def _pieces3(x):
    hi = _bf16(x)
    mid = _bf16(x - hi)
    return hi, mid, _bf16(x - hi - mid)


def chunk_backward(r, k, v, w, u, s0, dy, ds_last, *, dtype=torch.float32, pieces=3):
    """The backward's chunk route: the chain both ways (S at each chunk's
    start, G at its end, ds0 at the end), then each chunk's job (all at
    once) as the kernel takes it: the 16-step sub-chunks' boundary states S_b
    and gradients G_E chained from them, the products X = dY S_b^T, Y = V
    G_E^T and Z = (K . P(. + 1, e_q)) G_E with their operands split
    (``pieces`` as chain(); Z six of its nine piece products), M = dY V^T,
    the scores A, the row sums S_b . G_E, and each (sub-chunk, channel)
    walked over its 16 steps with running products and the carried sums.
    Returns (dr, dk, dv, dw) in r.dtype, du and ds0 in ``dtype``."""
    B, T, H, D = r.shape
    n = -(-T // C)
    rr, kk, vv, dd = (_padded(x, n, 0.0, dtype) for x in (r, k, v, dy))
    ww = _padded(w, n, 1.0, dtype)
    states, _ = chain(kk, vv, ww, s0, 0, pieces=pieces)
    grads, ds0 = chain(rr, dd, ww, ds_last, 1, pieces=pieces)
    split = {3: _split3, 1: _bf16, 0: lambda x: x}[pieces]
    # (B, H, n, 4, SUB, D): sub-chunk q, its step tau
    rs, ks, vs, ws, ds = (x.reshape(B, H, n, 4, SUB, D) for x in (rr, kk, vv, ww, dd))
    pre, suf = torch.empty_like(ws), torch.empty_like(ws)  # P(b_q, t), P(t + 1, e_q)
    run = torch.ones_like(ws[..., 0, :])
    for tau in range(SUB):
        pre[..., tau, :] = run
        run = run * ws[..., tau, :]
    g_fwd, run = run, torch.ones_like(run)
    for tau in reversed(range(SUB)):
        suf[..., tau, :] = run
        run = run * ws[..., tau, :]
    g_bwd = run
    k_dec, r_dec = ks * suf, rs * pre
    S, G = torch.stack(states, 2), torch.stack(grads, 2)
    Sb, Ge = [None] * 4, [None] * 4
    for q in range(4):
        Sb[q] = S
        S = g_bwd[:, :, :, q, :, None] * S + split(k_dec[:, :, :, q]).transpose(-1, -2) @ vs[:, :, :, q]
    for q in reversed(range(4)):
        Ge[q] = G
        G = g_fwd[:, :, :, q, :, None] * G + split(r_dec[:, :, :, q]).transpose(-1, -2) @ ds[:, :, :, q]
    Sb, Ge = torch.stack(Sb, 3), torch.stack(Ge, 3)  # (B, H, n, 4, D, D)
    X = ds @ split(Sb).transpose(-1, -2)  # X[tau][i] = S_b[i] . dy_tau
    Y = vs @ split(Ge).transpose(-1, -2)  # Y[tau][i] = G_E[i] . v_tau
    if pieces == 3:
        pg, pk = _pieces3(Ge), _pieces3(k_dec)
        Z = sum(pk[b] @ pg[a] for a, b in Z_PIECES)
    else:
        Z = split(k_dec) @ split(Ge)
    M = ds @ vs.transpose(-1, -2)  # M[a][b] = dy_a . v_b
    rows = (Sb * Ge).sum(-1)
    uu = u.to(dtype)[None, :, None, None, :]
    urk = (uu[..., None, :] * rs * ks).sum(-1)
    A = torch.zeros(M.shape, dtype=dtype)  # A[s'][t] = sum_i r_s' k_t P(t + 1, s'), s' > t
    for tau in range(SUB):
        run = torch.ones_like(ws[..., 0, :])
        for sp in range(tau + 1, SUB):
            A[..., sp, tau] = (ks[..., tau, :] * run * rs[..., sp, :]).sum(-1)
            run = run * ws[..., sp, :]
    out = {x: torch.empty_like(rs) for x in ("dr", "dk", "dv", "dw")}
    c = torch.zeros_like(rs)  # c[s'] = sum_{s<t} P(s + 1, t) k_s M[s'][s]
    Rs = torch.zeros_like(rs[..., 0, :])  # sum_{s<t} P(s + 1, t) k_s Y_s
    pr = torch.ones_like(Rs)  # P(b_q, t)
    zero = torch.zeros_like(Rs)
    for tau in range(SUB):
        beta, run = {}, torch.ones_like(Rs)  # P(t + 1, s') r_s'; run ends at P(t + 1, e_q)
        for sp in range(tau + 1, SUB):
            beta[sp] = run * rs[..., sp, :]
            run = run * ws[..., sp, :]
        t4 = sum((beta[sp] * c[..., sp, :] for sp in beta), zero)
        dki = sum((beta[sp] * M[..., sp, tau, None] for sp in beta), zero)
        qx = sum((beta[sp] * X[..., sp, :] for sp in beta), zero)
        mtt = M[..., tau, tau, None]
        out["dr"][..., tau, :] = pr * X[..., tau, :] + c[..., tau, :] + uu * ks[..., tau, :] * mtt
        out["dk"][..., tau, :] = run * Y[..., tau, :] + dki + uu * rs[..., tau, :] * mtt
        out["dw"][..., tau, :] = pr * run * rows + pr * qx + run * Rs + t4
        out["dv"][..., tau, :] = (Z[..., tau, :] + ds[..., tau, :] * urk[..., tau, None]
                                  + sum((A[..., sp, tau, None] * ds[..., sp, :] for sp in beta),
                                        zero))
        wt, kt = ws[..., tau, :], ks[..., tau, :]
        for sp in range(tau + 1, SUB):
            c[..., sp, :] = wt * c[..., sp, :] + kt * M[..., sp, tau, None]
        Rs = wt * Rs + kt * Y[..., tau, :]
        pr = pr * wt
    du = (rs * ks * torch.diagonal(M, dim1=-2, dim2=-1)[..., None]).sum((0, 2, 3, 4))
    grads4 = [out[x].reshape(B, H, n * C, D)[:, :, :T].permute(0, 2, 1, 3).to(r.dtype)
              for x in ("dr", "dk", "dv", "dw")]
    return (*grads4, du, ds0)


@pytest.fixture(scope="module")
def jax_refs():
    """Each case's y and s_last by the JAX package's plain version, and its
    gradients by jax.vjp of it (s0 and ds_last absent as zeros), once."""
    out = {}
    for n, (name, case) in enumerate(CASES.items()):
        r, k, v, w, u, s0, dy, ds_last = _inputs(case, seed=n)
        B, _, H, D = r.shape
        zeros = np.zeros((B, H, D, D), np.float32)
        (y, s_last), vjp = jax.vjp(jax_reference, *(jnp.asarray(a) for a in (
            r, k, v, w, u, zeros if s0 is None else s0)))
        grads = vjp((jnp.asarray(dy), jnp.asarray(zeros if ds_last is None else ds_last)))
        out[name] = [np.asarray(x) for x in (y, s_last, *grads)]
    return out


def test_cases_hold_the_edges_at_chunk_and_sub_chunk_boundaries():
    """w exactly 0, exactly 1 and exp(-100) at chunk edges (63, 64, 127,
    128, 129) and sub-chunk edges (15, 16, 31, 32), a T that is not a
    multiple of 64, T = 2, s0 and ds_last given and absent."""
    steps = {t for ts in EDGE_STEPS.values() for t in ts}
    assert {15, 16, 31, 32, 63, 64, 127, 128, 129} <= steps
    w = _inputs(CASES["edges-130"], seed=0)[3]
    assert (w == 0).any() and (w == 1).any()
    deep = w[(w > 0) & (w < 1e-38)]
    assert deep.size and np.log(deep.astype(np.float64)).min() < -99
    Ts = {c[1] for c in CASES.values()}
    assert 2 in Ts and any(T % C and T > C for T in Ts)
    assert {(c[4], c[5]) for c in CASES.values()} == {(True, True), (False, False),
                                                       (True, False), (False, True)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(CASES))
def test_exact_forward_schedule_matches_jax(jax_refs, name, dtype):
    """The chunk_exact schedule, in f32 and float64 with the chain's
    three-piece split, against the JAX package's plain version and the
    port's: y and s_last within 1e-5, all finite."""
    arrays = _inputs(CASES[name], seed=list(CASES).index(name))
    args = _torch(arrays)[:6]
    y, s_last = exact_forward(*args, dtype=dtype)
    assert torch.isfinite(y).all() and torch.isfinite(s_last).all()
    ry, rs = rwkv6_reference(*args)
    jy, js = jax_refs[name][:2]
    for ref_y, ref_s in ((jy, js), (ry.numpy(), rs.numpy())):
        assert _rel(y.numpy(), ref_y) <= 1e-5
        assert _rel(s_last.numpy(), ref_s) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(CASES))
def test_chunk_backward_schedule_matches_jax_vjp(jax_refs, name, dtype):
    """The backward's chunk schedule, in f32 and float64 with the chain's
    three-piece splits, against jax.vjp of the JAX package's plain version:
    dr, dk, dv, dw, du and ds0 within 1e-5, all finite."""
    arrays = _inputs(CASES[name], seed=list(CASES).index(name))
    outs = chunk_backward(*_torch(arrays), dtype=dtype)
    for what, out, ref in zip(("dr", "dk", "dv", "dw", "du", "ds0"), outs, jax_refs[name][2:]):
        assert torch.isfinite(out).all(), what
        assert _rel(out.numpy(), ref) <= 1e-5, what


@pytest.mark.parametrize("name", ["edges-130", "edges-200-bare"])
def test_bf16_outputs_stay_within_the_recurrences_own_rounding(name):
    """bf16 inputs, the schedules in f32 with their splits, each output
    rounded once, against the plain versions, which round the recurrence's
    f32 sums once: y equal to theirs but for a few elements one bf16 step
    apart (within 1e-4 relative: a few 1e-5), s_last within 1e-5.  The
    backward sums in another order than the recurrence: dr, dk, dv and dw,
    like the plain version's own, within one rounding of the float64
    gradient (plus f32 rounding where its sums cancel), few elements apart
    from the plain version's; du and ds0 (f32) within 1e-5."""
    args = _torch(_inputs(CASES[name], seed=11), torch.bfloat16)
    y, s_last = exact_forward(*args[:6])
    ry, rs = rwkv6_reference(*args[:6])
    assert y.dtype == torch.bfloat16
    _within_one_rounding(y, ry)
    assert _rel(y.float().numpy(), ry.float().numpy()) <= 1e-4
    assert _rel(s_last.numpy(), rs.numpy()) <= 1e-5
    outs = chunk_backward(*args)
    refs = rwkv6_wkv_bwd_reference(*args)
    exact = rwkv6_wkv_bwd_reference(*(None if a is None else a.double() for a in args))
    for what, out, ref, want in zip(("dr", "dk", "dv", "dw", "du", "ds0"), outs, refs, exact):
        assert out.dtype == ref.dtype, what
        if what in ("du", "ds0"):
            assert _rel(out.numpy(), ref.numpy()) <= 1e-5, what
        else:
            _within_one_rounding_of_exact(out, want)
            _within_one_rounding_of_exact(ref, want)
            assert (out != ref).float().mean() <= 1e-3, what


def test_one_rounding_of_the_decayed_operand_would_miss_it():
    """Why the chain takes three pieces: with one bf16 rounding of the
    decayed k (r) instead, s_last (ds0) moves far past 1e-5 and y (dk, whose
    chunk gradient the chain gives) past 1e-4, where three pieces hold."""
    args = _torch(_inputs(CASES["edges-200-bare"][:5] + (True, "model"), seed=12),
                  torch.bfloat16)
    ry, rs = rwkv6_reference(*args[:6])
    y1, s1 = exact_forward(*args[:6], pieces=1)
    assert _rel(s1.numpy(), rs.numpy()) > 1e-4
    assert _rel(y1.float().numpy(), ry.float().numpy()) > 1e-4
    refs = rwkv6_wkv_bwd_reference(*args)
    one = chunk_backward(*args, pieces=1)
    assert _rel(one[5].numpy(), refs[5].numpy()) > 1e-4          # ds0
    assert _rel(one[1].float().numpy(), refs[1].float().numpy()) > 1e-4  # dk
    three = chunk_backward(*args)
    assert _rel(three[5].numpy(), refs[5].numpy()) <= 1e-5


def test_route_tables_on_every_case_chip_smoke_launches():
    """route() and bwd_route() over chip_smoke's WKV cases: bf16 at head
    dim 64 with T >= 2 in chunks (served: chunk; a gradient's forward:
    chunk_exact; the backward: chunk); T = 1, f32 and head dims 8-32
    recurrent."""
    route, bwd_route = wkv_kernel.route, wkv_kernel.bwd_route

    def chunked(dtype, D, T):
        return dtype == torch.bfloat16 and D == 64 and T >= 2
    for dtype in (torch.float32, torch.bfloat16):
        for case in chip_smoke.WKV_CASES + chip_smoke.WKV_GRAD_CASES:
            T, D = case[1], case[3]
            assert route(dtype, D, T) == ("chunk" if chunked(dtype, D, T) else "recurrent")
            assert route(dtype, D, T, grad=True) == (
                "chunk_exact" if chunked(dtype, D, T) else "recurrent")
        for case in chip_smoke.WKV_BWD_CASES:
            T, D = case[1], case[3]
            assert bwd_route(dtype, D, T) == ("chunk" if chunked(dtype, D, T) else "recurrent")
    bf16_bwd = {bwd_route(torch.bfloat16, c[3], c[1]) for c in chip_smoke.WKV_BWD_CASES}
    assert bf16_bwd == set(wkv_kernel.BWD_ROUTES) == {"chunk", "recurrent"}
    assert {route(torch.bfloat16, c[3], c[1], grad=True)
            for c in chip_smoke.WKV_GRAD_CASES} == {"chunk_exact"}
    assert set(wkv_kernel.ROUTES) == {"chunk", "chunk_exact", "recurrent"}
    # the bf16 backward cases at 64 include T ragged against the chunk and T = 2
    ragged = [c for c in chip_smoke.WKV_BWD_CASES
              if bwd_route(torch.bfloat16, c[3], c[1]) == "chunk" and c[1] % C]
    assert any(c[1] > C and c[6] == "edges" for c in ragged)
    assert any(c[1] == 2 for c in chip_smoke.WKV_BWD_CASES)
    assert wkv_kernel.CHUNK_STEPS == C


class _Library:
    """Stand-ins for the libraries' chunked entry points: each records its
    route and arguments and returns 0."""

    def __init__(self):
        self.calls = []
        for name in ("rwkv6_wkv_fwd_chunk", "rwkv6_wkv_fwd_chunk_exact",
                     "rwkv6_wkv_fwd_recurrent", "rwkv6_wkv_bwd", "rwkv6_wkv_bwd_chunk"):
            setattr(self, name, self._entry(name))
        for name in ("rwkv6_wkv_fwd_error_string", "rwkv6_wkv_bwd_error_string",
                     "rwkv6_wkv_bwd_chunk_error_string"):
            setattr(self, name, lambda err: b"an error the stand-in names")

    def _entry(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def library(monkeypatch):
    """Both libraries and the device stood in; the chunk states' scratch
    recorded as the wrapper sizes it."""
    lib, scratch = _Library(), []
    real = wkv_kernel._chunk_states

    def chunk_states(*shape_and_device):
        out = real(*shape_and_device)
        scratch.append(out.numel())
        return out
    monkeypatch.setattr(wkv_kernel, "_library", lambda: lib)
    monkeypatch.setattr(wkv_kernel, "_bwd_library", lambda: lib)
    monkeypatch.setattr(wkv_kernel, "_chunk_states", chunk_states)
    monkeypatch.setattr(wkv_kernel, "_check_inputs", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: type("Stream", (), {"cuda_stream": 0})())
    wkv_kernel.reset_launches()
    yield lib, scratch
    wkv_kernel.reset_launches()


def test_wrappers_call_the_chunked_entry_points_and_count_them(library):
    """A gradient's forward in bf16 at head dim 64 reaches the chunk_exact
    entry point: 8 pointers, then the chunk states' scratch (B H ceil(T /
    64) D^2 floats), B, T, H, D and the stream; the backward the chunk
    entry: 17 pointers (the states' and gradients' scratch, each of that
    size, and the du partials), B, T, H, D and the stream.  Each adds one to
    its launches on its route only."""
    lib, scratch = library
    r, k, v, w, u, s0, dy, ds_last = _torch(_inputs(CASES["edges-130"], seed=3),
                                            torch.bfloat16)
    B, T, H, D = r.shape
    states = B * H * math.ceil(T / C) * D * D
    y, s_last = wkv_kernel.rwkv6_wkv_fwd(r, k, v, w, u, s0, grad=True)
    name, args = lib.calls[-1]
    assert name == "rwkv6_wkv_fwd_chunk_exact" and len(args) == 9 + 4 + 1
    assert args[9:13] == (B, T, H, D) and scratch == [states]
    assert y.dtype == torch.bfloat16 and s_last.shape == (B, H, D, D)
    outs = wkv_kernel.rwkv6_wkv_bwd(r, k, v, w, u, None, dy, ds_last)
    name, args = lib.calls[-1]
    assert name == "rwkv6_wkv_bwd_chunk" and len(args) == 17 + 4 + 1
    assert args[5] is None and args[7] is not None and args[17:21] == (B, T, H, D)
    assert scratch == [states] * 3
    assert [o.dtype for o in outs] == [torch.bfloat16] * 4 + [torch.float32] * 2
    assert wkv_kernel.rwkv6_wkv_fwd.launches_by_route == {"chunk": 0, "chunk_exact": 1,
                                                          "recurrent": 0}
    assert wkv_kernel.rwkv6_wkv_bwd.launches_by_route == {"chunk": 1, "recurrent": 0}
    # f32 stays recurrent both ways, with the dtype argument
    f32 = _torch(_inputs(CASES["edges-130"], seed=3))
    wkv_kernel.rwkv6_wkv_fwd(*f32[:6], grad=True)
    assert lib.calls[-1][0] == "rwkv6_wkv_fwd_recurrent" and lib.calls[-1][1][8] == 0
    wkv_kernel.rwkv6_wkv_bwd(*f32)
    assert lib.calls[-1][0] == "rwkv6_wkv_bwd" and lib.calls[-1][1][17] == 0
    assert wkv_kernel.rwkv6_wkv_fwd.launches_by_route == {"chunk": 0, "chunk_exact": 1,
                                                          "recurrent": 1}
    assert wkv_kernel.rwkv6_wkv_bwd.launches_by_route == {"chunk": 1, "recurrent": 1}
    assert wkv_kernel.rwkv6_wkv_fwd.launches == wkv_kernel.rwkv6_wkv_bwd.launches == 2


def test_bwd_launch_counts_the_route_it_is_given(library):
    """bwd_launch, which chip_smoke.py times the recurrent route through at
    the train shape, counts the route it is given, not bwd_route()'s."""
    lib, _ = library
    args = _torch(_inputs(CASES["T-2"], seed=5), torch.bfloat16)
    wkv_kernel.bwd_launch("recurrent", *args)
    assert lib.calls[-1][0] == "rwkv6_wkv_bwd" and lib.calls[-1][1][17] == 1
    assert wkv_kernel.rwkv6_wkv_bwd.launches_by_route == {"chunk": 0, "recurrent": 1}


def test_chunked_routes_refuse_a_misaligned_tensor(library):
    """TMA and the 16-byte loads of the chunked routes need 16-byte aligned
    tensors; the wrappers say so before any launch."""
    lib, _ = library
    r, k, v, w, u, s0, dy, ds_last = _torch(_inputs(CASES["T-2"], seed=6), torch.bfloat16)
    odd = torch.empty(r.numel() + 1, dtype=torch.bfloat16)[1:].view(r.shape)
    odd.copy_(r)
    with pytest.raises(ValueError, match="r must start on a 16-byte boundary for the chunk_exact"):
        wkv_kernel.rwkv6_wkv_fwd(odd, k, v, w, u, s0, grad=True)
    with pytest.raises(ValueError, match="dy must start on a 16-byte boundary for the chunk"):
        wkv_kernel.rwkv6_wkv_bwd(r, k, v, w, u, s0, odd, ds_last)
    assert lib.calls == []


@pytest.fixture
def by_route(monkeypatch):
    """rwkv6's WKV entry point sent through rwkv6_wkv_op on the CPU, each kernel
    call stood in by its plain version and counted on the route the
    wrapper's rule names."""
    n = {"fwd": dict.fromkeys(wkv_kernel.ROUTES, 0),
         "bwd": dict.fromkeys(wkv_kernel.BWD_ROUTES, 0)}

    def fwd(r, k, v, w, u, s0, grad=False):
        n["fwd"][wkv_kernel.route(r.dtype, r.shape[3], r.shape[1], grad)] += 1
        return rwkv6_reference(r, k, v, w, u, s0)

    def bwd(r, *args):
        n["bwd"][wkv_kernel.bwd_route(r.dtype, r.shape[3], r.shape[1])] += 1
        return rwkv6_wkv_bwd_reference(r, *args)
    monkeypatch.setattr(wkv_ops, "rwkv6_wkv_fwd", fwd)
    monkeypatch.setattr(wkv_ops, "rwkv6_wkv_bwd", bwd)
    monkeypatch.setattr(rwkv6, "rwkv6_wkv", wkv_ops.rwkv6_wkv_cuda)
    return n


@pytest.mark.parametrize("n_layers, want", [(14, (35, 14)), (2, (5, 2))],
                         ids=["cut-depth", "slice"])
def test_remat_launch_counts_by_route(by_route, n_layers, want):
    """A bf16 train step at head dim 64, remat "full": every WKV forward on
    the chunk_exact route and every backward on the chunk route, the counts
    chip_smoke.py's want_train_launches expects by route (rwkv6-7b's 14
    layers and its 2-layer slice)."""
    cfg = dataclasses.replace(get_config("rwkv6-7b").reduced(), d_model=128,
                              rwkv_head_dim=64, n_layers=n_layers)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), torch.bfloat16, "cpu")
    toks = torch.randint(0, cfg.vocab, (1, 8), generator=torch.Generator().manual_seed(1))
    make_train_step(cfg, remat="full", ce_chunk=8)(init_train_state(params),
                                                   {"tokens": toks, "labels": toks})
    fwd, bwd = want
    assert by_route["fwd"] == {"chunk": 0, "chunk_exact": fwd, "recurrent": 0}
    assert by_route["bwd"] == {"chunk": bwd, "recurrent": 0}
    expect = chip_smoke.want_train_launches(cfg, torch.bfloat16, 8)
    assert expect["rwkv6_wkv_fwd by route"] == by_route["fwd"]
    assert expect["rwkv6_wkv_bwd by route"] == by_route["bwd"]
