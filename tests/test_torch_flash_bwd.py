"""The flash-attention backward's plain versions and its wiring, on the CPU.

``flash_attention_bwd_reference`` (the backward kernels' plain version) is
held against ``jax.vjp`` of the JAX package's ``chunked_attention`` and
``attention_reference`` and against ``torch.autograd`` of the port's
``chunked_attention``, and ``lse_reference`` (the plain version of the lse
the forward writes) against ``jax.nn.logsumexp``, in f32, on the same numpy
inputs.  Tolerance 1e-5 relative (||a - b|| / ||b||) and 1e-5 absolute per
element: every side computes in f32 from the same inputs and differs only
in the order of its sums (the gradients are of magnitude about 1).  The
tensor-core backward's tile schedule is emulated in numpy and held against
the plain backward at the same tolerance; the tensor-core forward's at
(96, 64) and (80, 80) against the plain forward, exactly in f32 and, with P
rounded to bf16, within the route's tolerances on the card.  ``FlashAttention`` is checked by
``torch.autograd.gradcheck`` in float64 with both kernel calls stood in by
their plain versions.  The CUDA kernels cannot run here; the wrappers'
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
                                                 flash_attention_bwd_reference, lse_reference)
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
    (1, 40, 40, 16, 1, 256, True, 12, 0, None),       # recurrentgemma's: GQA 16:1, window
    (2, 37, 70, 4, 1, 256, True, 24, 33, None),       # 256, a window past q_offset, ragged
    (2, 50, 50, 16, 16, 80, False, None, 0, None),    # hubert-xlarge's: 80, bidirectional
    # the masks hubert never sets at its head dim, where every bf16 call takes
    # the tensor cores (chip_smoke.AT_80_MASKS)
    (2, 77, 130, 8, 2, 80, True, 33, 20, None),       # ragged, GQA, window, q_offset
    (2, 70, 200, 8, 2, 80, False, None, 0, 150),      # kv_len < Sk
    (1, 64, 64, 4, 2, 80, False, None, 0, 0),         # kv_len 0
]


def _inputs(seed, case, dims=None):
    """q, k, v and dout of the case from seed, at head dims ``dims`` (Dk,
    Dv) where given, else at the case's D."""
    B, Sq, Sk, H, KH, D = case[:6]
    dk, dv = dims or (D, D)
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, dk), (B, Sk, KH, dk), (B, Sk, KH, dv), (B, Sq, H, dv))]


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
    _check_against_jax_vjp(case, *_inputs(CASES.index(case), case))


def _check_against_jax_vjp(case, q, k, v, do):
    """The plain backward on numpy f32 inputs against jax.vjp of the JAX
    package's chunked_attention, and of its attention_reference where every
    row sees a key; where some row sees none, that row's dq is 0."""
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


def _jax_lse(q, k, case):
    """jax.nn.logsumexp of the JAX reference's masked, scaled scores (its
    attention_reference's s, before the softmax), 0 where a row sees no key;
    (B, H, Sq)."""
    B, Sq, Sk, H, KH, D, causal, window, q_offset, kv_len = case
    s = jnp.einsum("bqhgd,bkhd->bqhgk", jnp.asarray(q).reshape(B, Sq, KH, H // KH, D),
                   jnp.asarray(k)) * (1.0 / D ** 0.5)
    qi, kj = q_offset + jnp.arange(Sq)[:, None], jnp.arange(Sk)[None, :]
    mask = jnp.ones((Sq, Sk), dtype=bool)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    if kv_len is not None:
        mask &= kj < kv_len
    lse = jax.nn.logsumexp(jnp.where(mask[None, :, None, None, :], s, -jnp.inf), axis=-1)
    lse = jnp.where(jnp.isfinite(lse), lse, 0.0)
    return np.asarray(lse).reshape(B, Sq, H).transpose(0, 2, 1)


@pytest.mark.parametrize("case", CASES)
def test_lse_reference_matches_jax_logsumexp(case):
    """Each row's log-sum-exp over the keys it sees, 0 for a row that sees
    none (kv_len 0, and the first rows at q_offset -4).  Tolerance 1e-5: both
    sides sum the same f32 scores in another order."""
    q, k, v, _ = _inputs(300 + CASES.index(case), case)
    lse = lse_reference(*map(torch.from_numpy, (q, k, v)), **_kw(case))
    B, Sq, H = case[0], case[1], case[3]
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    _close(lse.numpy(), _jax_lse(q, k, case))
    if _sees_nothing(case):
        rows = slice(None) if case[9] == 0 else slice(0, -case[8])
        assert np.all(lse.numpy()[:, :, rows] == 0)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_given_the_lse_equals_itself_without(case):
    """The backward's plain version reading lse_reference's lse, as the
    kernels read the forward's, gives the very values it gives when it
    recomputes the lse itself."""
    q, k, v, do = map(torch.from_numpy, _inputs(400 + CASES.index(case), case))
    kw = _kw(case)
    o = chunked_attention(q, k, v, **kw)
    given = flash_attention_bwd_reference(q, k, v, o, do, lse=lse_reference(q, k, v, **kw), **kw)
    for a, b in zip(given, flash_attention_bwd_reference(q, k, v, o, do, **kw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", CASES[-3:])
def test_plain_backward_on_bf16_values_at_80_matches_jax_vjp(case):
    """The masks at (80, 80) on inputs rounded to bf16, as the card's bf16
    cases get them, computed in f32 on both sides (1e-5)."""
    _check_against_jax_vjp(case, *(_bf16(x) for x in _inputs(600 + CASES.index(case), case)))


def test_plain_backward_of_padded_heads_is_zero():
    """recurrentgemma's 10 heads padded to 16 over 1 kv head: gqa_block zeroes
    the padded heads' output, so their dout is 0.  Their dq comes back 0 (not
    NaN), and dk and dv are those of the 10 real heads alone."""
    case = (1, 24, 24, 16, 1, 256, True, 8, 0, None)
    q, k, v, do = map(torch.from_numpy, _inputs(500, case))
    do[:, :, 10:] = 0
    kw = _kw(case)
    o = chunked_attention(q, k, v, **kw)
    dq, dk, dv = flash_attention_bwd_reference(q, k, v, o, do, **kw)
    assert torch.isfinite(dq).all() and torch.all(dq[:, :, 10:] == 0)
    _, dk10, dv10 = flash_attention_bwd_reference(q[:, :, :10], k, v, o[:, :, :10],
                                                  do[:, :, :10], **kw)
    _close(dk.numpy(), dk10.numpy())
    _close(dv.numpy(), dv10.numpy())


# The tensor-core backward's tiles at each head-dim pair
# (csrc/flash_attention_bwd_sm90.cu, Tiles<DK, DV>): a dK/dV block owns BKV
# kv rows and takes BQ query rows a step; a dQ block owns QROWS query rows,
# CROWS a consumer, and takes KROWS kv rows a step.  At D 128 and (96, 64) a
# dK/dV consumer owns CROWS of the block's kv rows, every query column of a
# step and every column of dK and dV (QCOLS = BQ); at D 256 both consumers
# take all BKV kv rows, split a step's S^T and dP^T by query columns (QCOLS
# each), share P^T and dS^T, and split dK and dV by head-dim columns (D / 2
# each).  LAYOUT_DIMS: the head dims a layout is emulated at where they are
# not the case's own D (at (80, 80) D 128's tiles, Dk and Dv each in two
# chunks, the second zero past 80, and dK, dV and dQ at 128 columns).
LAYOUTS = {"d128": (128, 64, 128, 64, 64, 64), "d256": (64, 64, 128, 32, 64, 32),
           "d96x64": (128, 64, 128, 64, 64, 64), "d80x80": (128, 64, 128, 64, 64, 64)}
LAYOUT_DIMS = {"d96x64": (96, 64), "d80x80": (80, 80)}
CHUNK = 64  # the columns of a 128-byte swizzled chunk of bf16 in shared memory


def _visible(qpos, kpos, causal, window, kv_len):
    """Element-wise: key position kpos visible to query position qpos."""
    vis = kpos < kv_len
    if causal:
        vis = vis & (kpos <= qpos)
    if window > 0:
        vis = vis & (kpos > qpos - window)
    return vis


def _chunked(x, d):
    """x with its last dim, d columns, zero-filled to whole chunks (CHUNK
    columns), as TMA fills a tile's last chunk past d."""
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, -(-d // CHUNK) * CHUNK - d)])


def _ksteps(a, b, depth):
    """a @ b.T over the first ``depth`` columns in k16 steps, as issue_qk
    issues them: depth / 16 steps, a count fixed by the head dim, step kk
    reading 16 columns of chunk kk / 4, so the zero columns past depth are
    never read."""
    assert depth % 16 == 0
    return sum(a[:, 16 * kk:16 * kk + 16] @ b[:, 16 * kk:16 * kk + 16].T
               for kk in range(depth // 16))


def _emulate_wgmma_backward(q, k, o, dout, lse, v, case, layout):
    """numpy, block by block and step by step as the two kernels schedule the
    work in ``layout`` (LAYOUTS): which q steps a dK/dV block walks (every
    head of its group) and which kv tiles a dQ block walks, the "none
    visible" skips and each consumer's "all visible" fast path (held here
    against the element-wise masks), the masks, the split of a step between
    the consumers, and the ragged tails (rows beyond Sq or Sk read as 0).
    Head dims from the arrays (Dk of q and k, Dv of v and dout): each tile
    zero-filled to whole chunks; S^T and S in Dk / 16 k-steps, dP^T and dP
    in Dv / 16; dK, dV and dQ accumulated at whole chunks (at Dk 96, dK and
    dQ at 128 columns over the zero half chunk), the columns past Dk and Dv
    held to come out 0 and never stored.  In f32, without the kernels' bf16
    rounding of P and dS: the schedule is the point."""
    BKV, BQ, QROWS, KROWS, CROWS, QCOLS = layout
    split = QCOLS < BQ
    B, Sq, Sk, H, KH, _, causal, window, q_offset, kv_len = case
    Dk, Dv = q.shape[-1], v.shape[-1]
    win = -1 if window is None else window
    kv_len = Sk if kv_len is None else min(kv_len, Sk)
    G, scale = H // KH, 1.0 / Dk ** 0.5
    pad = max(BKV, QROWS)

    def padded(x, rows, d):  # zero rows to a multiple of the tiles, zero columns to chunks
        x = _chunked(x, d)
        return np.concatenate([x, np.zeros((x.shape[0], rows, *x.shape[2:]), x.dtype)], 1)
    qp, kp = padded(q, pad, Dk), padded(k, pad, Dk)
    vp, dop = padded(v, pad, Dv), padded(dout, pad, Dv)
    delta = np.pad((dout * o).sum(-1).transpose(0, 2, 1), ((0, 0), (0, 0), (0, pad)))
    lsep = np.pad(lse, ((0, 0), (0, 0), (0, pad)))
    dq = np.zeros((B, Sq, H, qp.shape[-1]), np.float32)
    dk = np.zeros((B, Sk, KH, kp.shape[-1]), np.float32)
    dv = np.zeros((B, Sk, KH, vp.shape[-1]), np.float32)

    def probs(qrows, krows, h, kvh, b):
        """P and dS of query rows qrows and kv rows krows, masked."""
        s = _ksteps(qp[b, qrows, h], kp[b, krows, kvh], Dk) * scale
        vis = (qrows[:, None] < Sq) & _visible(q_offset + qrows[:, None], krows[None, :],
                                                causal, win, kv_len)
        p = np.where(vis, np.exp(s - lsep[b, h, qrows][:, None]), 0.0)
        dp = _ksteps(dop[b, qrows, h], vp[b, krows, kvh], Dv)
        return p, p * (dp - delta[b, h, qrows][:, None]), vis

    for b in range(B):
        for kvh in range(KH):
            for k0 in range(0, Sk, BKV):  # a dK/dV block
                nk = min(BKV, Sk - k0)
                i_lo, i_hi = 0, Sq
                if causal:
                    i_lo = max(i_lo, k0 - q_offset)
                if win > 0:
                    i_hi = min(i_hi, k0 + nk - 1 + win - q_offset)
                if k0 >= kv_len:
                    i_hi = i_lo
                t_begin = i_lo // BQ
                n_t = (i_hi + BQ - 1) // BQ - t_begin if i_hi > i_lo else 0
                if split:
                    _emulate_split_dkdv(k0, b, kvh, t_begin, n_t, layout, case, scale, probs, qp,
                                        dop, dk, dv)
                    continue
                for cw in range(2):
                    kr0 = k0 + CROWS * cw
                    krows = np.arange(kr0, kr0 + CROWS)
                    for g in range(G * n_t):
                        h, q0 = kvh * G + g // n_t, (t_begin + g % n_t) * BQ
                        qp0 = q_offset + q0
                        none = (kr0 >= kv_len or (causal and kr0 > qp0 + BQ - 1)
                                or (win > 0 and kr0 + CROWS - 1 <= qp0 - win))
                        qrows = np.arange(q0, q0 + BQ)
                        p, ds, vis = probs(qrows, krows, h, kvh, b)
                        if none:
                            assert not vis.any()
                            continue
                        all_ = (kr0 + CROWS - 1 < kv_len and q0 + BQ <= Sq
                                and (not causal or kr0 + CROWS - 1 <= qp0)
                                and (win <= 0 or kr0 > qp0 + BQ - 1 - win))
                        assert not all_ or vis.all()
                        keep = krows < Sk
                        dv[b, krows[keep], kvh] += (p.T @ dop[b, qrows, h])[keep]
                        dk[b, krows[keep], kvh] += (ds.T @ qp[b, qrows, h])[keep] * scale
    for b in range(B):
        for h in range(H):
            kvh = h // G
            for q0 in range(0, Sq, QROWS):  # a dQ block
                nq = min(QROWS, Sq - q0)
                q_first = q_offset + q0
                kv_end = min(kv_len, q_first + nq) if causal else kv_len
                kv_begin = max(0, q_first - win + 1) if win > 0 else 0
                t_begin = kv_begin // KROWS
                t_end = (kv_end + KROWS - 1) // KROWS if kv_end > kv_begin else t_begin
                for cw in range(2):
                    qp_lo = q_first + CROWS * cw
                    qp_hi = qp_lo + CROWS - 1
                    qrows = np.arange(q0 + CROWS * cw, q0 + CROWS * cw + CROWS)
                    for t in range(t_begin, t_end):
                        kp0 = t * KROWS
                        none = (CROWS * cw >= nq or kp0 >= kv_len or (causal and kp0 > qp_hi)
                                or (win > 0 and kp0 + KROWS - 1 <= qp_lo - win))
                        krows = np.arange(kp0, kp0 + KROWS)
                        _, ds, vis = probs(qrows, krows, h, kvh, b)
                        if none:
                            assert not vis.any()
                            continue
                        all_ = (kp0 + KROWS <= kv_len and CROWS * cw + CROWS <= nq
                                and (not causal or kp0 + KROWS - 1 <= qp_lo)
                                and (win <= 0 or kp0 > qp_hi - win))
                        assert not all_ or vis.all()
                        keep = qrows < Sq
                        dq[b, qrows[keep], h] += (ds @ kp[b, krows, kvh])[keep] * scale
    for acc, d in ((dq, Dk), (dk, Dk), (dv, Dv)):  # past the head dim: 0, and not stored
        assert not acc[..., d:].any()
    return dq[..., :Dk], dk[..., :Dk], dv[..., :Dv]


def _emulate_split_dkdv(k0, b, kvh, t_begin, n_t, layout, case, scale, probs, qp, dop, dk, dv):
    """A dK/dV block of the D 256 layout: a step none of whose pairs the
    block's kv rows see is skipped by both consumers; consumer cw forms P^T
    and dS^T of query columns QCOLS cw .. QCOLS cw + QCOLS - 1, and then owns
    the half cw of the columns of dK and dV over all of them."""
    BKV, BQ, _, _, _, QCOLS = layout
    _, Sq, Sk, H, KH, _, causal, window, q_offset, kv_len = case
    win = -1 if window is None else window
    kv_len = Sk if kv_len is None else min(kv_len, Sk)
    half_k, half_v = dk.shape[-1] // 2, dv.shape[-1] // 2
    krows = np.arange(k0, k0 + BKV)
    keep = krows < Sk
    for g in range(H // KH * n_t):
        h, q0 = kvh * (H // KH) + g // n_t, (t_begin + g % n_t) * BQ
        qp0 = q_offset + q0
        qrows = np.arange(q0, q0 + BQ)
        p, ds, vis = probs(qrows, krows, h, kvh, b)
        if (k0 >= kv_len or (causal and k0 > qp0 + BQ - 1)
                or (win > 0 and k0 + BKV - 1 <= qp0 - win)):
            assert not vis.any()
            continue
        pt, dst = np.zeros((BKV, BQ), np.float32), np.zeros((BKV, BQ), np.float32)
        for cw in range(2):  # S^T and dP^T by query columns
            qc0 = QCOLS * cw
            cols = slice(qc0, qc0 + QCOLS)
            all_ = (k0 + BKV - 1 < kv_len and q0 + qc0 + QCOLS <= Sq
                    and (not causal or k0 + BKV - 1 <= qp0 + qc0)
                    and (win <= 0 or k0 > qp0 + qc0 + QCOLS - 1 - win))
            assert not all_ or vis[cols].all()
            pt[:, cols], dst[:, cols] = p[cols].T, ds[cols].T
        for cw in range(2):  # dK and dV by head-dim columns, P^T and dS^T shared
            kcols = slice(half_k * cw, half_k * cw + half_k)
            vcols = slice(half_v * cw, half_v * cw + half_v)
            dv[b, krows[keep], kvh, vcols] += (pt @ dop[b, qrows, h, vcols])[keep]
            dk[b, krows[keep], kvh, kcols] += (dst @ qp[b, qrows, h, kcols])[keep] * scale


SCHEDULE_CASES = [
    (2, 250, 333, 8, 2, 16, True, 150, 83, 300),     # ragged, GQA, window, q_offset, kv_len
    (1, 300, 300, 4, 2, 16, True, None, 0, None),    # causal, ragged last tiles
    (1, 130, 200, 2, 1, 16, False, None, 0, 150),    # bidirectional, kv_len < Sk
    (1, 64, 64, 2, 1, 16, False, None, 0, 0),        # kv_len 0: no row sees a key
    (1, 200, 200, 2, 2, 16, True, None, -70, None),  # the first 70 rows see no key
    (1, 100, 300, 4, 1, 16, True, 64, 200, None),    # a short window far into the keys
    # tile edges: the last q row that sees kv tile 0 (row 192, window 66) and the
    # first key q tile 128 sees (key 63) each alone in their tile; causal
    # diagonals 1 and 62 rows off the 64-row grid
    (1, 260, 260, 2, 1, 16, True, 66, 0, None),
    (1, 200, 256, 2, 1, 16, True, None, 1, None),
    (1, 130, 256, 2, 1, 16, True, None, 62, None),
    (1, 256, 256, 2, 1, 16, False, 63, 0, None),     # a window's edge on the grid, no causal
    # recurrentgemma's head dim: its 10 real heads over 1 kv head, a window
    # across the 64-row tiles, ragged, past q_offset
    (1, 150, 170, 10, 1, 256, True, 70, 20, None),
]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("case", SCHEDULE_CASES)
def test_wgmma_backward_tile_schedule_matches_plain_backward(case, layout):
    """The emulated schedule of the tensor-core backward, in each head dim's
    layout (at (96, 64) in its own: the case's shape and masks at those head
    dims), against the plain backward on the same inputs and lse, 1e-5
    relative and absolute (f32 on both sides, sums in another order)."""
    q, k, v, do = _inputs(500 + SCHEDULE_CASES.index(case), case, LAYOUT_DIMS.get(layout))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    kw = _kw(case)
    o = chunked_attention(tq, tk, tv, **kw)
    lse = lse_reference(tq, tk, tv, **kw)
    want = flash_attention_bwd_reference(tq, tk, tv, o, tdo, lse=lse, **kw)
    got = _emulate_wgmma_backward(q, k, o.numpy(), do, lse.numpy(), v, case, LAYOUTS[layout])
    for mine, ref in zip(got, want):
        _close(mine, ref.numpy())


# The tensor-core forward's tiles at (96, 64) and (80, 80)
# (csrc/flash_attention_fwd_sm90.cu, launch<96, 64, 128>, launch<80, 80,
# 128>): an item is BQ query rows of one (b, h), walking kv tiles of BK rows.
# Its tolerances on the card (chip_smoke.py: TOL, REL_TOL and LSE_ABS_TOL of
# the route): max |out - ref| 2e-2 and ||out - ref|| / ||ref|| 2**-7 in bf16,
# the lse within 2**-8.
FWD_TILES = (128, 128)
WGMMA_ABS, WGMMA_REL, WGMMA_LSE = 2e-2, 2**-7, 2**-8


def _bf16(x):
    """x rounded to bf16 (to nearest, ties to even, as __float2bfloat16_rn),
    held as f32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16().float().numpy()


def _emulate_wgmma_forward(q, k, v, case, round_bf16=True):
    """numpy, item by item and kv tile by kv tile as attn_fwd_wgmma schedules
    the work: items heaviest q tile first, the kv tiles each walks (from its
    first and last query, the window and kv_len), the all-visible fast path
    (held against the element-wise masks), S in Dk / 16 k-steps over Q and K
    zero-filled to whole chunks, the online softmax in exp2 with the scale
    folded into log2(e) / sqrt(Dk), tile t's P V landing while tile t + 1's
    softmax runs and O and l rescaled after it, P V over V zero-filled to
    whole chunks (at Dv 80, O's columns 80-127 held to come out 0 and never
    stored), rows that see no key 0, and each row's lse.  With
    ``round_bf16``, P is rounded to bf16 for P V and for l, and the output to
    bf16, as the kernel does; without, all in f32.
    Returns o (B, Sq, H, Dv) and lse (B, H, Sq)."""
    BQ, BK = FWD_TILES
    B, Sq, Sk, H, KH, _, causal, window, q_offset, kv_len = case
    Dk, Dv = q.shape[-1], v.shape[-1]
    win = -1 if window is None else window
    kv_len = Sk if kv_len is None else min(kv_len, Sk)
    sl = np.log2(np.e) / np.sqrt(Dk)
    rnd = _bf16 if round_bf16 else (lambda x: x)
    nqt = -(-Sq // BQ)
    qp = np.pad(_chunked(q, Dk), ((0, 0), (0, nqt * BQ - Sq), (0, 0), (0, 0)))
    kp = np.pad(_chunked(k, Dk), ((0, 0), (0, -(-Sk // BK) * BK - Sk), (0, 0), (0, 0)))
    vp = np.pad(_chunked(v, Dv), ((0, 0), (0, -(-Sk // BK) * BK - Sk), (0, 0), (0, 0)))
    o = np.full((B, Sq, H, Dv), np.nan, np.float32)
    lse = np.full((B, H, Sq), np.nan, np.float32)
    for w in range(nqt * H * B):
        q0, hb = (nqt - 1 - w // (H * B)) * BQ, w % (H * B)
        h, b = hb % H, hb // H
        kvh = h // (H // KH)
        nq = min(BQ, Sq - q0)
        q_first, q_last = q_offset + q0, q_offset + q0 + nq - 1
        kv_end = min(kv_len, q_last + 1) if causal else kv_len
        kv_begin = max(0, q_first - win + 1) if win > 0 else 0
        t_begin = kv_begin // BK
        t_end = (kv_end + BK - 1) // BK if kv_end > kv_begin else t_begin
        qpos = q_first + np.arange(BQ)[:, None]
        m, l, acc, last = np.full(BQ, -np.inf), np.zeros(BQ), np.zeros((BQ, vp.shape[-1])), None
        for t in range(t_begin, t_end):
            k0 = t * BK
            s = _ksteps(qp[b, q0:q0 + BQ, h], kp[b, k0:k0 + BK, kvh], Dk)
            vis = _visible(qpos, k0 + np.arange(BK)[None, :], causal, win, kv_len)
            if (k0 + BK <= kv_len and (not causal or k0 + BK - 1 <= q_first)
                    and (win <= 0 or k0 > q_last - win)):
                assert vis[:nq].all()
            else:
                s = np.where(vis, s, -np.inf)
            m_new = np.maximum(m, s.max(1))
            m_sl = np.where(m_new == -np.inf, 0.0, m_new * sl)
            alpha = np.exp2(m * sl - m_sl)
            p = rnd(np.exp2(s * sl - m_sl[:, None]))
            m = m_new
            if last is None:
                l = p.sum(1)
            else:  # the last tile's P V lands, then O and l take this tile's alpha
                acc = (acc + last[0] @ vp[b, last[1]:last[1] + BK, kvh]) * alpha[:, None]
                l = alpha * l + p.sum(1)
            last = (p, k0)
        if last is not None:
            acc = acc + last[0] @ vp[b, last[1]:last[1] + BK, kvh]
        assert not acc[:, Dv:].any()  # past Dv: 0, and not stored
        acc = acc[:, :Dv]
        seen = l > 0
        inv = np.where(seen, 1.0 / np.where(seen, l, 1.0), 0.0)
        o[b, q0:q0 + nq, h] = rnd(acc * inv[:, None])[:nq]
        lse[b, h, q0:q0 + nq] = np.where(
            seen, (m * sl + np.log2(np.where(seen, l, 1.0))) * np.log(2.0), 0.0)[:nq]
    assert not np.isnan(o).any() and not np.isnan(lse).any()  # every row written once
    return o, lse


@pytest.mark.parametrize("case", SCHEDULE_CASES)
def test_wgmma_forward_tile_schedule_at_96_64_matches_plain_forward(case):
    """The emulated schedule of the tensor-core forward at (Dk, Dv) = (96,
    64), on inputs rounded to bf16 as the card gets them: in f32 throughout,
    the output within 1e-5 of chunked_attention (port and JAX) and the lse
    of lse_reference; with P and the output rounded to bf16 as the kernel
    rounds them, within the route's tolerances of chunked_attention, the
    JAX reference and jax.nn.logsumexp."""
    _check_wgmma_forward_schedule(case, (96, 64), 700 + SCHEDULE_CASES.index(case))


@pytest.mark.parametrize("case", SCHEDULE_CASES)
def test_wgmma_forward_tile_schedule_at_80_80_matches_plain_forward(case):
    """The same at hubert-xlarge's (80, 80): Q and K in 5 k-steps, P V over
    V's zero-filled half chunk."""
    _check_wgmma_forward_schedule(case, (80, 80), 800 + SCHEDULE_CASES.index(case))


def _check_wgmma_forward_schedule(case, dims, seed):
    q, k, v, _ = (_bf16(x) for x in _inputs(seed, case, dims))
    kw = _kw(case)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    plain = chunked_attention(tq, tk, tv, **kw).numpy()
    plain_lse = lse_reference(tq, tk, tv, **kw).numpy()
    exact, exact_lse = _emulate_wgmma_forward(q, k, v, case, round_bf16=False)
    _close(exact, plain)
    _close(exact, np.asarray(jax_chunked(*map(jnp.asarray, (q, k, v)), q_chunk=32, k_chunk=32,
                                         **kw)))
    _close(exact_lse, plain_lse)
    out, lse = _emulate_wgmma_forward(q, k, v, case)
    jax_ref = np.asarray(jax_reference(*map(jnp.asarray, (q, k, v)), **kw))
    for ref in (plain, jax_ref):
        diff, norm = np.linalg.norm(out - ref), np.linalg.norm(ref)
        assert (diff / norm if norm > 0 else diff) <= WGMMA_REL
        assert np.abs(out - ref).max() <= WGMMA_ABS
    jax_lse = _jax_lse(q, k, case[:5] + (dims[0],) + case[6:])
    for ref in (plain_lse, jax_lse):
        assert np.abs(lse - ref).max() <= WGMMA_LSE


@pytest.mark.parametrize("case", [(1, 8, 8, 4, 2, 8, True, None, 0, None),
                                  (1, 6, 9, 2, 1, 8, True, 4, 3, 8),
                                  (2, 5, 5, 2, 2, 8, False, None, 0, 3),
                                  (1, 6, 6, 2, 1, 8, True, None, -3, None)])
def test_function_gradcheck_with_plain_stand_ins(case, monkeypatch):
    """FlashAttention's wiring, in float64: what forward saves, the order of
    the gradients backward returns, None for the masks.  Each kernel call is
    stood in by its plain version, and each is counted."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(q, k, v, with_lse=False, **kw):
        calls["fwd"] += 1
        o = attention_reference(q, k, v, **kw)
        return (o, lse_reference(q, k, v, **kw)) if with_lse else o

    def bwd(q, k, v, o, dout, lse, **kw):
        calls["bwd"] += 1
        return flash_attention_bwd_reference(q, k, v, o, dout, lse=lse, **kw)

    monkeypatch.setattr(fa_ops, "flash_attention_fwd", fwd)
    monkeypatch.setattr(fa_ops, "flash_attention_bwd", bwd)
    q, k, v, _ = _inputs(200, case)
    args = [torch.from_numpy(a).double().requires_grad_(True) for a in (q, k, v)]
    causal, window, q_offset, kv_len = case[6:]
    out = FlashAttention.apply(*args, causal, window, q_offset, kv_len, True)
    assert out.grad_fn is not None and calls == {"fwd": 1, "bwd": 0}
    out.sum().backward()
    assert calls == {"fwd": 1, "bwd": 1}
    assert torch.autograd.gradcheck(
        lambda q, k, v: FlashAttention.apply(q, k, v, causal, window, q_offset, kv_len, True),
        args, eps=1e-6, atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("grad_mode", ["no_grad", "inference_mode", "enable_grad"])
def test_entry_writes_the_lse_only_for_a_gradient(grad_mode, monkeypatch):
    """flash_attention on the card (flash_attention_cuda, kernels stood in by
    their plain versions) asks for the lse and saves q, k, v, o and lse only
    when the call makes a gradient: grad mode on and an input that requires
    grad.  Under no_grad or inference_mode on inputs that require grad (a
    trainer's parameters in an eval or a prefill), ctx.needs_input_grad is
    still true, but no lse is written and nothing is saved."""
    calls = {"fwd": 0, "lse": 0, "saved": 0}

    def fwd(q, k, v, with_lse=False, **kw):
        calls["fwd"] += 1
        calls["lse"] += with_lse
        o = attention_reference(q, k, v, **kw)
        return (o, lse_reference(q, k, v, **kw)) if with_lse else o

    save = torch.autograd.function.FunctionCtx.save_for_backward

    def counted_save(ctx, *tensors):
        calls["saved"] += len(tensors)
        return save(ctx, *tensors)
    monkeypatch.setattr(fa_ops, "flash_attention_fwd", fwd)
    monkeypatch.setattr(torch.autograd.function.FunctionCtx, "save_for_backward", counted_save)
    q, k, v, _ = _inputs(201, (1, 8, 8, 4, 2, 16, True, None, 0, None))
    args = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    context = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
               "enable_grad": torch.enable_grad}[grad_mode]
    with context():
        out = fa_ops.flash_attention_cuda(*args, causal=True)
    grad = grad_mode == "enable_grad"
    assert calls == {"fwd": 1, "lse": int(grad), "saved": 5 * grad}
    assert (out.grad_fn is not None) == grad
    torch.testing.assert_close(out, attention_reference(*args, causal=True).detach())


class _OnCuda:
    """A CPU tensor that reports a CUDA device (and, if given, another
    address), so the wrappers' checks run here."""
    device = torch.device("cuda", 0)

    def __init__(self, t, requires_grad=False, ptr=None):
        self._t, self.requires_grad, self._ptr = t, requires_grad, ptr

    dtype = property(lambda self: self._t.dtype)
    shape = property(lambda self: self._t.shape)

    def dim(self):
        return self._t.dim()

    def is_contiguous(self):
        return self._t.is_contiguous()

    def stride(self, *dim):
        return self._t.stride(*dim)

    def data_ptr(self):
        return self._t.data_ptr() if self._ptr is None else self._ptr


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
        flash_attention_bwd(q, q, q, q, q, torch.zeros(1, 2, 8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dk, dv", [(80, 64), (64, 96), (256, 128), (48, 48)])
def test_backward_wrapper_refuses_unsupported_head_dims(dk, dv, dtype, no_build):
    q = _OnCuda(torch.zeros(1, 8, 2, dk, dtype=dtype))
    v = _OnCuda(torch.zeros(1, 8, 2, dv, dtype=dtype))
    with pytest.raises(ValueError, match=r"flash_attention_bwd: head dims .* not supported; "
                                         r"supported: "):
        flash_attention_bwd(q, q, v, v, v, _OnCuda(torch.zeros(1, 2, 8)))


def _bwd_args(dtype, Sq=8, dims=(128, 128), lse_t=None, **ptrs):
    """q, k, v, o, dout, lse of one batch, 4 query heads over 2, as _OnCuda;
    ``ptrs`` moves a tensor to another address."""
    dk, dv = dims
    shapes = {"q": (1, Sq, 4, dk), "k": (1, 8, 2, dk), "v": (1, 8, 2, dv),
              "o": (1, Sq, 4, dv), "dout": (1, Sq, 4, dv)}
    args = [_OnCuda(torch.zeros(shape, dtype=dtype), ptr=ptrs.get(name))
            for name, shape in shapes.items()]
    lse = fa_kernel.empty_lse(1, 4, Sq, "cpu") if lse_t is None else lse_t
    return args + [_OnCuda(lse, ptr=ptrs.get("lse"))]


@pytest.mark.parametrize("wgmma_dims", sorted(fa_kernel.BWD_WGMMA_HEAD_DIMS))
@pytest.mark.parametrize("name", ["q", "k", "v", "dout", "lse"])
def test_backward_wrapper_refuses_misaligned_inputs_on_the_tensor_core_route(name, wgmma_dims,
                                                                           no_build):
    """TMA reads q, k, v, dout and the lse rows from 16-byte aligned
    addresses, at each head dim of the tensor-core route; the SIMT route
    (f32 here, and bf16 at head dim 64) does not, and gets past the checks
    to the allocation, which fails on this CPU."""
    for dtype, dims, raises in ((torch.bfloat16, wgmma_dims, True),
                                (torch.float32, wgmma_dims, False),
                                (torch.bfloat16, (64, 64), False)):
        args = _bwd_args(dtype, dims=dims, **{name: 8})
        if raises:
            with pytest.raises(ValueError, match=f"{name} must start on a 16-byte boundary"):
                flash_attention_bwd(*args)
        else:
            with pytest.raises(Exception) as err:
                flash_attention_bwd(*args)
            assert "16-byte" not in str(err.value)


@pytest.mark.parametrize("dims", sorted(fa_kernel.BWD_WGMMA_HEAD_DIMS))
def test_backward_wrapper_refuses_lse_rows_off_16_bytes_on_the_tensor_core_route(dims, no_build):
    """A contiguous (B, H, 7) lse has rows 28 bytes apart: TMA cannot read
    it, at either head dim of the route.  ``empty_lse`` pads each row to 8
    floats."""
    lse = torch.zeros(1, 4, 7)
    with pytest.raises(ValueError, match="16 bytes apart"):
        flash_attention_bwd(*_bwd_args(torch.bfloat16, Sq=7, dims=dims, lse_t=lse))
    assert fa_kernel.empty_lse(1, 4, 7, "cpu").stride() == (32, 8, 1)


@pytest.mark.parametrize("lse, match", [(torch.zeros(1, 4, 9), "lse has shape"),
                                        (torch.zeros(1, 4, 8, dtype=torch.float64),
                                         "lse is torch.float64"),
                                        (torch.zeros(1, 8, 4).transpose(1, 2),
                                         "rows of contiguous floats")])
def test_backward_wrapper_checks_the_lse(lse, match, no_build):
    with pytest.raises((ValueError, TypeError), match=match):
        flash_attention_bwd(*_bwd_args(torch.float32, dims=(16, 16), lse_t=lse))


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
        flash_attention_bwd(q, k, k, q, _OnCuda(torch.zeros(1, 8, 2, 16)),
                            _OnCuda(torch.zeros(1, 4, 8)))


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
    fa_kernel.flash_attention_bwd.launches_by_route["wgmma"] = 5
    fa_kernel.reset_launches()
    assert fa_kernel.flash_attention_bwd.launches == 0
    assert fa_kernel.flash_attention_bwd.launches_by_route == dict.fromkeys(fa_kernel.ROUTES, 0)


def _wkv_args(requires_grad):
    B, T, H, D = 1, 4, 2, 16
    t = [_OnCuda(torch.zeros(B, T, H, D)) for _ in range(4)]
    t[1].requires_grad = requires_grad
    return t + [_OnCuda(torch.zeros(H, D)), None]


def _scan_args(requires_grad):
    return [_OnCuda(torch.zeros(1, 4, 8), requires_grad), _OnCuda(torch.zeros(1, 4, 8)), None]


@pytest.mark.parametrize("wrapper, make, match", [
    (wkv_kernel.rwkv6_wkv_fwd, _wkv_args, "called directly .* call ops.rwkv6_wkv"),
    (scan_kernel.rglru_scan_fwd, _scan_args, "called directly .* call ops.rglru_scan")],
    ids=["wkv", "scan"])
def test_recurrence_kernels_refuse_inputs_that_require_grad(wrapper, make, match, no_build):
    """Never a silently detached output: the WKV and scan forward kernels
    called directly carry no gradient (their autograd Functions, RWKV6WKV
    and RGLRUScan, call them with grad mode off)."""
    with pytest.raises(NotImplementedError, match=match):
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
