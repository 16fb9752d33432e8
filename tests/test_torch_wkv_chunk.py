"""The chunked form of the RWKV6 WKV recurrence, on the CPU.

``rwkv6_wkv_fwd``'s chunk route (``csrc/rwkv6_wkv_fwd_sm90.cu``) runs only on
the card.  Its schedule is emulated here in plain PyTorch, step for step as
the kernel takes it: chunks of 64 steps split into four sub-chunks of 16;
every decay a running product of w from the nearest chunk or sub-chunk
boundary; the scores of an earlier sub-chunk through k decayed to the query
sub-chunk's first step; in each sub-chunk two diagonal 8 x 8 blocks by
running products and the block between them through its middle step; the
state update from k decayed to the chunk's end, which the kernel splits into
three bf16 pieces.  The emulation runs in f32 and in float64 against the port's
``rwkv6_reference`` and the JAX package's, on the same numpy inputs, within
1e-5 relative (the tolerance ``chip_smoke.py`` holds the kernel to in f32):
the model's decays with w exactly 0, near 1 and at log w = -100 at chosen
steps, ragged T, with and without s0, and T = 2.  With bf16 inputs and the
kernel's bf16 roundings (r . P, S_c, the decayed r and k, the scores, y) it
stays within the card's bf16 tolerances, 2**-7 on y and 1e-5 on s_last.  Then the
route rule, and the wrapper's choice and count of a route.
"""
import contextlib
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_wkv import rwkv6_reference as jax_reference
from repro_torch.kernels.rwkv6_wkv import kernel as wkv_kernel
from repro_torch.kernels.rwkv6_wkv import rwkv6_reference

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

C, SUB, HALF = 64, 16, 8  # steps a chunk, a sub-chunk and half one, as in the kernel


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def _split3(x):
    """hi + mid + lo, each rounded to bf16, as the kernel splits the decayed k."""
    hi = _bf16(x)
    mid = _bf16(x - hi)
    return hi + mid + _bf16(x - hi - mid)


def chunk_schedule(r, k, v, w, u, s0=None, *, dtype=torch.float32, bf16=False):
    """The chunk kernel's schedule in plain PyTorch, computing in ``dtype``;
    with ``bf16``, rounded to bf16 where the kernel rounds.  Returns (y in
    r.dtype, s_last in ``dtype``)."""
    B, T, H, D = r.shape
    n_chunks = -(-T // C)
    rnd = _bf16 if bf16 else (lambda x: x)

    def padded(x, fill):  # (B, H, T padded to chunks, D): zeros, and w = 1 past T
        out = torch.full((B, n_chunks * C, H, D), fill, dtype=dtype)
        out[:, :T] = x.to(dtype)
        return out.permute(0, 2, 1, 3)
    rr, kk, vv, ww = padded(r, 0.0), padded(k, 0.0), padded(v, 0.0), padded(w, 1.0)
    uu = u.to(dtype)[None, :, None, :]
    S = torch.zeros((B, H, D, D), dtype=dtype) if s0 is None else s0.to(dtype).clone()
    ys = []
    for n in range(n_chunks):
        rs, ks, vs, ws = (x[:, :, n * C:(n + 1) * C].reshape(B, H, 4, SUB, D)
                          for x in (rr, kk, vv, ww))
        # P(b_q, t) forwards and P(t + 1, b_q + 16) backwards, and each
        # sub-chunk's whole product G_q, running products of w
        pf, pb = torch.empty_like(ws), torch.empty_like(ws)
        run = torch.ones_like(ws[..., 0, :])
        for t in range(SUB):
            pf[..., t, :] = run
            run = run * ws[..., t, :]
        G = run
        run = torch.ones_like(G)
        for t in reversed(range(SUB)):
            pb[..., t, :] = run
            run = run * ws[..., t, :]
        before, after = torch.ones_like(G), torch.ones_like(G)  # P(c, b_q), P(b_q+1, c + C)
        for q in range(4):
            for p in range(4):
                if p < q:
                    before[:, :, q] = before[:, :, q] * G[:, :, p]
                if p > q:
                    after[:, :, q] = after[:, :, q] * G[:, :, p]
        r_c = rnd(rs * (before[..., None, :] * pf)).reshape(B, H, C, D)
        r_sub = rnd(rs * pf)
        kd = ks * pb                                   # k . P(s + 1, b_q + 16)
        k_e = kd * after[..., None, :]                 # k . P(s + 1, c + C)
        k_e = (_split3(k_e) if bf16 else k_e).reshape(B, H, C, D)
        A = torch.zeros((B, H, C, C), dtype=dtype)
        for q in range(4):
            rows = slice(SUB * q, SUB * q + SUB)
            if q:  # earlier sub-chunks: k decayed to b_q, one factor each side
                to_q = []
                for p in range(q):
                    f = torch.ones_like(G[:, :, 0])
                    for pp in range(p + 1, q):
                        f = f * G[:, :, pp]
                    to_q.append(rnd(kd[:, :, p] * f[..., None, :]))
                A[:, :, rows, :SUB * q] = torch.einsum("bhti,bhsi->bhts", r_sub[:, :, q],
                                                       torch.cat(to_q, dim=2))
            for lo in (0, HALF):  # the two diagonal 8 x 8 blocks, running products
                kp = torch.zeros((B, H, HALF, D), dtype=dtype)  # k_s . P(s + 1, t)
                for t in range(1, HALF):
                    kp[:, :, :t - 1] = kp[:, :, :t - 1] * ws[:, :, q, lo + t - 1][:, :, None]
                    kp[:, :, t - 1] = ks[:, :, q, lo + t - 1]
                    A[:, :, SUB * q + lo + t, SUB * q + lo:SUB * q + lo + t] = torch.einsum(
                        "bhi,bhsi->bhs", rs[:, :, q, lo + t], kp[:, :, :t])
            # the block between them, factored at b_q + 8: r . P(b_q + 8, t) and
            # k . P(s + 1, b_q + 8), running products from that step
            r_mid = torch.empty_like(rs[:, :, q, HALF:])
            k_mid = torch.empty_like(ks[:, :, q, :HALF])
            run = torch.ones_like(G[:, :, 0])
            for t in range(HALF):
                r_mid[:, :, t] = rs[:, :, q, HALF + t] * run
                run = run * ws[:, :, q, HALF + t]
            run = torch.ones_like(G[:, :, 0])
            for s in reversed(range(HALF)):
                k_mid[:, :, s] = ks[:, :, q, s] * run
                run = run * ws[:, :, q, s]
            A[:, :, SUB * q + HALF:SUB * q + SUB, SUB * q:SUB * q + HALF] = torch.einsum(
                "bhti,bhsi->bhts", rnd(r_mid), rnd(k_mid))
            diag = torch.arange(SUB * q, SUB * q + SUB)
            A[:, :, diag, diag] = (rs[:, :, q] * uu * ks[:, :, q]).sum(-1)
        v_c = vs.reshape(B, H, C, D)
        ys.append(r_c @ rnd(S) + rnd(A) @ v_c)
        S = (G[:, :, 0] * G[:, :, 1] * G[:, :, 2] * G[:, :, 3])[..., None] * S \
            + k_e.transpose(-1, -2) @ v_c
    return torch.cat(ys, dim=2)[:, :, :T].permute(0, 2, 1, 3).to(r.dtype), S


# (B, T, H, D, s0, edges): ragged T with and without s0; T = 2; a full chunk
# and more with w exactly 0, near 1 and at log w = -100 at chosen steps.
CASES = {
    "ragged-37": (2, 37, 2, 64, True, False),
    "ragged-100": (1, 100, 2, 64, False, False),
    "ragged-130-edges": (1, 130, 2, 64, True, True),
    "T-2": (2, 2, 2, 64, False, False),
    "T-2-s0": (1, 2, 3, 64, True, False),
    "edges": (1, 192, 2, 64, True, True),
}
# Steps where the edge cases force w, per channel parity: 0 exactly, near 1,
# and exp(-100), at the start, inside and at the end of sub-chunks and chunks.
ZERO_AT, ONE_AT, DEEP_AT = (0, 17, 63, 64, 100), (5, 15, 16, 47, 65, 127), (3, 31, 32, 80, 128)


def _inputs(case, seed):
    """r, k, v, u ~ N(0,1)*0.5, s0 ~ N(0,1)*0.1 or None, and the model's
    decay exp(-exp(N(0,1))), with the edge steps forced where asked."""
    B, T, H, D, with_s0, edges = case
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, D)).astype(np.float32) * 0.5 for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, T, H, D)))).astype(np.float32)
    if edges:
        for steps, value in ((ZERO_AT, 0.0), (ONE_AT, 1.0 - 2.0**-20), (DEEP_AT, np.exp(-100.0))):
            for t in steps:
                if t < T:
                    w[:, t, :, 0::2] = value  # even channels; odd ones keep the model's
    u = rng.standard_normal((H, D)).astype(np.float32) * 0.5
    s0 = rng.standard_normal((B, H, D, D)).astype(np.float32) * 0.1 if with_s0 else None
    return [r, k, v, w, u, s0]


def _torch(arrays, dtype=torch.float32):
    return [None if a is None else torch.from_numpy(a).to(dtype if i < 4 else torch.float32)
            for i, a in enumerate(arrays)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's reference on every case's inputs, once."""
    out = {}
    for n, (name, case) in enumerate(CASES.items()):
        arrays = _inputs(case, seed=n)
        y, s = jax_reference(*[None if a is None else jnp.asarray(a) for a in arrays])
        out[name] = (np.asarray(y), np.asarray(s))
    return out


def test_edge_cases_hold_their_traps():
    """The edge inputs really hold exact zeros, values near 1 and log w of
    about -100 (below f32's normal range)."""
    _, _, _, w, _, _ = _inputs(CASES["edges"], seed=0)
    assert (w == 0).sum() >= len(ZERO_AT) * 2
    assert (w == np.float32(1.0 - 2.0**-20)).any()
    deep = w[(w > 0) & (w < 1e-38)]
    assert deep.size and np.log(deep.astype(np.float64)).min() < -99


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(CASES))
def test_chunk_schedule_matches_both_references(jax_refs, name, dtype):
    """The schedule, in f32 and float64, against the port's plain version and
    the JAX package's, within 1e-5 relative on y and s_last, all finite."""
    n = list(CASES).index(name)
    arrays = _inputs(CASES[name], seed=n)
    args = _torch(arrays)
    y, s_last = chunk_schedule(*args, dtype=dtype)
    assert torch.isfinite(y).all() and torch.isfinite(s_last).all()
    ry, rs = rwkv6_reference(*args)
    jy, js = jax_refs[name]
    for ref_y, ref_s in ((ry.numpy(), rs.numpy()), (jy, js)):
        assert _rel(y.numpy(), ref_y) <= 1e-5
        assert _rel(s_last.numpy(), ref_s) <= 1e-5


@pytest.mark.parametrize("case", [(1, 256, 4, 64, False, True), (2, 100, 2, 64, True, False),
                                  (1, 1024, 4, 64, False, False)],
                         ids=["prefill-edges", "ragged-s0", "prefill-1024"])
def test_bf16_roundings_stay_within_the_card_tolerances(case):
    """bf16 inputs with the kernel's roundings (r . P, S_c, the decayed r and
    k for the scores, the scores, y; the state's k in three pieces) against the
    plain version: y within 2**-7 and s_last within 1e-5, the tolerances
    chip_smoke.py holds the chunk route to; without the three-piece split,
    one bf16 rounding of the decayed k misses s_last's."""
    args = _torch(_inputs(case, seed=7), torch.bfloat16)
    y, s_last = chunk_schedule(*args, bf16=True)
    ry, rs = rwkv6_reference(*args)
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()
    assert _rel(y.float().numpy(), ry.float().numpy()) <= 2**-7
    assert _rel(s_last.numpy(), rs.numpy()) <= 1e-5


def test_one_rounding_of_the_decayed_k_would_miss_s_last():
    """Why the state update takes three pieces: one bf16 rounding of
    k . P(s + 1, c + C) puts s_last far beyond 1e-5."""
    args = _torch(_inputs((1, 128, 2, 64, False, False), seed=8), torch.bfloat16)
    _, rs = rwkv6_reference(*args)
    B, T, H, D = args[0].shape
    kf, vf, wf = (x.float() for x in args[1:4])
    S = torch.zeros((B, H, D, D))
    for n in range(T // C):  # k . P(s + 1, c + C) rounded once, in whole chunks
        sl = slice(n * C, (n + 1) * C)
        w_c = wf[:, sl].permute(0, 2, 1, 3)
        tail = torch.flip(torch.cumprod(torch.flip(w_c, [2]), 2), [2])  # P(s, c + C)
        to_end = torch.cat([tail[:, :, 1:], torch.ones_like(tail[:, :, :1])], 2)
        k_e = _bf16(kf[:, sl].permute(0, 2, 1, 3) * to_end)
        S = tail[:, :, 0][..., None] * S + k_e.transpose(-1, -2) @ vf[:, sl].permute(0, 2, 1, 3)
    assert _rel(S.numpy(), rs.numpy()) > 1e-4


def test_route_table_on_every_case_chip_smoke_launches():
    """bf16 at head dim 64 for T >= 2 takes the chunk route: the prefill
    shape, the ragged case, the new cases and the 64-token serve slice;
    every decode step (T = 1), every f32 case and the smaller head dims take
    the recurrent route."""
    route = wkv_kernel.route
    for case in chip_smoke.WKV_CASES:
        B, T, H, D = case[:4]
        assert route(torch.float32, D, T) == "recurrent"
        assert route(torch.bfloat16, D, T) == ("chunk" if D == 64 and T >= 2 else "recurrent")
    assert route(torch.bfloat16, 64, 1024) == "chunk"       # rwkv6-7b prefill
    assert route(torch.bfloat16, 64, 64) == "chunk"         # the serve slice's prefill
    assert route(torch.bfloat16, 64, 37) == "chunk"
    assert route(torch.bfloat16, 64, 2) == "chunk"
    assert route(torch.bfloat16, 64, 1) == "recurrent"      # a decode step
    assert route(torch.float32, 64, 1024) == "recurrent"
    assert route(torch.bfloat16, 32, 48) == "recurrent"
    assert {route(torch.bfloat16, 64, T, grad) for T in (1, 2)
            for grad in (False, True)} == set(wkv_kernel.ROUTES)


@pytest.mark.parametrize("dtype, T", [(torch.bfloat16, 37), (torch.float32, 37),
                                      (torch.bfloat16, 1)])
def test_wrapper_refuses_cpu_tensors_before_building(monkeypatch, dtype, T):
    def no_build():
        raise AssertionError("the wrapper tried to build the kernel")
    monkeypatch.setattr(wkv_kernel, "build", no_build)
    args = _torch(_inputs((1, T, 2, 64, True, False), seed=3), dtype)
    before = dict(wkv_kernel.rwkv6_wkv_fwd.launches_by_route)
    with pytest.raises(ValueError, match="not a CUDA device"):
        wkv_kernel.rwkv6_wkv_fwd(*args)
    assert wkv_kernel.rwkv6_wkv_fwd.launches_by_route == before


class _Library:
    """Counting stand-ins for the library's entry points: each records the
    route it was called on and the number of its integer arguments."""

    def __init__(self):
        self.calls = []

        def entry(name):
            def call(*args):
                self.calls.append((name, sum(isinstance(a, int) and not isinstance(a, bool)
                                             for a in args[8:-1])))
                return 0
            return call
        self.rwkv6_wkv_fwd_chunk = entry("chunk")
        self.rwkv6_wkv_fwd_recurrent = entry("recurrent")


def test_wrapper_calls_the_entry_point_route_names_and_counts_it(monkeypatch):
    """With the library and the device stood in, each call reaches the entry
    point route() names (the chunk entry without a dtype argument) and adds
    one to launches and to launches_by_route on that route only."""
    lib = _Library()
    monkeypatch.setattr(wkv_kernel, "_library", lambda: lib)
    monkeypatch.setattr(wkv_kernel, "_check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: type("Stream", (), {"cuda_stream": 0})())
    wkv_kernel.reset_launches()
    calls = [(torch.bfloat16, 64), (torch.bfloat16, 1), (torch.float32, 64),
             (torch.bfloat16, 37), (torch.bfloat16, 2)]
    for dtype, T in calls:
        wkv_kernel.rwkv6_wkv_fwd(*_torch(_inputs((1, T, 2, 64, False, False), seed=4), dtype))
    want = [wkv_kernel.route(dtype, 64, T) for dtype, T in calls]
    assert [name for name, _ in lib.calls] == want
    assert all(n_int == (4 if name == "chunk" else 5) for name, n_int in lib.calls)
    assert wkv_kernel.rwkv6_wkv_fwd.launches == len(calls)
    assert wkv_kernel.rwkv6_wkv_fwd.launches_by_route == {"chunk": 3, "chunk_exact": 0,
                                                          "recurrent": 2}
    wkv_kernel.reset_launches()
    assert wkv_kernel.rwkv6_wkv_fwd.launches_by_route == {"chunk": 0, "chunk_exact": 0,
                                                          "recurrent": 0}
