"""The port's attention against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both.  On the CPU the
port's ``flash_attention`` runs its plain version (``chunked_attention``);
the JAX side runs its Pallas kernel in interpret mode and its oracle.
Tolerances are those of tests/test_kernels_attention.py: 2e-6 in f32,
2e-2 in bf16 (one bf16 rounding of outputs of magnitude about 1).  The CUDA
kernels cannot run here; their route rule, their entry points (read from
the sources) and the wrapper's checks are tested without a card.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels_attention import CASES

from repro.kernels.flash_attention import attention_reference as jax_reference
from repro.kernels.flash_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import build as build_mod
from repro_torch.kernels.flash_attention import (attention_reference, chunked_attention,
                                                 decode_attention, flash_attention,
                                                 flash_attention_fwd)
from repro_torch.kernels.flash_attention import kernel as fa_kernel

TOL = {"float32": 2e-6, "bfloat16": 2e-2}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(_JNP[dtype]) for a in arrays],
            [torch.from_numpy(a).to(_TORCH[dtype]) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_and_reference(case, dtype):
    B, Sq, Sk, H, KH, D, causal, window, qoff = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        CASES.index(case), [(B, Sq, H, D), (B, Sk, KH, D), (B, Sk, KH, D)], dtype)
    kw = dict(causal=causal, window=window, q_offset=qoff)
    pallas = jax_flash(jq, jk, jv, backend="pallas", interpret=True,
                       block_q=32, block_k=32, **kw)
    ref = jax_reference(jq, jk, jv, **kw)
    out = flash_attention(tq, tk, tv, **kw)
    assert out.dtype == _TORCH[dtype] and out.shape == (B, Sq, H, D)
    _close(out, pallas, TOL[dtype])
    _close(out, ref, TOL[dtype])
    _close(attention_reference(tq, tk, tv, **kw), ref, TOL[dtype])


@pytest.mark.parametrize("case", CASES)
def test_chunked_over_many_chunks_matches_reference(case):
    """Chunks smaller than the sequence, so the online softmax runs across tiles."""
    B, Sq, Sk, H, KH, D, causal, window, qoff = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        100 + CASES.index(case), [(B, Sq, H, D), (B, Sk, KH, D), (B, Sk, KH, D)],
        "float32")
    kw = dict(causal=causal, window=window, q_offset=qoff)
    out = chunked_attention(tq, tk, tv, q_chunk=32, k_chunk=48, **kw)
    _close(out, jax_reference(jq, jk, jv, **kw), 2e-6)


def test_dk_ne_dv():
    """k-dim 96 and v-dim 64 (the MLA shape)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        7, [(2, 32, 4, 96), (2, 32, 4, 96), (2, 32, 4, 64)], "float32")
    pallas = jax_flash(jq, jk, jv, causal=True, backend="pallas", interpret=True,
                       block_q=16, block_k=16)
    out = flash_attention(tq, tk, tv, causal=True)
    assert out.shape == (2, 32, 4, 64)
    _close(out, pallas, 2e-6)
    _close(out, jax_reference(jq, jk, jv, causal=True), 2e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_len_masks_padded_keys(dtype):
    """Keys at and beyond kv_len take no part, with a ragged Sq and Sk."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        8, [(2, 35, 8, 32), (2, 100, 2, 32), (2, 100, 2, 32)], dtype)
    kw = dict(causal=False, kv_len=75)
    pallas = jax_flash(jq, jk, jv, backend="pallas", interpret=True,
                       block_q=32, block_k=32, **kw)
    out = flash_attention(tq, tk, tv, **kw)
    _close(out, pallas, TOL[dtype])
    _close(out, jax_reference(jq, jk, jv, **kw), TOL[dtype])
    _close(attention_reference(tq, tk, tv, **kw), jax_reference(jq, jk, jv, **kw),
           TOL[dtype])


def test_row_with_no_visible_key_is_zero():
    """Causal with a negative q_offset: the first rows see no key and output 0."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        9, [(1, 16, 2, 16), (1, 16, 2, 16), (1, 16, 2, 16)], "float32")
    out = flash_attention(tq, tk, tv, causal=True, q_offset=-4)
    assert torch.all(out[:, :4] == 0)
    _close(out, jax_reference(jq, jk, jv, causal=True, q_offset=-4), 2e-6)


def test_decode_attention_matches_jax():
    """Two-pass decode over a cache padded beyond its valid length."""
    B, S, pad, H, KH, D = 2, 40, 24, 8, 4, 16
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        10, [(B, 1, H, D), (B, S + pad, KH, D), (B, S + pad, KH, D)], "float32")
    out = decode_attention(tq, tk, tv, S)
    _close(out, jax_decode(jq, jk, jv, S), 2e-6)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only; the CPU path is the plain one."""
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash_attention_fwd(q, q, q)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails makes the build raise and leaves no library behind."""
    monkeypatch.setattr(build_mod, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build_mod, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fa_kernel.build()
    assert not list(tmp_path.glob("*.so"))



def test_build_compiles_each_source_alone_with_the_route_rule(tmp_path, monkeypatch):
    """Each source goes to an nvcc of its own, with the header of the
    library's defines included first, then the objects are linked: the SIMT
    source reads route()'s rule from that header."""
    calls, fake = tmp_path / "calls", tmp_path / "nvcc"
    fake.write_text(f'#!/bin/sh\necho "$@" >> {calls}\n'
                    'while [ $# -gt 0 ]; do [ "$1" = -o ] && touch "$2"; shift; done\n')
    fake.chmod(0o755)
    monkeypatch.setattr(build_mod, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build_mod, "_nvcc", lambda: str(fake))
    built = fa_kernel.build()
    lines = calls.read_text().splitlines()
    compiles = [ln.split() for ln in lines if " -c " in ln]
    assert sorted(c[-1] for c in compiles) == sorted(map(str, fa_kernel.SOURCES))
    headers = {c[c.index("-include") + 1] for c in compiles}
    assert len(headers) == 1
    assert Path(headers.pop()).read_text() == (
        f"#define BF16_ON_WGMMA {fa_kernel.route_condition(fa_kernel.WGMMA_HEAD_DIMS)}\n")
    assert "-shared" in lines[-1].split() and built.path.exists()
    assert set(built.seconds_by_source) == {src.name for src in fa_kernel.SOURCES}

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_80_matches_pallas_and_reference(dtype):
    """hubert-xlarge's head dim 80: bidirectional, 16 heads over 16 kv heads."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(11, [(2, 50, 16, 80)] * 3, dtype)
    pallas = jax_flash(jq, jk, jv, causal=False, backend="pallas", interpret=True,
                       block_q=32, block_k=32)
    ref = jax_reference(jq, jk, jv, causal=False)
    out = flash_attention(tq, tk, tv, causal=False)
    assert out.dtype == _TORCH[dtype] and out.shape == (2, 50, 16, 80)
    _close(out, pallas, TOL[dtype])
    _close(out, ref, TOL[dtype])


# The masks hubert-xlarge never sets, at its head dim (80, 80), where every
# bf16 call takes the tensor cores: ragged with GQA, a window and q_offset;
# kv_len < Sk; kv_len 0 (chip_smoke.AT_80_MASKS, without the head dims).
AT_80_MASKS = [(2, 77, 130, 8, 2, True, 33, 20, None),
               (2, 70, 200, 8, 2, False, None, 0, 150),
               (1, 64, 64, 4, 2, False, None, 0, 0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", AT_80_MASKS)
def test_head_dim_80_with_masks_matches_pallas_and_chunked(case, dtype):
    """The plain version the card holds the (80, 80) kernels to
    (chunked_attention) against the JAX package's Pallas kernel in
    interpret mode and its chunked attention, at the masks' small shapes;
    where kv_len is 0 every row sees nothing and the output is 0."""
    B, Sq, Sk, H, KH, causal, window, qoff, kv_len = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        20 + AT_80_MASKS.index(case), [(B, Sq, H, 80), (B, Sk, KH, 80), (B, Sk, KH, 80)], dtype)
    kw = dict(causal=causal, window=window, q_offset=qoff, kv_len=kv_len)
    pallas = jax_flash(jq, jk, jv, backend="pallas", interpret=True, block_q=32, block_k=32,
                       **kw)
    chunked = jax_flash(jq, jk, jv, backend="chunked", q_chunk=32, k_chunk=32, **kw)
    out = chunked_attention(tq, tk, tv, **kw)
    assert out.dtype == _TORCH[dtype] and out.shape == (B, Sq, H, 80)
    _close(out, pallas, TOL[dtype])
    _close(out, chunked, TOL[dtype])
    if kv_len == 0:
        assert torch.all(out == 0)
    else:
        _close(out, jax_reference(jq, jk, jv, **kw), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", sorted(fa_kernel.HEAD_DIMS))
def test_route_takes_the_tensor_cores_for_bf16_at_128_and_256_only(dtype, dims):
    """bf16 at 128, 256, MLA's (96, 64) and hubert-xlarge's (80, 80) on the
    tensor cores; the rest, f32 at every pair, SIMT."""
    want = ("wgmma" if dtype == torch.bfloat16
            and dims in {(80, 80), (96, 64), (128, 128), (256, 256)} else "simt")
    assert fa_kernel.route(dtype, *dims) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", sorted(fa_kernel.BWD_HEAD_DIMS))
def test_backward_route_takes_the_tensor_cores_for_bf16_at_128_only(dtype, dims):
    """bf16 at 128, and, since recurrentgemma, minicpm3-4b and hubert-xlarge
    train there, 256, (96, 64) and (80, 80); the rest SIMT."""
    want = ("wgmma" if dtype == torch.bfloat16
            and dims in {(80, 80), (96, 64), (128, 128), (256, 256)} else "simt")
    assert fa_kernel.route(dtype, *dims, backward=True) == want


def test_backward_route_of_recurrentgemma_head_dim():
    """bf16 at (256, 256) on the tensor cores; f32 there stays SIMT, held to
    1e-5 of the plain version."""
    assert fa_kernel.route(torch.bfloat16, 256, 256, backward=True) == "wgmma"
    assert fa_kernel.route(torch.float32, 256, 256, backward=True) == "simt"


@pytest.mark.parametrize("direction, sources", [("fwd", fa_kernel.SOURCES),
                                                ("bwd", fa_kernel.BWD_SOURCES)])
def test_each_route_has_its_entry_point(direction, sources):
    """The wrappers call ``flash_attention_<direction>_<route()>``: each
    library exports one entry point a route (and the backward its delta
    pre-pass), so route() is the only place that picks a kernel."""
    text = "".join(src.read_text() for src in sources)
    entries = set(re.findall(rf'extern "C" int flash_attention_{direction}_(\w+)\(', text))
    assert entries == set(fa_kernel.ROUTES) | ({"delta"} if direction == "bwd" else set())



def _dispatch_pairs(text, start, pattern):
    """(Dk, Dv) of each dispatch line in the function that begins at
    ``start``, each checked against the pair its launch instantiates."""
    body = text[text.index(start):]
    lines = re.findall(pattern, body[:body.index("\n}\n")])
    assert all((dk, dv) == (tdk, tdv) for dk, dv, tdk, tdv in lines), lines
    return {(int(dk), int(dv)) for dk, dv, _, _ in lines}


def test_forward_head_dims_have_dispatch_lines():
    """A pair the wrapper sends to a route on which no kernel is instantiated
    for it would fail only on the card, as cudaErrorInvalidValue; here it
    fails on the CPU.  The SIMT dispatch has a line for every pair of
    HEAD_DIMS, the tensor-core entry point one for every pair of
    WGMMA_HEAD_DIMS."""
    csrc = Path(fa_kernel.__file__).parent / "csrc"
    simt = _dispatch_pairs((csrc / "flash_attention_fwd.cu").read_text(),
                           "cudaError_t dispatch(",
                           r"if \(dk == (\d+) && dv == (\d+)\) return launch<T, (\d+), (\d+),")
    wgmma = _dispatch_pairs((csrc / "flash_attention_fwd_sm90.cu").read_text(),
                            'extern "C" int flash_attention_fwd_wgmma(',
                            r"if \(Dk == (\d+) && Dv == (\d+)\) return launch<(\d+), (\d+),")
    assert simt == fa_kernel.HEAD_DIMS
    assert wgmma == fa_kernel.WGMMA_HEAD_DIMS


def test_backward_wgmma_head_dims_have_dispatch_lines():
    """The tensor-core backward's entry point launches every pair of
    BWD_WGMMA_HEAD_DIMS, each at its own tiles; a pair without a line would
    fail only on the card."""
    text = (Path(fa_kernel.__file__).parent / "csrc" / "flash_attention_bwd_sm90.cu").read_text()
    body = text[text.index('extern "C" int flash_attention_bwd_wgmma('):]
    lines = re.findall(r"if \(Dk == (\d+) && Dv == (\d+)\) return launch<(\d+), (\d+)>",
                       body[:body.index("\n}\n")])
    assert all((dk, dv) == (tdk, tdv) for dk, dv, tdk, tdv in lines), lines
    assert {(int(dk), int(dv)) for dk, dv, _, _ in lines} == fa_kernel.BWD_WGMMA_HEAD_DIMS


@pytest.mark.parametrize("backward", [False, True])
def test_route_condition_holds_where_route_picks_the_tensor_cores(backward):
    """The condition the SIMT source is built with (BF16_ON_WGMMA) is true
    exactly where route() sends bf16 to the tensor cores, and the SIMT
    launch compiles no kernel where it holds."""
    dims = fa_kernel.BWD_WGMMA_HEAD_DIMS if backward else fa_kernel.WGMMA_HEAD_DIMS
    cond = fa_kernel.route_condition(dims).replace("&&", "and").replace("||", "or")
    for dk, dv in fa_kernel.BWD_HEAD_DIMS if backward else fa_kernel.HEAD_DIMS:
        on_wgmma = fa_kernel.route(torch.bfloat16, dk, dv, backward=backward) == "wgmma"
        assert eval(cond, {"DK": dk, "DV": dv}) == on_wgmma, (dk, dv)
    simt = fa_kernel.BWD_SOURCES[0] if backward else fa_kernel.SOURCES[0]
    launch = simt.read_text().split("cudaError_t launch(", 1)[1]
    assert launch.lstrip().split("\n")[1].strip() == (
        "if constexpr (std::is_same_v<T, __nv_bfloat16> && (BF16_ON_WGMMA)) {")

class _OnCuda:
    """A CPU tensor that reports a CUDA device, so the wrapper's checks run here."""
    device = torch.device("cuda", 0)

    def __init__(self, t, ptr=None):
        self._t, self._ptr = t, ptr

    dtype = property(lambda self: self._t.dtype)
    shape = property(lambda self: self._t.shape)

    def dim(self):
        return self._t.dim()

    def is_contiguous(self):
        return self._t.is_contiguous()

    def data_ptr(self):
        return self._t.data_ptr() if self._ptr is None else self._ptr


@pytest.mark.parametrize("dk, dv", [(48, 48), (128, 64), (80, 64), (512, 512)])
def test_kernel_wrapper_refuses_unsupported_head_dims(dk, dv):
    q, v = _OnCuda(torch.zeros(1, 8, 2, dk)), _OnCuda(torch.zeros(1, 8, 2, dv))
    with pytest.raises(ValueError, match="not supported"):
        fa_kernel._check(q, q, v, None, None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_wrapper_takes_head_dim_80(dtype):
    t = _OnCuda(torch.zeros(2, 50, 16, 80, dtype=dtype))
    fa_kernel._check(t, t, t, None, None)


def test_kernel_wrapper_refuses_misaligned_inputs_on_the_tensor_core_route():
    """TMA needs 16-byte aligned inputs; the SIMT route (f32 here) does not."""
    for dtype, raises in ((torch.bfloat16, True), (torch.float32, False)):
        t = torch.zeros(1, 8, 2, 128, dtype=dtype)
        q = _OnCuda(t, ptr=t.data_ptr() + 4)
        if raises:
            with pytest.raises(ValueError, match="16-byte"):
                fa_kernel._check(q, _OnCuda(t), _OnCuda(t), None, None)
        else:
            fa_kernel._check(q, _OnCuda(t), _OnCuda(t), None, None)


@pytest.mark.parametrize("dims", sorted(fa_kernel.WGMMA_HEAD_DIMS))
@pytest.mark.parametrize("name", ["q", "k", "v"])
def test_kernel_wrapper_refuses_misaligned_inputs_at_each_tensor_core_head_dim(name, dims):
    """TMA reads q, k and v from 16-byte aligned addresses at every head-dim
    pair of the tensor-core route, (96, 64) among them; f32 there takes the
    SIMT route, which does not."""
    dk, dv = dims
    for dtype, raises in ((torch.bfloat16, True), (torch.float32, False)):
        t = {"q": torch.zeros(1, 8, 4, dk, dtype=dtype), "k": torch.zeros(1, 8, 2, dk, dtype=dtype),
             "v": torch.zeros(1, 8, 2, dv, dtype=dtype)}
        args = [_OnCuda(x, ptr=x.data_ptr() + 8 if n == name else None) for n, x in t.items()]
        if raises:
            with pytest.raises(ValueError, match=f"{name} must start on a 16-byte boundary"):
                fa_kernel._check(*args, None, None)
        else:
            fa_kernel._check(*args, None, None)


def test_reset_launches_zeroes_both_counters():
    flash_attention_fwd.launches = 3
    flash_attention_fwd.launches_by_route["wgmma"] = 2
    fa_kernel.flash_attention_bwd.launches_by_route["simt"] = 4
    fa_kernel.reset_launches()
    assert flash_attention_fwd.launches == 0
    for wrapper in (flash_attention_fwd, fa_kernel.flash_attention_bwd):
        assert wrapper.launches_by_route == dict.fromkeys(fa_kernel.ROUTES, 0)
