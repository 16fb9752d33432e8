"""The port's attention against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both.  On the CPU the
port's ``flash_attention`` runs its plain version (``chunked_attention``);
the JAX side runs its Pallas kernel in interpret mode and its oracle.
Tolerances are those of tests/test_kernels_attention.py: 2e-6 in f32,
2e-2 in bf16 (one bf16 rounding of outputs of magnitude about 1).
"""
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
