"""The port's recurrentgemma-2b against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
JAX package's parameters and caches reach the port through
``repro_torch.bridge``.  On the CPU the port's ``rglru_scan`` runs its plain
version; the JAX side runs its Pallas kernel in interpret mode, or its
oracle.  Tolerances: 1e-6 on the f32 recurrence and 3e-2 on bf16, as
tests/test_kernels_recurrence.py holds the Pallas kernel; 2e-5 on the
block's pieces in f32 (the same f32 arithmetic up to the order of sums in
the projections and the last bits of exp, expm1, softplus and tanh); 2e-4
on logits, as tests/test_models.py holds prefill and decode to the forward
pass (3e-4 for multi-token decode and the ring buffer, as there).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.kernels.rglru_scan import rglru_reference as jax_reference
from repro.kernels.rglru_scan import rglru_scan as jax_scan
from repro.models import layers as jax_layers
from repro.models import lm as jax_lm
from repro.models import rglru as jax_rglru
from repro.models import schema as jax_schema
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels.rglru_scan import rglru_reference, rglru_scan, rglru_scan_fwd
from repro_torch.kernels.rglru_scan import kernel as scan_kernel
from repro_torch.models import layers, lm, rglru, schema

NAME = "recurrentgemma-2b"
ROOT = Path(__file__).resolve().parent.parent
TOL = 2e-4
B, S, DECODE_STEPS = 2, 24, 8  # the prompt is longer than the reduced window (16)
# (B, T, W, block_t, block_w): the shapes of test_kernels_recurrence.py::test_rglru_kernel
KERNEL_SHAPES = [(1, 32, 32, 8, 16), (2, 128, 64, 32, 32), (3, 64, 96, 16, 32)]


def _scan_inputs(seed, B, T, W, h0=True):
    """a = sigmoid(N(0,1)), b = N(0,1)*0.1, h0 = N(0,1), as the JAX kernel test."""
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, W))))).astype(np.float32)
    b = rng.standard_normal((B, T, W)).astype(np.float32) * 0.1
    init = rng.standard_normal((B, W)).astype(np.float32) if h0 else None
    return a, b, init


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol)


def _t(a):
    return None if a is None else torch.from_numpy(a)


# --- the recurrence --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=str)
def test_plain_matches_pallas(shape, dtype):
    """The port's entry point on the CPU against the Pallas kernel (interpret)."""
    Bk, T, W, bt, bw = shape
    a, b, h0 = _scan_inputs(T * W, Bk, T, W)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ph, pl = jax_scan(jnp.asarray(a).astype(jd), jnp.asarray(b).astype(jd), jnp.asarray(h0),
                      backend="pallas", interpret=True, block_t=bt, block_w=bw)
    h, h_last = rglru_scan(_t(a).to(td), _t(b).to(td), _t(h0))
    assert h.dtype == td and h.shape == (Bk, T, W)
    assert h_last.dtype == torch.float32 and h_last.shape == (Bk, W)
    tol = 1e-6 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(h), _np(ph), atol=tol)
    np.testing.assert_allclose(_np(h_last), _np(pl), atol=tol)


@pytest.mark.parametrize("T,W,with_h0", [(37, 100, True), (1, 64, True), (23, 48, False)],
                         ids=["ragged", "one-step", "zero-state"])
def test_plain_matches_oracle(T, W, with_h0):
    """A ragged T and W (where the JAX wrapper itself takes its oracle), one
    step from a nonzero state, and h0=None."""
    a, b, h0 = _scan_inputs(T + W, 2, T, W, h0=with_h0)
    rh, rl = jax_reference(jnp.asarray(a), jnp.asarray(b),
                           None if h0 is None else jnp.asarray(h0))
    h, h_last = rglru_scan(_t(a), _t(b), _t(h0))
    np.testing.assert_allclose(_np(h), _np(rh), atol=1e-6)
    np.testing.assert_allclose(_np(h_last), _np(rl), atol=1e-6)
    np.testing.assert_allclose(_np(rglru_reference(_t(a), _t(b), _t(h0))[0]), _np(rh),
                               atol=1e-6)


def test_state_continues_across_calls():
    """Scanning [x1; x2] equals scanning x1, then x2 from its last state."""
    a, b, h0 = (_t(x) for x in _scan_inputs(9, 2, 64, 16))
    h, h_last = rglru_scan(a, b, h0)
    h1, l1 = rglru_scan(a[:, :32], b[:, :32], h0)
    h2, l2 = rglru_scan(a[:, 32:], b[:, 32:], l1)
    _close(torch.cat([h1, h2], dim=1), h, 1e-6)
    _close(l2, h_last, 1e-6)


# --- the kernel's wrapper --------------------------------------------------

def test_kernel_wrapper_refuses_cpu_tensors(monkeypatch):
    """The wrapper takes CUDA tensors only, and says so before building."""
    def no_build():
        raise AssertionError("the wrapper tried to build the kernel")
    monkeypatch.setattr(scan_kernel, "build", no_build)
    a, b, h0 = (_t(x) for x in _scan_inputs(0, 1, 4, 8))
    with pytest.raises(ValueError, match="not a CUDA device"):
        rglru_scan_fwd(a, b, h0)
    assert rglru_scan_fwd.launches == 0


def test_entry_point_on_cpu_launches_nothing():
    before = rglru_scan_fwd.launches
    rglru_scan(*(_t(x) for x in _scan_inputs(1, 1, 5, 8)))
    assert rglru_scan_fwd.launches == before == 0


# --- the block's pieces ----------------------------------------------------

def test_geglu_matches_jax_with_the_tanh_gelu():
    """jax.nn.gelu defaults to the tanh approximation; the erf form differs
    by more than the tolerance, so this test tells the two apart."""
    rng = np.random.default_rng(2)
    x, wg, wu, wo = (rng.standard_normal(s).astype(np.float32)
                     for s in ((2, 5, 64), (64, 96), (64, 96), (96, 64)))
    p = {"wg": wg / 8, "wu": wu / 8, "wo": wo / 10}
    out = layers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), "geglu")
    ref = jax_layers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), "geglu")
    _close(out, ref, 1e-6)
    g = torch.from_numpy(x @ p["wg"])
    erf = torch.nn.functional.gelu(g) * torch.from_numpy(x @ p["wu"])
    tanh = layers._act("geglu", g, torch.from_numpy(x @ p["wu"]))
    assert (erf - tanh).abs().max().item() > 1e-4


@pytest.mark.parametrize("S_,with_state", [(7, False), (7, True), (2, False), (1, True)],
                         ids=["no-state", "state", "short-prompt", "decode"])
def test_causal_conv_matches_jax(S_, with_state):
    """Width 4, with and without state; a prompt shorter than 3 keeps zero rows."""
    rng = np.random.default_rng(S_)
    x = rng.standard_normal((2, S_, 32)).astype(np.float32)
    w = rng.standard_normal((4, 32)).astype(np.float32) * 0.25
    bias = rng.standard_normal((32,)).astype(np.float32) * 0.1
    state = rng.standard_normal((2, 3, 32)).astype(np.float32) if with_state else None
    out, new = rglru._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(bias), _t(state))
    jout, jnew = jax_rglru._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                                        None if state is None else jnp.asarray(state))
    _close(out, jout, 1e-6)
    assert new.shape == (2, 3, 32)
    _close(new, jnew, 0.0)
    if S_ < 3 and not with_state:
        assert torch.all(new[:, :3 - S_] == 0)


def test_gates_and_coefficients_match_jax():
    """The 16-block block-diagonal gates and the a, b coefficients, in f32."""
    rng = np.random.default_rng(3)
    Bx, Sx, W = 2, 5, 64
    g, wb = schema.RGLRU_BLOCKS, 64 // schema.RGLRU_BLOCKS
    xb = rng.standard_normal((Bx, Sx, W)).astype(np.float32)
    p = {"gate_r": rng.standard_normal((g, wb, wb)).astype(np.float32) / 2,
         "gate_i": rng.standard_normal((g, wb, wb)).astype(np.float32) / 2,
         "bias_r": rng.standard_normal((W,)).astype(np.float32) * 0.1,
         "bias_i": rng.standard_normal((W,)).astype(np.float32) * 0.1,
         "lam": rng.uniform(4.0, 9.0, (W,)).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    r, i = rglru._gates(torch.from_numpy(xb), tp, Bx, Sx, W)
    jr, ji = jax_rglru._gates(jnp.asarray(xb), jp, Bx, Sx, W)
    assert r.dtype == i.dtype == torch.float32
    _close(r, jr, 2e-5)
    _close(i, ji, 2e-5)
    a, b = rglru._lru_coeffs(tp, r, i, torch.from_numpy(xb))
    ja, jb = jax_rglru._lru_coeffs(jp, jr, ji, jnp.asarray(xb))
    _close(a, ja, 2e-5)
    _close(b, jb, 2e-5)


@pytest.fixture(scope="module")
def models():
    """(jax cfg, jax params, port cfg, port params) on the reduced config, f32."""
    jcfg = JAX_ARCHS[NAME].reduced()
    jparams = jax.jit(jax_lm.init_params, static_argnums=(0, 2))(
        jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, get_config(NAME).reduced(), tparams


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_rglru_block_matches_jax(models, mode):
    jcfg, jparams, cfg, tparams = models
    assert cfg.layer_kinds()[1] == "rglru"
    jp, tp = jparams["blocks"][1], tparams["blocks"][1]
    rng = np.random.default_rng(6)
    D, W = cfg.d_model, cfg.lru_width
    x = rng.standard_normal((B, 1 if mode == "decode" else 9, D)).astype(np.float32)
    cache = None
    if mode == "decode":
        cache = {"h": rng.standard_normal((B, W)).astype(np.float32),
                 "conv": rng.standard_normal((B, 3, W)).astype(np.float32)}
    jblock = jax.jit(lambda p, x, c: jax_rglru.rglru_block(p, x, cfg=jcfg, mode=mode, cache=c))
    jout, jcache = jblock(jp, jnp.asarray(x),
                          None if cache is None else jax.tree.map(jnp.asarray, cache))
    out, new = rglru.rglru_block(tp, torch.from_numpy(x), cfg=cfg, mode=mode,
                                 cache=None if cache is None else
                                 {k: torch.from_numpy(a) for k, a in cache.items()})
    _close(out, jout, 2e-5)
    if mode == "train":
        assert new is None and jcache is None
        return
    assert set(new) == set(jcache) == {"h", "conv"}
    assert new["h"].dtype == torch.float32 and new["h"].shape == (B, W)
    for name in new:
        _close(new[name], jcache[name], 2e-5)


# --- the slice -------------------------------------------------------------

def _tokens(vocab, seed, n=S):
    return np.random.default_rng(seed).integers(0, vocab, (B, n)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_prefill(models):
    """One prompt batch and JAX's prefill of it, shared by the slice tests."""
    jcfg, jparams, cfg, _ = models
    tokens = _tokens(cfg.vocab, seed=4)
    jcache = jax_lm.init_cache(jcfg, B, 64, jnp.float32)
    jprefill = jax.jit(lambda p, c, t: jax_lm.prefill(p, jcfg, c, tokens=t))
    jlogits, jcache = jprefill(jparams, jcache, jnp.asarray(tokens))
    return tokens, jlogits, jcache


@pytest.fixture(scope="module")
def jax_decode(models):
    """JAX's decode step, jitted once for the slice tests."""
    jcfg = models[0]
    return jax.jit(lambda p, c, t: jax_lm.decode_step(p, jcfg, c, t))


def _close_caches(layers_, jlayers, tol):
    assert isinstance(layers_, list) and len(layers_) == len(jlayers)
    for mine, theirs in zip(layers_, jlayers):
        assert set(mine) == set(theirs)
        for name in mine:
            _close(mine[name], theirs[name], tol)


def test_prefill_and_greedy_decode_match_jax(models, jax_prefill, jax_decode):
    """Prefill of a prompt longer than the window and 8 greedy decode steps:
    logits, tokens and every layer's cache."""
    jcfg, jparams, cfg, tparams = models
    tokens, jlogits, jcache = jax_prefill
    cache = lm.init_cache(cfg, B, 64, torch.float32, "cpu")
    logits, cache = lm.prefill(tparams, cfg, cache, tokens=torch.from_numpy(tokens).long())
    assert logits.dtype == torch.float32 and logits.shape == (B, cfg.padded_vocab)
    _close(logits, jlogits, TOL)
    _close_caches(cache["layers"], jcache["layers"], TOL)

    jcur = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    cur = torch.argmax(logits, -1)[:, None]
    jtoks, toks = [np.asarray(jcur)], [cur.numpy()]
    for _ in range(DECODE_STEPS):
        jlogits, jcache = jax_decode(jparams, jcache, jcur)
        logits, cache = lm.decode_step(tparams, cfg, cache, cur)
        _close(logits, jlogits, TOL)
        jcur = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        cur = torch.argmax(logits, -1)[:, None]
        jtoks.append(np.asarray(jcur))
        toks.append(cur.numpy())
    assert cache["pos"] == int(jcache["pos"]) == S + DECODE_STEPS
    np.testing.assert_array_equal(np.concatenate(toks, 1), np.concatenate(jtoks, 1))
    _close_caches(cache["layers"], jcache["layers"], TOL)


def test_decode_from_bridged_cache_matches_jax(models, jax_prefill, jax_decode):
    """A list cache the JAX package filled, carried over whole by cache_from_numpy."""
    jcfg, jparams, cfg, tparams = models
    _, jlogits, jcache = jax_prefill
    cache = bridge.cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    assert cache["pos"] == S and len(cache["layers"]) == cfg.n_layers
    assert [set(c) for c in cache["layers"]] == \
        [{"k", "v"} if k == "attn_local" else {"h", "conv"} for k in cfg.layer_kinds()]
    nxt = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
    jlogits, jcache = jax_decode(jparams, jcache, jnp.asarray(nxt))
    logits, cache = lm.decode_step(tparams, cfg, cache, torch.from_numpy(nxt).long())
    _close(logits, jlogits, TOL)
    assert cache["pos"] == S + 1
    _close_caches(cache["layers"], jcache["layers"], TOL)


def _head(x, tparams):
    return x[:, -1] @ tparams["embed"].T


def test_local_attention_window_ring_buffer(models):
    """Decode beyond the window stays consistent, in the port alone (the
    twin of test_models.py::test_local_attention_window_ring_buffer)."""
    _, _, cfg, tparams = models
    assert cfg.local_window == 16
    tokens = torch.from_numpy(_tokens(cfg.vocab, seed=5)[:1]).long()  # 24 > 16
    x, _ = lm.forward(tparams, cfg, tokens=tokens, mode="train")
    cache = lm.init_cache(cfg, 1, 64, torch.float32, "cpu")
    assert cache["layers"][2]["k"].shape == (1, 16, cfg.n_kv_heads, cfg.head_dim)
    _, cache = lm.prefill(tparams, cfg, cache, tokens=tokens[:, :-1])
    logits, _ = lm.decode_step(tparams, cfg, cache, tokens[:, -1:])
    _close(logits, _head(x, tparams), 3e-4)


def test_multi_token_decode_matches_forward(models):
    """Greedy decode step by step equals teacher-forced full forwards, in the
    port alone (the twin of test_models.py::test_multi_token_decode_consistency)."""
    _, _, cfg, tparams = models
    seq = torch.from_numpy(_tokens(cfg.vocab, seed=6, n=12)[:1]).long()
    cache = lm.init_cache(cfg, 1, 64, torch.float32, "cpu")
    _, cache = lm.prefill(tparams, cfg, cache, tokens=seq[:, :-1])
    cur = seq[:, -1:]
    for _ in range(4):
        logits, cache = lm.decode_step(tparams, cfg, cache, cur)
        x, _ = lm.forward(tparams, cfg, tokens=seq, mode="train")
        _close(logits, _head(x, tparams), 3e-4)
        cur = torch.argmax(logits, -1)[:, None]
        seq = torch.cat([seq, cur], dim=1)


def test_cache_schema_matches_reference():
    """A list of per-layer caches; the recurrent state f32 in a bf16 model;
    an attn_local layer holds min(window, max_len) slots."""
    cfg, jcfg = get_config(NAME).reduced(), JAX_ARCHS[NAME].reduced()
    for max_len in (8, 40):
        cache = lm.init_cache(cfg, 3, max_len, torch.bfloat16, "cpu")
        jcache = jax_lm.init_cache(jcfg, 3, max_len, jnp.bfloat16)
        assert len(cache["layers"]) == len(jcache["layers"]) == 6
        for mine, theirs in zip(cache["layers"], jcache["layers"]):
            assert {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                    for k, t in mine.items()} == \
                {k: (a.shape, str(a.dtype)) for k, a in theirs.items()}
        assert cache["layers"][2]["k"].shape[1] == min(16, max_len)
    full = lm.cache_schema(get_config(NAME), 8, 4096 + 72)
    assert full[2]["k"].shape == (8, 2048, 1, 256)
    assert full[0]["h"].shape == (8, 2560) and full[0]["conv"].shape == (8, 3, 2560)


def test_bridge_carries_a_bf16_hybrid_tree(models):
    """A bf16 JAX list tree whose lam leaves are f32, carried over whole."""
    jcfg, jparams, cfg, _ = models
    jparams = jax.tree.map(lambda a, s: a.astype(s.dtype), jparams,
                           jax_schema.abstract_params(jcfg, jnp.bfloat16))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    assert isinstance(tparams["blocks"], list) and len(tparams["blocks"]) == 6
    lam = tparams["blocks"][0]["lam"]
    assert lam.dtype == torch.float32
    np.testing.assert_array_equal(lam.numpy(), np.asarray(jparams["blocks"][0]["lam"]))
    assert tparams["blocks"][2]["wq"].dtype == torch.bfloat16
    cache = lm.init_cache(cfg, B, 32, torch.bfloat16, "cpu")
    logits, cache = lm.prefill(tparams, cfg, cache,
                               tokens=torch.from_numpy(_tokens(cfg.vocab, seed=8)).long())
    assert torch.isfinite(logits).all()
    assert cache["layers"][0]["h"].dtype == torch.float32


# --- config and schema -----------------------------------------------------

def test_config_matches_reference():
    full, jfull = get_config(NAME), JAX_ARCHS[NAME]
    for cfg, jcfg in ((full, jfull), (full.reduced(), jfull.reduced())):
        mine, theirs = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
        source = mine.pop("source")
        assert "arXiv:2402.19427" in source and "google/recurrentgemma-2b" in source
        theirs.pop("source")
        assert mine == theirs
        assert cfg.layer_kinds() == jcfg.layer_kinds()
        assert (cfg.n_params(), cfg.padding_delta(), cfg.uniform_blocks) == \
            (jcfg.n_params(), jcfg.padding_delta(), jcfg.uniform_blocks)
    assert full.layer_kinds().count("rglru") == 18
    assert full.layer_kinds().count("attn_local") == 8
    assert (full.n_layers, full.d_model, full.n_heads, full.padded_heads, full.n_kv_heads,
            full.head_dim, full.d_ff, full.vocab, full.local_window, full.lru_width) == \
        (26, 2560, 10, 16, 1, 256, 7680, 256000, 2048, 2560)


def _jax_leaves(tree):
    return {jax.tree_util.keystr(path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, jax_schema.Param))[0]}


def test_schema_at_full_width_matches_reference():
    """Same keys, shapes, dtypes, initializers and fan-ins as the JAX schema,
    leaf by leaf, and 2,736,304,640 parameters."""
    cfg, jcfg = get_config(NAME), JAX_ARCHS[NAME]
    jabstract = _jax_leaves(jax_schema.abstract_params(jcfg))
    abstract = _jax_leaves(lm.abstract_params(cfg))
    assert list(abstract) == list(jabstract)  # the order jax flattens them
    assert {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for k, t in abstract.items()} == \
        {k: (a.shape, str(a.dtype)) for k, a in jabstract.items()}
    assert all(t.device.type == "meta" for t in abstract.values())
    n = sum(t.numel() for t in abstract.values())
    assert n == cfg.n_params() + cfg.padding_delta() == 2_736_304_640
    assert abstract["['blocks'][0]['gate_r']"].shape == (16, 160, 160)
    jparams = _jax_leaves(jax_schema.model_schema(jcfg))
    mine = _jax_leaves(lm.model_schema(cfg))
    for key, p in mine.items():
        jp = jparams[key]
        assert (p.shape, p.init, p.scale, p.dtype) == (jp.shape, jp.init, jp.scale, jp.dtype)


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_fan_in_matches_reference_on_every_arch(arch):
    """The port's _fan_in of every fan_in leaf of the JAX schema, all ten
    architectures (abstract Params, nothing allocated)."""
    leaves = _jax_leaves(jax_schema.model_schema(JAX_ARCHS[arch]))
    fan_in = {k: p for k, p in leaves.items() if p.init == "fan_in"}
    assert fan_in
    for key, p in fan_in.items():
        assert schema._fan_in(schema.Param(p.shape, p.axes)) == jax_schema._fan_in(p), key


def test_init_params_follows_schema_distributions():
    """lam inside logit((0.9..0.999) ** (1/8)); gate_r std 1/sqrt(160) (the
    block width); conv_w std 0.5/2 (scale 0.5, fan_in 4)."""
    cfg = dataclasses.replace(get_config(NAME), n_layers=3, d_model=256, d_ff=512, vocab=512)
    p = lm.init_params(cfg, torch.Generator("cpu").manual_seed(0), torch.bfloat16, "cpu")
    assert isinstance(p["blocks"], list) and len(p["blocks"]) == 3
    blk = p["blocks"][0]
    lam = blk["lam"]
    assert lam.dtype == torch.float32 and blk["gate_r"].dtype == torch.bfloat16

    def logit(u):
        a8 = u ** (1 / 8)
        return np.log(a8 / (1 - a8))
    assert logit(0.9) <= lam.min().item() and lam.max().item() <= logit(0.999)
    u = torch.sigmoid(lam.double()) ** 8  # back to U(0.9, 0.999)
    assert abs(u.mean().item() - 0.9495) < 0.005

    def std(t):
        return t.float().std().item()
    assert abs(std(blk["gate_r"]) * 160 ** 0.5 - 1.0) < 0.05
    assert abs(std(blk["gate_i"]) * 160 ** 0.5 - 1.0) < 0.05
    assert abs(std(blk["conv_w"]) / (0.5 / 2) - 1.0) < 0.05
    assert abs(std(blk["w_in"]) * 256 ** 0.5 - 1.0) < 0.05
    assert abs(std(blk["w_out"]) * 2560 ** 0.5 - 1.0) < 0.05
    assert torch.all(blk["bias_r"] == 0) and torch.all(blk["conv_b"] == 0)


# --- the command line ------------------------------------------------------

def test_serve_cli_runs_recurrentgemma_with_jax_and_repro_blocked():
    code = ("import sys; sys.modules.update(dict.fromkeys(('jax', 'jaxlib', 'repro'))); "
            "from repro_torch import serve; "
            "serve.main(['--arch', 'recurrentgemma-2b', '--reduced', '--device', 'cpu'])")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("[serve] prefill 4x24 in ")
    assert lines[1].startswith("[serve] decoded 16 tokens/seq x 4 seqs in ")
    assert lines[2].startswith("[serve] sample: [")
