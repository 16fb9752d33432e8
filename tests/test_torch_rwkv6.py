"""The port's rwkv6-7b against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
JAX package's parameters and caches reach the port through
``repro_torch.bridge``.  On the CPU the port's ``rwkv6_wkv`` runs its plain
version; the JAX side runs its Pallas kernel in interpret mode, or its
oracle.  Tolerances: 2e-5 on the recurrence and the block, as
tests/test_kernels_recurrence.py holds the Pallas kernel; 2e-4 on logits,
as tests/test_models.py holds prefill and decode to the forward pass (3e-4
for multi-token decode, as there); 2**-7 relative on a bf16 ``y`` (both
sides sum in f32 and round once).
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
from repro.kernels.rwkv6_wkv import rwkv6_reference as jax_reference
from repro.kernels.rwkv6_wkv import rwkv6_wkv as jax_wkv
from repro.models import lm as jax_lm
from repro.models import schema as jax_schema
from repro.models.rwkv6 import _group_norm as jax_group_norm
from repro.models.rwkv6 import rwkv_block as jax_rwkv_block
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels.rwkv6_wkv import rwkv6_reference, rwkv6_wkv, rwkv6_wkv_fwd
from repro_torch.kernels.rwkv6_wkv import kernel as wkv_kernel
from repro_torch.models import lm
from repro_torch.models import schema
from repro_torch.models.rwkv6 import _group_norm, rwkv_block

NAME = "rwkv6-7b"
ROOT = Path(__file__).resolve().parent.parent
TOL = 2e-4
B, S, DECODE_STEPS = 2, 17, 4
# (B, T, H, D, block_t): the shapes of test_kernels_recurrence.py::test_rwkv6_kernel
KERNEL_SHAPES = [(1, 16, 2, 8, 8), (2, 64, 3, 16, 16), (1, 48, 4, 32, 16)]


def _wkv_inputs(seed, B, T, H, D, s0=True):
    """r, k, v ~ N(0,1)*0.5, w = sigmoid(N(0,1)), u ~ N(0,1)*0.5, s0 ~ N(0,1)*0.1."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, D)).astype(np.float32) * 0.5 for _ in range(3))
    w = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, H, D)))).astype(np.float32)
    u = rng.standard_normal((H, D)).astype(np.float32) * 0.5
    init = rng.standard_normal((B, H, D, D)).astype(np.float32) * 0.1 if s0 else None
    return [r, k, v, w, u, init]


def _jax(arrays, dtype=jnp.float32):
    """The inputs for JAX: r, k, v, w in ``dtype``; u and s0 stay f32."""
    return [None if a is None else jnp.asarray(a).astype(dtype if i < 4 else jnp.float32)
            for i, a in enumerate(arrays)]


def _torch(arrays, dtype=torch.float32):
    return [None if a is None else torch.from_numpy(a).to(dtype if i < 4 else torch.float32)
            for i, a in enumerate(arrays)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# --- the recurrence --------------------------------------------------------

@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=str)
def test_plain_matches_pallas(shape):
    """The port's entry point on the CPU against the Pallas kernel (interpret)."""
    Bk, T, H, D, bt = shape
    arrays = _wkv_inputs(Bk * T * H, Bk, T, H, D)
    py, ps = jax_wkv(*_jax(arrays), backend="pallas", interpret=True, block_t=bt)
    y, s_last = rwkv6_wkv(*_torch(arrays))
    assert y.dtype == torch.float32 and y.shape == (Bk, T, H, D)
    assert s_last.dtype == torch.float32 and s_last.shape == (Bk, H, D, D)
    _close(y, py, 2e-5)
    _close(s_last, ps, 2e-5)


@pytest.mark.parametrize("T,with_s0", [(37, True), (1, True), (23, False)],
                         ids=["ragged", "one-step", "zero-state"])
def test_plain_matches_oracle(T, with_s0):
    """A ragged T (where the JAX wrapper itself takes its oracle), one decode
    step from a nonzero state, and s0=None."""
    arrays = _wkv_inputs(T, 2, T, 3, 16, s0=with_s0)
    ry, rs = jax_reference(*_jax(arrays))
    y, s_last = rwkv6_wkv(*_torch(arrays))
    _close(y, ry, 2e-5)
    _close(s_last, rs, 2e-5)
    _close(rwkv6_reference(*_torch(arrays))[0], ry, 2e-5)


def test_plain_matches_oracle_in_bf16():
    arrays = _wkv_inputs(11, 2, 29, 3, 16)
    ry, rs = jax_reference(*_jax(arrays, jnp.bfloat16))
    y, s_last = rwkv6_wkv(*_torch(arrays, torch.bfloat16))
    assert y.dtype == torch.bfloat16 and s_last.dtype == torch.float32
    assert _rel(y, ry) <= 2**-7
    assert _rel(s_last, rs) <= 1e-5


def test_state_continues_across_calls():
    """Running [x1; x2] equals running x1, then x2 from its last state."""
    r, k, v, w, u, s0 = _torch(_wkv_inputs(12, 1, 24, 2, 16))
    y, s_last = rwkv6_wkv(r, k, v, w, u, s0)
    y1, s1 = rwkv6_wkv(r[:, :10], k[:, :10], v[:, :10], w[:, :10], u, s0)
    y2, s2 = rwkv6_wkv(r[:, 10:], k[:, 10:], v[:, 10:], w[:, 10:], u, s1)
    _close(torch.cat([y1, y2], dim=1), y, 1e-6)
    _close(s2, s_last, 1e-6)


# --- the kernel's wrapper --------------------------------------------------

def test_kernel_wrapper_refuses_cpu_tensors(monkeypatch):
    """The wrapper takes CUDA tensors only, and says so before building."""
    def no_build():
        raise AssertionError("the wrapper tried to build the kernel")
    monkeypatch.setattr(wkv_kernel, "build", no_build)
    r, k, v, w, u, s0 = _torch(_wkv_inputs(0, 1, 4, 2, 8))
    with pytest.raises(ValueError, match="not a CUDA device"):
        rwkv6_wkv_fwd(r, k, v, w, u, s0)
    assert rwkv6_wkv_fwd.launches == 0


def test_entry_point_on_cpu_launches_nothing():
    before = rwkv6_wkv_fwd.launches
    rwkv6_wkv(*_torch(_wkv_inputs(1, 1, 5, 2, 8)))
    assert rwkv6_wkv_fwd.launches == before == 0


# --- the block -------------------------------------------------------------

def test_group_norm_matches_jax():
    """The population variance, as jnp.var; at D = 16 the unbiased one differs."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal((4, 16)).astype(np.float32) * 0.1
    out = _group_norm(torch.from_numpy(x), torch.from_numpy(scale))
    _close(out, jax_group_norm(jnp.asarray(x), jnp.asarray(scale)), 2e-6)


@pytest.fixture(scope="module")
def models():
    """(jax cfg, jax params, port cfg, port params) on the reduced config, f32."""
    jcfg = JAX_ARCHS[NAME].reduced()
    jparams = jax.jit(jax_lm.init_params, static_argnums=(0, 2))(
        jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, get_config(NAME).reduced(), tparams


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_rwkv_block_matches_jax(models, mode):
    jcfg, jparams, cfg, tparams = models
    jp = jax.tree.map(lambda a: a[1], jparams["blocks"])
    tp = {k: w[1] for k, w in tparams["blocks"].items()}
    rng = np.random.default_rng(6)
    D, hd = cfg.d_model, cfg.rwkv_head_dim
    x = rng.standard_normal((B, 1 if mode == "decode" else S, D)).astype(np.float32)
    cache = None
    if mode == "decode":
        cache = {"s": rng.standard_normal((B, D // hd, hd, hd)).astype(np.float32) * 0.1,
                 "x_tm": rng.standard_normal((B, D)).astype(np.float32),
                 "x_cm": rng.standard_normal((B, D)).astype(np.float32)}
    jblock = jax.jit(lambda p, x, c: jax_rwkv_block(p, x, cfg=jcfg, mode=mode, cache=c))
    jout, jcache = jblock(jp, jnp.asarray(x),
                          None if cache is None else jax.tree.map(jnp.asarray, cache))
    out, new = rwkv_block(tp, torch.from_numpy(x), cfg=cfg, mode=mode,
                          cache=None if cache is None else
                          {k: torch.from_numpy(a) for k, a in cache.items()})
    _close(out, jout, 2e-5)
    if mode == "train":
        assert new is None and jcache is None
        return
    assert set(new) == set(jcache) == {"s", "x_tm", "x_cm"}
    for name in new:
        assert new[name].dtype == torch.float32
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
    jlogits, jcache = jax_lm.prefill(jparams, jcfg, jcache, tokens=jnp.asarray(tokens))
    return tokens, jlogits, jcache


def test_prefill_and_greedy_decode_match_jax(models, jax_prefill):
    """Prefill and 4 greedy decode steps: logits, tokens and the cache."""
    jcfg, jparams, cfg, tparams = models
    tokens, jlogits, jcache = jax_prefill
    cache = lm.init_cache(cfg, B, 64, torch.float32, "cpu")
    logits, cache = lm.prefill(tparams, cfg, cache, tokens=torch.from_numpy(tokens).long())
    assert logits.dtype == torch.float32 and logits.shape == (B, cfg.padded_vocab)
    _close(logits, jlogits, TOL)
    for name in ("s", "x_tm", "x_cm"):
        _close(cache["layers"][name], jcache["layers"][name], TOL)

    jdecode = jax.jit(lambda p, c, t: jax_lm.decode_step(p, jcfg, c, t))
    jcur = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    cur = torch.argmax(logits, -1)[:, None]
    jtoks, toks = [np.asarray(jcur)], [cur.numpy()]
    for _ in range(DECODE_STEPS):
        jlogits, jcache = jdecode(jparams, jcache, jcur)
        logits, cache = lm.decode_step(tparams, cfg, cache, cur)
        _close(logits, jlogits, TOL)
        jcur = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        cur = torch.argmax(logits, -1)[:, None]
        jtoks.append(np.asarray(jcur))
        toks.append(cur.numpy())
    assert cache["pos"] == int(jcache["pos"]) == S + DECODE_STEPS
    np.testing.assert_array_equal(np.concatenate(toks, 1), np.concatenate(jtoks, 1))
    for name in ("s", "x_tm", "x_cm"):
        _close(cache["layers"][name], jcache["layers"][name], TOL)


def test_decode_from_bridged_cache_matches_jax(models, jax_prefill):
    """A cache the JAX package filled, carried over by cache_from_numpy."""
    jcfg, jparams, cfg, tparams = models
    _, jlogits, jcache = jax_prefill
    cache = bridge.cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    assert cache["pos"] == S
    nxt = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
    jlogits, jcache = jax_lm.decode_step(jparams, jcfg, jcache, jnp.asarray(nxt))
    logits, cache = lm.decode_step(tparams, cfg, cache, torch.from_numpy(nxt).long())
    _close(logits, jlogits, TOL)
    assert cache["pos"] == S + 1
    _close(cache["layers"]["s"], jcache["layers"]["s"], TOL)


def test_multi_token_decode_matches_forward(models):
    """Greedy decode step by step equals teacher-forced full forwards, in the
    port alone (the twin of test_models.py::test_multi_token_decode_consistency)."""
    _, _, cfg, tparams = models
    seq = torch.from_numpy(_tokens(cfg.vocab, seed=6, n=12)).long()
    cache = lm.init_cache(cfg, B, 64, torch.float32, "cpu")
    _, cache = lm.prefill(tparams, cfg, cache, tokens=seq[:, :-1])
    cur = seq[:, -1:]
    for _ in range(DECODE_STEPS):
        logits, cache = lm.decode_step(tparams, cfg, cache, cur)
        x, _ = lm.forward(tparams, cfg, tokens=seq, mode="train")
        _close(logits, x[:, -1] @ tparams["lm_head"], 3e-4)
        cur = torch.argmax(logits, -1)[:, None]
        seq = torch.cat([seq, cur], dim=1)


def test_cache_schema_is_f32_in_a_bf16_model():
    cfg = get_config(NAME)
    cache = lm.init_cache(cfg.reduced(), 3, 16, torch.bfloat16, "cpu")
    jcache = jax_lm.init_cache(JAX_ARCHS[NAME].reduced(), 3, 16, jnp.bfloat16)
    for name, t in cache["layers"].items():
        assert t.dtype == torch.float32 and str(jcache["layers"][name].dtype) == "float32"
        assert tuple(t.shape) == jcache["layers"][name].shape
    full = lm.cache_schema(cfg, 8, 1088)
    assert full["s"].shape == (32, 8, 64, 64, 64)
    assert full["x_tm"].shape == full["x_cm"].shape == (32, 8, 4096)


def test_bridge_keeps_f32_leaves_of_a_bf16_model(models):
    """A bf16 JAX tree whose decay and bonus are f32, and its f32 cache."""
    jcfg, jparams, _, _ = models
    # each leaf in the dtype the JAX schema gives it in a bf16 model
    jparams = jax.tree.map(lambda a, s: a.astype(s.dtype), jparams,
                           jax_schema.abstract_params(jcfg, jnp.bfloat16))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    for key in ("u", "decay_base"):
        assert tparams["blocks"][key].dtype == torch.float32
        np.testing.assert_array_equal(tparams["blocks"][key].numpy(),
                                      np.asarray(jparams["blocks"][key]))
    wr = tparams["blocks"]["wr"]
    assert wr.dtype == torch.bfloat16
    np.testing.assert_array_equal(wr.float().numpy(),
                                  np.asarray(jparams["blocks"]["wr"].astype(jnp.float32)))
    jcache = jax_lm.init_cache(jcfg, B, 16, jnp.bfloat16)
    cache = bridge.cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    assert {t.dtype for t in cache["layers"].values()} == {torch.float32}
    tokens = torch.from_numpy(_tokens(jcfg.vocab, seed=8)).long()
    logits, _ = lm.prefill(tparams, get_config(NAME).reduced(), cache, tokens=tokens)
    assert torch.isfinite(logits).all()


# --- config and schema -----------------------------------------------------

def test_config_matches_reference():
    full, jfull = get_config(NAME), JAX_ARCHS[NAME]
    for cfg, jcfg in ((full, jfull), (full.reduced(), jfull.reduced())):
        mine, theirs = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
        assert "RWKV/v6-Finch-7B-HF" in mine.pop("source")
        theirs.pop("source")
        assert mine == theirs
        assert cfg.layer_kinds() == jcfg.layer_kinds()
        assert cfg.n_params() == jcfg.n_params()
    assert full.n_params() == 7_576_621_056
    assert (full.n_layers, full.d_model, full.d_model // full.rwkv_head_dim,
            full.rwkv_head_dim, full.d_ff, full.vocab) == (32, 4096, 64, 64, 14336, 65536)


def _jax_leaves(tree):
    return {jax.tree_util.keystr(path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, jax_schema.Param))[0]}


def test_schema_at_full_width_matches_reference():
    """Same keys, shapes, dtypes, initializers and fan-ins as the JAX schema."""
    cfg, jcfg = get_config(NAME), JAX_ARCHS[NAME]
    jabstract = _jax_leaves(jax_schema.abstract_params(jcfg))
    abstract = _jax_leaves(lm.abstract_params(cfg))
    assert {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for k, t in abstract.items()} == \
        {k: (a.shape, str(a.dtype)) for k, a in jabstract.items()}
    assert all(t.device.type == "meta" for t in abstract.values())
    assert sum(t.numel() for t in abstract.values()) == cfg.n_params() == 7_576_621_056
    assert abstract["['lm_head']"].shape == (4096, 65536)
    jparams = _jax_leaves(jax_schema.model_schema(jcfg))
    mine = _jax_leaves(lm.model_schema(cfg))
    for key, p in mine.items():
        jp = jparams[key]
        assert (p.shape, p.init, p.scale, p.dtype) == (jp.shape, jp.init, jp.scale, jp.dtype)
        if p.init == "fan_in":
            assert schema._fan_in(p) == jax_schema._fan_in(jp), key


def test_init_params_follows_schema_distributions():
    cfg = dataclasses.replace(get_config(NAME), n_layers=1, vocab=512, d_ff=512)
    p = lm.init_params(cfg, torch.Generator("cpu").manual_seed(0), torch.bfloat16, "cpu")
    blocks, d = p["blocks"], cfg.d_model
    assert blocks["u"].dtype == blocks["decay_base"].dtype == torch.float32
    assert blocks["wr"].dtype == torch.bfloat16

    def std(t):
        return t.float().std().item()
    assert abs(std(blocks["u"]) - 1.0) < 0.05                            # normal
    assert abs(std(blocks["decay_base"]) - 1.0) < 0.05
    assert abs(std(blocks["wr"]) * d ** 0.5 - 1.0) < 0.05                # fan_in d
    assert abs(std(blocks["tm_w2"]) * 32 ** 0.5 / 0.1 - 1.0) < 0.05     # 0.1, fan_in 32
    assert abs(std(blocks["decay_w2"]) * 64 ** 0.5 / 0.1 - 1.0) < 0.05  # 0.1, fan_in 64
    assert abs(std(blocks["wo"]) * d ** 0.5 - 1.0) < 0.05                # fan_in h * hd
    assert abs(std(p["lm_head"]) * d ** 0.5 - 1.0) < 0.05
    assert torch.all(blocks["ln_x"] == 0) and torch.all(blocks["tm_mus"] == 0)


# --- the command line ------------------------------------------------------

def test_serve_cli_runs_rwkv6_with_jax_and_repro_blocked():
    code = ("import sys; sys.modules.update(dict.fromkeys(('jax', 'jaxlib', 'repro'))); "
            "from repro_torch import serve; "
            "serve.main(['--arch', 'rwkv6-7b', '--reduced', '--device', 'cpu'])")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("[serve] prefill 4x24 in ")
    assert lines[1].startswith("[serve] decoded 16 tokens/seq x 4 seqs in ")
    assert lines[2].startswith("[serve] sample: [")
