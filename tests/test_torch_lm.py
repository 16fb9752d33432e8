"""The port's qwen3-1.7b against the JAX package's, on the CPU, in f32.

The JAX package initialises ``qwen3-1.7b.reduced()``; its parameters go
through numpy and ``repro_torch.bridge`` into the port, so both sides run
the same weights.  Tolerance 2e-4, as tests/test_models.py holds prefill and
decode to the forward pass.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import lm as jax_lm
from repro.models import schema as jax_schema
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.types import MLAConfig

NAME = "qwen3-1.7b"
TOL = 2e-4
B, S, DECODE_STEPS = 2, 17, 8


@pytest.fixture(scope="module")
def models():
    """(jax cfg, jax params, port cfg, port params) on the reduced config."""
    jcfg = JAX_ARCHS[NAME].reduced()
    jparams = jax_lm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                                       torch.float32)
    return jcfg, jparams, get_config(NAME).reduced(), tparams


def _tokens(vocab, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=tol, rtol=tol)


def test_config_matches_reference():
    """The port's copy of the config and of ArchConfig's arithmetic agree."""
    full, jfull = get_config(NAME), JAX_ARCHS[NAME]
    for cfg, jcfg in ((full, jfull), (full.reduced(), jfull.reduced())):
        mine = dataclasses.asdict(cfg)
        theirs = dataclasses.asdict(jcfg)
        assert mine.pop("source") == "[hf:Qwen/Qwen3-1.7B config.json; hf]"
        theirs.pop("source")
        assert mine == theirs
        assert cfg.layer_kinds() == jcfg.layer_kinds()
        assert (cfg.padded_vocab, cfg.padded_heads, cfg.uniform_blocks) == \
            (jcfg.padded_vocab, jcfg.padded_heads, jcfg.uniform_blocks)
        assert (cfg.n_params(), cfg.padding_delta()) == \
            (jcfg.n_params(), jcfg.padding_delta())


def test_schema_at_full_width_matches_reference():
    """Same keys, shapes and parameter count as the JAX schema, on `meta`."""
    cfg, jcfg = get_config(NAME), JAX_ARCHS[NAME]
    jtree = jax_schema.model_schema(jcfg)
    jleaves = {jax.tree_util.keystr(path): p.shape for path, p in
               jax.tree_util.tree_flatten_with_path(
                   jtree, is_leaf=lambda x: isinstance(x, jax_schema.Param))[0]}
    abstract = lm.abstract_params(cfg)
    leaves = {jax.tree_util.keystr(path): t for path, t in
              jax.tree_util.tree_flatten_with_path(abstract)[0]}
    assert {k: tuple(t.shape) for k, t in leaves.items()} == jleaves
    assert all(t.device.type == "meta" for t in leaves.values())
    n = sum(t.numel() for t in leaves.values())
    assert n == cfg.n_params() + cfg.padding_delta() == 1_720_574_976


def test_init_params_follows_schema_distributions():
    cfg = get_config(NAME).reduced()
    params = lm.init_params(cfg, torch.Generator("cpu").manual_seed(0), torch.float32, "cpu")
    d = cfg.d_model
    assert params["embed"].shape == (cfg.padded_vocab, d)
    assert abs(params["embed"].std().item() - 1.0) < 0.05               # normal
    wq = params["blocks"]["wq"]
    assert wq.shape == (cfg.n_layers, d, cfg.padded_heads, cfg.head_dim)
    assert abs(wq.std().item() * d ** 0.5 - 1.0) < 0.05                 # fan_in d
    wo = params["blocks"]["wo"]
    assert abs(wo.std().item() * (cfg.padded_heads * cfg.head_dim) ** 0.5 - 1.0) < 0.05
    assert torch.all(params["blocks"]["ln1"] == 0) and torch.all(params["final_norm"] == 0)


# What the port does not run yet: MLA attention (minicpm3-4b) and an
# encoder-only model (hubert-xlarge), each as the reduced widths give it.
UNPORTED = {"mla": dict(attn_kind="mla", mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                                       qk_nope_dim=16, qk_rope_dim=8,
                                                       v_head_dim=16)),
            "encoder-only": dict(has_decoder=False, causal=False, mlp_kind="gelu")}


@pytest.mark.parametrize("kind", sorted(UNPORTED))
def test_unported_blocks_raise(kind):
    cfg = dataclasses.replace(get_config(NAME).reduced(), **UNPORTED[kind])
    with pytest.raises(NotImplementedError):
        lm.model_schema(cfg)


def test_forward_hidden_matches_jax(models):
    jcfg, jparams, cfg, tparams = models
    tokens = _tokens(cfg.vocab)
    jx, _ = jax_lm.forward(jparams, jcfg, tokens=jnp.asarray(tokens), mode="train",
                           remat="none")
    x, cache = lm.forward(tparams, cfg, tokens=torch.from_numpy(tokens).long(),
                          mode="train")
    assert cache is None
    _close(x.numpy(), jx)


def test_prefill_and_greedy_decode_match_jax(models):
    """Prefill logits, 8 greedy decode steps of logits, and the tokens."""
    jcfg, jparams, cfg, tparams = models
    tokens = _tokens(cfg.vocab, seed=4)
    jcache = jax_lm.init_cache(jcfg, B, 64, jnp.float32)
    jlogits, jcache = jax_lm.prefill(jparams, jcfg, jcache, tokens=jnp.asarray(tokens))
    cache = lm.init_cache(cfg, B, 64, torch.float32, "cpu")
    logits, cache = lm.prefill(tparams, cfg, cache, tokens=torch.from_numpy(tokens).long())
    assert logits.dtype == torch.float32 and logits.shape == (B, cfg.padded_vocab)
    _close(logits.numpy(), jlogits)
    for name in ("k", "v"):
        _close(cache["layers"][name].numpy(), jcache["layers"][name])

    jdecode = jax.jit(lambda p, c, t: jax_lm.decode_step(p, jcfg, c, t))
    jcur = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    cur = torch.argmax(logits, -1)[:, None]
    jtoks, toks = [np.asarray(jcur)], [cur.numpy()]
    for _ in range(DECODE_STEPS):
        jlogits, jcache = jdecode(jparams, jcache, jcur)
        logits, cache = lm.decode_step(tparams, cfg, cache, cur)
        _close(logits.numpy(), jlogits)
        jcur = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        cur = torch.argmax(logits, -1)[:, None]
        jtoks.append(np.asarray(jcur))
        toks.append(cur.numpy())
    assert cache["pos"] == int(jcache["pos"]) == S + DECODE_STEPS
    np.testing.assert_array_equal(np.concatenate(toks, 1), np.concatenate(jtoks, 1))


def test_decode_from_bridged_cache_matches_jax(models):
    """A cache the JAX package filled, carried over by cache_from_numpy."""
    jcfg, jparams, cfg, tparams = models
    tokens = _tokens(cfg.vocab, seed=5)
    jcache = jax_lm.init_cache(jcfg, B, 32, jnp.float32)
    _, jcache = jax_lm.prefill(jparams, jcfg, jcache, tokens=jnp.asarray(tokens[:, :-1]))
    cache = bridge.cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    assert cache["pos"] == S - 1
    jlogits, _ = jax_lm.decode_step(jparams, jcfg, jcache, jnp.asarray(tokens[:, -1:]))
    logits, cache = lm.decode_step(tparams, cfg, cache, torch.from_numpy(tokens[:, -1:]).long())
    _close(logits.numpy(), jlogits)
    assert cache["pos"] == S


def test_prefill_decode_matches_forward(models):
    """logits(prefill(t[:-1]) then decode(t[-1])) == forward(t)[-1], in the port alone."""
    _, _, cfg, tparams = models
    tokens = torch.from_numpy(_tokens(cfg.vocab, seed=6)).long()
    x, _ = lm.forward(tparams, cfg, tokens=tokens, mode="train")
    full_logits = x[:, -1] @ tparams["embed"].T
    cache = lm.init_cache(cfg, B, 64, torch.float32, "cpu")
    _, cache = lm.prefill(tparams, cfg, cache, tokens=tokens[:, :-1])
    logits, cache = lm.decode_step(tparams, cfg, cache, tokens[:, -1:])
    assert cache["pos"] == S
    _close(logits.numpy(), full_logits.numpy())


def test_window_ring_cache_decode_matches_forward(models):
    """A sliding window shorter than the prompt: prefill keeps the trailing
    window in ring order and decode writes slot pos % window."""
    _, _, cfg, tparams = models
    cfg = dataclasses.replace(cfg, block_pattern=("attn_local",), local_window=8)
    tokens = torch.from_numpy(_tokens(cfg.vocab, seed=7)).long()
    x, _ = lm.forward(tparams, cfg, tokens=tokens, mode="train")
    cache = lm.init_cache(cfg, B, 64, torch.float32, "cpu")
    assert cache["layers"]["k"].shape[2] == 8
    _, cache = lm.prefill(tparams, cfg, cache, tokens=tokens[:, :-1])
    logits, _ = lm.decode_step(tparams, cfg, cache, tokens[:, -1:])
    _close(logits.numpy(), (x[:, -1] @ tparams["embed"].T).numpy())
