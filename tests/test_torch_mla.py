"""The port's multi-head latent attention (MLA) and minicpm3-4b against the
JAX package's, on the CPU, in f32.

``mla_block`` in train, prefill and decode: output, the compressed cache
{"ckv", "krope"} and every gradient within 1e-4 (both sides compute in f32
and differ in the order of their sums, as tests/test_torch_gqa_block.py
holds gqa_block), with the 12 heads padded past the reduced config's 4
random, not zero, so a port that read them would fail: their gradients
must be exactly 0 on both sides.  ``_mla_two_pass`` against the
reference's, with cache entries past the length.  minicpm3-4b's config and
full-width schema, the bridge of its reference tree, prefill plus 8 greedy
decode steps and one train step at ``.reduced()`` within 2e-4, as
tests/test_torch_lm.py and tests/test_torch_train.py hold the dense models.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.data import SyntheticLMDataset as JaxDataset
from repro.models import attention as jax_attention
from repro.models import lm as jax_lm
from repro.models import schema as jax_schema
from repro.optim import init_train_state as jax_init_train_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.models import attention, lm
from repro_torch.optim import init_train_state
from repro_torch.train import make_train_step
from repro_torch.tree import leaves, paths

NAME = "minicpm3-4b"
BLOCK_TOL = 1e-4
TOL = 2e-4
B, S = 2, 24
FULL_PARAMS = 4_396_112_384
STEP_KW = dict(lr=1e-2, warmup=2, total=10, ce_chunk=8)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=tol, rtol=tol)


def _configs():
    return get_config(NAME).reduced(), JAX_ARCHS[NAME].reduced()


def _block_params(cfg, seed):
    """One MLA block's parameters, every leaf random (the norms and the
    padded heads' rows included), scaled by its fan-in."""
    rng = np.random.default_rng(seed)
    d, h, m = cfg.d_model, cfg.padded_heads, cfg.mla
    qk = m.qk_nope_dim + m.qk_rope_dim
    shapes = {"ln1": (d,), "wq_a": (d, m.q_lora_rank), "q_a_norm": (m.q_lora_rank,),
              "wq_b": (m.q_lora_rank, h, qk), "wkv_a": (d, m.kv_lora_rank + m.qk_rope_dim),
              "kv_a_norm": (m.kv_lora_rank,),
              "wkv_b": (m.kv_lora_rank, h, m.qk_nope_dim + m.v_head_dim),
              "wo": (h, m.v_head_dim, d)}
    fan_in = {"wq_a": d, "wq_b": m.q_lora_rank, "wkv_a": d, "wkv_b": m.kv_lora_rank,
              "wo": h * m.v_head_dim}
    return {name: (rng.standard_normal(shape) / np.sqrt(fan_in.get(name, 25))).astype(np.float32)
            for name, shape in shapes.items()}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _positions(start, n):
    return np.broadcast_to(np.arange(start, start + n, dtype=np.int32), (B, n))


def _x(cfg, n, seed):
    return np.random.default_rng(seed).standard_normal((B, n, cfg.d_model)).astype(np.float32)


def _empty_cache(cfg, length):
    m = cfg.mla
    return {"ckv": np.zeros((B, length, m.kv_lora_rank), np.float32),
            "krope": np.zeros((B, length, m.qk_rope_dim), np.float32)}


def test_reduced_config_pads_heads():
    cfg, _ = _configs()
    assert cfg.padded_heads == 16 > cfg.n_heads == cfg.n_kv_heads == 4


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_mla_block_matches_jax(mode):
    """Output and cache of train, prefill and two decode steps after it (the
    cache one longer than the prompt and its steps, so the decode masks an
    entry past its length)."""
    cfg, jcfg = _configs()
    p = _block_params(cfg, 0)
    x = _x(cfg, S, 1)
    jp, tp = {k: jnp.asarray(v) for k, v in p.items()}, _torch(p)
    cache = _empty_cache(cfg, S + 3) if mode != "train" else None
    first = "train" if mode == "train" else "prefill"
    jout, jcache = jax_attention.mla_block(
        jp, jnp.asarray(x), cfg=jcfg, positions=_positions(0, S), mode=first,
        cache=None if cache is None else {k: jnp.asarray(v) for k, v in cache.items()})
    tout, tcache = attention.mla_block(
        tp, torch.from_numpy(x), cfg=cfg, positions=torch.from_numpy(_positions(0, S).copy()),
        mode=first, cache=None if cache is None else _torch(cache))
    if mode == "decode":
        for i in range(2):
            x1 = _x(cfg, 1, 10 + i)
            jout, jcache = jax_attention.mla_block(
                jp, jnp.asarray(x1), cfg=jcfg, positions=_positions(S + i, 1), mode="decode",
                cache=jcache, pos=S + i)
            tout, tcache = attention.mla_block(
                tp, torch.from_numpy(x1), cfg=cfg,
                positions=torch.from_numpy(_positions(S + i, 1).copy()), mode="decode",
                cache=tcache, pos=S + i)
    _close(tout.numpy(), jout, BLOCK_TOL)
    if mode == "train":
        assert tcache is None and jcache is None
        return
    for name in ("ckv", "krope"):
        assert tuple(tcache[name].shape) == jcache[name].shape
        _close(tcache[name].numpy(), jcache[name], BLOCK_TOL)
    filled = S + (2 if mode == "decode" else 0)
    assert torch.all(tcache["ckv"][:, filled:] == 0) and torch.any(tcache["ckv"][:, :filled] != 0)


def test_mla_block_writes_the_cache_it_is_given():
    """Prefill and decode store into the cache tensors in place."""
    cfg, _ = _configs()
    tp = _torch(_block_params(cfg, 0))
    cache = _torch(_empty_cache(cfg, S + 1))
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    _, new = attention.mla_block(tp, torch.from_numpy(_x(cfg, S, 1)), cfg=cfg,
                                 positions=torch.from_numpy(_positions(0, S).copy()),
                                 mode="prefill", cache=cache)
    _, new = attention.mla_block(tp, torch.from_numpy(_x(cfg, 1, 2)), cfg=cfg,
                                 positions=torch.from_numpy(_positions(S, 1).copy()),
                                 mode="decode", cache=new, pos=S)
    assert {k: v.data_ptr() for k, v in new.items()} == ptrs


def test_mla_block_gradients_match_jax():
    """The gradient of every parameter and of x in train mode against
    jax.vjp of the reference on the same cotangent; the padded heads' rows
    of wq_b, wkv_b and wo exactly 0 on both sides."""
    cfg, jcfg = _configs()
    p = _block_params(cfg, 3)
    x = _x(cfg, S, 4)
    cot = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def jax_fn(params, xx):
        return jax_attention.mla_block(params, xx, cfg=jcfg, positions=_positions(0, S),
                                       mode="train", cache=None)[0]
    _, vjp = jax.vjp(jax_fn, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    jgrads, jdx = vjp(jnp.asarray(cot))

    tp = {k: v.requires_grad_(True) for k, v in _torch(p).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, _ = attention.mla_block(tp, tx, cfg=cfg,
                                 positions=torch.from_numpy(_positions(0, S).copy()),
                                 mode="train", cache=None)
    grads = dict(zip([*tp, "x"], torch.autograd.grad(out, [*tp.values(), tx],
                                                     torch.from_numpy(cot))))
    for name, g in grads.items():
        want = jdx if name == "x" else jgrads[name]
        assert tuple(g.shape) == want.shape, name
        _close(g.numpy(), want, BLOCK_TOL)
    real = cfg.n_heads
    for name, rows in (("wq_b", (slice(None), slice(real, None))),
                       ("wkv_b", (slice(None), slice(real, None))), ("wo", (slice(real, None),))):
        assert torch.all(grads[name][rows] == 0), name
        assert np.all(np.asarray(jgrads[name])[rows] == 0), name
        assert torch.any(grads[name][(slice(None),) * (len(rows) - 1) + (slice(0, real),)] != 0)


@pytest.mark.parametrize("length", [1, 7, 16])
def test_mla_two_pass_matches_jax(length):
    """The absorbed decode attention on a cache of 16 entries, of which
    ``length`` are valid, the rest random (they must take no part)."""
    rng = np.random.default_rng(length)
    H, R, P, Sc = 6, 16, 8, 16
    q_abs, q_rope = (rng.standard_normal((B, 1, H, n)).astype(np.float32) for n in (R, P))
    ckv, krope = (rng.standard_normal((B, Sc, n)).astype(np.float32) for n in (R, P))
    scale = 1.0 / 24 ** 0.5
    want = jax_attention._mla_two_pass(*(jnp.asarray(a) for a in (q_abs, q_rope, ckv, krope)),
                                       length, scale)
    got = attention._mla_two_pass(*(torch.from_numpy(a) for a in (q_abs, q_rope, ckv, krope)),
                                  length, scale)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, 1, H, R)
    _close(got.numpy(), want, 1e-5)


def test_mla_two_pass_takes_products_in_f32():
    """bf16 inputs: the logits and the weighted sum in f32 (the reference's
    preferred_element_type), so the result is the f32 inputs' own."""
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, 1, 4, 16), (B, 1, 4, 8), (B, 9, 16), (B, 9, 8))]
    bf16 = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    got = attention._mla_two_pass(*bf16, 9, 0.2)
    want = attention._mla_two_pass(*(t.float() for t in bf16), 9, 0.2)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_config_matches_reference():
    full, jfull = get_config(NAME), JAX_ARCHS[NAME]
    for cfg, jcfg in ((full, jfull), (full.reduced(), jfull.reduced())):
        mine, theirs = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
        assert mine.pop("source") == "[hf:openbmb/MiniCPM3-4B config.json; hf]"
        theirs.pop("source")
        assert mine == theirs
        assert (cfg.padded_heads, cfg.padded_vocab, cfg.n_params(), cfg.padding_delta()) == (
            jcfg.padded_heads, jcfg.padded_vocab, jcfg.n_params(), jcfg.padding_delta())
    assert (full.n_layers, full.d_model, full.n_heads, full.padded_heads, full.n_kv_heads,
            full.d_ff, full.padded_vocab, full.tie_embeddings) == (
        62, 2560, 40, 48, 40, 6400, 73472, False)


def test_schema_at_full_width_matches_reference():
    """Same keys and shapes as the JAX schema, on `meta`; 4,396,112,384
    parameters, padded heads and vocab included."""
    cfg, jcfg = get_config(NAME), JAX_ARCHS[NAME]
    jleaves = {jax.tree_util.keystr(path): p.shape for path, p in
               jax.tree_util.tree_flatten_with_path(
                   jax_schema.model_schema(jcfg),
                   is_leaf=lambda x: isinstance(x, jax_schema.Param))[0]}
    abstract = lm.abstract_params(cfg)
    mine = {jax.tree_util.keystr(path): tuple(t.shape) for path, t in
            jax.tree_util.tree_flatten_with_path(abstract)[0]}
    assert mine == jleaves
    blocks = abstract["blocks"]
    assert tuple(blocks["wq_b"].shape) == (62, 768, 48, 96)
    assert tuple(blocks["wkv_b"].shape) == (62, 256, 48, 128)
    assert tuple(blocks["wo"].shape) == (62, 48, 64, 2560)
    assert sum(t.numel() for t in leaves(abstract)) == FULL_PARAMS


def test_cache_schema_matches_reference():
    cfg, jcfg = get_config(NAME), JAX_ARCHS[NAME]
    want = {k: p.shape for k, p in jax_lm.cache_schema(jcfg, 8, 1088)["layers"].items()}
    mine = {k: p.shape for k, p in lm.cache_schema(cfg, 8, 1088).items()}
    assert mine == want == {"ckv": (62, 8, 1088, 256), "krope": (62, 8, 1088, 32)}


def test_full_width_layer_attends_at_96_and_64():
    """At full width a layer hands flash_attention q and k of 96 (64 + 32
    rotary) and v of 64 at the 48 padded heads, one kv head a query head:
    the backward's (96, 64) pair, on the tensor cores in bf16 and the SIMT
    route in f32."""
    cfg = dataclasses.replace(get_config(NAME), n_layers=1)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    seen = []

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape), kw))
        return torch.zeros(q.shape[:3] + (v.shape[3],), dtype=q.dtype)
    p = {name: t[0] for name, t in params["blocks"].items()}
    x = torch.zeros(1, 3, cfg.d_model)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention, "flash_attention", spy)
        attention.mla_block(p, x, cfg=cfg, positions=torch.arange(3)[None], mode="train",
                            cache=None)
    assert seen == [((1, 3, 48, 96), (1, 3, 48, 96), (1, 3, 48, 64),
                     {"causal": True, "window": None})]
    assert (96, 64) in fa_kernel.BWD_HEAD_DIMS
    for dtype, want in ((torch.float32, "simt"), (torch.bfloat16, "wgmma")):
        assert fa_kernel.route(dtype, 96, 64) == fa_kernel.route(dtype, 96, 64, backward=True) \
            == want


def test_bridge_carries_the_reference_tree():
    """The JAX package's own init of the reduced model, through numpy: the
    port's keys, shapes and dtypes, the values unchanged, and the port runs
    it."""
    cfg, jcfg = _configs()
    jparams = jax_schema.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    abstract = lm.abstract_params(cfg, torch.float32)
    assert paths(params) == paths(abstract)
    for mine, want, ref in zip(leaves(params), leaves(abstract), jax.tree.leaves(jparams)):
        assert mine.shape == want.shape and mine.dtype == want.dtype
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, 5)).astype(np.int32)
    jx, _ = jax_lm.forward(jparams, jcfg, tokens=jnp.asarray(tokens), mode="train",
                           remat="none")
    with torch.no_grad():
        x, _ = lm.forward(params, cfg, tokens=torch.from_numpy(tokens).long(), mode="train")
    _close(x.numpy(), jx)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.detach().numpy()


@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, port cfg, port params): the port's seeded init of
    the reduced config, carried to jax."""
    cfg, jcfg = _configs()
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    return jcfg, jax.tree.map(jnp.asarray, _to_numpy(params)), cfg, params


def test_prefill_and_greedy_decode_match_jax(model):
    """Prefill logits and cache, 8 greedy decode steps of logits (each on
    the compressed cache), and the tokens."""
    jcfg, jparams, cfg, params = model
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (B, 17)).astype(np.int32)
    jcache = jax_lm.init_cache(jcfg, B, 64, jnp.float32)
    jlogits, jcache = jax_lm.prefill(jparams, jcfg, jcache, tokens=jnp.asarray(tokens))
    cache = lm.init_cache(cfg, B, 64, torch.float32, "cpu")
    with torch.no_grad():
        logits, cache = lm.prefill(params, cfg, cache, tokens=torch.from_numpy(tokens).long())
    _close(logits.numpy(), jlogits)
    for name in ("ckv", "krope"):
        _close(cache["layers"][name].numpy(), jcache["layers"][name])
    jdecode = jax.jit(lambda p, c, t: jax_lm.decode_step(p, jcfg, c, t))
    jcur = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    cur = torch.argmax(logits, -1)[:, None]
    jtoks, toks = [np.asarray(jcur)], [cur.numpy()]
    for _ in range(8):
        jlogits, jcache = jdecode(jparams, jcache, jcur)
        with torch.no_grad():
            logits, cache = lm.decode_step(params, cfg, cache, cur)
        _close(logits.numpy(), jlogits)
        jcur = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        cur = torch.argmax(logits, -1)[:, None]
        jtoks.append(np.asarray(jcur))
        toks.append(cur.numpy())
    assert cache["pos"] == int(jcache["pos"]) == 17 + 8
    for name in ("ckv", "krope"):
        _close(cache["layers"][name].numpy(), jcache["layers"][name])
    np.testing.assert_array_equal(np.concatenate(toks, 1), np.concatenate(jtoks, 1))


def test_train_step_matches_jax(model):
    """The gradients of loss_fn (remat "full") against jax.grad, then one
    make_train_step step: loss, grad_norm and every leaf of the state (the
    f32 master, mu and nu after the first AdamW step)."""
    jcfg, jparams, cfg, params = model
    batch = JaxDataset(jcfg.vocab, 16, seed=0).batch(0, 4)
    tbatch = {k: torch.from_numpy(np.asarray(v)).long() for k, v in batch.items()}
    jbatch = jax.tree.map(jnp.asarray, batch)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jax_lm.loss_fn(p, jcfg, jbatch, remat="none", ce_chunk=8), has_aux=True)(jparams)
    port = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    weights = leaves(port)
    for w in weights:
        w.requires_grad_(True)
    loss, _ = lm.loss_fn(port, cfg, tbatch, remat="full", ce_chunk=8)
    grads = torch.autograd.grad(loss, weights)
    _close(loss.item(), float(jl))
    for path, mine, theirs in zip(paths(port), grads, jax.tree.leaves(jg)):
        assert tuple(mine.shape) == theirs.shape, path
        _close(mine.numpy(), theirs)
    jstate, jm = jax.jit(jax_make_train_step(jcfg, remat="none", **STEP_KW))(
        jax_init_train_state(jparams), jbatch)
    port = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    state, m = make_train_step(cfg, remat="full", **STEP_KW)(init_train_state(port), tbatch)
    _close(m["loss"].item(), float(jm["loss"]))
    _close(m["grad_norm"].item(), float(jm["grad_norm"]))
    assert int(state["step"]) == int(jstate["step"]) == 1
    for path, mine, theirs in zip(paths(state), leaves(state), jax.tree.leaves(jstate)):
        assert tuple(mine.shape) == theirs.shape, path
        _close(mine.detach().numpy(), theirs)
