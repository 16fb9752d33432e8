"""The port's gqa_block against the JAX package's, on the CPU, where query
heads are padded past n_heads (``padded_heads``, 16 at the reduced widths).

recurrentgemma-2b has one kv head: the port leaves its padded heads out of
attention (the real heads' rows of wq and wo only) where the reference
attends at 16 heads and zeroes the padded ones before wo.  qwen3-1.7b has
two kv heads, so slicing query heads would change the GQA mapping: it
attends at all 16.  Either way the numbers are the reference's: output,
cache and every parameter's gradient within 1e-4 in f32 (both sides compute
in f32 and differ in the order of their sums), and the padded rows of wq and
wo get gradient exactly 0 on both sides.  Every padded row is random here,
not zero, so a port that read them would fail.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models.attention import gqa_block as jax_gqa_block
from repro_torch.configs import get_config
from repro_torch.models import attention

TOL = 1e-4
B, S = 2, 40
# arch: (query heads attention runs at, the window its attention layers use)
ARCHS = {"recurrentgemma-2b": (4, 16), "qwen3-1.7b": (16, None)}


def _params(cfg, seed):
    rng = np.random.default_rng(seed)
    d, h, kh, hd = cfg.d_model, cfg.padded_heads, cfg.n_kv_heads, cfg.head_dim
    fan_in = {"wq": d, "wk": d, "wv": d, "wo": h * hd}
    shapes = {"ln1": (d,), "wq": (d, h, hd), "wk": (d, kh, hd), "wv": (d, kh, hd),
              "wo": (h, hd, d)}
    if cfg.qk_norm:
        shapes.update(q_norm=(hd,), k_norm=(hd,))
    return {name: (rng.standard_normal(shape) / np.sqrt(fan_in.get(name, 100))).astype(np.float32)
            for name, shape in shapes.items()}


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=TOL, rtol=TOL)


@pytest.fixture
def heads_seen(monkeypatch):
    """The query heads of each call gqa_block makes to flash_attention and
    decode_attention (the plain versions on the CPU)."""
    seen = []
    for name in ("flash_attention", "decode_attention"):
        fn = getattr(attention, name)

        def spy(q, *args, _fn=fn, _name=name, **kw):
            seen.append((_name, q.shape[2]))
            return _fn(q, *args, **kw)
        monkeypatch.setattr(attention, name, spy)
    return seen


def _setup(arch, seed=0):
    jcfg, cfg = JAX_ARCHS[arch].reduced(), get_config(arch).reduced()
    assert cfg.padded_heads == 16 > cfg.n_heads == 4
    p = _params(cfg, seed)
    x = np.random.default_rng(seed + 1).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, p, x


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _positions(start, n):
    return np.broadcast_to(np.arange(start, start + n, dtype=np.int32), (B, n))


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_gqa_block_with_padded_heads_matches_jax(arch, mode, heads_seen):
    """Output and cache of train, prefill and one decode step after it, and
    the query heads attention runs at: the real ones alone over one kv
    head, all 16 over two."""
    jcfg, cfg, p, x = _setup(arch)
    heads, window = ARCHS[arch]
    cache_len = window or S + 1
    cache = {"k": np.zeros((B, cache_len, cfg.n_kv_heads, cfg.head_dim), np.float32)}
    cache["v"] = cache["k"].copy()
    kw = dict(window=window)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jout, jcache = jax_gqa_block(jp, jnp.asarray(x), cfg=jcfg, positions=_positions(0, S),
                                 mode="prefill" if mode != "train" else "train",
                                 cache={k: jnp.asarray(v) for k, v in cache.items()}
                                 if mode != "train" else None, **kw)
    tout, tcache = attention.gqa_block(
        _torch(p), torch.from_numpy(x), cfg=cfg,
        positions=torch.from_numpy(_positions(0, S).copy()),
        mode="prefill" if mode != "train" else "train",
        cache=_torch(cache) if mode != "train" else None, **kw)
    want_seen = [("flash_attention", heads)]
    if mode == "decode":
        x1 = np.random.default_rng(7).standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        jout, jcache = jax_gqa_block(jp, jnp.asarray(x1), cfg=jcfg, positions=_positions(S, 1),
                                     mode="decode", cache=jcache, pos=S, **kw)
        tout, tcache = attention.gqa_block(
            _torch(p), torch.from_numpy(x1), cfg=cfg,
            positions=torch.from_numpy(_positions(S, 1).copy()), mode="decode",
            cache=tcache, pos=S, **kw)
        want_seen.append(("decode_attention", heads))
    assert heads_seen == want_seen
    _close(tout.numpy(), jout)
    if mode == "train":
        assert tcache is None and jcache is None
    else:
        for name in ("k", "v"):
            _close(tcache[name].numpy(), jcache[name])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_gqa_block_gradients_with_padded_heads_match_jax(arch):
    """The gradient of every parameter and of x in train mode against
    jax.vjp of the reference on the same cotangent; the padded rows of wq
    and wo exactly 0 on both sides."""
    jcfg, cfg, p, x = _setup(arch, seed=3)
    window = ARCHS[arch][1]
    cot = np.random.default_rng(9).standard_normal((B, S, cfg.d_model)).astype(np.float32)

    def jax_fn(params, xx):
        return jax_gqa_block(params, xx, cfg=jcfg, positions=_positions(0, S), mode="train",
                             cache=None, window=window)[0]
    _, vjp = jax.vjp(jax_fn, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    jgrads, jdx = vjp(jnp.asarray(cot))

    tp = {k: v.requires_grad_(True) for k, v in _torch(p).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, _ = attention.gqa_block(tp, tx, cfg=cfg,
                                 positions=torch.from_numpy(_positions(0, S).copy()),
                                 mode="train", cache=None, window=window)
    tgrads = torch.autograd.grad(out, [*tp.values(), tx], torch.from_numpy(cot))
    assert set(tp) == set(jgrads)
    for name, g in zip(tp, tgrads):
        _close(g.numpy(), jgrads[name])
    _close(tgrads[-1].numpy(), jdx)
    n, grads = cfg.n_heads, dict(zip(tp, tgrads))
    for name, pad, real in (("wq", np.s_[:, n:], np.s_[:, :n]), ("wo", np.s_[n:], np.s_[:n])):
        assert torch.all(grads[name][pad] == 0), name
        assert np.all(np.asarray(jgrads[name])[pad] == 0), name
        assert torch.any(grads[name][real] != 0), name
