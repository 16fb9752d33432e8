"""The port's dense siblings of qwen3-1.7b, yi-9b and minitron-4b, against the
JAX package's, on the CPU, in f32.

yi-9b is a llama-architecture GQA decoder (SwiGLU); minitron-4b has an
ungated squared-ReLU MLP (``relu2``, no ``mlp_wg``) and 24 query heads
padded to 32 over 8 kv heads.  Each side runs the same weights: the port
initialises each reduced config from a seed, and the same numbers go to
the JAX package through numpy.  Tolerance 2e-4, as tests/test_torch_lm.py
holds the forward pass, prefill and decode, and tests/test_torch_train.py a
train step.

C1 (``ROADMAP.md``): the reference pads query heads and lets head h read
kv head h // (padded_heads // n_kv_heads), so the real heads of minitron-4b
read kv heads 0-5 and kv heads 6 and 7 are read by masked heads only.  The
port mirrors that; the gradients of the unread kv heads' wk and wv, and of
the padded rows of wq and wo, are exactly 0 on both sides.
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
from repro.data import SyntheticLMDataset as JaxDataset
from repro.models import layers as jax_layers
from repro.models import lm as jax_lm
from repro.models import schema as jax_schema
from repro.optim import init_train_state as jax_init_train_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import layers, lm
from repro_torch.optim import init_train_state
from repro_torch.train import make_train_step
from repro_torch.tree import leaves, paths

ROOT = Path(__file__).resolve().parent.parent
NAMES = ("yi-9b", "minitron-4b")
SOURCES = {"yi-9b": "[hf:01-ai/Yi-9B config.json; arXiv:2403.04652; hf]",
           "minitron-4b": "[hf:nvidia/Minitron-4B-Base config.json; arXiv:2407.14679; hf]"}
# parameters at full width, padded heads included (n_params() + padding_delta())
FULL_PARAMS = {"yi-9b": 8_829_407_232, "minitron-4b": 4_391_635_968}
TOL = 2e-4
B, S, DECODE_STEPS = 2, 17, 8
STEP_KW = dict(lr=1e-2, warmup=2, total=10, ce_chunk=8)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=tol, rtol=tol)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _weights(cfg, jcfg, seed=0):
    """(port params, jax params): the port's seeded init, carried to jax."""
    params = lm.init_params(cfg, torch.Generator().manual_seed(seed), torch.float32, "cpu")
    return params, jax.tree.map(jnp.asarray, _to_numpy(params))


@pytest.fixture(scope="module", params=NAMES)
def models(request):
    """(jax cfg, jax params, port cfg, port params) on the reduced config."""
    name = request.param
    cfg, jcfg = get_config(name).reduced(), JAX_ARCHS[name].reduced()
    params, jparams = _weights(cfg, jcfg)
    return jcfg, jparams, cfg, params


def _tokens(vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("name", NAMES)
def test_config_matches_reference(name):
    """The port's copy of the config and ArchConfig's arithmetic agree, at
    full width and reduced; the copy cites the published config."""
    full, jfull = get_config(name), JAX_ARCHS[name]
    for cfg, jcfg in ((full, jfull), (full.reduced(), jfull.reduced())):
        mine, theirs = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
        assert mine.pop("source") == SOURCES[name]
        theirs.pop("source")
        assert mine == theirs
        assert (cfg.padded_heads, cfg.padded_vocab, cfg.layer_kinds()) == \
            (jcfg.padded_heads, jcfg.padded_vocab, jcfg.layer_kinds())
        assert (cfg.n_params(), cfg.padding_delta()) == (jcfg.n_params(), jcfg.padding_delta())


@pytest.mark.parametrize("name", NAMES)
def test_schema_at_full_width_matches_reference(name):
    """Same keys and shapes as the JAX schema, on `meta`; minitron's MLP has
    no gate; the count is n_params() + padding_delta()."""
    cfg, jcfg = get_config(name), JAX_ARCHS[name]
    jleaves = {jax.tree_util.keystr(path): p.shape for path, p in
               jax.tree_util.tree_flatten_with_path(
                   jax_schema.model_schema(jcfg),
                   is_leaf=lambda x: isinstance(x, jax_schema.Param))[0]}
    abstract = lm.abstract_params(cfg)
    mine = {jax.tree_util.keystr(path): tuple(t.shape) for path, t in
            jax.tree_util.tree_flatten_with_path(abstract)[0]}
    assert mine == jleaves
    assert ("mlp_wg" in abstract["blocks"]) == (name == "yi-9b")
    n = sum(t.numel() for t in leaves(abstract))
    assert n == cfg.n_params() + cfg.padding_delta() == FULL_PARAMS[name]


def test_relu2_matches_jax():
    u = np.random.default_rng(0).standard_normal((3, 5, 7)).astype(np.float32)
    u[0, 0, :3] = (0.0, -0.0, 1e-3)
    mine = layers._act("relu2", None, torch.from_numpy(u))
    np.testing.assert_array_equal(mine.numpy(), np.asarray(jax_layers._act("relu2", None, u)))
    assert torch.all(mine[u < 0] == 0)


def test_forward_hidden_matches_jax(models):
    jcfg, jparams, cfg, params = models
    tokens = _tokens(cfg.vocab, 3)
    jx, _ = jax_lm.forward(jparams, jcfg, tokens=jnp.asarray(tokens), mode="train",
                           remat="none")
    x, cache = lm.forward(params, cfg, tokens=torch.from_numpy(tokens).long(), mode="train")
    assert cache is None
    _close(x.detach().numpy(), jx)


def test_prefill_and_greedy_decode_match_jax(models):
    """Prefill logits and cache, 8 greedy decode steps of logits, and the tokens."""
    jcfg, jparams, cfg, params = models
    tokens = _tokens(cfg.vocab, 4)
    jcache = jax_lm.init_cache(jcfg, B, 64, jnp.float32)
    jlogits, jcache = jax_lm.prefill(jparams, jcfg, jcache, tokens=jnp.asarray(tokens))
    cache = lm.init_cache(cfg, B, 64, torch.float32, "cpu")
    with torch.no_grad():
        logits, cache = lm.prefill(params, cfg, cache, tokens=torch.from_numpy(tokens).long())
    _close(logits.numpy(), jlogits)
    for name in ("k", "v"):
        _close(cache["layers"][name].numpy(), jcache["layers"][name])
    jdecode = jax.jit(lambda p, c, t: jax_lm.decode_step(p, jcfg, c, t))
    jcur = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    cur = torch.argmax(logits, -1)[:, None]
    jtoks, toks = [np.asarray(jcur)], [cur.numpy()]
    for _ in range(DECODE_STEPS):
        jlogits, jcache = jdecode(jparams, jcache, jcur)
        with torch.no_grad():
            logits, cache = lm.decode_step(params, cfg, cache, cur)
        _close(logits.numpy(), jlogits)
        jcur = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        cur = torch.argmax(logits, -1)[:, None]
        jtoks.append(np.asarray(jcur))
        toks.append(cur.numpy())
    assert cache["pos"] == int(jcache["pos"]) == S + DECODE_STEPS
    np.testing.assert_array_equal(np.concatenate(toks, 1), np.concatenate(jtoks, 1))


@pytest.fixture(scope="module")
def jax_step(models):
    """One JAX train step of the module's model (jax.checkpoint changes no
    value, so the port's remat modes share it)."""
    jcfg, jparams, cfg, _ = models
    batch = JaxDataset(jcfg.vocab, 16, seed=0).batch(0, 4)
    jstep = jax.jit(jax_make_train_step(jcfg, remat="none", **STEP_KW))
    return batch, jstep(jax_init_train_state(jparams), jax.tree.map(jnp.asarray, batch))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_matches_reference(models, jax_step, remat):
    """Loss, grad_norm and every leaf of the state after one step."""
    jcfg, jparams, cfg, _ = models
    batch, (jstate, jm) = jax_step
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    state, m = make_train_step(cfg, remat=remat, **STEP_KW)(
        init_train_state(params), {k: torch.from_numpy(v).long() for k, v in batch.items()})
    assert int(m["tokens"]) == int(jm["tokens"]) == 4 * 16
    _close(m["loss"].item(), float(jm["loss"]))
    _close(m["grad_norm"].item(), float(jm["grad_norm"]))
    for path, mine, theirs in zip(paths(state), leaves(state), jax.tree.leaves(jstate)):
        assert tuple(mine.shape) == theirs.shape, path
        _close(mine.detach().numpy(), theirs)


def _unread_kv_heads(cfg):
    """The kv heads that no real query head reads: head h reads kv head
    h // (padded_heads // n_kv_heads)."""
    group = cfg.padded_heads // cfg.n_kv_heads
    return list(range(-(-cfg.n_heads // group), cfg.n_kv_heads))


# minitron-4b reduced (4 heads padded to 16 over 2 kv heads) and its full
# width's head layout at the reduced width (24 heads padded to 32 over 8)
C1_HEADS = {"reduced": {}, "full-width heads": {"n_heads": 24, "n_kv_heads": 8}}


@pytest.mark.parametrize("layout", sorted(C1_HEADS))
def test_padded_heads_mapping_matches_reference(layout):
    """C1, mirrored: the gradients of loss_fn on both sides agree within
    2e-4, and on both sides the unread kv heads' wk and wv and the padded
    rows of wq and wo get gradient exactly 0 (their weights are random, not
    zero, so a port that read them would show it)."""
    cfg = dataclasses.replace(get_config("minitron-4b").reduced(), **C1_HEADS[layout])
    jcfg = dataclasses.replace(JAX_ARCHS["minitron-4b"].reduced(), **C1_HEADS[layout])
    unread = _unread_kv_heads(cfg)
    assert unread == ([1] if layout == "reduced" else [6, 7])
    params, jparams = _weights(cfg, jcfg, seed=5)
    batch = JaxDataset(jcfg.vocab, 12, seed=1).batch(0, 2)
    jgrads = jax.grad(lambda p: jax_lm.loss_fn(p, jcfg, jax.tree.map(jnp.asarray, batch),
                                               remat="none", ce_chunk=4)[0])(jparams)
    weights = leaves(params)
    for w in weights:
        w.requires_grad_(True)
    loss, _ = lm.loss_fn(params, cfg, {k: torch.from_numpy(v).long() for k, v in batch.items()},
                         remat="none", ce_chunk=4)
    grads = dict(zip(paths(params), torch.autograd.grad(loss, weights)))
    jflat = dict(zip(paths(params), jax.tree.leaves(jgrads)))
    for path, g in grads.items():
        _close(g.numpy(), jflat[path])
    h = cfg.n_heads
    for side in (grads, {k: torch.from_numpy(np.array(v)) for k, v in jflat.items()}):
        blocks = {k.removeprefix("blocks/"): v for k, v in side.items()}
        for name in ("wk", "wv"):
            assert torch.all(blocks[name][:, :, unread] == 0), name
            assert torch.all(blocks[name][:, :, :unread[0]].abs().amax(dim=(1, 3)) > 0), name
        assert torch.all(blocks["wq"][:, :, h:] == 0)
        assert torch.all(blocks["wo"][:, h:] == 0)
        assert torch.all(blocks["wq"][:, :, :h].abs().amax(dim=(1, 3)) > 0)


@pytest.mark.parametrize("argv, first", [
    (["serve", "--arch", "yi-9b"], "[serve] prefill 4x24 in "),
    (["serve", "--arch", "minitron-4b"], "[serve] prefill 4x24 in "),
    (["launch.train", "--arch", "minitron-4b", "--steps", "2", "--batch", "2", "--seq", "16"],
     "[train] arch=minitron-4b params=")])
def test_cli_runs_with_jax_and_repro_blocked(argv, first):
    """The serve and train entry points at the reduced width on the CPU,
    with jax and the JAX package unimportable."""
    module, args = argv[0], argv[1:] + ["--reduced", "--device", "cpu"]
    code = ("import sys; sys.modules.update(dict.fromkeys(('jax', 'jaxlib', 'repro'))); "
            f"import repro_torch.{module} as entry; sys.exit(entry.main({args!r}))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[0].startswith(first)
