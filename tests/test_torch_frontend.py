"""The port's two models with a frontend stub, hubert-xlarge and pixtral-12b,
against the JAX package's, on the CPU, in f32.

hubert-xlarge is encoder-only and bidirectional: an ungated GELU MLP (the
tanh approximation, jax.nn.gelu's default), a ``cls_head`` in place of
``lm_head``, no decode step; its prefill is a train-mode forward that
returns the frame logits.  pixtral-12b is a GQA decoder whose prompt is
patch embeddings, decoded greedily on tokens.  Both read embeddings (the
frontends are stubs), so the ``embed`` leaf is never read in a train step:
it gets a zero gradient on both sides, and AdamW only decays its master.
Each side runs the same weights and the same numpy embeddings; tolerance
2e-4, as tests/test_torch_dense_siblings.py.
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
from repro_torch.configs import ARCHS, get_config
from repro_torch.data import pseudo_embeds
from repro_torch.models import layers, lm
from repro_torch.optim import cosine_schedule, init_train_state
from repro_torch.serve import encode, generate
from repro_torch.train import make_prefill_step, make_train_step
from repro_torch.tree import leaves, paths

ROOT = Path(__file__).resolve().parent.parent
NAMES = ("hubert-xlarge", "pixtral-12b")
# parameters at full width (no padded heads in either)
FULL_PARAMS = {"hubert-xlarge": 945_153_280, "pixtral-12b": 12_247_782_400}
TOL = 2e-4
B, S, DECODE_STEPS = 2, 17, 8
STEP_KW = dict(lr=1e-2, warmup=2, total=10, ce_chunk=8, weight_decay=0.1)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=tol, rtol=tol)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _embeds(d, seed, seq=S):
    return (0.02 * np.random.default_rng(seed).standard_normal((B, seq, d))).astype(np.float32)


@pytest.fixture(scope="module", params=NAMES)
def models(request):
    """(jax cfg, jax params, port cfg, port params) on the reduced config:
    the port's seeded init, carried to jax through numpy."""
    return _model(request.param, 0)


@pytest.mark.parametrize("name", NAMES)
def test_config_matches_reference(name):
    """The port's copy of the config, its source note included, and
    ArchConfig's arithmetic agree with the JAX package's, at full width and
    reduced."""
    full, jfull = get_config(name), JAX_ARCHS[name]
    for cfg, jcfg in ((full, jfull), (full.reduced(), jfull.reduced())):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert (cfg.padded_heads, cfg.padded_vocab, cfg.layer_kinds()) == \
            (jcfg.padded_heads, jcfg.padded_vocab, jcfg.layer_kinds())
        assert (cfg.n_params(), cfg.padding_delta()) == (jcfg.n_params(), jcfg.padding_delta())
    assert (full.frontend, full.has_decoder, full.causal) == {
        "hubert-xlarge": ("audio", False, False), "pixtral-12b": ("vision", True, True)}[name]


@pytest.mark.parametrize("name", NAMES)
def test_schema_at_full_width_matches_reference(name):
    """Same keys and shapes as the JAX schema, on `meta`: hubert has
    cls_head (d, padded vocab 512) and no lm_head, pixtral an untied
    lm_head; the count is n_params() + padding_delta()."""
    cfg, jcfg = get_config(name), JAX_ARCHS[name]
    jleaves = {jax.tree_util.keystr(path): p.shape for path, p in
               jax.tree_util.tree_flatten_with_path(
                   jax_schema.model_schema(jcfg),
                   is_leaf=lambda x: isinstance(x, jax_schema.Param))[0]}
    abstract = lm.abstract_params(cfg)
    mine = {jax.tree_util.keystr(path): tuple(t.shape) for path, t in
            jax.tree_util.tree_flatten_with_path(abstract)[0]}
    assert mine == jleaves
    if name == "hubert-xlarge":
        assert "lm_head" not in abstract and abstract["cls_head"].shape == (1280, 512)
    else:
        assert "cls_head" not in abstract and abstract["lm_head"].shape == (5120, 131072)
    n = sum(t.numel() for t in leaves(abstract))
    assert n == cfg.n_params() + cfg.padding_delta() == FULL_PARAMS[name]


@pytest.mark.parametrize("name", NAMES)
def test_bridge_carries_the_reference_tree(name):
    """The JAX package's own init of the reduced model, through numpy: the
    port's keys, shapes and dtypes, the values unchanged, and the port's
    forward from embeddings on it agrees with jax's."""
    cfg, jcfg = get_config(name).reduced(), JAX_ARCHS[name].reduced()
    jparams = jax_schema.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    abstract = lm.abstract_params(cfg, torch.float32)
    assert paths(params) == paths(abstract)
    for mine, want, ref in zip(leaves(params), leaves(abstract), jax.tree.leaves(jparams)):
        assert mine.shape == want.shape and mine.dtype == want.dtype
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    emb = _embeds(cfg.d_model, 0, seq=5)
    jx, _ = jax_lm.forward(jparams, jcfg, embeds=jnp.asarray(emb), mode="train", remat="none")
    with torch.no_grad():
        x, _ = lm.forward(params, cfg, embeds=torch.from_numpy(emb), mode="train")
    _close(x.numpy(), jx)


def test_ungated_gelu_matches_jax():
    """The ungated MLP's tanh-approximated GELU, jax.nn.gelu's default,
    against the JAX package's _act; torch's default (erf) GELU differs by
    more than f32 rounding."""
    u = (3 * np.random.default_rng(0).standard_normal((3, 5, 7))).astype(np.float32)
    mine = layers._act("gelu", None, torch.from_numpy(u)).numpy()
    want = np.asarray(jax_layers._act("gelu", None, u))
    np.testing.assert_allclose(mine, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(want, np.asarray(jax.nn.gelu(u)), rtol=0, atol=0)
    erf = torch.nn.functional.gelu(torch.from_numpy(u)).numpy()
    assert np.abs(erf - want).max() > 1e-4


def _model(name, seed):
    """(jax cfg, jax params, port cfg, port params) of name reduced."""
    cfg, jcfg = get_config(name).reduced(), JAX_ARCHS[name].reduced()
    params = lm.init_params(cfg, torch.Generator().manual_seed(seed), torch.float32, "cpu")
    return jcfg, jax.tree.map(jnp.asarray, _to_numpy(params)), cfg, params


@pytest.fixture(scope="module")
def hubert():
    return _model("hubert-xlarge", 1)


def test_hubert_forward_and_loss_match_jax(hubert):
    """The bidirectional forward from frame embeddings (every position reads
    the frames after it too) and loss_fn through cls_head."""
    jcfg, jparams, cfg, params = hubert
    emb = _embeds(cfg.d_model, 3)
    labels = np.random.default_rng(4).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jx, _ = jax_lm.forward(jparams, jcfg, embeds=jnp.asarray(emb), mode="train", remat="none")
    jloss, jaux = jax_lm.loss_fn(jparams, jcfg, {"embeds": jnp.asarray(emb),
                                                 "labels": jnp.asarray(labels)},
                                 remat="none", ce_chunk=8)
    with torch.no_grad():
        x, cache = lm.forward(params, cfg, embeds=torch.from_numpy(emb), mode="train")
        loss, aux = lm.loss_fn(params, cfg, {"embeds": torch.from_numpy(emb),
                                             "labels": torch.from_numpy(labels).long()},
                               remat="none", ce_chunk=8)
        late = emb.copy()
        late[:, -1] += 1.0  # the last frame moves the first position's output
        x_late, _ = lm.forward(params, cfg, embeds=torch.from_numpy(late), mode="train")
    assert cache is None
    _close(x.numpy(), jx)
    _close(loss.item(), float(jloss))
    assert int(aux["tokens"]) == int(jaux["tokens"]) == B * S
    assert not torch.allclose(x_late[:, 0], x[:, 0])


def test_hubert_prefill_gives_frame_logits(hubert):
    """The encoder-only prefill: f32 frame logits (B, S, padded vocab) and
    no cache, on both sides; init_cache gives None and make_prefill_step
    and encode() take it; generate() refuses an encoder-only model."""
    jcfg, jparams, cfg, params = hubert
    emb = _embeds(cfg.d_model, 5)
    jlogits, jcache = jax_lm.prefill(jparams, jcfg, None, embeds=jnp.asarray(emb))
    assert lm.init_cache(cfg, B, 64, torch.float32, "cpu") is None
    with torch.no_grad():
        logits, cache = make_prefill_step(cfg)(params, None, {"embeds": torch.from_numpy(emb)})
        enc = encode(params, cfg, torch.from_numpy(emb))
    assert jcache is None and cache is None
    assert logits.shape == (B, S, cfg.padded_vocab) == jlogits.shape
    assert logits.dtype == torch.float32
    _close(logits.numpy(), jlogits)
    assert torch.equal(enc.logits, logits) and enc.prefill_s >= 0
    np.testing.assert_array_equal(enc.labels.numpy(), np.asarray(jnp.argmax(jlogits, -1)))
    with pytest.raises(ValueError, match="encoder-only"):
        generate(params, cfg, None, 4, cache_dtype=torch.float32, embeds=torch.from_numpy(emb))


def test_pixtral_prefill_from_embeddings_and_greedy_decode_match_jax():
    """A prompt of patch embeddings: prefill logits and KV cache, then 8
    greedy decode steps on tokens, logits and tokens; generate() with
    embeds= gives the same tokens."""
    jcfg, jparams, cfg, params = _model("pixtral-12b", 1)
    emb = _embeds(cfg.d_model, 6)
    jcache = jax_lm.init_cache(jcfg, B, 64, jnp.float32)
    jlogits, jcache = jax_lm.prefill(jparams, jcfg, jcache, embeds=jnp.asarray(emb))
    cache = lm.init_cache(cfg, B, 64, torch.float32, "cpu")
    with torch.no_grad():
        logits, cache = lm.prefill(params, cfg, cache, embeds=torch.from_numpy(emb))
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
    with torch.no_grad():
        gen = generate(params, cfg, None, DECODE_STEPS + 1, cache_dtype=torch.float32,
                       embeds=torch.from_numpy(emb))
    np.testing.assert_array_equal(gen.tokens.numpy(), np.concatenate(toks, 1))


@pytest.fixture(scope="module")
def jax_step(models):
    """One JAX train step of the module's model on a batch of embeddings and
    the dataset's labels (jax.checkpoint changes no value, so the port's
    remat modes share it)."""
    jcfg, jparams, cfg, _ = models
    batch = {"embeds": _embeds(cfg.d_model, 7, seq=16),
             "labels": JaxDataset(jcfg.vocab, 16, seed=0).batch(0, B)["labels"]}
    jstep = jax.jit(jax_make_train_step(jcfg, remat="none", **STEP_KW))
    return batch, jstep(jax_init_train_state(jparams), jax.tree.map(jnp.asarray, batch))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_on_embeddings_matches_reference(models, jax_step, remat):
    """Loss, grad_norm and every leaf of the state after one step; the
    embed leaf, which the loss never reads, gets a zero gradient on both
    sides: its mu and nu stay 0 and its master is (1 - lr wd) embed."""
    jcfg, jparams, cfg, _ = models
    batch, (jstate, jm) = jax_step
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    embed0 = params["embed"].clone()
    state, m = make_train_step(cfg, remat=remat, **STEP_KW)(
        init_train_state(params), {"embeds": torch.from_numpy(batch["embeds"]),
                                   "labels": torch.from_numpy(batch["labels"]).long()})
    assert int(m["tokens"]) == int(jm["tokens"]) == B * 16
    _close(m["loss"].item(), float(jm["loss"]))
    _close(m["grad_norm"].item(), float(jm["grad_norm"]))
    for path, mine, theirs in zip(paths(state), leaves(state), jax.tree.leaves(jstate)):
        assert tuple(mine.shape) == theirs.shape, path
        _close(mine.detach().numpy(), theirs)
    lr = cosine_schedule(STEP_KW["lr"], STEP_KW["warmup"], STEP_KW["total"])(
        torch.tensor(1)).item()
    decayed = (1 - lr * STEP_KW["weight_decay"]) * embed0
    torch.testing.assert_close(state["master"]["embed"], decayed, rtol=1e-6, atol=0)
    _close(np.asarray(jstate["master"]["embed"]), decayed.numpy(), tol=1e-6)
    assert torch.all(state["mu"]["embed"] == 0) and torch.all(state["nu"]["embed"] == 0)


@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_gives_the_unread_embed_a_zero_gradient(microbatch):
    """In either path of the step (one batch, or microbatches): the unread
    leaf counts in the global norm as 0 and is decayed, with no error from
    autograd."""
    cfg = get_config("pixtral-12b").reduced()
    params = lm.init_params(cfg, torch.Generator().manual_seed(2), torch.float32, "cpu")
    embed0 = params["embed"].clone()
    batch = {"embeds": torch.from_numpy(_embeds(cfg.d_model, 8, seq=8)),
             "labels": torch.randint(0, cfg.vocab, (B, 8), generator=torch.Generator()
                                     .manual_seed(3))}
    state, m = make_train_step(cfg, remat="none", microbatch=microbatch, **STEP_KW)(
        init_train_state(params), batch)
    assert torch.isfinite(m["grad_norm"]) and m["grad_norm"] > 0
    assert torch.all(state["mu"]["embed"] == 0)
    assert torch.all(state["master"]["embed"].abs() < embed0.abs() + 1e-12)
    assert not torch.equal(state["master"]["embed"], embed0)


def test_pseudo_embeds_depend_on_seed_and_step_only():
    """0.02 N(0, 1) in the asked dtype, the same for the same (seed, step),
    another for another step or seed."""
    def draw(seed, step, dtype=torch.float32):
        return pseudo_embeds(2, 64, 32, seed=seed, step=step, dtype=dtype, device="cpu")
    a = draw(0, 3)
    assert a.shape == (2, 64, 32) and a.dtype == torch.float32
    assert torch.equal(a, draw(0, 3))
    assert not torch.equal(a, draw(0, 4)) and not torch.equal(a, draw(1, 3))
    assert abs(a.std().item() / 0.02 - 1) < 0.1
    assert torch.equal(draw(0, 3, torch.bfloat16), a.to(torch.bfloat16))


@pytest.mark.parametrize("argv, first", [
    (["serve", "--arch", "hubert-xlarge"], "[serve] encoded 4x24 frames in "),
    (["serve", "--arch", "pixtral-12b"], "[serve] prefill 4x24 in "),
    (["launch.train", "--arch", "hubert-xlarge", "--steps", "2", "--batch", "2", "--seq", "16",
      "--remat", "full", "--log-every", "1"], "[train] arch=hubert-xlarge params="),
    (["launch.train", "--arch", "pixtral-12b", "--steps", "2", "--batch", "2", "--seq", "16",
      "--log-every", "1"], "[train] arch=pixtral-12b params=")])
def test_cli_runs_with_jax_and_repro_blocked(argv, first):
    """The serve and train entry points at the reduced width on the CPU,
    with jax and the JAX package unimportable."""
    module, args = argv[0], argv[1:] + ["--reduced", "--device", "cpu"]
    code = ("import sys; sys.modules.update(dict.fromkeys(('jax', 'jaxlib', 'repro'))); "
            f"import repro_torch.{module} as entry; sys.exit(entry.main({args!r}))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout.splitlines()
    assert out[0].startswith(first)
    if module == "launch.train":
        assert sum(line.startswith("[train] step ") for line in out) == 2


def test_train_driver_resumes_with_the_same_embeddings(tmp_path):
    """A run of 2 steps, then a resume to 4, ends where a straight run of 4
    does: the pseudo-embeddings come from (seed, step)."""
    from repro_torch.launch import train as driver
    common = ["--arch", "pixtral-12b", "--reduced", "--device", "cpu", "--batch", "2",
              "--seq", "8", "--log-every", "100", "--seed", "3"]
    driver.main(common + ["--steps", "2", "--ckpt-dir", str(tmp_path / "a")])
    driver.main(common + ["--steps", "4", "--ckpt-dir", str(tmp_path / "a")])
    driver.main(common + ["--steps", "4", "--ckpt-dir", str(tmp_path / "b")])
    from repro_torch.checkpoint import CheckpointManager
    cfg = get_config("pixtral-12b").reduced()
    like = init_train_state(lm.init_params(cfg, torch.Generator().manual_seed(0),
                                           torch.float32, "cpu"))
    a = CheckpointManager(str(tmp_path / "a")).restore(like)
    b = CheckpointManager(str(tmp_path / "b")).restore(
        init_train_state(lm.init_params(cfg, torch.Generator().manual_seed(0),
                                        torch.float32, "cpu")))
    assert int(a["step"]) == int(b["step"]) == 4
    for x, y in zip(leaves(a["master"]), leaves(b["master"])):
        assert torch.equal(x, y)


# Twins of tests/test_models.py's smoke tests, on the port, over the ten
# architectures of the JAX package's registry.
ARCH_NAMES = sorted(JAX_ARCHS)


def _batch(cfg, seed, S=32):
    g = torch.Generator().manual_seed(seed)
    labels = torch.randint(0, cfg.vocab, (2, S), generator=g)
    if cfg.frontend:
        return {"embeds": 0.02 * torch.randn((2, S, cfg.d_model), generator=g),
                "labels": labels}
    return {"tokens": torch.randint(0, cfg.vocab, (2, S), generator=g), "labels": labels}


def test_the_port_registers_the_ten_architectures():
    assert sorted(ARCHS) == ARCH_NAMES


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_smoke_forward_loss(name):
    cfg = get_config(name).reduced()
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    batch = _batch(cfg, 1)
    with torch.no_grad():
        loss, aux = lm.loss_fn(params, cfg, batch)
    assert loss.shape == ()
    assert torch.isfinite(loss), f"{name}: non-finite loss"
    assert int(aux["tokens"]) == batch["labels"].numel()


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_smoke_train_step_no_nans(name):
    cfg = get_config(name).reduced()
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    step = make_train_step(cfg, lr=1e-3, remat="none", ce_chunk=16)
    state, metrics = step(init_train_state(params), _batch(cfg, 2))
    assert torch.isfinite(metrics["loss"])
    assert torch.isfinite(metrics["grad_norm"])
    for leaf in leaves(state["params"]):
        assert torch.all(torch.isfinite(leaf))
