"""The port's MoE layer and the two MoE models, qwen2-moe-a2.7b and
qwen3-moe-30b-a3b, against the JAX package's, on the CPU, in f32.

``moe_block`` is held to the reference at capacity factors 1.25 (copies
dropped), 4.0 (none dropped) and 0.1 (most dropped) within 1e-5, as
tests/test_moe.py holds the reference to its dense oracle; the router's
gates and expert ids equal the reference's, ties included (the lower expert
index first, as ``lax.top_k``); prefill and greedy decode of each model
within 2e-4 with identical tokens, as tests/test_torch_lm.py holds
qwen3-1.7b.  Each side runs the same weights: the port initialises each
reduced config from a seed, and the same numbers go to the JAX package
through numpy.
"""
import ast
import dataclasses
import inspect
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
from repro.models import lm as jax_lm
from repro.models import moe as jax_moe
from repro.models import schema as jax_schema
from repro_torch.configs import get_config
from repro_torch.models import lm, moe, schema
from repro_torch.models.layers import rms_norm
from repro_torch.tree import leaves, paths

ROOT = Path(__file__).resolve().parent.parent
NAMES = ("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b")
SOURCES = {"qwen2-moe-a2.7b": "[hf:Qwen/Qwen1.5-MoE-A2.7B config.json; hf]",
           "qwen3-moe-30b-a3b": "[hf:Qwen/Qwen3-30B-A3B config.json; hf]"}
# parameters at full width, padded experts included (n_params() + padding_delta())
FULL_PARAMS = {"qwen2-moe-a2.7b": 15_146_305_536, "qwen3-moe-30b-a3b": 30_532_122_624}
BLOCK_TOL = 1e-5
TOL = 2e-4
B, S, DECODE_STEPS = 2, 17, 8


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=tol, rtol=tol)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _configs(name, capacity_factor=None):
    cfg, jcfg = get_config(name).reduced(), JAX_ARCHS[name].reduced()
    if capacity_factor is not None:
        cfg, jcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor)) for c in (cfg, jcfg))
    return cfg, jcfg


@pytest.fixture(scope="module", params=NAMES)
def models(request):
    """(jax cfg, jax params, port cfg, port params): the port's seeded init of
    the reduced config, carried to jax."""
    cfg, jcfg = _configs(request.param)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    return jcfg, jax.tree.map(jnp.asarray, _to_numpy(params)), cfg, params


def _block(params):
    """Layer 0 of the stacked blocks."""
    return {k: v[0] for k, v in params["blocks"].items()}


@pytest.mark.parametrize("name", NAMES)
def test_config_matches_reference(name):
    full, jfull = get_config(name), JAX_ARCHS[name]
    for cfg, jcfg in ((full, jfull), (full.reduced(), jfull.reduced())):
        mine, theirs = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
        assert mine.pop("source") == SOURCES[name]
        theirs.pop("source")
        assert mine == theirs
        assert (cfg.padded_experts, cfg.padded_heads, cfg.n_active_params()) == \
            (jcfg.padded_experts, jcfg.padded_heads, jcfg.n_active_params())
        assert (cfg.n_params(), cfg.padding_delta()) == (jcfg.n_params(), jcfg.padding_delta())


@pytest.mark.parametrize("name", NAMES)
def test_schema_at_full_width_matches_reference(name):
    """Same keys and shapes as the JAX schema, on `meta`: the f32 router over
    the padded experts, the stacked experts, the shared experts and their
    gate where the config has them; the count is n_params() + padding_delta()."""
    cfg, jcfg = get_config(name), JAX_ARCHS[name]
    jleaves = {jax.tree_util.keystr(path): p.shape for path, p in
               jax.tree_util.tree_flatten_with_path(
                   jax_schema.model_schema(jcfg),
                   is_leaf=lambda x: isinstance(x, jax_schema.Param))[0]}
    abstract = lm.abstract_params(cfg)
    mine = {jax.tree_util.keystr(path): tuple(t.shape) for path, t in
            jax.tree_util.tree_flatten_with_path(abstract)[0]}
    assert mine == jleaves
    blocks = abstract["blocks"]
    assert blocks["router"].dtype == torch.float32 and blocks["we_u"].dtype == torch.bfloat16
    assert blocks["router"].shape[-1] == cfg.padded_experts
    assert ("sh_gate" in blocks) == bool(cfg.moe.n_shared) and "mlp_wu" not in blocks
    n = sum(t.numel() for t in leaves(abstract))
    assert n == cfg.n_params() + cfg.padding_delta() == FULL_PARAMS[name]


def _x(cfg, shape, seed=1, scale=0.5, shared=0.0):
    """N(0, scale^2) inputs, plus a direction that every token shares with
    weight ``shared``, which makes the router favour some experts."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape + (cfg.d_model,)) * scale
    return (x + shared * rng.standard_normal(cfg.d_model)).astype(np.float32)


def _dropped(cfg, p, x):
    """Copies past their expert's capacity in a moe_block call on x."""
    _, idx, _ = moe._router(rms_norm(torch.from_numpy(x), p["ln2"]), p, cfg.moe)
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.padded_experts)
    C = moe._capacity(cfg.moe, x.shape[0] * x.shape[1])
    return int(torch.clamp_min(counts - C, 0).sum())


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("capacity_factor, shape", [(1.25, (4, 32)), (4.0, (2, 16)),
                                                    (0.1, (2, 16)), (1.25, (2, 1))])
def test_moe_block_matches_jax(name, capacity_factor, shape):
    """At 1.25 over 128 tokens that share a direction some copies are
    dropped, at 4.0 none, at 0.1 most; (2, 1) is a decode step's call (T =
    2, C = 4)."""
    cfg, jcfg = _configs(name, capacity_factor)
    params = lm.init_params(cfg, torch.Generator().manual_seed(7), torch.float32, "cpu")
    p = _block(params)
    x = _x(cfg, shape, shared=1.0)
    dropped = _dropped(cfg, p, x)
    T = shape[0] * shape[1]
    if shape == (2, 1):
        assert moe._capacity(cfg.moe, T) == 4 and dropped == 0
    else:
        assert (dropped > 0) == (capacity_factor != 4.0), dropped
    want = jax_moe.moe_block(jax.tree.map(jnp.asarray, _to_numpy(p)), jnp.asarray(x), cfg=jcfg)
    with torch.no_grad():
        got = moe.moe_block(p, torch.from_numpy(x), cfg=cfg)
    _close(got.numpy(), want, BLOCK_TOL)
    if dropped == 0:  # nothing dropped: the dense oracle's numbers
        _close(got.numpy(), moe.moe_block_dense_reference(p, torch.from_numpy(x), cfg=cfg),
               BLOCK_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_capacity_is_the_references_arithmetic(name):
    """C = max(4, ceil(cf T k / n_experts)) at the full widths' prefill (T =
    8192: 1.25 x 8192 x 4 / 60 = 682.7 and 1.25 x 8192 x 8 / 128 = 640) and
    decode (T = 8) of the card's serve."""
    moe_cfg = get_config(name).moe
    want = {"qwen2-moe-a2.7b": (683, 4), "qwen3-moe-30b-a3b": (640, 4)}[name]
    assert (moe._capacity(moe_cfg, 8 * 1024), moe._capacity(moe_cfg, 8)) == want


def _router_case(cfg, case):
    """A block's params with the router of ``case``: as drawn; with column 1
    a copy of column 0 (every token ties there); or zero (all real experts
    tie)."""
    params = lm.init_params(cfg, torch.Generator().manual_seed(3), torch.float32, "cpu")
    p = _block(params)
    if case == "tied columns":
        p["router"][:, 1] = p["router"][:, 0]
    elif case == "zero":
        p["router"].zero_()
    return p


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", ["drawn", "tied columns", "zero"])
def test_router_matches_jax_with_ties(name, case):
    """Gates, expert ids (in order) and probabilities equal the reference's;
    on a tie the lower expert id comes first; a padded expert is never
    chosen and has probability exactly 0."""
    cfg, jcfg = _configs(name)
    p = _router_case(cfg, case)
    y = _x(cfg, (2, 16), seed=4, scale=1.0)
    jg, jidx, jprobs = jax_moe._router(jnp.asarray(y), {"router": jnp.asarray(
        p["router"].numpy())}, jcfg.moe)
    gates, idx, probs = moe._router(torch.from_numpy(y), p, cfg.moe)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(gates.numpy(), jg, 1e-6)
    _close(probs.numpy(), jprobs, 1e-6)
    assert int(idx.max()) < cfg.moe.n_experts
    assert torch.all(probs[..., cfg.moe.n_experts:] == 0)
    if case == "tied columns":  # where 0 and 1 are both chosen, 0 comes first
        both = ((idx == 0).any(-1) & (idx == 1).any(-1))
        assert both.any()
        first = torch.argmax((idx == 0).int(), -1) < torch.argmax((idx == 1).int(), -1)
        assert torch.all(first[both])
    if case == "zero":
        assert torch.all(idx == torch.arange(cfg.moe.top_k))


def test_combine_adds_no_atomics():
    """The combine sums each token's copies by a loop over k, in ascending
    expert order: no index_add, scatter-add or accumulating put, whose order
    on CUDA changes from run to run."""
    tree = ast.parse(inspect.getsource(moe))
    names = {n.attr if isinstance(n, ast.Attribute) else n.id for n in ast.walk(tree)
             if isinstance(n, (ast.Attribute, ast.Name))}
    assert not names & {"index_add", "index_add_", "scatter_add", "scatter_add_",
                        "scatter_reduce", "scatter_reduce_", "put_", "index_put_"}
    assert not any(isinstance(n, ast.keyword) and n.arg == "accumulate" for n in ast.walk(tree))


def test_moe_block_is_deterministic_in_bf16():
    cfg, _ = _configs("qwen3-moe-30b-a3b", 1.25)
    params = lm.init_params(cfg, torch.Generator().manual_seed(7), torch.bfloat16, "cpu")
    x = torch.from_numpy(_x(cfg, (4, 32))).to(torch.bfloat16)
    a, b = (moe.moe_block(_block(params), x, cfg=cfg) for _ in range(2))
    assert torch.equal(a, b)


def test_forward_hidden_matches_jax(models):
    jcfg, jparams, cfg, params = models
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jx, _ = jax_lm.forward(jparams, jcfg, tokens=jnp.asarray(tokens), mode="train",
                           remat="none")
    with torch.no_grad():
        x, _ = lm.forward(params, cfg, tokens=torch.from_numpy(tokens).long(), mode="train")
    _close(x.numpy(), jx)


def test_prefill_and_greedy_decode_match_jax(models):
    """Prefill logits and cache, 8 greedy decode steps of logits (each a
    decode-sized MoE call), and the tokens."""
    jcfg, jparams, cfg, params = models
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (B, S)).astype(np.int32)
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


def test_init_draws_each_leaf_in_its_dtype(monkeypatch):
    """No f32 temporary: each normal or fan-in leaf is drawn by normal_
    straight into its dtype (bf16 here), never by randn; the experts'
    weights keep their fan-in distribution (std 1/sqrt(D) for we_u,
    1/sqrt(f) for we_o), each layer drawn anew; the router stays f32.  In
    f32 the draws are those of randn times the std, leaf by leaf in the
    schema's order."""
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(), n_layers=4)
    f32 = lm.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    g = torch.Generator().manual_seed(0)

    def old_draw(p):
        if p.init == "zeros":
            return torch.zeros(p.shape)
        std = p.scale if p.init == "normal" else p.scale / schema._fan_in(p) ** 0.5
        return torch.randn(p.shape, generator=g) * std
    for path, mine, want in zip(paths(f32), leaves(f32),
                                leaves(schema.map_schema(schema.model_schema(cfg), old_draw))):
        assert torch.equal(mine, want), path
    monkeypatch.setattr(torch, "randn", lambda *a, **k: pytest.fail("an f32 temporary"))
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), torch.bfloat16, "cpu")
    blocks = params["blocks"]
    we_u, we_o = blocks["we_u"], blocks["we_o"]
    E, D, f = cfg.padded_experts, cfg.d_model, cfg.moe.d_expert
    assert we_u.shape == (4, E, D, f) and we_u.dtype == torch.bfloat16
    assert abs(we_u.float().std().item() * D ** 0.5 - 1.0) < 0.05
    assert abs(we_o.float().std().item() * f ** 0.5 - 1.0) < 0.05
    assert abs(we_u.float().mean().item()) < 0.01
    assert not torch.equal(we_u[0], we_u[1])
    assert blocks["router"].dtype == torch.float32 and blocks["router"].shape == (4, D, E)
    assert torch.all(blocks["ln2"] == 0)


@pytest.mark.parametrize("name", NAMES)
def test_serve_cli_runs_with_jax_and_repro_blocked(name):
    args = ["--arch", name, "--reduced", "--device", "cpu"]
    code = ("import sys; sys.modules.update(dict.fromkeys(('jax', 'jaxlib', 'repro'))); "
            f"from repro_torch import serve; serve.main({args!r})")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("[serve] prefill 4x24 in ")
    assert lines[2].startswith("[serve] sample: [")
