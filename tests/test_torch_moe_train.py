"""Training through the port's MoE layer: qwen2-moe-a2.7b and
qwen3-moe-30b-a3b against the JAX package, on the CPU, in f32.

``moe_block``'s output and the gradient of every parameter and of x
against ``jax.vjp`` of the reference within 1e-5, as tests/test_moe.py
holds the reference's block, with and without capacity drops.  A token
whose k-th and (k+1)-th router probabilities nearly tie could go to another
expert on either side and move its row by O(1), where the two frameworks'
f32 sums differ by rounding: every input asserts a gap of at least GAP
there, so a swapped expert cannot pass as rounding.  Then one ``.reduced()``
train step of each model (remat "full", the MoE layer inside each
checkpointed group) against the reference's ``loss_fn`` under ``jax.grad``
and its train step: loss, every gradient and the AdamW state after the
step within 2e-4, as tests/test_torch_train.py holds the dense models, but
for the few master elements whose gradient is within NEAR_EPS eps (below).
The port's loss is the cross-entropy alone: no auxiliary (load-balancing)
term, as the reference adds none.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.data import SyntheticLMDataset as JaxDataset
from repro.models import lm as jax_lm
from repro.models import moe as jax_moe
from repro.models.layers import chunked_ce_loss as jax_chunked_ce
from repro.optim import init_train_state as jax_init_train_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import attention, lm, moe, schema
from repro_torch.models.layers import chunked_ce_loss, rms_norm
from repro_torch.optim import cosine_schedule, init_train_state
from repro_torch.train import make_train_step
from repro_torch.tree import leaves, paths

NAMES = ("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b")
BLOCK_TOL = 1e-5
TOL = 2e-4
# The least gap between a token's k-th and (k+1)-th router probability
# that the inputs must show: f32 rounding moves a probability by about
# 1e-7 between the frameworks, a hundredth of this.
GAP = 1e-5
STEP_KW = dict(lr=1e-2, warmup=2, total=10, ce_chunk=8)
# The first AdamW step moves a master element by lr u, u = x / (|x| + eps)
# (x the clipped gradient), so a gradient difference dx moves it by about
# lr eps dx / (|x| + eps)^2 between the sides.  Where either side's |x| is
# under NEAR_EPS eps (and x is not 0 on both), that is at most lr dx / (121
# eps), and an element there carries its gradient's own relative error
# into the master (ROADMAP C4): such elements are held to what the two
# sides' own steps make of them instead of at TOL, and counted (EXEMPT, of
# each model's master after the step at this seed).  Above it the same dx
# moves the master by at most lr dx / (121 eps): 4e-6 at the 1e-9 seen
# here, 50 times under TOL.
ADAM_EPS = 1e-8
NEAR_EPS = 10
EXEMPT = {"qwen2-moe-a2.7b": 8, "qwen3-moe-30b-a3b": 4}


def _close(a, b, tol):
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


def _x(cfg, shape, seed, shared):
    """N(0, 1/4) inputs plus a direction every token shares with weight
    ``shared``, which makes the router favour some experts (and drop
    copies at capacity factor 1.25)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape + (cfg.d_model,)) * 0.5
    return (x + shared * rng.standard_normal(cfg.d_model)).astype(np.float32)


def _least_gap(probs, top_k):
    """The least gap over the tokens between the k-th and (k+1)-th router
    probability."""
    top = torch.topk(probs.reshape(-1, probs.shape[-1]).double(), top_k + 1, dim=-1).values
    return (top[:, top_k - 1] - top[:, top_k]).min().item()


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("capacity_factor, shape, seed, shared", [(1.25, (4, 32), 1, 1.0),
                                                                  (4.0, (2, 16), 2, 0.0)])
def test_moe_block_gradients_match_jax(name, capacity_factor, shape, seed, shared):
    """Output, and the gradient of every parameter (router, experts, shared
    experts and their gate where the config has them, ln2) and of x on one
    cotangent, against jax.vjp; at 1.25 some copies are dropped, at 4.0
    none."""
    cfg, jcfg = _configs(name, capacity_factor)
    params = lm.init_params(cfg, torch.Generator().manual_seed(7), torch.float32, "cpu")
    g = torch.Generator().manual_seed(8)
    p = {k: params["blocks"][k][0] for k in schema._moe_schema(cfg)}
    # ln2 drawn away from zero, so its gradient is not the only thing tested at 1
    p["ln2"] = 0.1 * torch.randn(p["ln2"].shape, generator=g)
    x = _x(cfg, shape, seed, shared)
    _, idx, probs = moe._router(rms_norm(torch.from_numpy(x), p["ln2"]), p, cfg.moe)
    assert _least_gap(probs, cfg.moe.top_k) > GAP
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.padded_experts)
    dropped = int(torch.clamp_min(counts - moe._capacity(cfg.moe, idx.shape[0] * idx.shape[1]),
                                  0).sum())
    assert (dropped > 0) == (capacity_factor == 1.25), dropped
    cot = np.random.default_rng(seed + 10).standard_normal(x.shape).astype(np.float32)

    names = sorted(p)
    _, vjp = jax.vjp(lambda pp, xx: jax_moe.moe_block(pp, xx, cfg=jcfg),
                     {k: jnp.asarray(p[k].numpy()) for k in names}, jnp.asarray(x))
    want_out = jax_moe.moe_block({k: jnp.asarray(p[k].numpy()) for k in names},
                                 jnp.asarray(x), cfg=jcfg)
    jgrads, jdx = vjp(jnp.asarray(cot))

    tp = {k: p[k].clone().requires_grad_(True) for k in names}
    tx = torch.from_numpy(x).requires_grad_(True)
    out = moe.moe_block(tp, tx, cfg=cfg)
    _close(out.detach().numpy(), want_out, BLOCK_TOL)
    grads = torch.autograd.grad(out, [*tp.values(), tx], torch.from_numpy(cot))
    for key, mine in zip([*names, "x"], grads):
        want = jdx if key == "x" else jgrads[key]
        assert tuple(mine.shape) == want.shape, key
        assert np.any(np.asarray(want) != 0), key
        _close(mine.numpy(), want, BLOCK_TOL)


def _record_router(monkeypatch):
    """The probabilities of each call the MoE layer makes to its router."""
    calls = []
    router = moe._router

    def recording(y, p, moe_cfg):
        out = router(y, p, moe_cfg)
        calls.append(out[2].detach())
        return out
    monkeypatch.setattr(moe, "_router", recording)
    return calls


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    """(jax cfg, jax params, port cfg, a batch of 4 x 16 tokens): the port's
    seeded init of the reduced config, carried to jax."""
    cfg, jcfg = _configs(request.param)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    batch = JaxDataset(jcfg.vocab, 16, seed=0).batch(0, 4)
    return jcfg, jax.tree.map(jnp.asarray, _to_numpy(params)), cfg, batch


def _port(jparams):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long() for k, v in batch.items()}


def test_loss_gradients_match_jax(model, monkeypatch):
    """loss_fn with remat "full" (the MoE layer recomputed in each
    checkpointed group) under torch autograd against jax.grad of the
    reference's loss_fn: the loss and every gradient.  Every router call
    (the forward's and the recomputations') shows the gap."""
    jcfg, jparams, cfg, batch = model
    (jl, _), jg = jax.value_and_grad(
        lambda p: jax_lm.loss_fn(p, jcfg, jax.tree.map(jnp.asarray, batch), remat="none",
                                 ce_chunk=8), has_aux=True)(jparams)
    calls = _record_router(monkeypatch)
    params = _port(jparams)
    weights = leaves(params)
    for w in weights:
        w.requires_grad_(True)
    loss, _ = lm.loss_fn(params, cfg, _torch_batch(batch), remat="full", ce_chunk=8)
    grads = torch.autograd.grad(loss, weights)
    assert cfg.n_layers == 2 and len(calls) == 5  # 3 L - L / k, one group of k = 2 layers
    assert min(_least_gap(p, cfg.moe.top_k) for p in calls) > GAP
    _close(loss.item(), float(jl), TOL)
    for path, mine, theirs in zip(paths(params), grads, jax.tree.leaves(jg)):
        assert tuple(mine.shape) == theirs.shape, path
        _close(mine.numpy(), theirs, TOL)


def _first_step_gradients(mu, b1=0.9):
    """Each leaf's clipped gradient x as the first AdamW step's moment mu =
    (1 - b1) x gives it, in float64."""
    return [np.asarray(m, np.float64) / (1 - b1) for m in mu]


def _first_step_directions(mu, nu, b1=0.9, b2=0.95, eps=ADAM_EPS):
    """Each leaf's direction u = x / (|x| + eps) of the first AdamW step (x
    the clipped gradient), as the step formed it from its moments mu = (1 -
    b1) x and nu = (1 - b2) x^2, in float64."""
    return [(np.asarray(m, np.float64) / (1 - b1))
            / (np.sqrt(np.asarray(n, np.float64) / (1 - b2)) + eps) for m, n in zip(mu, nu)]


def test_train_step_matches_jax(model):
    """One make_train_step step (remat "full") against the reference's
    train step: loss, grad_norm, mu and nu within 2e-4; the f32 master
    (and the params, its copy) after the first AdamW step within 2e-4 at
    every element but those whose clipped gradient x is within NEAR_EPS
    eps on either side (and not 0 on both).  Those, EXEMPT of them in each
    model's master, are held to what the two sides' own steps make of
    them: m0 - lr (u + wd m0) with u = x / (|x| + eps), so m_port - m_jax =
    lr (u_jax - u_port) to f32 rounding, u from each side's moments (ROADMAP
    C4: 1 of qwen2-moe's 65536 expert weights here, x 0.2 eps, moves by 2 %
    of itself)."""
    jcfg, jparams, cfg, batch = model
    jstate, jm = jax.jit(jax_make_train_step(jcfg, remat="none", **STEP_KW))(
        jax_init_train_state(jparams), jax.tree.map(jnp.asarray, batch))
    m0 = _port(jparams)
    state, m = make_train_step(cfg, remat="full", **STEP_KW)(init_train_state(_port(jparams)),
                                                            _torch_batch(batch))
    _close(m["loss"].item(), float(jm["loss"]), TOL)
    _close(m["grad_norm"].item(), float(jm["grad_norm"]), TOL)
    assert int(state["step"]) == int(jstate["step"]) == 1
    assert int(m["tokens"]) == int(jm["tokens"]) == 64
    for part in ("mu", "nu"):
        for path, mine, theirs in zip(paths(state[part]), leaves(state[part]),
                                      jax.tree.leaves(jstate[part])):
            assert tuple(mine.shape) == theirs.shape, path
            _close(mine.numpy(), theirs, TOL)
    lr = cosine_schedule(STEP_KW["lr"], STEP_KW["warmup"], STEP_KW["total"])(
        torch.tensor(1)).item()
    x_port = _first_step_gradients(leaves(state["mu"]))
    x_jax = _first_step_gradients(jax.tree.leaves(jstate["mu"]))
    u_port = _first_step_directions(leaves(state["mu"]), leaves(state["nu"]))
    u_jax = _first_step_directions(jax.tree.leaves(jstate["mu"]), jax.tree.leaves(jstate["nu"]))
    exempt = {}
    for part in ("master", "params"):
        exempt[part] = 0
        for i, (path, mine, theirs, start) in enumerate(zip(
                paths(state[part]), leaves(state[part]), jax.tree.leaves(jstate[part]),
                leaves(m0))):
            mine, theirs = mine.detach().numpy().astype(np.float64), np.asarray(theirs, np.float64)
            assert mine.shape == theirs.shape, path
            assert not np.array_equal(mine, start.numpy()), path
            near = ((np.minimum(np.abs(x_port[i]), np.abs(x_jax[i])) < NEAR_EPS * ADAM_EPS)
                    & (np.maximum(np.abs(x_port[i]), np.abs(x_jax[i])) > 0))
            _close(mine[~near], theirs[~near], TOL)
            exempt[part] += int(near.sum())
            slack = (lr * 1e-5 * (np.abs(u_port[i]) + np.abs(u_jax[i]))
                     + 2.0**-23 * (np.abs(mine) + np.abs(theirs)) + 1e-30)[near]
            assert np.all(np.abs(mine - theirs - lr * (u_jax[i] - u_port[i]))[near] <= slack), path
    assert exempt == dict.fromkeys(("master", "params"), EXEMPT[cfg.name])


def test_loss_has_no_auxiliary_term(model):
    """The port's loss_fn is the chunked cross-entropy of the final hidden
    state, to the bit, as the reference's is: the MoE layer returns its
    residual output alone and adds no load-balancing term."""
    jcfg, jparams, cfg, batch = model
    params = _port(jparams)
    tb = _torch_batch(batch)
    with torch.no_grad():
        loss, _ = lm.loss_fn(params, cfg, tb, remat="none", ce_chunk=8)
        x, _ = lm.forward(params, cfg, tokens=tb["tokens"], mode="train", remat="none")
        ce, _ = chunked_ce_loss(x, params["lm_head"], tb["labels"], chunk=8)
    assert torch.equal(loss, ce)
    jb = jax.tree.map(jnp.asarray, batch)
    jloss, _ = jax_lm.loss_fn(jparams, jcfg, jb, remat="none", ce_chunk=8)
    jx, _ = jax_lm.forward(jparams, jcfg, tokens=jb["tokens"], mode="train", remat="none")
    jce, _ = jax_chunked_ce(jx, jparams["lm_head"], jb["labels"], chunk=8)
    assert float(jloss) == float(jce)
    _close(loss.item(), float(jloss), TOL)
    block = {k: v[0] for k, v in params["blocks"].items()}
    out = moe.moe_block(block, torch.zeros(1, 2, cfg.d_model), cfg=cfg)
    assert isinstance(out, torch.Tensor) and out.shape == (1, 2, cfg.d_model)


@pytest.mark.parametrize("n_layers, group, want", [(2, 8, 5), (4, 8, 11), (4, 2, 10)])
def test_remat_runs_the_moe_layer_in_each_group(n_layers, group, want, monkeypatch):
    """Under remat "full" a train step's gradient runs each layer's MoE
    branch where it runs its attention: 3 L - L / k times (k layers a
    checkpointed group: the step's forward, the group's recompute, each
    layer's own but the group's last), as many router calls as flash
    forward launches, through FlashAttention (its kernels stood in by their
    plain versions); L flash backward launches."""
    n = {"fwd": 0, "bwd": 0, "lse": 0}

    def fwd(q, k, v, with_lse=False, **kw):
        n["fwd"] += 1
        n["lse"] += with_lse
        o = fa_ops.chunked_attention(q, k, v, **kw)
        return (o, fa_ref.lse_reference(q, k, v, **kw)) if with_lse else o

    def bwd(q, k, v, o, dout, lse, **kw):
        n["bwd"] += 1
        return fa_ref.flash_attention_bwd_reference(q, k, v, o, dout, lse=lse, **kw)
    monkeypatch.setattr(fa_ops, "flash_attention_fwd", fwd)
    monkeypatch.setattr(fa_ops, "flash_attention_bwd", bwd)
    monkeypatch.setattr(attention, "flash_attention", fa_ops.flash_attention_cuda)
    calls = _record_router(monkeypatch)
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(), n_layers=n_layers)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    toks = torch.randint(0, cfg.vocab, (1, 8), generator=torch.Generator().manual_seed(1))
    step = make_train_step(cfg, remat="full", remat_group=group, ce_chunk=8)
    step(init_train_state(params), {"tokens": toks, "labels": toks})
    assert (len(calls), n["fwd"], n["lse"], n["bwd"]) == (want, want, want, n_layers)
