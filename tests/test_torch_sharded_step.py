"""The port's sharded train step on four gloo ranks, against the unsharded
port and the JAX reference, on the CPU in f32.

One ``torch.multiprocessing.spawn`` of four ranks (a ``file://`` store in a
temporary directory) serves every case of the file: on each mesh, (2, 2)
and (1, 4) over ("data", "model"), and for each architecture, the ranks
run the forward (final hidden state), the loss and every parameter's
gradient with DTensor parameters and batch under the rules
(``use_mesh_rules``): the hidden state by a forward, and the loss and the
gradients by one ``make_train_step`` step with ZeRO-1 master, mu and nu,
which also gives the updated state; rank 0 gathers each result
(``full_tensor``) to a file.  The
tests compare those with the same computations on plain tensors in this
process and with the JAX package's, on the same weights.

The (1, 4) mesh holds the reduced configs' 2 kv heads over a "model" axis
of 4: kv heads replicated, query heads (16, padded) split, each rank's
kernel call given the kv heads its query heads read.  minitron-4b has
padded heads (C1), qwen3-moe-30b-a3b its experts split over "model",
recurrentgemma-2b one kv head and ``lru_blocks``.  rwkv6-7b's 4 reduced
heads shard over "model" on both meshes.

The workers import no JAX: the JAX side runs in this process.
"""
import os
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.optim import adamw_update, cosine_schedule, init_train_state
from repro_torch.train import make_train_step
from repro_torch.train import steps as train_steps
from repro_torch.tree import leaves, paths, unflatten

ARCHS = ("qwen3-1.7b", "minitron-4b", "qwen3-moe-30b-a3b", "recurrentgemma-2b", "rwkv6-7b")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
WORLD = 4
B, S = 4, 16
TOL = 1e-5
LR = 1e-3


def _batch(cfg, seed=7):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return {"tokens": tokens, "labels": labels}


def _weights(arch):
    """Initial f32 weights of the reduced config as numpy, drawn by the
    port's init_params (the JAX package's schema and distributions; JAX's
    own init takes seconds a model on this CPU)."""
    params = lm.init_params(get_config(arch).reduced(), torch.Generator().manual_seed(1),
                            torch.float32, "cpu")
    return unflatten(params, [t.numpy() for t in leaves(params)])


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _unsharded(cfg, params, batch):
    """hidden, loss and gradients on plain tensors."""
    tparams = bridge.params_from_numpy(params, "cpu", torch.float32)
    weights = leaves(tparams)
    for w in weights:
        w.requires_grad_(True)
    hidden, _ = lm.forward(tparams, cfg, tokens=batch["tokens"], mode="train", remat="none")
    loss, _ = lm.loss_fn(tparams, cfg, batch, remat="full")
    grads = torch.autograd.grad(loss, weights, allow_unused=True, materialize_grads=True)
    return {"hidden": hidden.detach(), "loss": loss.detach(),
            "grads": [g.detach() for g in grads]}


def _sharded(mesh, cfg, params, batch):
    """The same on DTensors under the rules of ``mesh``, gathered whole."""
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from repro_torch.optim import train_state_specs
    from repro_torch.sharding import make_rules, placements_for, use_mesh_rules
    from repro_torch.train import batch_specs
    from repro_torch.tree import is_spec

    rules = make_rules(cfg, mesh, global_batch=B)
    pspecs = lm.param_specs(cfg, rules)

    def dist_tree(tree, specs):
        return unflatten(tree, [
            distribute_tensor(t, mesh, placements_for(s, mesh, t.ndim), src_data_rank=None)
            for t, s in zip(leaves(tree), leaves(specs, is_spec), strict=True)])

    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach()

    tparams = bridge.params_from_numpy(params, "cpu", torch.float32)
    dparams = dist_tree(tparams, pspecs)
    dbatch = dist_tree(batch, batch_specs(cfg, _shape(), rules))
    seen = []  # the gradients the step hands AdamW, before its redistribution

    def recording(state, grads, **kw):
        seen.extend(grads)
        return adamw_update(state, grads, **kw)
    with use_mesh_rules(mesh, rules):
        hidden, _ = lm.forward(dparams, cfg, tokens=dbatch["tokens"], mode="train",
                               remat="none")
        sspecs = train_state_specs(pspecs, lm.abstract_params(cfg, torch.float32), mesh, rules)
        state = {"params": dparams, "step": torch.zeros((), dtype=torch.int32)}
        for k, init in (("master", tparams), ("mu", None), ("nu", None)):
            tree = tparams if init is not None else unflatten(
                tparams, [torch.zeros_like(t) for t in leaves(tparams)])
            state[k] = dist_tree(tree, sspecs[k])
        zero1 = [tuple(t.placements) for t in leaves(state["master"])]
        with mock.patch.object(train_steps, "adamw_update", recording):
            state, metrics = make_train_step(cfg, lr=LR, warmup=0)(state, dbatch)
    split = [isinstance(z[0], Shard) for z in zero1]  # over "data"
    return {"hidden": whole(hidden), "loss": whole(metrics["loss"]),
            "grads": [whole(g) for g in seen],
            "step": {k: [whole(t) for t in leaves(state[k])]
                     for k in ("master", "mu", "nu", "params")},
            "zero1_split": split,
            "master_kept": [tuple(t.placements) == z
                            for t, z in zip(leaves(state["master"]), zero1)]}


def _shape():
    from repro_torch.types import ShapeConfig
    return ShapeConfig("gloo", S, B, "train")


def _worker(rank, store, out_dir):
    from torch.distributed.device_mesh import DeviceMesh
    torch.set_num_threads(1)  # four ranks on the host's cores: none oversubscribes them
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD)
    try:
        for arch in ARCHS:
            cfg = get_config(arch).reduced()
            params = torch.load(os.path.join(out_dir, f"{arch}.params.pt"), weights_only=False)
            batch = _torch_batch(_batch(cfg))
            for name, shape in MESHES.items():
                mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(shape),
                                  mesh_dim_names=("data", "model"))
                got = _sharded(mesh, cfg, params, batch)
                if rank == 0:
                    torch.save(got, os.path.join(out_dir, f"{arch}.{name}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each (arch, mesh)'s sharded results from one spawn of four ranks."""
    out = tmp_path_factory.mktemp("sharded")
    for arch in ARCHS:  # the workers import no JAX: its weights reach them as numpy
        torch.save(_weights(arch), out / f"{arch}.params.pt")
    mp.spawn(_worker, args=(str(out / "store"), str(out)), nprocs=WORLD, join=True)
    return out


def _err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max(initial=0.0))


def _close(got, want, what, tol=TOL):
    err = _err(got, want)
    assert err <= tol, f"{what}: max abs difference {err:.3g} > {tol:.3g}"


@pytest.fixture(scope="module")
def unsharded(runs):
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        params = torch.load(runs / f"{arch}.params.pt", weights_only=False)
        out[arch] = _unsharded(cfg, params, _torch_batch(_batch(cfg)))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_forward_loss_and_gradients_equal_the_unsharded_port(arch, mesh, runs,
                                                                    unsharded):
    got = torch.load(runs / f"{arch}.{mesh}.pt", weights_only=False)
    want = unsharded[arch]
    names = paths(lm.model_schema(get_config(arch).reduced()))
    _close(got["hidden"], want["hidden"], "hidden")
    _close(got["loss"], want["loss"], "loss")
    for name, g, w in zip(names, got["grads"], want["grads"], strict=True):
        _close(g, w, f"grad {name}")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_train_step_equals_the_unsharded_step(arch, mesh, runs, unsharded):
    """One make_train_step on ZeRO-1 state: its loss is the unsharded
    step's, and master, mu, nu and the params, gathered, equal the unsharded
    AdamW update of the gradients the sharded step took (the sharded
    gradients equal the unsharded ones within 1e-5, above; the first step's
    u = g / (|g| + eps) turns a difference of 1e-9 in a gradient near eps
    into one of order lr in the master, so each update is held to its own
    gradients).  The master stays on its ZeRO-1 placements."""
    got = torch.load(runs / f"{arch}.{mesh}.pt", weights_only=False)
    cfg = get_config(arch).reduced()
    params = torch.load(runs / f"{arch}.params.pt", weights_only=False)
    state = init_train_state(bridge.params_from_numpy(params, "cpu", torch.float32))
    want, _ = adamw_update(state, got["grads"], lr=cosine_schedule(LR, 0, 10_000))
    for k in ("master", "mu", "nu", "params"):
        for name, g, w in zip(paths(lm.model_schema(cfg)), got["step"][k], leaves(want[k]),
                              strict=True):
            _close(g, w, f"{k} {name}")
    assert all(got["master_kept"])
    # a data axis of 2 gives each leaf with an even unsplit dim its ZeRO-1
    # split; an axis of 1 splits nothing
    assert any(got["zero1_split"]) == (MESHES[mesh][0] > 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_equals_the_jax_reference(arch, runs, unsharded):
    """The hidden state, loss and gradients of both meshes, and of the
    unsharded port, against the JAX package's on the same weights and
    batch, each within 1e-5."""
    import jax
    import jax.numpy as jnp

    from repro.configs import ARCHS as JAX_ARCHS
    from repro.models import lm as jax_lm
    jcfg = JAX_ARCHS[arch].reduced()
    params = torch.load(runs / f"{arch}.params.pt", weights_only=False)
    batch = {k: jnp.asarray(v) for k, v in _batch(get_config(arch).reduced()).items()}
    jparams = jax.tree.map(jnp.asarray, params)
    hidden, _ = jax.jit(lambda p: jax_lm.forward(p, jcfg, tokens=batch["tokens"], mode="train",
                                                 remat="none"))(jparams)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm.loss_fn(p, jcfg, batch, remat="full"), has_aux=True))(jparams)
    want = {"hidden": hidden, "loss": loss, "grads": jax.tree.leaves(grads)}
    port = unsharded[arch]

    for name, got in [("unsharded", port)] + [
            (mesh, torch.load(runs / f"{arch}.{mesh}.pt", weights_only=False))
            for mesh in sorted(MESHES)]:
        for k in ("hidden", "loss"):
            _close(got[k], want[k], f"{name} {k}")
        for i, (g, w) in enumerate(zip(got["grads"], want["grads"], strict=True)):
            _close(g, w, f"{name} grad leaf {i}")
