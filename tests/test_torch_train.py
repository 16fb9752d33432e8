"""The port's train path against the JAX package's, on the CPU, in f32.

Data, chunked cross-entropy, AdamW, one train step, remat, checkpoints and
the training CLI.  The port initialises each reduced config from a seed;
the same weights go through numpy to both packages (``jnp.asarray`` on one
side, ``repro_torch.bridge`` on the other; jax's own init, op by op, takes
seconds a model), so both sides start from the same weights and batch.  Tolerance 2e-4 (relative and
absolute), as tests/test_torch_lm.py holds the forward pass: the two
frameworks sum in other orders, through every layer and the optimizer.
Checkpoints are compared bit for bit.
"""
import dataclasses
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import ARCHS as JAX_ARCHS
from repro.data import SyntheticLMDataset as JaxDataset
from repro.launch import train as jax_train
from repro.models import lm as jax_lm
from repro.models.layers import chunked_ce_loss as jax_chunked_ce
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_schedule as jax_cosine
from repro.optim import init_train_state as jax_init_train_state
from repro.train import make_train_step as jax_make_train_step
from repro.train import useful_flops as jax_useful_flops
from repro.types import SHAPES as JAX_SHAPES
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.rglru_scan import ref as scan_ref
from repro_torch.launch import train as train_mod
from repro_torch.models import attention, lm, rglru
from repro_torch.models.layers import chunked_ce_loss
from repro_torch.optim import adamw_update, cosine_schedule, init_train_state
from repro_torch.train import make_train_step, useful_flops
from repro_torch.tree import leaves, map_tree, paths
from repro_torch.types import ShapeConfig

TOL = 2e-4
B, S = 4, 16


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=tol, rtol=tol)


def _np_tree(tree):
    """A JAX tree as numpy, with jax's leaf order kept by our dict walk."""
    return jax.tree.map(np.asarray, tree)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long() for k, v in batch.items()}


def _weights(name, seed):
    """(jax cfg, jax params, port cfg): one set of seeded f32 weights, as jax arrays."""
    cfg = get_config(name).reduced()
    params = lm.init_params(cfg, torch.Generator().manual_seed(seed), torch.float32, "cpu")
    return JAX_ARCHS[name].reduced(), jax.tree.map(jnp.asarray, _to_numpy(params)), cfg


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return tree.numpy()


def _port(jparams):
    return bridge.params_from_numpy(_np_tree(jparams), "cpu", torch.float32)


@pytest.fixture(scope="module")
def qwen():
    jcfg, jparams, _ = _weights("qwen3-1.7b", 0)
    batch = JaxDataset(jcfg.vocab, S, seed=0).batch(0, B)
    return jcfg, jparams, batch


# ---------------------------------------------------------------------------
# data, loss, optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed, step, host, n_hosts", [(0, 0, 0, 1), (1, 5, 0, 1),
                                                       (1, 5, 1, 2), (7, 123, 3, 4)])
def test_dataset_batches_equal_reference(seed, step, host, n_hosts):
    mine = SyntheticLMDataset(100, 32, seed=seed).batch(step, 8, host_id=host, n_hosts=n_hosts)
    theirs = JaxDataset(100, 32, seed=seed).batch(step, 8, host_id=host, n_hosts=n_hosts)
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(mine[k], theirs[k])


@pytest.mark.parametrize("chunk, masked", [(7, False), (7, True), (24, False), (512, True)])
def test_chunked_ce_matches_reference_and_naive(chunk, masked):
    """A ragged last chunk (24 = 3 x 7 + 3), labels -1 and beyond the vocab
    (clipped into it before the gather), and a label mask; the loss, the count
    and the gradients of x and the head weight."""
    Bc, Sc, D, V = 2, 24, 16, 50
    rng = np.random.default_rng(chunk + masked)
    x = rng.standard_normal((Bc, Sc, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.1).astype(np.float32)
    labels = rng.integers(0, V, (Bc, Sc)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, 5] = V + 7
    mask = rng.random((Bc, Sc)) < 0.8 if masked else None

    def jloss(x, w):
        return jax_chunked_ce(x, w, jnp.asarray(labels), chunk=chunk,
                              label_mask=None if mask is None else jnp.asarray(mask))
    (jl, jcnt), (jgx, jgw) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    loss, cnt = chunked_ce_loss(tx, tw, torch.from_numpy(labels).long(), chunk=chunk,
                                label_mask=None if mask is None else torch.from_numpy(mask))
    gx, gw = torch.autograd.grad(loss, (tx, tw))
    assert int(cnt) == int(jcnt)
    _close(loss.item(), float(jl), 1e-5)
    _close(gx.numpy(), jgx, 1e-5)
    _close(gw.numpy(), jgw, 1e-5)
    keep = (labels >= 0) & (True if mask is None else mask)
    logp = torch.log_softmax(torch.from_numpy(x) @ torch.from_numpy(w), -1)
    lab = torch.from_numpy(np.clip(labels, 0, V - 1)).long()
    naive = -logp.gather(-1, lab[..., None])[..., 0][torch.from_numpy(keep)].mean()
    assert int(cnt) == keep.sum()
    np.testing.assert_allclose(loss.item(), naive.item(), rtol=1e-5)


def test_adamw_minimizes_quadratic():
    state = init_train_state({"w": torch.tensor([5.0, -3.0])})
    for _ in range(200):
        grads = {"w": 2 * state["params"]["w"]}
        state, _ = adamw_update(state, grads, lr=0.1, weight_decay=0.0)
    assert float(state["params"]["w"].abs().max()) < 0.1


def test_grad_clip():
    state = init_train_state({"w": torch.zeros(4)})
    state, aux = adamw_update(state, {"w": torch.full((4,), 1e6)}, lr=1e-3, clip=1.0)
    assert float(aux["grad_norm"]) > 1e5
    assert bool(torch.all(torch.isfinite(state["params"]["w"])))


def test_adamw_updates_match_reference():
    """Three updates of a tree with a bf16 leaf, on the cosine schedule past
    its warm-up, clipping on, weight decay on every leaf."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": [(5,), (2, 2)]}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                          is_leaf=lambda s: isinstance(s, tuple))
    params["c"] = rng.standard_normal((6,)).astype(np.float32)
    jstate = jax_init_train_state(jax.tree.map(jnp.asarray, params))
    jstate["params"]["c"] = jstate["params"]["c"].astype(jnp.bfloat16)
    state = init_train_state(map_tree(torch.from_numpy, params))
    state["params"]["c"] = state["params"]["c"].bfloat16()
    for i in range(3):
        grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * (i + 1)).astype(np.float32),
                             params)
        jstate, jaux = jax_adamw_update(jstate, jax.tree.map(jnp.asarray, grads),
                                        lr=jax_cosine(1e-2, 1, 5), clip=1.0)
        state, aux = adamw_update(state, map_tree(torch.from_numpy, grads),
                                  lr=cosine_schedule(1e-2, 1, 5), clip=1.0)
        _close(aux["grad_norm"].item(), float(jaux["grad_norm"]), 1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 3
    for mine, theirs in zip(leaves(state), jax.tree.leaves(jstate)):
        _close(mine.float().numpy(), np.asarray(theirs, np.float32), 1e-6)


@pytest.mark.parametrize("name", ["qwen3-1.7b", "rwkv6-7b", "recurrentgemma-2b"])
def test_useful_flops_matches_reference(name):
    cfg, jcfg = get_config(name), JAX_ARCHS[name]
    assert cfg.n_active_params() == jcfg.n_active_params()
    for shape in JAX_SHAPES.values():
        mine = ShapeConfig(shape.name, shape.seq_len, shape.global_batch, shape.kind)
        assert useful_flops(cfg, mine) == jax_useful_flops(jcfg, shape)


# ---------------------------------------------------------------------------
# the train step and remat
# ---------------------------------------------------------------------------

STEP_KW = dict(lr=1e-2, warmup=2, total=10, ce_chunk=8)


@pytest.fixture(scope="module")
def jax_steps(qwen):
    """One JAX train step a microbatch count, shared by the port's remat modes
    (jax.checkpoint changes no value)."""
    jcfg, jparams, batch = qwen
    cache = {}

    def get(microbatch):
        if microbatch not in cache:
            jstep = jax.jit(jax_make_train_step(jcfg, remat="none", microbatch=microbatch,
                                                **STEP_KW))
            cache[microbatch] = jstep(jax_init_train_state(jparams),
                                      jax.tree.map(jnp.asarray, batch))
        return cache[microbatch]
    return get


@pytest.mark.parametrize("remat, microbatch", [("none", 1), ("full", 1), ("none", 2),
                                               ("full", 2)])
def test_train_step_matches_reference(qwen, jax_steps, remat, microbatch):
    jcfg, jparams, batch = qwen
    jstate, jm = jax_steps(microbatch)
    cfg, params = get_config("qwen3-1.7b").reduced(), _port(jparams)
    state, m = make_train_step(cfg, remat=remat, microbatch=microbatch, **STEP_KW)(
        init_train_state(params), _torch_batch(batch))
    assert int(m["tokens"]) == int(jm["tokens"]) == B * S
    _close(m["loss"].item(), float(jm["loss"]))
    _close(m["grad_norm"].item(), float(jm["grad_norm"]))
    assert int(state["step"]) == int(jstate["step"]) == 1
    assert paths(state)[:3] == ["master/blocks/k_norm", "master/blocks/ln1",
                                "master/blocks/ln2"]
    for path, mine, theirs in zip(paths(state), leaves(state), jax.tree.leaves(jstate)):
        assert tuple(mine.shape) == theirs.shape, path
        _close(mine.detach().numpy(), theirs)


def test_train_step_refuses_a_batch_microbatch_does_not_divide(qwen):
    """5 rows in 2 micro-batches: the reference's reshape raises, and so does
    the port, before any row is taken (no step that silently drops a row)."""
    jcfg, jparams, _ = qwen
    batch = JaxDataset(jcfg.vocab, S, seed=3).batch(0, 5)
    jstep = jax_make_train_step(jcfg, remat="none", microbatch=2, **STEP_KW)
    with pytest.raises(TypeError, match="cannot reshape"):
        jstep(jax_init_train_state(jparams), jax.tree.map(jnp.asarray, batch))
    state = init_train_state(_port(jparams))
    step = make_train_step(get_config("qwen3-1.7b").reduced(), remat="none", microbatch=2,
                           **STEP_KW)
    with pytest.raises(ValueError, match=r"batch of 5 rows .* microbatch=2"):
        step(state, _torch_batch(batch))
    assert int(state["step"]) == 0


@pytest.mark.parametrize("name", ["rwkv6-7b", "recurrentgemma-2b"])
def test_loss_fn_with_remat_matches_reference(name):
    """A uniform stack in groups (rwkv6) and a hybrid a layer at a time
    (recurrentgemma), checkpointed, against jax.value_and_grad."""
    jcfg, jparams, cfg = _weights(name, 1)
    batch = JaxDataset(jcfg.vocab, 8, seed=2).batch(0, 2)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jax_lm.loss_fn(p, jcfg, b, remat="full", ce_chunk=4), has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch))
    params = _port(jparams)
    weights = leaves(params)
    for w in weights:
        w.requires_grad_(True)
    loss, aux = lm.loss_fn(params, cfg, _torch_batch(batch), remat="full", ce_chunk=4)
    grads = torch.autograd.grad(loss, weights)
    assert int(aux["tokens"]) == int(jaux["tokens"])
    _close(loss.item(), float(jl))
    for mine, theirs in zip(grads, jax.tree.leaves(jg)):
        _close(mine.numpy(), theirs)


@pytest.fixture
def counting(monkeypatch):
    """The flash entry point sent through FlashAttention and the scan's
    through RGLRUScan on the CPU, each kernel call stood in by its plain
    version and counted."""
    n = {"fwd": 0, "bwd": 0, "lse": 0, "scan_fwd": 0, "scan_bwd": 0}

    def fwd(q, k, v, with_lse=False, **kw):
        n["fwd"] += 1
        n["lse"] += with_lse
        o = fa_ops.chunked_attention(q, k, v, **kw)
        return (o, fa_ref.lse_reference(q, k, v, **kw)) if with_lse else o

    def bwd(q, k, v, o, dout, lse, **kw):
        n["bwd"] += 1
        return fa_ref.flash_attention_bwd_reference(q, k, v, o, dout, lse=lse, **kw)

    def entry(q, k, v, *, causal=True, window=None, q_offset=0, kv_len=None):
        return fa_ops.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                           q_offset=q_offset, kv_len=kv_len)

    def scan_fwd(a, b, h0):
        n["scan_fwd"] += 1
        return scan_ref.rglru_reference(a, b, h0)

    def scan_bwd(a, h, h0, dh, dh_last):
        n["scan_bwd"] += 1
        return scan_ref.rglru_scan_bwd_reference(a, h, h0, dh, dh_last)

    monkeypatch.setattr(fa_ops, "flash_attention_fwd", fwd)
    monkeypatch.setattr(fa_ops, "flash_attention_bwd", bwd)
    monkeypatch.setattr(attention, "flash_attention", entry)
    monkeypatch.setattr(scan_ops, "rglru_scan_fwd", scan_fwd)
    monkeypatch.setattr(scan_ops, "rglru_scan_bwd", scan_bwd)
    monkeypatch.setattr(rglru, "rglru_scan",
                        scan_ops.rglru_scan_cuda)
    return n


@pytest.mark.parametrize("name, n_layers, remat, group, want", [
    ("qwen3-1.7b", 28, "full", 8, (77, 28)),   # groups of 4: 3 L - L / 4
    ("qwen3-1.7b", 2, "full", 8, (5, 2)),      # one group of 2
    ("qwen3-1.7b", 8, "full", 8, (23, 8)),     # one group of 8
    ("qwen3-1.7b", 28, "none", 8, (28, 28)),
    ("qwen3-1.7b", 28, "dots", 8, (77, 28)),
    # a hybrid checkpoints each layer on its own: twice a layer forward, once
    # backward; 2 attention and 4 RG-LRU layers reduced, 8 and 18 at full depth
    ("recurrentgemma-2b", None, "full", 8, (4, 2, 8, 4)),
    ("recurrentgemma-2b", 26, "full", 8, (16, 8, 36, 18)),
    ("recurrentgemma-2b", 26, "none", 8, (8, 8, 18, 18)),
])
def test_remat_launch_counts(counting, name, n_layers, remat, group, want):
    """One train step's kernel launches under PyTorch's nested non-reentrant
    checkpoints: a layer's forward runs once, again in its group's recompute,
    and again in its own, except the last layer of a group, whose own
    recompute the group's already served.  Flash forward and backward, then
    the scan's forward and backward (none in qwen3)."""
    cfg = get_config(name).reduced()
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    toks = torch.randint(0, cfg.vocab, (1, 8), generator=torch.Generator().manual_seed(1))
    step = make_train_step(cfg, remat=remat, remat_group=group, ce_chunk=8)
    step(init_train_state(params), {"tokens": toks, "labels": toks})
    got = (counting["fwd"], counting["bwd"], counting["scan_fwd"], counting["scan_bwd"])
    assert got == (want if len(want) == 4 else want + (0, 0))
    assert counting["lse"] == counting["fwd"]  # each forward of a train step keeps its lse


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
        return func(*args, **(kwargs or {}))


def test_dots_remat_saves_the_matrix_products():
    """'dots' recomputes no matrix product without batch dims, 'full' all of
    them; the values are the same."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(), n_layers=4)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    for w in leaves(params):
        w.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(1))
    counts, losses = {}, {}
    for remat in ("none", "dots", "full"):
        with _CountMatmuls() as mode:
            loss, _ = lm.loss_fn(params, cfg, {"tokens": toks, "labels": toks}, remat=remat,
                                 ce_chunk=8)
            torch.autograd.grad(loss, leaves(params))
        counts[remat], losses[remat] = mode.mm, loss.item()
    assert counts["none"] == counts["dots"] < counts["full"]
    assert losses["none"] == losses["dots"] == losses["full"]


def test_unknown_remat_raises():
    with pytest.raises(ValueError):
        lm._maybe_remat(lambda x: x, "everything")


# ---------------------------------------------------------------------------
# checkpoints and the training CLI
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    bits = torch.tensor([1, 0x7F7F, -0x80, -1], dtype=torch.int16)  # 0xFF80 is -inf
    state = {"params": {"w": torch.arange(6, dtype=torch.bfloat16), "x": bits.view(torch.bfloat16)},
             "step": torch.tensor(3, dtype=torch.int32),
             "mu": torch.from_numpy(np.random.default_rng(0).standard_normal(4).astype(np.float32))}
    for s in (1, 2, 3):
        mgr.save(s, state, blocking=True)
    assert mgr.latest_step() == 3
    assert len(mgr._step_dirs()) == 2  # retention
    assert {p.name for p in tmp_path.iterdir()} == {"step_00000002", "step_00000003"}
    restored = mgr.restore(map_tree(torch.zeros_like, state))
    assert restored["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(restored["params"]["w"].view(torch.int16),
                       state["params"]["w"].view(torch.int16))
    assert torch.equal(restored["params"]["x"].view(torch.int16), bits)
    assert torch.equal(restored["mu"], state["mu"]) and int(restored["step"]) == 3
    assert mgr.restore(state, step=999) is None


def test_checkpoint_save_copies_before_returning(tmp_path):
    """The train step updates the state in place: a save must not see it."""
    mgr = CheckpointManager(tmp_path)
    state = {"w": torch.zeros(1000)}
    mgr.save(1, state)
    state["w"].add_(1.0)
    mgr.wait()
    assert torch.all(mgr.restore(state)["w"] == 0)


def test_checkpoint_restore_refuses_another_structure(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"a": torch.zeros(3), "b": torch.zeros(2)}, blocking=True)
    with pytest.raises(ValueError, match="holds 2 leaves"):
        mgr.restore({"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"a": torch.zeros(3), "b": torch.zeros(5)})


def _bf16_state(jparams):
    """A JAX train state with bf16 params, as the card trains."""
    st = jax_init_train_state(jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams))
    st["step"] = jnp.int32(7)
    return st


def test_checkpoints_interchange_bit_for_bit(qwen, tmp_path):
    jcfg, jparams, _ = qwen
    jstate = _bf16_state(jparams)
    JaxCheckpointManager(tmp_path / "jax").save(7, jstate, blocking=True)
    cfg = get_config("qwen3-1.7b").reduced()
    like = init_train_state(lm.init_params(cfg, torch.Generator().manual_seed(0),
                                           torch.bfloat16, "cpu"))
    mine = CheckpointManager(tmp_path / "jax").restore(like)
    assert int(mine["step"]) == 7
    for path, a, b in zip(paths(mine), leaves(mine), jax.tree.leaves(jstate)):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), path
        bits = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        want = np.asarray(b).view(np.int16) if b.dtype == jnp.bfloat16 else np.asarray(b)
        np.testing.assert_array_equal(bits.numpy(), want, err_msg=path)

    CheckpointManager(tmp_path / "port").save(7, mine, blocking=True)
    theirs = JaxCheckpointManager(tmp_path / "port").restore(
        jax.tree.map(np.zeros_like, _np_tree(jstate)))
    for a, b in zip(jax.tree.leaves(theirs), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).reshape(-1).view(np.uint8),
                                      np.asarray(b).reshape(-1).view(np.uint8))


CLI_ARGS = ["--arch", "qwen3-1.7b", "--reduced", "--batch", "4", "--seq", "16",
          "--log-every", "100"]


@pytest.fixture
def signals():
    """The training CLI installs SIGTERM and SIGINT handlers; put back the ones found."""
    found = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield found
    for s, h in found.items():
        signal.signal(s, h)


def test_train_driver_checkpoint_resume(tmp_path, signals):
    """Kill-and-resume through the training CLI (the preemption contract)."""
    ckpt = str(tmp_path / "ck")
    args = CLI_ARGS + ["--device", "cpu", "--ckpt-dir", ckpt, "--ckpt-every", "3"]
    assert train_mod.main(args + ["--steps", "6"]) == 0
    mgr = CheckpointManager(ckpt)
    assert mgr.latest_step() == 6
    assert train_mod.main(args + ["--steps", "8"]) == 0  # runs only the remaining steps
    assert mgr.latest_step() == 8
    assert {signal.getsignal(s) for s in signals} == set(signals.values())


def test_port_resumes_a_jax_run(tmp_path, signals):
    """The JAX package's CLI runs straight to step 6, checkpointing at 3; the
    port's resumes from that step-3 checkpoint to 6; the two step-6 states
    agree."""
    mixed, straight = tmp_path / "mixed", tmp_path / "straight"
    assert jax_train.main(CLI_ARGS + ["--steps", "6", "--ckpt-every", "3",
                                    "--ckpt-dir", str(straight)]) == 0
    for s, h in signals.items():
        signal.signal(s, h)
    shutil.copytree(straight / "step_00000003", mixed / "step_00000003")
    assert train_mod.main(CLI_ARGS + ["--device", "cpu", "--steps", "6",
                                    "--ckpt-dir", str(mixed)]) == 0
    a = np.load(f"{mixed}/step_00000006/arrays.npz")
    b = np.load(f"{straight}/step_00000006/arrays.npz")
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        _close(a[key], b[key])


def test_sigterm_checkpoints_and_exits_cleanly(tmp_path, monkeypatch, signals):
    """SIGTERM arrives while step 2's batch is made: the step finishes, a
    checkpoint at step 3 is written, and main returns 0."""
    class Preempted(SyntheticLMDataset):
        def batch(self, step, batch_size, **kw):
            if step == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return super().batch(step, batch_size, **kw)

    monkeypatch.setattr(train_mod, "SyntheticLMDataset", Preempted)
    ckpt = str(tmp_path / "ck")
    assert train_mod.main(CLI_ARGS + ["--device", "cpu", "--steps", "10", "--ckpt-dir", ckpt,
                                    "--ckpt-every", "100"]) == 0
    assert CheckpointManager(ckpt).latest_step() == 3
    assert {signal.getsignal(s) for s in signals} == set(signals.values())
