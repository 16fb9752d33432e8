"""The port's dry-run (``repro_torch.launch.dryrun``, ``op_analysis``) on the
CPU, with reduced configs.

- ``roofline`` against the reference's formulas, reimplemented here (the
  reference's module sets XLA_FLAGS when imported, so no test imports it),
  on a profile built from the JAX package's TPU_V5E fields;
- records of cells traced on a fake process group of 256 ranks and a CPU
  mesh: the reference's keys (``ops`` for ``xla_cost`` and ``hlo``), the
  group destroyed on every path;
- per-device FLOPs of a reduced dense train cell at (1, 1) against
  ``repro.launch.hlo_analysis.analyze`` of the JAX step lowered on one CPU
  device;
- the kernels' custom ops: each fake implementation on fake CUDA tensors
  gives its plain version's shapes and dtypes, the flash FLOP formula
  counts the visible pairs, and a trace that takes the kernel path (the
  entry points pointed at the custom ops) reaches the fake implementations,
  never a kernel, with FLOPs equal to FlopCounterMode's on the real step.
"""
import contextlib
import dataclasses
import logging
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro.configs import ARCHS as JAX_ARCHS
from repro.launch.hlo_analysis import analyze
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.models import lm as jax_lm
from repro.sharding import make_rules as jax_make_rules
from repro.sharding import use_mesh_rules as jax_use_mesh_rules
from repro.train import input_specs as jax_input_specs
from repro.train import make_train_step as jax_make_train_step
from repro.train.steps import ideal_bytes as jax_ideal_bytes
from repro.train.steps import useful_flops as jax_useful_flops
from repro.types import TPU_V5E
from repro_torch.configs import SHAPES, get_config
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.rglru_scan import kernel as scan_kernel
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.rglru_scan import ref as scan_ref
from repro_torch.kernels.rwkv6_wkv import kernel as wkv_kernel
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.kernels.rwkv6_wkv import ref as wkv_ref
from repro_torch.launch import dryrun
from repro_torch.models import attention, lm, rglru, rwkv6
from repro_torch.optim import init_train_state
from repro_torch.train import make_train_step
from repro_torch.types import H100_SXM, HardwareProfile, ShapeConfig

logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)

# the reference's run_cell record, less its XLA keys
RECORD_KEYS = {"arch", "shape", "mesh", "remat", "seq_shard", "microbatch", "status", "n_chips",
               "lower_s", "compile_s", "memory", "roofline"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "per_device_bytes", "fits_hbm"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "dominant", "model_flops",
                 "hlo_flops_total", "useful_flop_ratio", "ideal_bytes_per_dev", "ideal_memory_s",
                 "roofline_fraction", "step_lower_bound_s"}
SMALL_TRAIN = ShapeConfig("train_4k", 64, 256, "train")


@pytest.fixture(autouse=True)
def no_group_left():
    """No test leaves a process group behind: a worker runs many files."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()
        pytest.fail("a process group was left initialized")


def _reference_roofline(totals, cfg, shape, n_chips, profile):
    """repro.launch.dryrun.roofline's formulas, written out."""
    compute_s = totals["flops"] / profile.peak_flops
    memory_s = totals["bytes"] / profile.hbm_bw
    collective_s = totals["collective_bytes"] / profile.link_bw
    model_fl = jax_useful_flops(cfg, shape)
    total = totals["flops"] * n_chips
    ideal_b = jax_ideal_bytes(cfg, shape, n_chips=n_chips, tp=16)
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s}
    bound = max(terms.values())
    return {**terms, "dominant": max(terms, key=terms.get), "model_flops": model_fl,
            "hlo_flops_total": total, "useful_flop_ratio": model_fl / total,
            "ideal_bytes_per_dev": ideal_b, "ideal_memory_s": ideal_b / profile.hbm_bw,
            "roofline_fraction": model_fl / (n_chips * profile.peak_flops) / bound,
            "step_lower_bound_s": bound}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "recurrentgemma-2b", "qwen3-moe-30b-a3b"])
def test_roofline_matches_the_reference_formulas(arch, shape):
    profile = HardwareProfile(**{f.name: getattr(TPU_V5E, f.name)
                                 for f in dataclasses.fields(HardwareProfile)})
    for totals in ({"flops": 3.1e14, "bytes": 2.2e11, "collective_bytes": 4.4e9},
                   {"flops": 1.0e9, "bytes": 5.0e12, "collective_bytes": 0.0}):
        for n in (256, 512):
            got = dryrun.roofline(totals, get_config(arch), SHAPES[shape], n, profile)
            assert got == _reference_roofline(totals, JAX_ARCHS[arch], SHAPES[shape], n,
                                              profile)
    assert (H100_SXM.peak_flops, H100_SXM.hbm_bw, H100_SXM.link_bw, H100_SXM.hbm_per_chip) == (
        989e12, 3.35e12, 450e9, 80e9)


@pytest.mark.parametrize("arch, shape", [
    ("qwen3-1.7b", SMALL_TRAIN),
    ("qwen3-moe-30b-a3b", ShapeConfig("decode_32k", 64, 128, "decode")),
    ("recurrentgemma-2b", ShapeConfig("prefill_32k", 64, 32, "prefill"))])
def test_a_cell_on_256_fake_ranks_gives_the_reference_record(arch, shape):
    rec = dryrun.run_cell(get_config(arch).reduced(), shape, "pod16x16", device="cpu")
    assert rec["status"] == "ok", rec.get("traceback")
    assert RECORD_KEYS | {"ops", "device", "kernels", "profile"} == set(rec)
    assert set(rec["memory"]) == MEMORY_KEYS and set(rec["roofline"]) == ROOFLINE_KEYS
    assert rec["n_chips"] == 256 and rec["device"] == "cpu"
    assert rec["kernels"] == "the plain versions"
    ops = rec["ops"]
    assert ops["flops"] > 0 and ops["bytes"] > 0 and ops["collective_bytes"] > 0
    kinds = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")
    assert set(ops["collective_by_group"]) <= {f"{k}@{n}" for k in kinds for n in (16, 256)}
    m = rec["memory"]
    assert m["per_device_bytes"] == m["argument_bytes"] + m["temp_bytes"] and m["fits_hbm"]
    assert not dist.is_initialized()


def test_the_fake_group_goes_on_every_path():
    """A cell that fails (the reference's own duplicate "model" in MLA's
    decode logits) is recorded, and its fake group is gone; a group already
    running is not replaced."""
    rec = dryrun.run_cell(get_config("minicpm3-4b").reduced(),
                          ShapeConfig("decode_32k", 64, 128, "decode"), "pod16x16", device="cpu")
    assert rec["status"] == "error" and "uses mesh axis 'model' twice" in rec["error"]
    assert not dist.is_initialized()
    skip = dryrun.run_cell("hubert-xlarge", "decode_32k", "pod16x16", device="cpu")
    assert skip["status"] == "skip" and not dist.is_initialized()
    with dryrun.fake_group(4):
        with pytest.raises(RuntimeError, match="one is already initialized"):
            with dryrun.fake_group(256):
                pass
    assert not dist.is_initialized()


def _jax_flops(remat, B, S):
    """hlo_analysis' per-device FLOPs of reduced qwen3-1.7b's JAX train step,
    lowered on make_host_mesh()."""
    jcfg = JAX_ARCHS["qwen3-1.7b"].reduced()
    mesh = jax_host_mesh()
    rules = jax_make_rules(jcfg, mesh, global_batch=B)
    aparams = jax_lm.abstract_params(jcfg, jnp.bfloat16)
    f32 = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, jnp.float32), aparams)
    state = {"params": aparams, "master": f32, "mu": f32, "nu": f32,
             "step": jax.ShapeDtypeStruct((), jnp.int32)}
    with mesh, jax_use_mesh_rules(mesh, rules):
        step = jax.jit(jax_make_train_step(jcfg, remat=remat, ce_chunk=512))
        compiled = step.lower(state, jax_input_specs(jcfg, ShapeConfig("t", S, B, "train")))
        return analyze(compiled.compile().as_text(), n_devices=1)["flops"]


def test_host_mesh_flops_of_a_dense_train_step_match_hlo_analysis():
    """Reduced qwen3-1.7b, 2 x 64 tokens, on one device: the port's step
    traced on a (1, 1) CPU mesh, whose flash calls take the plain chunked
    attention as the JAX package's CPU path does, against hlo_analysis of
    the JAX step.  With remat "none" they count the same products, equal.
    With remat "full" the port counts less by design: torch's checkpoint
    stops a recomputation at the last saved tensor the backward needs
    (early stop), so a remat group's last layer, and each layer's ops
    after its last saved input, run their forward twice where XLA's scans
    run them three times.  The reference's extra FLOPs over remat "none"
    are two forwards of every layer; the port's fall short of them by less
    than one of those two (measured: by 22,544,384 of 87,031,808)."""
    B, S = 2, 64
    cfg = get_config("qwen3-1.7b").reduced()
    got = {}
    for remat in ("none", "full"):
        rec = dryrun.run_cell(cfg, ShapeConfig("t", S, B, "train"), "host1x1", device="cpu",
                              remat=remat)
        assert rec["status"] == "ok", rec.get("traceback")
        got[remat] = rec["ops"]["flops"]
    want = {remat: _jax_flops(remat, B, S) for remat in ("none", "full")}
    assert got["none"] == want["none"]
    one_forward = (want["full"] - want["none"]) / 2
    assert 0 < want["full"] - got["full"] < one_forward, (got, want)


# --- the kernels' custom ops ------------------------------------------------

def test_fake_implementations_give_the_plain_versions_shapes():
    B, Sq, Sk, H, KH, Dk, Dv, T, W, D = 2, 5, 7, 4, 2, 16, 8, 6, 12, 8
    cpu = {"q": torch.randn(B, Sq, H, Dk, dtype=torch.bfloat16),
           "k": torch.randn(B, Sk, KH, Dk, dtype=torch.bfloat16),
           "v": torch.randn(B, Sk, KH, Dv, dtype=torch.bfloat16)}
    o = fa_ops.chunked_attention(**cpu)
    lse = fa_ref.lse_reference(**cpu)
    grads = fa_ref.flash_attention_bwd_reference(*cpu.values(), o, o, lse=lse)
    a = torch.rand(B, T, W)
    h, h_last = scan_ref.rglru_reference(a, a)
    da = scan_ref.rglru_scan_bwd_reference(a, h, None, h, None)
    r = torch.rand(B, T, H, D, dtype=torch.bfloat16)
    u = torch.rand(H, D)
    y, s_last = wkv_ref.rwkv6_reference(r, r, r, r, u)
    dwkv = wkv_ref.rwkv6_wkv_bwd_reference(r, r, r, r, u, None, y, None)
    meta = lambda ts: [(tuple(t.shape), t.dtype) for t in ts]  # noqa: E731
    with FakeTensorMode():
        fake = {k: torch.empty(v.shape, dtype=v.dtype, device="cuda") for k, v in cpu.items()}
        fo, flse = fa_ops.flash_attention_op(*fake.values(), True, None, 0, None, True)
        assert fo.device.type == "cuda"
        assert meta([fo, flse]) == meta([o, lse])
        assert meta(fa_ops.flash_attention_op(*fake.values(), True, 3, 2, 5, False)[:1]) == meta([o])
        assert meta(fa_ops.flash_attention_bwd_op(*fake.values(), fo, fo, flse, True, None, 0,
                                                  None)) == meta(grads)
        fa = torch.empty(B, T, W, device="cuda")
        fh = scan_ops.rglru_scan_op(fa, fa, None, True)
        assert meta(fh) == meta([h, h_last])
        assert meta(scan_ops.rglru_scan_bwd_op(fa, fh[0], None, fh[0], None)) == meta(da)
        fr = torch.empty(B, T, H, D, dtype=torch.bfloat16, device="cuda")
        fu = torch.empty(H, D, device="cuda")
        fy = wkv_ops.rwkv6_wkv_op(fr, fr, fr, fr, fu, None, True)
        assert meta(fy) == meta([y, s_last])
        assert meta(wkv_ops.rwkv6_wkv_bwd_op(fr, fr, fr, fr, fu, None, fy[0], None)) == meta(dwkv)


def _pairs(Sq, Sk, causal, window, q_offset, kv_len):
    q = q_offset + np.arange(Sq)[:, None]
    k = np.arange(Sk)[None, :]
    seen = (k < (Sk if kv_len is None else kv_len)) & (q >= 0)
    if causal:
        seen = seen & (k <= q)
    if window is not None:
        seen = seen & (k > q - window)
    return int(seen.sum())


@pytest.mark.parametrize("case", [
    (9, 9, True, None, 0, None),      # causal
    (40, 40, True, 8, 0, None),       # a window
    (6, 20, True, None, 13, 17),      # kv_len, a query offset (a chunk of a prefill)
    (7, 11, False, None, 0, 5)],      # bidirectional, kv_len
    ids=["causal", "window", "kv_len", "bidirectional"])
def test_flash_flop_formulas_count_the_visible_pairs(case):
    Sq, Sk, causal, window, q_offset, kv_len = case
    B, H, KH, Dk, Dv = 2, 4, 2, 96, 64
    pairs = _pairs(*case)
    assert fa_ops.visible_pairs(*case) == pairs
    q, k, v = (torch.empty(s) for s in ((B, Sq, H, Dk), (B, Sk, KH, Dk), (B, Sk, KH, Dv)))
    fwd = flop_registry[torch.ops.repro_torch.flash_attention]
    bwd = flop_registry[torch.ops.repro_torch.flash_attention_bwd]
    assert fwd(q, k, v, causal, window, q_offset, kv_len, True, out_val=None) == \
        2 * B * H * pairs * (Dk + Dv)
    assert bwd(q, k, v, q, q, q, causal, window, q_offset, kv_len, out_val=None) == \
        2 * B * H * pairs * (3 * Dk + 2 * Dv)


def _kernel_path():
    """The models' entry points pointed at the custom ops (the card's path)
    whatever the device, and each kernel call stood in by its plain version,
    counted; any build fails."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(q, k, v, with_lse=False, **kw):
        calls["fwd"] += 1
        o = fa_ops.chunked_attention(q, k, v, **kw)
        return (o, fa_ref.lse_reference(q, k, v, **kw)) if with_lse else o

    def bwd(q, k, v, o, dout, lse, **kw):
        calls["bwd"] += 1
        return fa_ref.flash_attention_bwd_reference(q, k, v, o, dout, lse=lse, **kw)

    def flash(q, k, v, *, causal=True, window=None, q_offset=0, kv_len=None):
        return fa_ops.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                           q_offset=q_offset, kv_len=kv_len)

    def counted(kind, plain):
        def stand_in(*args, grad=False):
            calls[kind] += 1
            return plain(*args)
        return stand_in

    def refuse():
        raise AssertionError("a kernel was built")
    patches = [mock.patch.object(attention, "flash_attention", flash),
               mock.patch.object(fa_ops, "flash_attention_fwd", fwd),
               mock.patch.object(fa_ops, "flash_attention_bwd", bwd),
               mock.patch.object(rglru, "rglru_scan", scan_ops.rglru_scan_cuda),
               mock.patch.object(scan_ops, "rglru_scan_fwd", counted("fwd", scan_ref.rglru_reference)),
               mock.patch.object(scan_ops, "rglru_scan_bwd",
                                 counted("bwd", scan_ref.rglru_scan_bwd_reference)),
               mock.patch.object(rwkv6, "rwkv6_wkv", wkv_ops.rwkv6_wkv_cuda),
               mock.patch.object(wkv_ops, "rwkv6_wkv_fwd", counted("fwd", wkv_ref.rwkv6_reference)),
               mock.patch.object(wkv_ops, "rwkv6_wkv_bwd",
                                 counted("bwd", wkv_ref.rwkv6_wkv_bwd_reference))]
    patches += [mock.patch.object(mod, name, refuse) for mod in (fa_kernel, scan_kernel,
                                                                  wkv_kernel)
                for name in ("build", "build_bwd")]
    return calls, patches


@pytest.mark.parametrize("arch, kernels", [
    ("qwen3-1.7b", {"flash_attention": 5, "flash_attention_bwd": 2}),
    ("rwkv6-7b", {"rwkv6_wkv": 5, "rwkv6_wkv_bwd": 2}),
    ("recurrentgemma-2b", {"rglru_scan": 8, "rglru_scan_bwd": 4, "flash_attention": 4,
                           "flash_attention_bwd": 2})])
def test_a_trace_on_the_kernel_path_reaches_the_fake_implementations(arch, kernels):
    """On the kernel path the (1, 1) trace calls each custom op (the
    launches of a train step of 2 layers, remat full) and no kernel or
    stand-in: a fake tensor never reaches ctypes, and no launch is counted.
    The traced FLOPs equal FlopCounterMode's on the real step (stand-ins
    for the kernels): the same ops, the same formulas, as the card checks
    at full width; recurrentgemma-2b's sharded path attends its 16 padded
    heads, as the reference does, where the unsharded one leaves the 6
    padded ones out."""
    cfg = get_config(arch).reduced()
    B, S = 2, 32
    calls, patches = _kernel_path()
    fa_kernel.reset_launches()
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        rec = dryrun.run_cell(cfg, ShapeConfig("t", S, B, "train"), "host1x1", device="cpu")
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["ops"]["kernels"] == kernels
        assert calls == {"fwd": 0, "bwd": 0} and fa_kernel.flash_attention_fwd.launches == 0
        rng = np.random.default_rng(0)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))),
                 "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))}
        state = init_train_state(lm.init_params(cfg, torch.Generator().manual_seed(0),
                                                torch.bfloat16, "cpu"))
        with FlopCounterMode(display=False) as counter:
            make_train_step(cfg, remat="full", ce_chunk=512)(state, batch)
    assert calls["bwd"] > 0
    if arch == "recurrentgemma-2b":
        assert rec["ops"]["flops"] > counter.get_total_flops()
    else:
        assert rec["ops"]["flops"] == counter.get_total_flops()

