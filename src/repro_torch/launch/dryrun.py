"""Compile-free dry-run of every (arch x shape x mesh) cell, priced on an
H100 profile (``repro.launch.dryrun`` twin).

Each cell's step (train, prefill or decode) runs once under
``FakeTensorMode`` on a DTensor mesh of the production shape, over a fake
process group of the mesh's size that the dry-run starts and destroys
itself: abstract bf16 params, f32 master, mu and nu (ZeRO-1), the cell's
cache and batch, every tensor distributed by its spec tree, nothing
allocated, nothing sent.  ``op_analysis.OpAnalysis`` reads the per-device
FLOPs, bytes, collective bytes and peak memory from the local ops, and
``roofline`` prices them on ``types.H100_SXM``: the data sheet's numbers,
not a measurement.

The mesh is ``"cuda"`` unless the caller passes ``--device cpu``: on a
CUDA mesh the trace reaches the kernels' custom ops (their fake
implementations and FLOP formulas); on a CPU mesh the entry points take the
plain versions (``flash_attention`` on a CPU tensor is ``chunked_attention``),
and the record says so.  Without CUDA built in, ``--device cuda`` fails; the
dry-run never moves to the CPU by itself.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k \\
      --device cpu --reduced     # here, on a CPU host: plain versions
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import pathlib
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.configs import ARCHS, SHAPES, applicable, get_config, get_shape
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.op_analysis import OpAnalysis
from repro_torch.models import lm
from repro_torch.optim import train_state_specs
from repro_torch.sharding import make_rules, mesh_axes, placements_for, use_mesh_rules
from repro_torch.train import (batch_specs, ideal_bytes, input_specs, make_decode_step,
                               make_prefill_step, make_train_step, useful_flops)
from repro_torch.tree import is_spec, leaves, unflatten
from repro_torch.types import H100_SXM

BUILD_OUT = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"
MESH_SHAPES = {"pod16x16": (16, 16), "pod2x16x16": (2, 16, 16), "host1x1": (1, 1)}


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0,
    destroyed on the way out whatever happens inside."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run starts its own fake process group; "
                           "one is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _distribute(tree, specs, mesh):
    """Each tensor of ``tree`` as a DTensor with its spec's placements; each
    rank keeps its own shard, nothing is sent."""
    return unflatten(tree, [
        distribute_tensor(t, mesh, placements_for(s, mesh, t.ndim), src_data_rank=None)
        for t, s in zip(leaves(tree), leaves(specs, is_spec), strict=True)])


def _local(t):
    return t._local_tensor if isinstance(t, DTensor) else t


def _local_bytes(tree) -> int:
    return sum(_local(t).nbytes for t in leaves(tree) if isinstance(t, torch.Tensor))


def _fake_like(tree, device, dtype=None):
    """Tensors on ``device`` (fake, under a fake mode) of the shapes (and
    dtypes, or ``dtype``) of the meta tensors of ``tree``."""
    return unflatten(tree, [torch.empty(t.shape, dtype=dtype or t.dtype, device=device)
                            for t in leaves(tree)])


def trace_cell(cfg, shape, mesh, rules, *, remat="full", ce_chunk=512, microbatch=1):
    """One step of the cell on fake tensors on ``mesh``.  Returns (the
    step's OpAnalysis, the bytes a device holds of its arguments, of its new
    outputs and of its outputs that are its arguments updated in place,
    seconds).

    The state, cache and batch are fake; the step itself runs outside the
    fake mode, which each op on a fake tensor enters for that op alone, so
    DTensor's sharding propagation (which computes placements' offsets with
    small tensors of its own) runs on real values.  The step's own small
    constants (an arange, a mask) are real, and the fake mode takes them in
    (``allow_non_fake_inputs``)."""
    device = mesh.device_type
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    aparams = lm.abstract_params(cfg, torch.bfloat16)
    pspecs = lm.param_specs(cfg, rules)
    B, S = shape.global_batch, shape.seq_len
    with fake:
        batch = _distribute(_fake_like(input_specs(cfg, shape), device),
                            batch_specs(cfg, shape, rules), mesh)
        params = _distribute(_fake_like(aparams, device), pspecs, mesh)
        args = [params, batch]
        cache = None
        if shape.kind == "train":
            sspecs = train_state_specs(pspecs, aparams, mesh, rules)
            state = {"params": params, "step": torch.zeros((), dtype=torch.int32, device=device)}
            for k in ("master", "mu", "nu"):
                state[k] = _distribute(_fake_like(aparams, device, torch.float32), sspecs[k],
                                       mesh)
            args = [state, batch]
        elif cfg.has_decoder:
            cspecs = lm.cache_specs(cfg, B, S, rules)
            layers = _distribute(_fake_like(lm.abstract_cache(cfg, B, S), device),
                                 cspecs["layers"], mesh)
            cache = {"pos": S - 1 if shape.kind == "decode" else 0, "layers": layers}
            args.append(cache)
    analysis = OpAnalysis()
    analysis.given(leaves(args))
    t0 = time.perf_counter()
    with use_mesh_rules(mesh, rules), analysis.counting():
        if shape.kind == "train":
            out = make_train_step(cfg, remat=remat, ce_chunk=ce_chunk,
                                  microbatch=microbatch)(state, batch)
        elif shape.kind == "prefill":
            with torch.no_grad():
                out = make_prefill_step(cfg)(params, cache, batch)
        else:
            with torch.no_grad():
                out = make_decode_step(cfg)(params, cache, batch)
    seconds = time.perf_counter() - t0
    given = {id(_local(t).untyped_storage()) for t in leaves(args) if isinstance(t, torch.Tensor)}
    outs = [_local(t) for t in leaves(out) if isinstance(t, torch.Tensor)]
    alias = sum(t.nbytes for t in outs if id(t.untyped_storage()) in given)
    memory = {"argument_bytes": _local_bytes(args),
              "output_bytes": sum(t.nbytes for t in outs) - alias, "alias_bytes": alias}
    return analysis, memory, seconds


def roofline(totals, cfg, shape, n_chips, profile=H100_SXM, tp=16):
    """Three roofline terms (seconds) from per-device totals."""
    compute_s = totals["flops"] / profile.peak_flops
    memory_s = totals["bytes"] / profile.hbm_bw
    collective_s = totals["collective_bytes"] / profile.link_bw
    model_fl = useful_flops(cfg, shape)
    total_flops = totals["flops"] * n_chips
    ideal_b = ideal_bytes(cfg, shape, n_chips=n_chips, tp=tp)
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    bound_s = max(terms.values())
    ideal_s = model_fl / (n_chips * profile.peak_flops)
    return {
        **terms,
        "dominant": dominant,
        "model_flops": model_fl,
        "hlo_flops_total": total_flops,
        "useful_flop_ratio": (model_fl / total_flops if total_flops else 0.0),
        "ideal_bytes_per_dev": ideal_b,
        "ideal_memory_s": ideal_b / profile.hbm_bw,
        "roofline_fraction": (ideal_s / bound_s) if bound_s else 0.0,
        "step_lower_bound_s": bound_s,
    }


def run_cell(arch, shape, mesh_tag="pod16x16", *, device="cuda", remat="full", ce_chunk=512,
             seq_shard=False, microbatch=1, profile=H100_SXM):
    """The JSON record of one cell.  ``arch``, ``shape``: names or configs;
    ``mesh_tag``: "pod16x16", "pod2x16x16" or "host1x1" (one rank, as a
    single card runs the step).  A failure is recorded, not raised."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = get_shape(shape) if isinstance(shape, str) else shape
    ok, why = applicable(cfg, shape)
    rec = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_tag, "remat": remat,
           "seq_shard": seq_shard, "microbatch": microbatch, "device": device,
           "kernels": ("the custom ops' fake implementations" if device == "cuda"
                       else "the plain versions")}
    if not ok:
        rec.update(status="skip", reason=why)
        return rec
    n_chips = 1
    for s in MESH_SHAPES[mesh_tag]:
        n_chips *= s
    try:
        with fake_group(n_chips):
            mesh = (make_host_mesh(device) if mesh_tag == "host1x1"
                    else make_production_mesh(multi_pod=mesh_tag == "pod2x16x16", device=device))
            rules = make_rules(cfg, mesh, seq_shard=seq_shard, global_batch=shape.global_batch)
            analysis, memory, seconds = trace_cell(cfg, shape, mesh, rules, remat=remat,
                                                   ce_chunk=ce_chunk, microbatch=microbatch)
        ops = analysis.as_dict(breakdown=True)
        per_dev = memory["argument_bytes"] + analysis.peak_temp_bytes
        rec.update(
            status="ok",
            n_chips=n_chips,
            lower_s=round(seconds, 2),  # the trace: nothing is compiled
            compile_s=None,
            memory={
                **memory,
                "temp_bytes": analysis.peak_temp_bytes,
                "per_device_bytes": per_dev,
                "fits_hbm": bool(per_dev < profile.hbm_per_chip),
            },
            ops=ops,
            roofline=roofline(ops, cfg, shape, n_chips, profile,
                              tp=mesh_axes(mesh)["model"]),
            profile=dataclasses.asdict(profile),
        )
    except Exception as e:  # noqa: BLE001 - record the failure, don't stop the matrix
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="compile-free dry-run priced on an H100 profile")
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--remat", default="full", choices=["full", "dots", "none"])
    ap.add_argument("--ce-chunk", type=int, default=512)
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the mesh's device: cuda reaches the kernels' custom ops, cpu the "
                         "plain versions")
    ap.add_argument("--reduced", action="store_true", help="the reduced (CPU smoke) configs")
    ap.add_argument("--out", default=str(BUILD_OUT))
    ap.add_argument("--tag", default="baseline")
    args = ap.parse_args(argv)
    # DTensor warns on each redistribution it does in two collectives
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    if args.device == "cuda" and not torch.backends.cuda.is_built():
        ap.error("--device cuda: this torch has no CUDA built in; pass --device cpu for a "
                 "CPU mesh (the plain versions)")
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    meshes = ["pod2x16x16", "pod16x16"] if args.both_meshes else (
        ["pod2x16x16"] if args.multi_pod else ["pod16x16"])

    outdir = pathlib.Path(args.out) / args.tag
    outdir.mkdir(parents=True, exist_ok=True)
    todo = [(a, s, tag) for a, s in cells for tag in meshes]
    for a, s, tag in todo:
        cfg = get_config(a).reduced() if args.reduced else get_config(a)
        rec = run_cell(cfg, s, tag, device=args.device, remat=args.remat,
                       ce_chunk=args.ce_chunk, seq_shard=args.seq_shard,
                       microbatch=args.microbatch)
        (outdir / f"{a}__{s}__{tag}.json").write_text(json.dumps(rec, indent=1))
        if rec["status"] == "ok":
            r, m = rec["roofline"], rec["memory"]
            extra = (f" dom={r['dominant']} frac={r['roofline_fraction']:.3f}"
                     f" fit={m['fits_hbm']} trace={rec['lower_s']}s")
        elif rec["status"] == "error":
            extra = " " + rec["error"][:160]
        else:
            extra = " " + rec["reason"]
        print(f"[{rec['status']:5s}] {a} x {s} x {tag}{extra}", flush=True)


if __name__ == "__main__":
    main()
