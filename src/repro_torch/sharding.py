"""Logical-axis sharding rules for the production mesh, on DTensor
(``repro.sharding`` twin).

Models name each dim of a parameter or activation by a *logical* axis; a
per-arch rule table (``make_rules``, the JAX package's table) maps those to
the axes of a ``DeviceMesh``.  A spec is a neutral tuple with one entry a
tensor dim: None, a mesh axis name, or a tuple of names (``("pod",
"data")``); ``placements_for`` turns it into DTensor placements, one
``Shard(dim)`` on each mesh dim a tensor dim is split over.

``use_mesh_rules`` installs a (mesh, rules) context, so deep model code can
call ``constrain(x, *logical)`` without threading the mesh everywhere: on a
DTensor inside the context it redistributes x to the rules' placements;
outside the context, or on a plain tensor, it returns x, as the reference's
does.  The context is the process's, not a thread's: autograd runs a CUDA
tensor's backward, and a checkpoint's recomputation, on a thread of its
own, which must take the same path as the forward did.  The models'
constants (positions, an arange, a head mask) become DTensors through
``constant``; ``local_call`` runs a kernel on each rank's shards
(``local_map``), with placements from the rules.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import local_map

_STACK: list = []  # (mesh, rules) contexts, innermost last

Rules = Dict[str, Optional[object]]  # logical name -> mesh axis (str | tuple | None)
Spec = Tuple[Optional[object], ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh, or of any object with ``axis_names``
    and a ``shape`` dict (a stand-in mesh for the rule tables)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def _prod(sizes, axes):
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def make_rules(cfg, mesh, *, seq_shard: bool = False,
               global_batch: Optional[int] = None) -> Rules:
    """The logical -> mesh-axis table for one architecture on one mesh.

    seq_shard: also shard activation *sequence* dims over "model".
    global_batch: if given and not divisible by the data-parallel world
    size, the outer batch axes are shed (pod first, then data) until it
    divides, or the batch is replicated (long_500k's global batch of 1).
    """
    sizes = mesh_axes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes) or None
    if dp is not None and global_batch is not None:
        while dp and global_batch % _prod(sizes, dp) != 0:
            dp = dp[1:]
        dp = dp or None
    tp = "model" if "model" in sizes else None
    tp_size = sizes["model"] if tp else 1

    def div(n):  # shard over model only if divisible
        return tp if tp and n % tp_size == 0 else None

    kv_heads_shardable = (tp is not None and cfg.n_kv_heads % tp_size == 0
                          and cfg.attn_kind == "gqa")
    return {
        "batch": dp,
        "seq": tp if (seq_shard and tp) else None,
        # decode cache: shard kv heads when they divide the model axis,
        # otherwise the cache's sequence dim (flash-decoding in SPMD)
        "kv_seq": None if kv_heads_shardable else tp,
        # q heads shard over "model" even when the count does not divide it
        # (padded_heads is a multiple of 16; DTensor splits unevenly like chunk)
        "heads": tp if cfg.n_heads > 1 else None,
        "kv_heads": tp if kv_heads_shardable else None,
        "head_dim": None,
        "qk_dim": None,
        "v_dim": None,
        "embed": None,
        "ffn": div(cfg.d_ff),
        "expert_ffn": None,  # expert parallelism takes "model" on the expert dim
        "shared_ffn": div(cfg.moe.d_shared) if (cfg.moe and cfg.moe.n_shared) else None,
        "vocab": div(cfg.padded_vocab),
        "experts": tp,
        "capacity": None,
        "layers": None,
        "lru_blocks": div(16) if tp_size in (1, 2, 4, 8, 16) else None,
        "lru_width": None,
        "lora": None,
        "stats": None,
    }


def entry(mesh_axes_):
    """One spec entry as PartitionSpec writes it: a 1-tuple of axes is its axis."""
    if isinstance(mesh_axes_, tuple) and len(mesh_axes_) == 1:
        return mesh_axes_[0]
    return mesh_axes_


def spec_for(axes: Tuple[Optional[str], ...], rules: Rules) -> Spec:
    """The spec of a tensor whose dims have the logical ``axes``, trailing
    Nones trimmed, as the reference's PartitionSpec."""
    parts = [None if a is None else entry(rules.get(a)) for a in axes]
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def placements_for(spec: Spec, mesh, ndim: int) -> tuple:
    """DTensor placements of a spec on ``mesh``: Shard(dim) on each mesh dim
    that tensor dim ``dim`` is split over (in the order the spec names
    them, outer first), Replicate on the rest and on a mesh dim of size 1,
    where a split splits nothing (and DTensor would refuse to view a dim
    "sharded" so)."""
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than a {ndim}-d tensor has dims")
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} uses mesh axis {a!r} twice")
            out[i] = Shard(dim)
    return tuple(Replicate() if mesh.size(i) == 1 else p for i, p in enumerate(out))


@contextlib.contextmanager
def use_mesh_rules(mesh, rules: Rules):
    _STACK.append((mesh, rules))
    try:
        yield
    finally:
        _STACK.pop()


def current() -> Optional[Tuple[object, Rules]]:
    return _STACK[-1] if _STACK else None


def placements(ndim: int, *logical: Optional[str]) -> tuple:
    """The current rules' placements for a tensor of ``ndim`` dims whose
    leading dims have the ``logical`` axes."""
    mesh, rules = current()
    return placements_for(spec_for(tuple(logical), rules), mesh, ndim)


def constrain(x, *logical: Optional[str]):
    """Pin x's sharding by logical axis names; no-op outside a mesh context
    or on a plain tensor."""
    if current() is None or not isinstance(x, DTensor):
        return x
    want = placements(x.ndim, *logical)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def constant(like, t: torch.Tensor, *logical: Optional[str]):
    """``t``, a tensor every rank holds whole and alike (positions, an
    arange), as a DTensor with the rules' placements when ``like`` is a
    DTensor in a mesh context: each rank keeps its own shard, nothing is
    sent.  Else ``t``."""
    if current() is None or not isinstance(like, DTensor):
        return t
    return distribute_tensor(t, like.device_mesh, placements(t.ndim, *logical),
                             src_data_rank=None)


def _summed(ndim, logical, summed):
    """Placements of an input with ``logical`` axes whose gradient on each
    rank is a partial sum over the mesh axes of the logical names ``summed``."""
    mesh, rules = current()
    out = list(placements(ndim, *logical))
    names = list(mesh.mesh_dim_names)
    for name in summed:
        entry = rules.get(name)
        for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            if mesh.size(names.index(a)) > 1:
                out[names.index(a)] = Partial()
    return tuple(out)


def local_call(fn, args, in_axes, out_axes, grad_sum=None, out_sum=None):
    """``fn(*args)`` on each rank's shards under the current rules.

    in_axes: the logical axes of each argument (None for an argument that is
    not a DTensor: a Python value, None); out_axes: those of each result.
    Each DTensor argument is redistributed to its axes' placements, fn runs
    on the local tensors, and its results come back as DTensors.
    grad_sum: {argument index: logical names} for an argument every rank
    along those names' mesh axes reads whole (a parameter beside a
    batch-sharded activation, kv heads beside sharded query heads): its
    gradient on each rank is a partial sum over them.  out_sum: {result
    index: logical names} for a result each rank holds a partial sum of
    over those names' mesh axes.
    """
    mesh, _ = current()
    grad_sum, out_sum = grad_sum or {}, out_sum or {}
    in_pl, grad_pl = [], []
    for i, (a, axes) in enumerate(zip(args, in_axes)):
        if axes is None:
            in_pl.append(None)
            grad_pl.append(None)
            continue
        in_pl.append(list(placements(a.ndim, *axes)))
        grad_pl.append(list(_summed(a.ndim, axes, grad_sum.get(i, ()))))
    # a list of placements is one result's; a tuple of lists, one a result
    out_pl = [list(_summed(len(axes), axes, out_sum.get(i, ())))
              for i, axes in enumerate(out_axes)]
    out_pl = out_pl[0] if len(out_pl) == 1 else tuple(out_pl)
    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def local_offset(x: DTensor, dim: int) -> int:
    """The global index of this rank's first element along ``dim`` of x:
    DTensor splits a dim like ``torch.chunk``, over each mesh dim that
    shards it in turn."""
    mesh, coord = x.device_mesh, x.device_mesh.get_coordinate()
    offset, size = 0, x.shape[dim]
    for md, p in enumerate(x.placements):
        if p.is_shard(dim):
            chunk = -(-size // mesh.size(md))
            start = min(coord[md] * chunk, size)
            offset, size = offset + start, min(chunk, size - start)
    return offset


def is_sharded(x) -> bool:
    """x is a DTensor inside a mesh context: the model takes its mesh path."""
    return current() is not None and isinstance(x, DTensor)
