"""Per-device totals of a traced step, from the local ops it runs
(``repro.launch.hlo_analysis`` twin).

The reference reads the compiled per-device HLO.  The port has no compiler:
``OpAnalysis`` is a dispatch mode around one step traced under
``FakeTensorMode`` on a DTensor mesh, and it counts each *local* op, the op
one rank runs on its shards, once:

* flops            - ``torch.utils.flop_counter``'s formula for each op that
                     has one: the products (mm, bmm, ...) and the three
                     kernels' custom ops, whose formulas count the work the
                     kernel does (the visible pairs under the masks);
* bytes            - operand + output bytes of products, kernels, reductions,
                     gathers, scatters, copies and collectives.  Elementwise
                     ops are left out, as ``hlo_analysis`` leaves out the ops
                     XLA fuses into their neighbours: eager PyTorch runs each
                     elementwise op as a kernel of its own, so counting them
                     would price a step that no fusing compiler runs, several
                     times the memory term the reference's rule gives;
* collective bytes - operand bytes of the ``c10d_functional`` collectives
                     that redistributions run, by kind and by the size of
                     the group that runs them;
* peak bytes       - the most bytes that the storages the ops make hold at
                     once on the rank, beside what the step was given
                     (``peak_temp_bytes``).

A DTensor-level op (its arguments DTensors, at the global shapes) is not
counted: the mode defers it to DTensor, whose local ops then come through
the mode; counting both, as ``FlopCounterMode`` around DTensor code does,
gives each product twice.  So is the op DTensor runs on global-shape fake
tensors to find an output's shape (``ShardingPropagator``'s tensor-meta
propagation), which no rank runs.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

COLLECTIVES = {"all_gather_into_tensor": "all-gather", "reduce_scatter_tensor": "reduce-scatter",
               "all_reduce": "all-reduce", "all_to_all_single": "all-to-all",
               "broadcast": "broadcast"}

# aten ops whose operand and output bytes count as memory traffic (besides
# the products, the kernels and the collectives): reductions, gathers,
# scatters and copies.
MEM_OPS = frozenset({
    # reductions
    "sum", "mean", "amax", "amin", "max", "min", "logsumexp", "var", "var_mean", "std",
    "norm", "linalg_vector_norm", "prod", "cumsum", "argmax", "argmin", "sort", "topk",
    "_softmax", "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data",
    "searchsorted", "any", "all",
    # gathers and scatters
    "index", "index_select", "gather", "embedding", "take", "index_put", "index_put_",
    "_index_put_impl_", "scatter", "scatter_", "scatter_add", "scatter_add_", "index_add",
    "index_add_", "index_copy", "index_copy_", "embedding_dense_backward", "masked_scatter",
    # copies
    "copy_", "clone", "_to_copy", "cat", "stack", "constant_pad_nd", "roll", "repeat",
    "repeat_interleave", "slice_scatter", "select_scatter", "split_with_sizes_copy",
    "_unsafe_index", "flip",
})


def _tensor_bytes(xs) -> float:
    return float(sum(x.numel() * x.element_size() for x in xs if isinstance(x, torch.Tensor)))


class OpAnalysis(TorchDispatchMode):
    """Counts the local ops of the code run under it (see the module's
    docstring); ``as_dict()`` gives the totals, the reference's keys."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collective_bytes = 0.0
        self.collectives = defaultdict(float)
        self.collective_by_group = defaultdict(float)
        self.bytes_by_kind = defaultdict(float)
        self.dots = 0
        self.kernels = defaultdict(int)
        self.live_bytes = 0
        self.peak_temp_bytes = 0
        self._storages = WeakIdKeyDictionary()  # storages the ops made, still alive
        self._shadow = 0  # > 0 inside DTensor's tensor-meta propagation

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it; its local ops come back here
        out = func(*args, **kwargs)
        if self._shadow:
            return out
        if func is not torch.ops._c10d_functional.wait_tensor.default:  # its input's buffer
            self._hold(out)
        packet = func._overloadpacket
        ns, name = packet._qualified_op_name.split("::")
        operands = [x for x in tree_flatten((args, kwargs))[0] if isinstance(x, torch.Tensor)]
        if ns == "_c10d_functional" and name in COLLECTIVES:
            kind = COLLECTIVES[name]
            nbytes = _tensor_bytes(operands[:1])
            group = dist.distributed_c10d._resolve_process_group(args[-1]).size()
            self.collective_bytes += nbytes
            self.collectives[kind] += nbytes
            self.collective_by_group[f"{kind}@{group}"] += nbytes
            self._charge(kind, operands[:1], out)
            return out
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            if ns == "repro_torch":
                self.kernels[name] += 1
                self._charge(f"kernel {name}", operands, out)
            else:
                self.dots += 1
                self._charge("product", operands, out)
        elif ns == "aten" and name in MEM_OPS:
            self._charge(name, operands, out)
        return out

    def given(self, tensors):
        """Mark the storages of the step's arguments (the local shards of
        DTensors) as held already: a view of one holds no new bytes."""
        for t in tensors:
            if not isinstance(t, torch.Tensor):
                continue
            t = t._local_tensor if isinstance(t, DTensor) else t
            self._storages[t.untyped_storage()] = 0

    def _hold(self, out):
        """Count the bytes of each new storage among out's tensors while it lives."""
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._storages:
                continue
            self._storages[st] = n = st.nbytes()
            self.live_bytes += n
            self.peak_temp_bytes = max(self.peak_temp_bytes, self.live_bytes)
            weakref.finalize(st, self._release, n)

    def _release(self, n):
        self.live_bytes -= n

    def _charge(self, kind, operands, out):
        nbytes = _tensor_bytes(operands) + _tensor_bytes(tree_flatten(out)[0])
        self.bytes += nbytes
        self.bytes_by_kind[kind] += nbytes

    @contextlib.contextmanager
    def counting(self):
        """Enter the mode, with DTensor's tensor-meta propagation marked as
        not a rank's work."""
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        propagate = ShardingPropagator._propagate_tensor_meta_non_cached

        def marked(prop, op_schema):
            self._shadow += 1
            try:
                return propagate(prop, op_schema)
            finally:
                self._shadow -= 1
        ShardingPropagator._propagate_tensor_meta_non_cached = marked
        try:
            with self:
                yield self
        finally:
            ShardingPropagator._propagate_tensor_meta_non_cached = propagate

    def as_dict(self, breakdown: bool = False) -> dict:
        d = {"flops": self.flops, "bytes": self.bytes,
             "collective_bytes": self.collective_bytes,
             "collectives": dict(self.collectives),
             "collective_by_group": dict(self.collective_by_group),
             "dots": self.dots, "kernels": dict(self.kernels),
             "peak_temp_bytes": self.peak_temp_bytes}
        if breakdown:
            d["bytes_by_kind"] = dict(sorted(self.bytes_by_kind.items(), key=lambda kv: -kv[1]))
        return d
