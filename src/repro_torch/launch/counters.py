"""Counting what a step does: FLOPs, bytes and collective traffic.

The port's counterpart of ``repro/launch/hlo_counters.py`` (with
``hlo_analysis.collective_bytes`` and ``hlo_shapes.py``).  The reference
lowers a jitted step and walks the compiled HLO; the port's steps are
eager torch, so ``OpCounter`` (a ``TorchDispatchMode``) counts each aten
op as it is dispatched, under the reference analyzer's rules:

* FLOPs — 2·prod(out)·prod(contracted) per matmul-class op (``mm``,
  ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``; 4·B·H·Sq·Skv·D for a
  fused attention op), elementwise work ignored, as in MFU arithmetic;
* bytes — operands plus outputs per op, each tensor at the elements it
  spans (a slice is charged at its own size, a broadcast operand at its
  stored size).  Views and allocations move nothing and are charged 0.
  A write into part of a buffer (``copy_`` into a slice,
  ``index_put_``, ``index_copy_``, ``scatter_``) is charged at the size
  of the update, twice, plus its indices, as the reference charges a
  dynamic-update-slice, not the whole buffer; a gather (``index``,
  ``index_select``, ``gather``, ``embedding``) twice its result plus its
  indices, as the reference charges a gather, not the whole table;
* collectives — result bytes per kind (``c10d`` ops: all-gather,
  all-reduce, reduce-scatter, all-to-all), all-reduce counted twice on
  the wire.

The kernel layer's entry points (``kernels/ops.bitmap_spmm``,
``bitmap_spmm_grouped``, ``block_sparse_matmul``, ``flash_attention``,
``decode_attention`` and ``kernels/nm_spmm.nm_spmm``) report themselves
to the active counter as one op each (``counting.counted``, which calls
``kernel_call``): FLOPs counted densely, 2·M·K·N, as the reference's
analyzer counts its ``xla-oracle`` dot (decode attention 4·B·Hq·C·D over
the whole cache, as its einsums), and the bytes the implementation
fetches (the weight's dense rendering for the plain version, the
format's ``hbm_bytes`` for the card's kernel; decode attention q, both
whole caches and the output), with nothing counted inside.  Given meta tensors an entry point returns an empty
result of the right shape and charges what ``dispatch`` would fetch, so
a step is counted on meta tensors without running it (the reference's
"lowering never executes").  With no counter active the entry points pay
one list check.

``OpCounter.result()`` gives ``{"flops", "bytes", "wire_bytes",
"<kind>_bytes", "<kind>_count"}`` under the reference's keys;
``ops`` lists each counted op (name, FLOPs, bytes) in order, so two
counts of one step can be compared op for op.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.counting import _ACTIVE, tensor_bytes

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "ragged-all-to-all")
_WIRE_FACTOR = {k: (2.0 if k == "all-reduce" else 1.0) for k in COLLECTIVES}

#: the ``c10d`` ops a ``torch.distributed`` collective dispatches, by kind
_C10D = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
}

_MATMUL = {"mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot"}
#: ops that allocate or describe a tensor and move no data
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "lift_fresh", "alias",
         "_unsafe_view", "resize_", "set_", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset"}
#: writes into part of a buffer, charged at the update's size
_PARTIAL_WRITES = {"index_put_", "_index_put_impl_", "index_copy_",
                   "scatter_", "copy_"}
#: reads of part of a tensor by index, charged at the result's size
_GATHERS = {"index", "index_select", "gather", "embedding"}

def _tensors(obj) -> List[torch.Tensor]:
    return [t for t in tree_flatten(obj)[0] if isinstance(t, torch.Tensor)]


def _index_region(dst: torch.Tensor, indices) -> int:
    """Elements ``dst[indices] = ...`` writes."""
    idx = [i for i in indices if i is not None]
    lead = (math.prod(torch.broadcast_shapes(*[i.shape for i in idx]))
            if idx else 1)
    indexed = {d for d, i in enumerate(indices) if i is not None}
    rest = math.prod(n for d, n in enumerate(dst.shape) if d not in indexed)
    return lead * rest


def _partial_write_bytes(name: str, args) -> int:
    dst = args[0]
    esize = dst.element_size()
    if name == "copy_":
        return tensor_bytes(args[1]) + tensor_bytes(dst)
    if name in ("index_put_", "_index_put_impl_"):
        idx = list(args[1])
        return (2 * _index_region(dst, idx) * esize
                + sum(tensor_bytes(i) for i in idx if i is not None))
    # index_copy_(dst, dim, index, source) / scatter_(dst, dim, index, x)
    index = args[2]
    src = args[3] if len(args) > 3 and isinstance(args[3],
                                                  torch.Tensor) else None
    region = src.numel() if src is not None and name == "index_copy_" \
        else index.numel()
    return 2 * region * esize + tensor_bytes(index)


def _matmul_flops(name: str, args, out: torch.Tensor) -> float:
    if name == "dot":
        return 2.0 * args[0].numel()
    a = args[1] if name in ("addmm", "baddbmm", "addmv") else args[0]
    return 2.0 * out.numel() * a.shape[-1]


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched inside ``with OpCounter(...):``.

    ``dispatch`` ("cuda" or "torch") is the kernel dispatch a meta call
    of an entry point is charged as; a call on real tensors is charged
    as it runs (its tensors' device, or its ``impl``)."""

    def __init__(self, dispatch: str = "torch", keep_ops: bool = True):
        super().__init__()
        if dispatch not in ("cuda", "torch"):
            raise ValueError(f"dispatch must be cuda or torch, not "
                             f"{dispatch!r}")
        self.dispatch = dispatch
        self.keep_ops = keep_ops
        self.flops = 0.0
        self.bytes = 0.0
        self.coll: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.coll_n: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.ops: List[Tuple[str, float, int]] = []
        self._inside = 0

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def _add(self, name: str, flops: float, nbytes: int) -> None:
        self.flops += flops
        self.bytes += nbytes
        if self.keep_ops:
            self.ops.append((name, flops, nbytes))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # an op's own implementation may dispatch ops (a meta kernel's
        # Python decomposition does): only the outermost op is counted
        self._inside += 1
        try:
            out = func(*args, **kwargs)
        finally:
            self._inside -= 1
        if self._inside:
            return out
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "c10d":
            kind = _C10D.get(name)
            if kind is not None:
                res = sum(tensor_bytes(t) for t in _tensors(args[0]))
                self.coll[kind] += res
                self.coll_n[kind] += 1
                self._add(f"c10d.{name}", 0.0,
                          sum(tensor_bytes(t) for t in _tensors(args)))
            return out
        if func.is_view or name in _FREE:
            return out
        if name in _PARTIAL_WRITES:
            self._add(name, 0.0, _partial_write_bytes(name, args))
            return out
        if name in _GATHERS:
            index = [t for t in _tensors(args[1:])
                     if not t.is_floating_point()]
            self._add(name, 0.0, 2 * tensor_bytes(out)
                      + sum(tensor_bytes(t) for t in index))
            return out
        flops = 0.0
        if name in _MATMUL:
            flops = _matmul_flops(name, args, out)
        elif "scaled_dot_product" in name and "backward" not in name:
            q, k = args[0], args[1]
            flops = 4.0 * math.prod(q.shape[:-1]) * k.shape[-2] * q.shape[-1]
        nbytes = (sum(tensor_bytes(t) for t in _tensors((args, kwargs)))
                  + sum(tensor_bytes(t) for t in _tensors(out)))
        self._add(name, flops, nbytes)
        return out

    def kernel_call(self, name: str, flops: float, operand_bytes: int,
                    out_shape, out_dtype: torch.dtype,
                    device: torch.device, run: Callable[[], torch.Tensor]
                    ) -> torch.Tensor:
        """One entry point's call as one op: on meta tensors an empty
        result of ``out_shape``, else ``run()`` with nothing inside it
        counted; charged ``flops`` and ``operand_bytes`` plus the
        result's bytes."""
        self._inside += 1
        try:
            if device.type == "meta":
                out = torch.empty(tuple(out_shape), dtype=out_dtype,
                                  device="meta")
            else:
                out = run()
        finally:
            self._inside -= 1
        self._add(name, float(flops), int(operand_bytes) + tensor_bytes(out))
        return out

    def result(self) -> Dict[str, float]:
        """The reference analyzer's keys: ``flops``, ``bytes``,
        ``wire_bytes`` and, for each collective kind seen,
        ``<kind>_bytes`` / ``<kind>_count``."""
        wire = sum(self.coll[k] * _WIRE_FACTOR[k] for k in COLLECTIVES)
        return {"flops": self.flops, "bytes": self.bytes,
                "wire_bytes": wire,
                **{f"{k}_bytes": v for k, v in self.coll.items() if v},
                **{f"{k}_count": v for k, v in self.coll_n.items() if v}}


def to_meta(obj):
    """A copy of a tree of tensors (dicts, lists, tuples, dataclasses
    such as ``BitmapWeight``) with every tensor an empty meta tensor of
    the same shape, dtype and strides; anything else as it is."""
    import dataclasses
    if isinstance(obj, torch.Tensor):
        return torch.empty_strided(obj.shape, obj.stride(), dtype=obj.dtype,
                                   device="meta")
    if isinstance(obj, dict):
        return {k: to_meta(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_meta(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_meta(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init
            and isinstance(getattr(obj, f.name), torch.Tensor)})
    return obj
