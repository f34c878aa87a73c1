"""Cost counter over the aten ops a step executes: flops, bytes,
collectives, marked kernel regions.

PyTorch counterpart of ``repro.launch.hlo_analysis``.  PyTorch has no HLO
to parse, so the counter reads what runs: ``CostCounter`` is a
``TorchDispatchMode`` that sees every aten op below autograd (forward,
backward and recomputation alike) and tallies

  * flops            — matrix products and convolutions (``mm``, ``bmm``,
                       ``addmm``, ``baddbmm``, convolution and its
                       backward), by ``torch.utils.flop_counter``'s
                       registry (2 x result x contraction);
  * bytes accessed   — each op's tensor inputs plus the outputs it writes.
                       This is the *eager* model: every aten op reads and
                       writes device memory, where XLA's counts stop at a
                       fusion's boundary, so a chain of elementwise ops
                       counts once per op.  View and allocation ops touch
                       nothing; a gather (index, embedding) reads the rows
                       it returns, not its whole source (2 x result +
                       indices); a scatter into a buffer (``index_put_``,
                       ``index_copy_``, ...) moves its payload, not the
                       buffer (2 x the inputs but the destination), as the
                       reference's analyser prices slices and in-place
                       updates;
  * bytes accessed without copies — the same without ``copy_`` and
                       ``clone`` (the reference's ``count_copies=False``);
  * collective bytes — result bytes of the functional collectives DTensor
                       issues (and of ``torch.distributed``'s c10d ops), by
                       kind;
  * marked bytes     — the bytes of ops run inside a ``KERNEL_<name>``
                       region (``kernels.kernel_region``), with the
                       region's entries (``region_entries``);
  * trip counts      — PyTorch has no while loop: a Python loop counts
                       every pass by itself, so this field now holds the
                       block applications of each stacked block list (the
                       passes ``kernels.note_loop`` reports), not loop
                       bounds recovered from a condition.  A loop that
                       shape analysis runs once in place of n passes (the
                       sLSTM recurrence on meta) counts under
                       ``kernels.repeated(n)``, multiplied by n.

Counts are per device.  Under DTensor the counter returns
``NotImplemented`` for the DTensor-level op, so DTensor runs its sharding
and redistribution and the counter sees the local shard's ops and the
collectives that come out of it; the reference's counts come from the
post-SPMD module, which is per device too.  A kernel launched through
ctypes is invisible to the counter (it sees only the wrapper's
allocations); its region's entries still count.

Validated against analytic counts in ``tests/test_torch_cost_analysis.py``
(every case of ``tests/test_hlo_analysis.py``).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import kernels

aten = torch.ops.aten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast")

#: op names (overload packet name, namespace stripped) -> collective kind
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "broadcast", "broadcast": "broadcast",
}

_FLOP_OPS = (aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten.convolution,
             aten._convolution, aten.convolution_backward)

#: ops that read only the rows they return
_GATHER_OPS = {aten.index, aten.embedding, aten.gather, aten.index_select,
               aten.take_along_dim}
#: ops that write a payload into a buffer, not read it whole
_SCATTER_OPS = {aten.index_put_, aten.index_put, aten._index_put_impl_,
                aten.index_copy_, aten.index_copy, aten.index_add_,
                aten.index_add, aten.scatter_, aten.scatter,
                aten.scatter_add_, aten.scatter_add}
#: ops that allocate without touching memory
_ALLOC_OPS = {aten.empty, aten.empty_like, aten.empty_strided,
              aten.new_empty, aten.new_empty_strided}
_COPY_OPS = {aten.copy_, aten.clone}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class CostCounter(TorchDispatchMode):
    """Tallies the ops run under it (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.bytes_no_copy = 0.0
        self.coll_bytes = {k: 0.0 for k in COLLECTIVES}
        self.coll_counts = {k: 0 for k in COLLECTIVES}
        self.marked: dict[str, float] = {}
        self.region_entries: dict[str, int] = {}
        self.loops: list[int] = []
        self._scale = [1]

    # -- the kernels package's listener hooks ------------------------------------------

    def region_entered(self, name: str) -> None:
        self.region_entries[name] = self.region_entries.get(name, 0) + 1

    def loop_ran(self, name: str, passes: int) -> None:
        self.loops.append(passes)

    def repeat_enter(self, times: int) -> None:
        self._scale.append(self._scale[-1] * times)

    def repeat_exit(self) -> None:
        self._scale.pop()

    def __enter__(self):
        kernels._LISTENERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kernels._LISTENERS.remove(self)
        return super().__exit__(*exc)

    # -- counting ------------------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor shard and redistribute; its local ops come back
            return NotImplemented
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation infers global shapes on fake
            # tensors: no rank runs that op
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = getattr(func, "_overloadpacket", None)
        if packet is None:
            return
        scale = self._scale[-1]
        kind = _COLLECTIVE_OPS.get(packet.__name__)
        if kind is not None:
            moved = scale * sum(_nbytes(t) for t in tree_leaves(out))
            self.coll_bytes[kind] += moved
            self.coll_counts[kind] += scale
            return
        if packet.__name__ == "wait_tensor":
            return
        if packet in _FLOP_OPS and packet in flop_registry:
            self.flops += scale * float(flop_registry[packet](
                *args, **kwargs, out_val=out))
        moved = scale * self._op_bytes(func, packet, args, kwargs, out)
        self.bytes += moved
        if packet not in _COPY_OPS:
            self.bytes_no_copy += moved
        region = kernels.current_region()
        if region is not None:
            self.marked[region] = self.marked.get(region, 0.0) + moved

    @staticmethod
    def _op_bytes(func, packet, args, kwargs, out) -> float:
        if func.is_view or packet in _ALLOC_OPS:
            return 0.0
        inputs = [t for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)]
        if packet in _GATHER_OPS:
            result = sum(_nbytes(t) for t in tree_leaves(out))
            index = sum(_nbytes(t) for t in inputs[1:]
                        if not t.is_floating_point())
            return 2.0 * result + index
        if packet in _SCATTER_OPS:
            return 2.0 * sum(_nbytes(t) for t in inputs[1:])
        returns = func._schema.returns
        outs = out if isinstance(out, (tuple, list)) else (out,)
        written = sum(_nbytes(o) for o, r in zip(outs, returns)
                      if r.alias_info is None)
        return float(sum(_nbytes(t) for t in inputs) + written)

    # -- result --------------------------------------------------------------------------

    def result(self) -> dict:
        """The reference's ``analyze()`` keys (plus ``region_entries``)."""
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes,
            "bytes_accessed_no_copy": self.bytes_no_copy,
            "collectives": {"bytes": dict(self.coll_bytes),
                            "counts": dict(self.coll_counts),
                            "total_bytes": int(sum(self.coll_bytes.values()))},
            "trip_counts": list(self.loops),
            "marked_bytes": dict(self.marked),
            "region_entries": dict(self.region_entries),
        }


def analyze(fn: Callable, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under a ``CostCounter``; returns its
    counts (``CostCounter.result``)."""
    with CostCounter() as counter:
        fn(*args, **kwargs)
    return counter.result()
