"""Hand-written Hopper (sm_90a) kernels for the port's hot paths.

Each kernel package holds its CUDA source (``csrc/*.cu``, a plain C
interface), an ``ops.py`` wrapper and the plain PyTorch version beside it
(``ref.py``).  The wrapper runs the plain version for a tensor on the CPU;
for a tensor on the card it launches the kernel or raises.  On either it
refuses an input that requires grad under grad mode (``refuse_autograd``).
Libraries are built at first use by ``_build.py``.

A wrapper given meta tensors (the dry run's abstract shapes, plain or
DTensor) runs the plain version as shape analysis (``plain_on_meta``):
meta has no data and no device, so this is no fallback.  Each wrapper
marks its work as the region ``KERNEL_<name>`` (``kernel_region``), on
the card around the launch and on meta around the plain version, so the
cost counter (``launch/cost_analysis.py``) attributes the region's bytes
as the reference's ``jax.named_scope("KERNEL_...")`` does.  While
``torch.profiler`` records, the region is also the range
``kernel/<name>`` (``obs.span``), which holds the kernel's launch.
"""

import contextlib
import math

import torch

from repro_torch.obs.ranges import span

#: the regions open now, innermost last
_REGIONS: list[str] = []
#: the cost counters listening (``launch/cost_analysis.CostCounter``)
_LISTENERS: list = []
#: the program's host counters, as (owner, attribute), each registered by
#: ``host_counter`` where it is defined; a CUDA graph's replay runs no
#: Python, so it advances each by what its recorded call added
#: (``models/decode_graph.py``)
HOST_COUNTERS: list[tuple[object, str]] = []


def host_counter(owner, name: str) -> None:
    """Start the counter ``owner.<name>`` at 0 and register it."""
    setattr(owner, name, 0)
    HOST_COUNTERS.append((owner, name))


class DeviceTally:
    """A count that depends on the data, kept on the device: ``add(n)``
    adds a device tensor in place without reading it, so a step adds to it
    with no sync and a CUDA graph's replay adds again; ``value()`` reads
    the sum over devices (one sync each, once the run is over)."""

    def __init__(self):
        self._on: dict = {}

    def add(self, n: torch.Tensor) -> None:
        if n.device.type == "meta":             # shape analysis: no data
            return
        tally = self._on.get(n.device)
        if tally is None:
            tally = self._on[n.device] = torch.zeros(
                (), dtype=torch.int64, device=n.device)
        tally.add_(n)

    def value(self) -> int:
        return sum(int(t) for t in self._on.values())


def device_counter(owner, name: str) -> None:
    """Start the device tally ``owner.<name>`` (``DeviceTally``) at 0: a
    replay repeats its recorded add, so it needs no host step."""
    setattr(owner, name, DeviceTally())


@contextlib.contextmanager
def kernel_region(name: str):
    """Mark the work inside as kernel ``name``'s; each listening counter
    counts the region's entries."""
    _REGIONS.append(name)
    for listener in _LISTENERS:
        listener.region_entered(name)
    try:
        with span(f"kernel/{name}"):
            yield
    finally:
        _REGIONS.pop()


def current_region():
    """The innermost open region's name, or None."""
    return _REGIONS[-1] if _REGIONS else None


@contextlib.contextmanager
def repeated(times: int):
    """The work inside stands for ``times`` passes of a loop that shape
    analysis runs once (on meta): each listening counter multiplies what
    it counts inside by ``times``, as the reference's analyser multiplies
    a while body by its trip count."""
    for listener in _LISTENERS:
        listener.repeat_enter(times)
    try:
        yield
    finally:
        for listener in _LISTENERS:
            listener.repeat_exit()


def note_loop(name: str, passes: int) -> None:
    """Tell the listening counters that a Python loop ``name`` ran
    ``passes`` times (the block applications of a stacked block list)."""
    for listener in _LISTENERS:
        listener.loop_ran(name, passes)


def _state_placements(placements, lead_map: dict):
    """Placements of an output whose tensor dims map from the input's by
    ``lead_map`` (input dim -> output dim); an unmapped sharded dim becomes
    replicated."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for p in placements:
        if isinstance(p, Shard):
            d = lead_map.get(p.dim)
            out.append(Shard(d) if d is not None else Replicate())
        else:
            out.append(p)
    return tuple(out)


def _resolved(placements, ndim: int) -> tuple:
    """``placements`` with partial sums reduced (Replicate) and shards of
    dims past ``ndim`` replicated."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if p.is_partial()
                 or (p.is_shard() and p.dim >= ndim) else p
                 for p in placements)


def plain_on_meta(name: str, fn, q, *args, out_dims=None, align=False,
                  **kw):
    """Run the plain version ``fn(q, *args, **kw)`` on meta tensors under
    the region ``KERNEL_<name>``.  For DTensors it runs on each rank's
    local shards (``local_map``): partial sums are reduced first; the
    other inputs (K, V) take q's batch shards, keep their head shards and
    hold every key of the sequence, or with ``align`` every input takes
    q's placements (its batch, sequence and head shards); the output is
    placed as q (or, for a flat tuple of outputs, by ``out_dims``: per
    output a map from q's tensor dims to its own).  Meta tensors carry shapes only, so ``fn`` may adapt shapes that
    a shard breaks (``gqa_local``)."""
    if q.device.type != "meta":
        raise ValueError(f"{name}: plain_on_meta takes meta tensors, got "
                         f"{q.device}")
    with kernel_region(name):
        from torch.distributed.tensor import DTensor, Replicate
        if not isinstance(q, DTensor):
            return fn(q, *args, **kw)
        from torch.distributed.tensor.experimental import local_map
        q_pl = _resolved(q.placements, q.dim())
        if out_dims is None:
            out = list(q_pl)              # one output: a list of placements
        else:
            out = tuple(list(_state_placements(q_pl, m)) for m in out_dims)

        def placed(a):
            if align or a is q:
                return _resolved(q_pl, a.dim())
            # K / V: the batch (dim 0) sharded as q's, their own head
            # shards (dim 2) kept, every key of the sequence present
            return tuple(qp if qp.is_shard() and qp.dim == 0
                         else p if p.is_shard() and p.dim == 2
                         else Replicate()
                         for qp, p in zip(q_pl, _resolved(a.placements,
                                                          a.dim())))
        ins = tuple(placed(a) if isinstance(a, DTensor) else None
                    for a in (q, *args))
        return local_map(lambda *a: fn(*a, **kw), out_placements=out,
                         in_placements=ins, device_mesh=q.device_mesh,
                         redistribute_inputs=True)(q, *args)


def gqa_local(q: torch.Tensor, *kv: torch.Tensor, head_dim: int) -> tuple:
    """K/V cut to a head count that divides q's along ``head_dim``: a rank
    whose query heads are a shard of a replicated KV set (nemotron's 96/8
    on a 16-way axis) keeps ``gcd`` of the two counts.  Shape analysis
    only: on meta there are no values to pick."""
    h, n = q.shape[head_dim], kv[0].shape[head_dim]
    if h % n == 0:
        return kv
    g = math.gcd(h, n)
    return tuple(t.narrow(head_dim, 0, g) for t in kv)


def refuse_autograd(kernel: str, *tensors) -> None:
    """Raise if grad mode is on and any of ``tensors`` requires grad.

    The kernels are forward-only (their outputs are filled from C and carry
    no ``grad_fn``), as the reference's Pallas kernels have no VJP either:
    a backward pass through one would leave the gradients before it unset,
    with no error.  The check runs on every device, the CPU's plain
    versions included, so a training path that reaches a wrapper fails on
    the CPU as it would on the card.  ``None`` entries are skipped."""
    if not torch.is_grad_enabled():
        return
    if any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: an input requires grad, but the kernel has no "
            f"backward (the reference's Pallas kernel has no VJP in the JAX "
            f"package either); train through the model's train mode, or "
            f"call it under torch.no_grad()")
