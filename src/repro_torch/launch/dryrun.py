"""Multi-pod dry run: drive every (arch x shape x mesh) cell on abstract
tensors and read the roofline terms off the ops it runs.

PyTorch counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell for 256 / 512 placeholder devices and reads the
post-SPMD HLO.  The port opens a process group of the ``"fake"`` backend
with as many ranks (``mesh.fake_world``; opened in ``run_cell``, never at
import), builds the production ``DeviceMesh``, places every parameter and
input as a meta DTensor by ``ShardingRules`` / ``specs``, and runs the
cell's step (a train step with autograd and the remat of
``torch.utils.checkpoint``, a prefill, or one decode step) under the cost
counter (``cost_analysis.CostCounter``), which counts this rank's local
ops and the collectives DTensor issues.  Nothing is allocated: meta
tensors carry shapes only.

The multi-pod mesh (2, 16, 16) runs as (32, 16): its data axes
flattened into one over the same ranks (``mesh.flat_data_mesh``), since
DTensor handles a batch sharded by two mesh axes badly (an exponential
redistribution planner in newer torch, inconsistent local shapes in
older).  The batch shards the same 32 ways; the one difference from the
reference's layout is FSDP ("embed" -> "data"), which then shards over
all 32 data ranks instead of the 16 of a pod.  The record names the mesh
run as ``exec_mesh``.

Ops DTensor has no sharding strategy for (index writes into caches,
top-k and scatter in MoE dispatch) run on each rank's local shard, the
outputs placed as the reference's partitioner keeps such operands (the
first DTensor input's placements): ``_LocalFallback``, an op-level
``local_map``.  Each such op is counted in the record's ``local_ops``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Per cell this writes build/dryrun/<arch>__<shape>__<mesh>.json (the
port's records never go to the reference's artifacts/dryrun/) with the
counts, the three-term roofline and the kernel-substituted memory term.

Roofline constants: one NVIDIA H100 80GB HBM3 (SXM5) at its 700 W limit,
from NVIDIA's H100 Tensor Core GPU data sheet: 989 TFLOP/s dense BF16,
3.35 TB/s HBM3, 450 GB/s NVLink each way (900 GB/s bidirectional).  The
collective term assumes every byte crosses NVLink at that rate.  A 16-wide
model axis spans two 8-GPU hosts, whose traffic between hosts runs on
the network (400 Gb/s InfiniBand NDR per GPU, 50 GB/s), so for such a
mesh the term is a lower bound.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import (ARCH_IDS, SHAPES, InputShape,
                                      ModelConfig, get_config,
                                      shape_applicable)
from repro_torch.launch import cost_analysis
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import (data_axis_names, fake_world,
                                     flat_data_mesh, make_production_mesh,
                                     mesh_chip_count, mesh_shape)
from repro_torch.models import model as model_lib
from repro_torch.models.layers import set_activation_resolver, set_moe_mesh
from repro_torch.models.shardings import ShardingRules
from repro_torch.training.optimizer import AdamWConfig, leaves, tree_map
from repro_torch.training.train_loop import init_train_state, make_train_step

OUT_DIR = os.path.join(os.path.dirname(__file__), "../../../build/dryrun")

# NVIDIA H100 80GB HBM3 (SXM5), 700 W: NVIDIA H100 Tensor Core GPU data sheet
PEAK_FLOPS = 989e12          # dense BF16 tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
LINK_BW = 450e9              # NVLink 4 bytes/s each way (900 GB/s both)


def kernel_bytes(cfg: ModelConfig, shape: InputShape, mesh=None) -> dict:
    """Analytic per-device HBM bytes of the hand-written kernels that
    replace the marked plain regions (the kernels keep logits and decay
    tiles on chip and touch HBM only for Q/K/V/O + states).

    Used for the kernel-substituted memory term: the plain versions
    materialize O(S x block) intermediates that the kernels never write.
    train: fwd + recompute + backward ~ 4x forward traffic (the reference's
    count; the port trains through the plain versions, whose own bytes the
    marked regions do not cover in train mode).  ``mesh`` None: one
    device holding everything (the card).
    """
    if mesh is None:
        shape_of, param_rules = {"model": 1}, {}
    else:
        shape_of = mesh_shape(mesh)
        param_rules = ShardingRules(cfg, mesh).param_rules
    model_n = shape_of["model"]
    data_n = math.prod(n for a, n in shape_of.items() if a != "model")
    B, S = shape.global_batch, shape.seq_len
    b_loc = max(1, B // data_n) if B % data_n == 0 else B
    dt = 2  # bf16

    h_loc = (cfg.n_heads // model_n if param_rules.get("heads") == "model"
             else cfg.n_heads)
    kv_loc = (cfg.n_kv_heads // model_n
              if param_rules.get("kv_heads") == "model" else cfg.n_kv_heads)
    D = cfg.head_dim
    passes = 4 if shape.kind == "train" else 1
    out: dict = {}

    if cfg.family != "ssm" and shape.kind != "decode":
        # flash attention: Q + O (h_loc) and K + V (kv_loc), per layer
        per_layer = (2 * b_loc * S * h_loc * D + 2 * b_loc * S * kv_loc * D) * dt
        n_attn = cfg.n_layers + cfg.encoder_layers
        out["flash_attention"] = passes * n_attn * per_layer
    if shape.kind == "decode" and cfg.family != "ssm":
        # paged decode: read the (seq-sharded) cache once + q/o
        seq_loc = S // model_n if S % model_n == 0 else S
        if cfg.use_mla:
            cache = b_loc * seq_loc * (cfg.kv_lora_rank + cfg.rope_head_dim) * dt
        else:
            cache = 2 * b_loc * seq_loc * cfg.n_kv_heads * D * dt
        n_full = len(cfg.global_layers) if cfg.sliding_window else cfg.n_layers
        n_win = cfg.n_layers - n_full if cfg.sliding_window else 0
        win_cache = (2 * b_loc * min(cfg.sliding_window or S, S)
                     * cfg.n_kv_heads * D * dt)
        out["paged_attention"] = n_full * cache + n_win * win_cache
    if cfg.ssm_kind:
        inner = cfg.ssm_expand * cfg.d_model
        inner_loc = (inner // model_n if param_rules.get("mlp") == "model"
                     else inner)
        per_layer = (8 * b_loc * max(S if shape.kind != "decode" else 1, 1)
                     * inner_loc * dt)
        key = "mlstm_scan" if cfg.ssm_kind == "xlstm" else "ssd_scan"
        out[key] = passes * cfg.n_layers * per_layer
    return out


class _LocalFallback(TorchDispatchMode):
    """An op-level ``local_map`` for DTensor ops with no sharding strategy:
    where DTensor's propagation raises, the op runs on each rank's local
    shards and each output takes the placements of an input whose shard
    has its shape (a gather's follow ``_gather_placements``; an in-place
    op keeps its destination); inputs placed apart are first brought to
    the first input's placements.  A view DTensor refuses runs on a
    contiguous copy of its input, or failing that (a dim sharded
    unevenly) on its input gathered (all but dim 0's shards, or all).
    The local run is meta only: on real data it would be a different
    result, so it raises there.  ``ops`` counts the ops that took either
    way."""

    def __init__(self):
        super().__init__()
        self.ops: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor, Replicate
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except Exception as e:
            failure = e
        name = func._overloadpacket.__name__
        if func.is_view or name == "_unsafe_view":
            src = args[0]
            mesh = src.device_mesh
            outer = next((i for i, p in enumerate(src.placements)
                          if p.is_shard() and p.dim == 0), None)
            # a shard laid out apart (a transpose's) copied, as the reshape
            # of such a tensor does; then the input gathered (collectives
            # the counter sees) but for dim 0's outermost shard; then whole
            tries = [("copied", src.placements),
                     ("gathered", tuple(
                         p if i == outer else Replicate()
                         for i, p in enumerate(src.placements))),
                     ("gathered", tuple(Replicate()
                                        for _ in src.placements))]
            for i, (how, pl) in enumerate(tries):
                x = (src.redistribute(mesh, pl) if pl != src.placements
                     else src).clone(memory_format=torch.contiguous_format)
                try:
                    out = func(x, *args[1:], **kwargs)
                except Exception:
                    if i == len(tries) - 1:
                        raise
                    continue
                key = f"{name}({how})"
                self.ops[key] = self.ops.get(key, 0) + 1
                return out
        from torch.utils._pytree import tree_flatten, tree_unflatten
        flat, spec = tree_flatten((args, kwargs))
        first = next(a for a in flat if isinstance(a, DTensor))
        if first.to_local().device.type != "meta":
            raise failure
        gather = _gather_placements(func, args)

        def run(flat):
            """The op on the local shards, and each tensor output's
            placements: the gather rule's, or those of an input whose
            shard has the output's shape (None: the shards disagree)."""
            largs, lkwargs = tree_unflatten(
                [a.to_local() if isinstance(a, DTensor) else a
                 for a in flat], spec)
            out = func(*largs, **lkwargs)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            pls = []
            for o in outs:
                if not isinstance(o, torch.Tensor):
                    pls.append(None)
                    continue
                like = next((a for a in flat if isinstance(a, DTensor)
                             and a.to_local().shape == o.shape), None)
                if gather is None and like is None:
                    return out, None
                pls.append(gather if gather is not None
                           else like.placements)
            return out, pls

        try:
            out, pls = run(flat)
        except Exception:
            pls = None
        if pls is None:
            # elementwise ops (a backward's) whose inputs are placed apart:
            # bring every input of the first's rank to its placements
            pl = tuple(Replicate() if p.is_partial() else p
                       for p in first.placements)
            flat = [a.redistribute(a.device_mesh, pl)
                    if isinstance(a, DTensor) and a.dim() == first.dim()
                    else a for a in flat]
            try:
                out, pls = run(flat)
            except Exception as e:
                raise RuntimeError(
                    f"{func}: no sharding strategy ({failure}) and the "
                    f"local shards disagree ({e})") from e
            if pls is None:
                raise RuntimeError(f"{func}: no sharding strategy "
                                   f"({failure}) and no input's shard has "
                                   f"the output's shape")
        self.ops[name] = self.ops.get(name, 0) + 1
        if func._schema.is_mutable and name.endswith("_"):
            return args[0]
        mesh = first.device_mesh
        wrapped = [o if pl is None else DTensor.from_local(
            o, mesh, pl, run_check=False)
            for o, pl in zip(out if isinstance(out, (tuple, list))
                             else (out,), pls)]
        if isinstance(out, (tuple, list)):
            return type(out)(wrapped)
        return wrapped[0]


def _gather_placements(func, args):
    """Placements of ``table[indices]`` (``aten.index`` with one index
    tensor, or ``embedding``) from the index's and the table's: the
    index's shards stay on its dims, the table's trailing shards move
    after them, and a table sharded on its gathered dim (a vocab-parallel
    embedding) gives partial sums, each rank holding the rows it owns.
    None for other ops."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    name = func._overloadpacket.__name__
    if name == "index" and len(args) > 1 and len(args[1]) == 1:
        src, idx = args[0], args[1][0]
    elif name == "embedding":
        src, idx = args[0], args[1]
    else:
        return None
    ref = src if isinstance(src, DTensor) else idx
    if not isinstance(ref, DTensor):
        return None
    out = []
    for i in range(ref.device_mesh.ndim):
        ip = idx.placements[i] if isinstance(idx, DTensor) else Replicate()
        sp = src.placements[i] if isinstance(src, DTensor) else Replicate()
        if ip.is_shard():
            out.append(Shard(ip.dim))
        elif sp.is_shard() and sp.dim > 0:
            out.append(Shard(sp.dim - 1 + idx.dim()))
        elif sp.is_shard():
            out.append(Partial())
        else:
            out.append(Replicate())
    return tuple(out)


def _abstract_params(cfg, rules, mesh):
    params, axes = model_lib.abstract_params(cfg)
    placed = tree_map(lambda t, spec: specs_lib.abstract(
        tuple(t.shape), t.dtype, mesh, spec), params,
        rules.params_specs(params, axes))
    return placed, rules.params_shardings(params, axes)


def build_cell(cfg: ModelConfig, shape: InputShape, mesh):
    """Returns (fn, args) to run for this cell: meta DTensor parameters
    (and optimizer state) placed by ``ShardingRules``, inputs by
    ``specs``.  Installs the activation resolver and the MoE mesh (the
    caller uninstalls them)."""
    rules = ShardingRules(cfg, mesh)
    set_activation_resolver(rules.resolver())
    set_moe_mesh(mesh, data_axis_names(mesh), "model")
    params, placements = _abstract_params(cfg, rules, mesh)

    if shape.kind == "train":
        opt_cfg = AdamWConfig()
        for t in leaves(params):
            t.requires_grad_(True)
        opt_state = init_train_state(params, opt_cfg)
        batch = specs_lib.train_input_specs(cfg, shape, mesh)
        step = make_train_step(cfg, opt_cfg, grad_shardings=placements)
        return step, (params, opt_state, batch)

    if shape.kind == "prefill":
        batch = specs_lib.prefill_input_specs(cfg, shape, mesh)

        @torch.no_grad()
        def prefill_step(params, batch):
            tokens = batch["tokens"]
            extra = {k: v for k, v in batch.items() if k != "tokens"}
            logits, caches, _ = model_lib.prefill(params, cfg, tokens,
                                                  shape.seq_len, **extra)
            return logits, caches
        return prefill_step, (params, batch)

    d = specs_lib.decode_input_specs(cfg, shape, mesh)

    @torch.no_grad()
    def serve_step(params, caches, tokens, index):
        return model_lib.decode_step(params, cfg, caches, tokens, index)
    return serve_step, (params, d["caches"], d["tokens"], d["index"])


def analyse(counts: dict, mesh, cfg, shape) -> dict:
    """The record's terms from one cell's counts (per device)."""
    chips = mesh_chip_count(mesh)
    flops = float(counts["flops"])
    bytes_accessed = float(counts["bytes_accessed"])
    bytes_no_copy = float(counts["bytes_accessed_no_copy"])
    coll = counts["collectives"]

    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_accessed / HBM_BW
    collective_s = coll["total_bytes"] / LINK_BW

    # kernel-substituted memory term: swap the marked plain regions' bytes
    # for the kernels' analytic profile
    marked = counts.get("marked_bytes", {})
    kernel = kernel_bytes(cfg, shape, mesh)
    sub_bytes = (max(0.0, bytes_accessed - sum(marked.values()))
                 + sum(kernel.values()))
    kernel_sub = {"marked_bytes": marked, "kernel_bytes": kernel,
                  "bytes_substituted": sub_bytes,
                  "memory_s": sub_bytes / HBM_BW}

    n_params = cfg.param_count()
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6 if shape.kind == "train" else 2
    model_flops = mult * n_active * tokens

    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    return {
        "chips": chips,
        "flops_per_device": flops,
        "bytes_per_device": bytes_accessed,
        "bytes_no_copy_per_device": bytes_no_copy,
        "memory_s_no_copy": bytes_no_copy / HBM_BW,
        "collectives": coll,
        "trip_counts": counts["trip_counts"],
        "region_entries": counts["region_entries"],
        "kernel_substitution": kernel_sub,
        **terms,
        "dominant": dominant,
        "model_flops_global": model_flops,
        "model_flops_per_device": model_flops / chips,
        "useful_flops_ratio": (model_flops / chips) / flops if flops else 0.0,
        "params_total": n_params,
        "params_active": n_active,
    }


def _memory(args) -> dict:
    """Per-device bytes of the cell's inputs (parameters, optimizer state,
    batch / caches): the local shards' sizes."""
    from torch.distributed.tensor import DTensor
    total = 0
    for t in leaves(list(args)):
        if isinstance(t, DTensor):
            total += t.to_local().numel() * t.element_size()
        elif isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return {"argument_size_in_bytes": total}


def run_cell_on(mesh, cfg: ModelConfig, shape: InputShape) -> dict:
    """Build and count one applicable cell on an open mesh."""
    from torch.distributed.tensor.experimental import implicit_replication
    t0 = time.time()
    fallback = _LocalFallback()
    try:
        fn, args = build_cell(cfg, shape, mesh)
        t_build = time.time() - t0
        with implicit_replication(), cost_analysis.CostCounter() as counter, \
                fallback:
            fn(*args)
        record = analyse(counter.result(), mesh, cfg, shape)
        record.update(memory=_memory(args), local_ops=dict(fallback.ops),
                      build_s=round(t_build, 1),
                      run_s=round(time.time() - t0 - t_build, 1))
        return record
    finally:
        set_activation_resolver(None)
        set_moe_mesh(None, (), None)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             force: bool = False, out_dir: str = OUT_DIR, tag: str = "",
             overrides: dict = None, donate_cache: bool = False) -> dict:
    """One cell's record, written to ``out_dir`` (read back unless
    ``force``).  Opens the fake process group of the mesh's size for the
    cell, and closes it after.  ``donate_cache`` is recorded only: a
    decode step here always updates its caches in place."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir,
                            f"{arch}__{shape_name}__{mesh_name}{tag}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "applicable": ok, "skip_reason": why, "status": "skip",
              "donate_cache": donate_cache}
    if ok:
        try:
            with fake_world(512 if multi_pod else 256):
                mesh = flat_data_mesh(make_production_mesh(
                    multi_pod=multi_pod))
                record.update(run_cell_on(mesh, cfg, shape),
                              exec_mesh=mesh_shape(mesh))
            record.update(status="ok")
        except Exception as e:
            record.update(status="error", error=f"{type(e).__name__}: {e}",
                          traceback=traceback.format_exc()[-4000:])

    with open(out_path, "w") as f:
        json.dump(record, f, indent=1, default=str)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (hillclimb knob)")
    ap.add_argument("--donate-cache", action="store_true",
                    help="recorded only: decode updates its caches in place")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = {"true": True, "false": False}.get(
            v.lower(), int(v) if v.lstrip("-").isdigit() else v)

    cells = []
    if args.all:
        for arch in ARCH_IDS:
            if arch == "qwen3p6-27b":
                continue  # paper workload: serving benches cover it
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        cells.append((args.arch, args.shape))

    t0 = time.time()
    for arch, shape in cells:
        rec = run_cell(arch, shape, multi_pod=args.multi_pod,
                       force=args.force, tag=args.tag, overrides=overrides,
                       donate_cache=args.donate_cache)
        status = rec.get("status")
        line = f"{arch:22s} {shape:12s} {rec['mesh']:10s} {status}"
        if status == "ok":
            line += (f"  dominant={rec['dominant']:<12s}"
                     f" compute={rec['compute_s']:.4f}s"
                     f" mem={rec['memory_s']:.4f}s"
                     f" coll={rec['collective_s']:.4f}s"
                     f" useful={rec['useful_flops_ratio']:.2f}")
        elif status == "error":
            line += f"  {rec['error'][:120]}"
        else:
            line += f"  ({rec['skip_reason'][:60]})"
        print(line, flush=True)
    print(f"dryrun: {len(cells)} cells in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
