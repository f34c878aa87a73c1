"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py decode_graphs     # the decode graphs' phase alone

Builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc`` with
nvcc (sm_90a), holds each kernel to its plain PyTorch version on the card,
serves full-width olmo-1b, xlstm-1.3b, qwen1.5-4b, qwen3p6-27b,
qwen3-32b, hymba-1.5b (hybrid attention + Mamba-2 heads, sliding
windows; again with prompts past the window, through its ring caches),
deepseek-moe-16b (MoE) and deepseek-v2-lite-16b (MLA on MoE; the flash
kernel at head dim 192) (random weights from a seed) through the port's
``ServingEngine`` under the sync, async and worker policies (their tokens
must agree), holds each row of the paged kernel bit-equal across the
rows its launch packs for every decode geometry served, runs
full-width olmo-1b's quantized KV restore under decode (bridge_opt on;
restore codecs "", fp8 and int8, each restored block widened by the
dequant kernel; the quantized restores again under seeded restore
corruption, pipelined and on the sync-restore rung), serves full-width
olmo-1b from a two-replica confidential cluster (``repro_torch.cluster``)
under seeded bridge faults (fault-free twice, transient faults, the
ladder ablation) after a probe of whether a row's logits depend on how
many rows step beside it, through the engine's executed-width call
(probed too at max_len 2048 and with 32 slots, and for qwen1.5-4b,
xlstm-1.3b, hymba-1.5b, deepseek-moe-16b and deepseek-v2-lite-16b; the
raw model at 32 slots as a report), serves qwen3p6-27b with 32 slots
to 48 requests of 1024-token prompts (sync packed, worker packed and
sync dense: every token equal), writes full-width olmo-1b's weights as a sharded checkpoint
and loads them back through the port's ``PooledLoader`` (full width,
int8 weight-only pricing, TP 4; the loaded model must serve the in-memory
model's tokens; pageable and page-locked uploads timed beside it), serves
it from a one-replica cluster at TP 1, 2, 4 and 8 (tokens identical,
P2P only above TP 1), trains full-width olmo-1b through
``launch/train.py``'s path (torch autograd over the train mode: no kernel
launched; the train-mode logits held to the flash path's; memorisation of
one batch; an async checkpoint of the full state restored bit-equal),
serves full-width seamless-m4t-medium model-level over stub frames (its
encoder and cross attention on the flash kernel, decode on the paged
kernel; trained too, gradients reaching its encoder and cross attention)
and internvl2-76b at 8 of its 80 layers after a stub patch prefix,
serves nemotron-4-340b at 4 of its 96 layers (GQA 96/8 at head dim 192:
the paged kernel's D = 192 instantiation), re-places the training
checkpoint onto a 1x1 CUDA ``DeviceMesh`` (``launch/elastic.py``; every
leaf bit-equal, the same tokens served), counts olmo-1b's decode step,
prefills and train step with the cost counter
(``launch/cost_analysis.py``) beside the profiler's device time, runs
four dry-run cells (``launch/dryrun.py``: fake process group, meta
DTensors) on the card's host, runs the paper's engine benches on
full-width olmo-1b (``repro_torch.bench.bridge_opt``'s ablation,
scheduling ladder, overlap guardrail and slot-masked sweep and
``bench.cluster``'s rows; every claim row must hold), runs
``repro_torch.bench.run``'s fourteen modules on the card (the eight paper
benches' rows held to ``bench/reference_rows.json``), runs the examples
(``repro_torch.examples``: quickstart, serve_cluster, loader_and_offload,
serve_cc_policies for olmo-1b and xlstm-1.3b, and train_lm at its own
full width for 300 steps, then resumed from its step-300 checkpoint),
checks that each path went through its kernels
(launch counters: flash + paged for the dense models and the clusters,
the chunked mLSTM scan for xlstm-1.3b, dequant once per quantized
restore) and that its crossing tapes obey the bridge law, checks that
every family's decode calls replay as a CUDA graph bit-equal to eager
calls and that no eager decode call synchronises the card, and does so at
the benchmark cells' widths (``phase_decode_graphs``), profiles a
decode step of olmo-1b, xlstm-1.3b, qwen3p6-27b, qwen3-32b and the three
models above, recomputes
``BENCH_packed.json``, ``BENCH_obs.json``, ``BENCH_chaos.json``,
``BENCH_tp.json`` and ``BENCH_quant.json`` on the card
(``repro_torch.bench``; a difference fails the run), and times each
kernel, its plain version and the PyTorch call computing the
same function, where there is one (device time by the profiler; the flash
kernel at each of the main path's prompt lengths and at 4096; the paged
kernel at the main path's decode lengths, with every slot full, and at a
profiled decode step's lengths back to back, after idle and after a
GEMM; the mLSTM kernel at the longest prompt and summed over one main
path run's prefills; the dequant kernel at a restore's shape, one list
call against 32 single calls; flash and paged at qwen1.5-4b's,
qwen3p6-27b's, qwen3-32b's and nemotron-4-340b's head layouts; flash at
deepseek-v2-lite's
D = 192, at hymba's windowed layout and at seamless-m4t-medium's cross
attention and encoder).  It prints
the card's name, power limit and confidential-computing state, one ``{"kernels": [...]}`` line, and as
its last line ``{"ok": true, "device": {...}}``.  Without a CUDA card, or
without the repository's ``src`` beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
BF16_TOL = 3e-2
#: each flash case is also held to its output's own size: rel L2 of the
#: kernel against the plain version (bf16 rounding of the output alone is
#: ~2^-9 relative; a dropped or misweighted KV tile moves it far more)
FLASH_REL_L2 = 1e-2
#: each paged case too (bf16 rounding of the output alone is ~2^-9
#: relative; a page or split dropped or misweighted moves it far more)
PAGED_REL_L2 = 1e-2
#: the mLSTM scan's tolerances, tests/test_kernels.py's: rtol 1e-5 with atol
#: 5e-4 (f32) or 1e-1 (bf16), mean error below 1e-5 (f32) or 1e-3 (bf16)
MLSTM_TOL = {torch.float32: (5e-4, 1e-5), torch.bfloat16: (1e-1, 1e-3)}
#: the card's published peaks (H100 SXM, dense): bf16 and TF32 tensor
#: cores, f32 on the CUDA cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

#: where every phase runs (the card; a CPU rehearsal may rebind it)
DEVICE = "cuda"
MAIN = dict(max_batch=8, max_len=1024, new_tokens=32,
            prompt_lens=[16, 87, 158, 229, 299, 370, 441, 512])
#: the long prompt at which the flash kernel is timed beside the main path's
#: lengths (operations bound it there, bytes at the main path's)
LONG_PROMPT = 4096
#: the restore-under-decode path: a shared prompt spilled as KV blocks of
#: ``block_tokens`` and restored (pipelined, ``chunk_bytes`` chunks) for the
#: request that re-reads it while three short requests decode
RESTORE = dict(max_batch=4, max_len=1024, prompt_len=512, block_tokens=16,
               new_tokens=32, short_lens=[24, 48, 96], short_new_tokens=8,
               chunk_bytes=4 << 20)
#: per-block bound on max|widened - spilled| / block amax: half a code step
#: at the top of the block (int8: 0.5/127; fp8 e4m3: 16 of 448), plus the
#: f32 rounding of the scale, the product and the difference
QUANT_BOUND = {"int8": 0.5 / 127, "fp8": 16 / 448}
#: the chaos phase: ``benchmarks/bench_chaos.py``'s workload at full width
#: (waves of greedy requests sharing a prefix of 32 KV blocks, each wave
#: drained so the next restores the prefix warm over the faulted channel),
#: served by a two-replica cluster of one model; the transient plan's seed
#: and rate are the bench's ablation point
CHAOS = dict(n_replicas=2, max_batch=8, max_len=1024, block_tokens=16,
             n_pages=512, waves=3, wave_size=16, prefix_len=512, own_len=16,
             new_tokens=32, seed=11, rate=0.3)
#: the loader phase: full-width olmo-1b's own weights written in
#: ``n_shards`` shards and loaded back by a pool of ``n_workers``
LOADER = dict(n_shards=8, n_workers=8)
#: the paged kernel's width probe: each decode geometry the card serves
#: (name, query heads, KV heads, head dim; MLA's decode reads its latent
#: cache without the paged kernel) over page pools of (rows, pages_max)
#: pages of ``page``, every row launched in calls packing each of
#: ``widths`` rows that the pool holds
PAGED_WIDTHS = dict(
    geometries=(("olmo-1b / deepseek-moe-16b", 16, 16, 128),
                ("qwen1.5-4b", 20, 20, 128),
                ("qwen3-32b / qwen3p6-27b / internvl2-76b", 64, 8, 128),
                ("hymba-1.5b", 25, 5, 64),
                ("nemotron-4-340b", 96, 8, 192),
                ("seamless-m4t-medium", 16, 16, 64)),
    pools=((8, 64), (8, 128), (32, 64)), page=16,
    widths=(1, 4, 5, 6, 7, 8, 17, 32))
#: engine width probes beside the chaos phase's: olmo-1b at ``long_len``
#: and qwen1.5-4b, xlstm-1.3b, hymba-1.5b, deepseek-moe-16b and
#: deepseek-v2-lite-16b at MAIN's length, widths 1 ... MAIN's max_batch,
#: and olmo-1b with ``wide`` slots at MAIN's length over ``wide_widths``
#: (rows must be width-independent); the raw model at the wide widths
#: beside it (a report, not a gate)
PROBES = dict(long_len=2048, wide=32, wide_widths=(1, 8, 17, 32))
#: more than 8 rows on the paper's model (``phase_wide``, qwen3p6-27b):
#: its 1k-token prompts (``benchmarks/workloads.py``'s 1k-in) with short
#: outputs (request i greedy for 8 + 8 * (i % 5) tokens), 48 requests
#: through 32 slots, so the stepping rows shrink and regrow
WIDE = dict(max_batch=32, max_len=2048, n_requests=48, prompt_len=1024)
#: the TP phase: ``benchmarks/bench_tp.py``'s guardrail at full width (a
#: one-replica cluster, partition of 8; 8 greedy requests, each a shared
#: prompt of ``prompt_len`` plus ``own_len`` tokens of its own, with
#: ``new_tokens`` + i % 4 new tokens), at each TP degree
TP = dict(degrees=(1, 2, 4, 8), partition_size=8, max_batch=8, max_len=1024,
          block_tokens=16, n_pages=512, n_requests=8, prompt_len=256,
          own_len=4, new_tokens=8)
#: hymba-1.5b's ring phase: prompts past its 1024-token window, so every
#: sliding layer's prefill runs the flash kernel with the window biting and
#: decodes through its ring cache, while the global layers keep the paged
#: kernel over a cache of ``max_len``
RING = dict(max_batch=8, max_len=2048, prompt_lens=[1536, 1100, 300],
            new_tokens=16)
#: the training phase: full-width olmo-1b through ``launch/train.py``'s
#: path (the data pipeline's batches, ``TrainLoop``, AdamW in place) for
#: ``steps`` at ``batch`` x ``seq`` (``lr``: at 1e-3 the random-weight model
#: spikes to a loss of 17.5 on its second step); then ``memorise_steps`` on
#: one repeated batch at ``memorise_lr``, where the loss must fall by
#: ``memorise_drop``; then one async
#: checkpoint of the full state with ``pending_steps`` steps taken while it
#: is written
TRAIN = dict(steps=20, batch=8, seq=512, lr=3e-4, memorise_steps=10,
             memorise_lr=1e-3, memorise_drop=1.0, pending_steps=2)
#: seamless-m4t-medium at full width: ``batch`` requests of the frontend's
#: 512 stub frames and ``prompt_len`` tokens, ``new_tokens`` greedy tokens
#: (model-level: the serving engine feeds only tokens, as the reference's
#: does); then ``train_steps`` at ``train_batch`` x ``train_seq``
ENCDEC = dict(batch=8, prompt_len=64, new_tokens=32, train_steps=5,
              train_batch=4, train_seq=128)
#: internvl2-76b at full width and ``n_layers`` of its 80 (141 GB of
#: weights at full depth fit no card): ``batch`` requests of the frontend's
#: 256 stub patch embeddings and ``prompt_len`` tokens, ``new_tokens``
#: greedy tokens
VLM = dict(n_layers=8, batch=4, prompt_len=64, new_tokens=32)
#: the faulted restores' plan: restore corruption only, at p 0.5.  Seed 1's
#: first two restore-corruption draws (0.355, 0.031) fall below 0.5, so a
#: restore redoes twice (the restore policy's cap) on either path
RESTORE_FAULTS = dict(seed=1, restore_corruption_p=0.5)
#: nemotron-4-340b cut to 4 of its 96 layers for one card (every width as
#: published: 23,253,221,376 parameters, 46.51 GB in bf16)
NEMOTRON = dict(n_layers=4)
#: the decode graphs (``models/decode_graph.py``): each family of
#: ``GRAPH_ARCHS`` at smoke width decodes ``steps`` calls of ``rows`` rows
#: twice, eagerly and through ``Model.decode_step``, then each is timed
#: over ``timed`` calls; each benchmark cell's configuration serves at its
#: width, ``cell_calls`` decode calls each beside an eager call of the same
#: inputs, two ``cell_prompt``-token prompts admitted every
#: ``cell_admit_every`` calls
GRAPHS = dict(rows=8, max_len=64, steps=8, timed=20, cell_calls=64,
              cell_admit_every=16, cell_prompt=1024, cell_new_tokens=40,
              cell_seed=31000000001)
GRAPH_ARCHS = ("olmo-1b", "xlstm-1.3b", "qwen1.5-4b", "qwen3p6-27b",
               "qwen3-32b", "nemotron-4-340b", "hymba-1.5b",
               "deepseek-moe-16b", "deepseek-v2-lite-16b", "deepseek-v3",
               "seamless-m4t-medium", "internvl2-76b")
#: fields set on a ``GRAPH_ARCHS`` family's smoke config: deepseek-v3
#: holds a share of its experts (4 of the 8, from 4), as its benchmark
#: cell does, so its decode tallies the held assignments on the device
GRAPH_SHARES = {"deepseek-v3": dict(experts_held=4, experts_offset=4)}
#: families whose prefill is recorded as a CUDA graph in a benchmark cell
#: (``prefill_graphs``), checked at smoke width with the share above and
#: these fields: MLA's prefill runs the flash kernel at nope + rope, and
#: the kernel has no head dim of the smoke width's 48; nope 48 makes it 64
PREFILL_GRAPH_ARCHS = {"deepseek-v3": dict(nope_head_dim=48, head_dim=64)}
#: the dry run's cells on the card's host (fake process group, meta
#: tensors): olmo-1b's three shapes on one pod, deepseek-moe-16b's decode
#: (expert parallel) on two
DRYRUN = (("olmo-1b", "train_4k", False), ("olmo-1b", "prefill_32k", False),
          ("olmo-1b", "decode_32k", False),
          ("deepseek-moe-16b", "decode_32k", True))
#: the paper benches' claims at full width (``phase_bench_full_width``):
#: row -> the test its value must pass (the bench states each as 0/1,
#: except the closure floor and the deadline flush count)
BENCH_CLAIMS = {
    "bridge_opt/fresh_share_strictly_decreasing": lambda v: v == 1.0,
    "bridge_opt/conformance_pass": lambda v: v == 1.0,
    "obs/closure_min": lambda v: v >= 0.99,
    "obs/fresh_toll_monotone": lambda v: v == 1.0,
    "obs/serialization_monotone": lambda v: v == 1.0,
    "bridge_opt/ladder_deadline_flushes": lambda v: v > 0,
    "bridge_opt/ladder_conformance_pass": lambda v: v == 1.0,
    "bridge_opt/ladder_worker_beats_flag_at_high_c": lambda v: v == 1.0,
    "bridge_opt/overlap_guardrail_ok": lambda v: v == 1.0,
    "bridge_opt/slot_masked_beats_barrier": lambda v: v == 1.0,
    "bridge_opt/slot_masked_tokens_identical": lambda v: v == 1.0,
    "bridge_opt/slot_masked_conformance_pass": lambda v: v == 1.0,
    "cluster/tenants_serving_simultaneously": lambda v: v == 1.0,
    "cluster/tenants_isolated": lambda v: v == 1.0,
    "cluster/tenant_devices_disjoint": lambda v: v == 1.0,
    "cluster/tenants_finished_all": lambda v: v == 1.0,
    "cluster/tenants_attestation_gated": lambda v: v == 1.0,
}
#: the train_lm example at its own full width (olmo-100m, 119.5 M
#: parameters): ``steps`` of ``batch`` x ``seq`` into a fresh directory
#: under ``build/``, then a second call to ``resume_steps`` that must start
#: at the step-``steps`` checkpoint; the step wall is the median of the
#: steps from ``median_from``
TRAIN_LM = dict(steps=300, resume_steps=320, batch=8, seq=128,
                median_from=20)
F32_SLACK = 2.0 ** -22
#: what phase_profile saw of the paged kernel, by model: the lengths of a
#: profiled decode step and each launch's device time (us)
PROFILED = {}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float,
          peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """Least time the card could take: ops over the peak rate of their type
    (bf16 unless given) or bytes over the memory rate, whichever is larger
    (ms, which bounds it)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_HBM_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


# ---------------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------------

def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    # the card's confidential-computing state, as the tool reports it
    # (its own output and exit code; an unsupported query says so there)
    cc = subprocess.run(["nvidia-smi", "conf-compute", "-f"],
                        capture_output=True, text=True, timeout=60)
    print(f"confidential computing: nvidia-smi conf-compute -f exited "
          f"{cc.returncode}; its output:")
    print((cc.stdout + cc.stderr).rstrip("\n") or "(none)")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()})")
    check(torch.backends.cuda.matmul.allow_tf32 is False
          and torch.backends.cudnn.allow_tf32 is False, "TF32 must be off")
    return card


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(sorted(logs))})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("ptxas info")[-1].strip()
                print(f"  ptxas {name}: {entry}")
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)


def phase_flash(gen) -> float:
    """Every case within BF16_TOL (max abs) and FLASH_REL_L2 (rel L2) of
    the plain version; returns the worst max abs error."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    # olmo-1b's heads at 1 token, ragged lengths, the main path's largest
    # prompt and beyond; GQA (H40/KV8); a window; cross-attention
    cases = [dict(b=1, sq=s, sk=s, h=16, kv=16, d=128, causal=True)
             for s in (1, 17, 128, 500, 1024)]
    cases += [dict(b=1, sq=512, sk=512, h=40, kv=8, d=128, causal=True),
              dict(b=2, sq=300, sk=300, h=16, kv=4, d=128, causal=True,
                   window=100),
              dict(b=2, sq=96, sk=384, h=8, kv=4, d=64, causal=False)]
    # for the tensor-core fragment paths: lengths just under and over one
    # 64-key tile (63, 65), S=4096 (the long, operations-bound shape), GQA
    # H40/KV8 at 2048, and D=32.  They draw from a generator of their own,
    # so every later phase's inputs stay those of earlier runs (the mLSTM
    # check's per-element slack is sensitive to its draw: ROADMAP Queue 3)
    added = [dict(b=1, sq=s, sk=s, h=16, kv=16, d=128, causal=True)
             for s in (63, 65, 4096)]
    added += [dict(b=1, sq=2048, sk=2048, h=40, kv=8, d=128, causal=True),
              dict(b=2, sq=200, sk=200, h=8, kv=2, d=32, causal=True),
              dict(b=1, sq=333, sk=333, h=4, kv=4, d=32, causal=True,
                   window=70),
              dict(b=2, sq=100, sk=257, h=4, kv=2, d=32, causal=False)]
    own = torch.Generator(device=DEVICE).manual_seed(1)
    # the head layouts of the main path's qwen1.5-4b (MHA, 20 heads) and
    # qwen3-32b (GQA 64/8) prefills, from a generator of their own too
    layouts = [dict(b=1, sq=512, sk=512, h=20, kv=20, d=128, causal=True),
               dict(b=1, sq=512, sk=512, h=64, kv=8, d=128, causal=True)]
    own_layouts = torch.Generator(device=DEVICE).manual_seed(19)
    # D = 192 (deepseek-v2-lite's MLA prefill: nope 128 + rope 64, V
    # zero-padded; the timed case first) and hymba's sliding layers (H25
    # KV5 D64, window 1024 biting at 1536), from a generator of their own
    wide = [dict(b=1, sq=512, sk=512, h=16, kv=16, d=192, causal=True),
            dict(b=1, sq=1, sk=1, h=16, kv=16, d=192, causal=True),
            dict(b=2, sq=65, sk=65, h=16, kv=16, d=192, causal=True),
            dict(b=1, sq=1100, sk=1100, h=16, kv=16, d=192, causal=True),
            dict(b=1, sq=1536, sk=1536, h=25, kv=5, d=64, causal=True,
                 window=1024)]
    own_wide = torch.Generator(device=DEVICE).manual_seed(22)
    # nemotron-4-340b's prefill: GQA 96/8 at D = 192 (the timed case first)
    nemotron = [dict(b=1, sq=512, sk=512, h=96, kv=8, d=192, causal=True),
                dict(b=2, sq=65, sk=65, h=96, kv=8, d=192, causal=True)]
    own_nemotron = torch.Generator(device=DEVICE).manual_seed(24)
    worst = 0.0
    for c, g in ([(c, gen) for c in cases] + [(c, own) for c in added]
                 + [(c, own_layouts) for c in layouts]
                 + [(c, own_wide) for c in wide]
                 + [(c, own_nemotron) for c in nemotron]):
        q = _randn(g, c["b"], c["sq"], c["h"], c["d"])
        k = _randn(g, c["b"], c["sk"], c["kv"], c["d"])
        v = _randn(g, c["b"], c["sk"], c["kv"], c["d"])
        kw = dict(causal=c["causal"], window=c.get("window"))
        out = ops.flash_attention(q, k, v, **kw).float()
        torch.cuda.synchronize()
        ref = flash_attention_ref(q, k, v, **kw).float()
        err = (out - ref).abs().max().item()
        rel = _rel(out, ref)
        print(f"flash {c}: max_abs_err {err:.3g} rel_l2 {rel:.3g} "
              f"(output rms {ref.pow(2).mean().sqrt().item():.3g})")
        check(math.isfinite(err) and err <= BF16_TOL,
              f"flash kernel disagrees with its plain version at {c}: {err}")
        check(math.isfinite(rel) and rel <= FLASH_REL_L2,
              f"flash kernel disagrees with its plain version at {c}: rel "
              f"L2 {rel}")
        worst = max(worst, err)
    return worst


def _paged_inputs(gen, b, h, kv, d, page, pages_max, lengths, identity):
    n_pages = b * pages_max
    q = _randn(gen, b, h, d)
    kp = _randn(gen, n_pages, page, kv, d)
    vp = _randn(gen, n_pages, page, kv, d)
    if identity:   # the engine's table: slot s owns pages s*pages_max + j
        bt = (torch.arange(b, device=DEVICE)[:, None] * pages_max
              + torch.arange(pages_max, device=DEVICE)[None, :])
    else:
        bt = torch.randint(0, n_pages, (b, pages_max), generator=gen,
                           device=DEVICE)
    return (q, kp, vp, bt.to(torch.int32).contiguous(),
            torch.tensor(lengths, dtype=torch.int32, device=DEVICE))


def phase_paged(gen) -> float:
    """Every case within BF16_TOL (max abs) and PAGED_REL_L2 (rel L2) of
    the plain version; returns the worst max abs error.  Each case prints
    the kernel's split size (``ops.split_plan``: a case's pool holds its
    ``b`` rows)."""
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    lens8 = [1, 7, 16, 17, 32, 333, 1023, 1024]   # 1, < page, boundaries, max
    olmo = dict(h=16, kv=16, d=128, page=16, pages_max=64)
    cases = [dict(b=8, **olmo, lengths=lens8, identity=False),
             dict(b=8, **olmo, lengths=lens8, identity=True),
             dict(b=4, h=40, kv=8, d=128, page=16, pages_max=64,
                  lengths=[1, 15, 500, 1024], identity=False)]

    def at_splits(b, kv, page, pages_max, extra=()):
        """Lengths one token short of, at and past a split (and two
        splits) of a pool of ``b`` rows, plus ``extra``."""
        t = ops.pages_per_split(b, kv, pages_max, page) * page
        return [t - 1, t, t + 1, 2 * t + 1, *extra][:b]

    # split boundaries (olmo-1b and GQA H40/KV8), one row at the longest
    # length a slot holds, lengths past pages_max * page (clipped), two
    # head groups (12 query heads a KV head) and the other head dims.  They
    # draw from a generator of their own, so every later phase's inputs
    # stay those of earlier runs (the mLSTM check is draw-sensitive)
    added = [dict(b=4, **olmo, lengths=at_splits(4, 16, 16, 64),
                  identity=False),
             dict(b=1, **olmo, lengths=[1024], identity=True),
             dict(b=2, **olmo, lengths=[1025, 5000], identity=False),
             dict(b=5, h=40, kv=8, d=128, page=16, pages_max=64,
                  lengths=at_splits(5, 8, 16, 64, [1024]), identity=False),
             dict(b=2, h=24, kv=2, d=128, page=16, pages_max=32,
                  lengths=[77, 512], identity=False),
             dict(b=3, h=8, kv=4, d=64, page=8, pages_max=40,
                  lengths=[1, 64, 320], identity=False),
             dict(b=2, h=4, kv=1, d=32, page=16, pages_max=16,
                  lengths=[17, 256], identity=False),
             dict(b=2, h=8, kv=4, d=256, page=16, pages_max=16,
                  lengths=[100, 256], identity=False)]
    own = torch.Generator(device=DEVICE).manual_seed(2)
    # the decode head layouts of the main path's qwen1.5-4b (MHA, 20 heads)
    # and qwen3-32b (GQA 64/8), from a generator of their own too
    layouts = [dict(b=8, h=20, kv=20, d=128, page=16, pages_max=64,
                    lengths=lens8, identity=True),
               dict(b=8, h=64, kv=8, d=128, page=16, pages_max=64,
                    lengths=lens8, identity=True)]
    own_layouts = torch.Generator(device=DEVICE).manual_seed(20)
    # D = 192 (the padded-lane instantiation) at nemotron-4-340b's decode
    # layout (GQA 96/8: 12 query heads a KV head, two head groups) and at
    # its split boundaries, from a generator of their own
    nemotron = [dict(b=8, h=96, kv=8, d=192, page=16, pages_max=64,
                     lengths=lens8, identity=True),
                dict(b=4, h=96, kv=8, d=192, page=16, pages_max=64,
                     lengths=at_splits(4, 8, 16, 64), identity=False)]
    own_nemotron = torch.Generator(device=DEVICE).manual_seed(25)
    worst = 0.0
    for c, g in ([(c, gen) for c in cases] + [(c, own) for c in added]
                 + [(c, own_layouts) for c in layouts]
                 + [(c, own_nemotron) for c in nemotron]):
        args = _paged_inputs(g, **c)
        out = ops.paged_attention(*args).float()
        torch.cuda.synchronize()
        ref = paged_attention_ref(*args).float()
        err = (out - ref).abs().max().item()
        rel = _rel(out, ref)
        pps = ops.split_plan(args[1], args[3])
        print(f"paged {c}: split {pps} pages ({pps * c['page']} tokens); "
              f"max_abs_err {err:.3g} rel_l2 {rel:.3g}")
        check(math.isfinite(err) and err <= BF16_TOL,
              f"paged kernel disagrees with its plain version at {c}: {err}")
        check(math.isfinite(rel) and rel <= PAGED_REL_L2,
              f"paged kernel disagrees with its plain version at {c}: rel "
              f"L2 {rel}")
        worst = max(worst, err)
    return worst


def phase_paged_widths() -> None:
    """Each row's paged output bit-equal whatever rows share its launch:
    for each of PAGED_WIDTHS' geometries and pools, random pages and q
    (a generator of its own) at lengths one token short of, at and past
    the pool's split (``ops.split_plan``), two splits, the whole row and
    random ones; the pool's rows through the kernel in calls of each width
    (the calls of width w take rows s, s+1, ..., s+w-1 modulo the rows, s
    = 0, w, 2w, ...), each row held bit for bit to the call of every row,
    which is held to the plain version (BF16_TOL, PAGED_REL_L2).  Prints
    each pool's plan beside the plans its widths would have chosen had
    the plan followed the rows a call packs, and, as a report, how many
    rows stay bit-equal under those plans (each call again over a pool of
    just its rows' pages, copied, whose ``split_plan`` is that plan)."""
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    gen = torch.Generator(device=DEVICE).manual_seed(26)
    page = PAGED_WIDTHS["page"]
    for name, h, kv, d in PAGED_WIDTHS["geometries"]:
        for rows, pages_max in PAGED_WIDTHS["pools"]:
            cap = pages_max * page
            q = _randn(gen, rows, h, d)
            kp = _randn(gen, rows * pages_max, page, kv, d)
            vp = _randn(gen, rows * pages_max, page, kv, d)
            tables = (torch.arange(rows, device=DEVICE)[:, None] * pages_max
                      + torch.arange(pages_max, device=DEVICE)[None, :]
                      ).to(torch.int32)
            pps = ops.split_plan(kp, tables)
            t = pps * page
            edges = [1, t - 1, t, t + 1, 2 * t + 1, cap - 1, cap]
            drawn = torch.randint(1, cap + 1, (rows,), generator=gen,
                                  device=DEVICE).tolist()
            lengths = torch.tensor((edges + drawn)[:rows], dtype=torch.int32,
                                   device=DEVICE)
            whole = ops.paged_attention(q, kp, vp, tables, lengths)
            ref = paged_attention_ref(q, kp, vp, tables, lengths)
            err = (whole.float() - ref.float()).abs().max().item()
            rel = _rel(whole.float(), ref.float())
            check(math.isfinite(err) and err <= BF16_TOL
                  and math.isfinite(rel) and rel <= PAGED_REL_L2,
                  f"paged widths {name} pool {rows}x{pages_max}: the kernel "
                  f"disagrees with its plain version: {err} (rel L2 {rel})")
            widths = [w for w in PAGED_WIDTHS["widths"] if w <= rows]
            equal = torch.ones(rows, dtype=torch.bool, device=DEVICE)
            by_width = equal.clone()        # under the width-chosen plans
            calls = 0

            def same(got, idx):
                return (got.view(torch.int16) == whole[idx].view(torch.int16)
                        ).flatten(1).all(1)

            for w in widths:
                for s in range(0, rows, w):
                    idx = torch.tensor([(s + i) % rows for i in range(w)],
                                       device=DEVICE)
                    equal[idx] &= same(ops.paged_attention(
                        q[idx], kp, vp, tables[idx], lengths[idx]), idx)
                    own = [t.view(rows, pages_max, page, kv, d)[idx].flatten(
                        0, 1) for t in (kp, vp)]
                    by_width[idx] &= same(ops.paged_attention(
                        q[idx], *own, tables[:w], lengths[idx]), idx)
                    calls += 1
            n_equal = int(equal.sum())
            chosen = [ops.pages_per_split(w, kv, pages_max, page)
                      for w in widths]
            print(f"paged widths {name} (H{h} KV{kv} D{d}), pool of {rows} "
                  f"rows x {pages_max} pages of {page}: plan {pps} pages "
                  f"({t} tokens) at every width (chosen by the call's rows "
                  f"it would be {dict(zip(widths, chosen))}); widths "
                  f"{widths} in {calls} launches; rows bit-equal across "
                  f"widths {n_equal} of {rows} (under the width-chosen plans "
                  f"{int(by_width.sum())}); lengths "
                  f"{lengths.tolist()}; whole pool vs plain max_abs_err "
                  f"{err:.3g} rel_l2 {rel:.3g}")
            check(n_equal == rows, f"paged widths {name} pool {rows}x"
                                   f"{pages_max}: rows "
                                   f"{(~equal).nonzero().flatten().tolist()} "
                                   f"differ across widths")
            del q, kp, vp
    torch.cuda.empty_cache()


def _mlstm_inputs(gen, b, s, h, dk, dv, dtype, initial_state):
    """tests/test_kernels.py's draw: q pre-scaled, k and v normal (rounded
    to ``dtype``), log_i normal x 2, log_f log_sigmoid(normal + 1), on the
    card; with ``initial_state`` a normal (C, n, m) in f32."""
    def rn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    q, k, v = ((rn(b, s, h, dk) / math.sqrt(dk)).to(dtype),
               rn(b, s, h, dk).to(dtype), rn(b, s, h, dv).to(dtype))
    li, lf = rn(b, s, h) * 2.0, F.logsigmoid(rn(b, s, h) + 1.0)
    state = ((rn(b, h, dk, dv), rn(b, h, dk), rn(b, h))
             if initial_state else None)
    return (q, k, v, li, lf), state


def phase_mlstm(gen) -> float:
    """The mLSTM kernel against its plain version on y and the final
    (C, n, m), by the per-element criterion of ``_mlstm_compare``.
    Returns the worst f32 max-abs error."""
    f32, bf16 = torch.float32, torch.bfloat16
    full = dict(b=1, h=4, dk=512, dv=1024, chunk=256)
    cases = [dict(full, s=512, dtype=f32, init=False),      # the model's shape
             dict(full, s=300, dtype=f32, init=False),      # ragged tail
             dict(full, s=512, dtype=f32, init=True),       # carried state
             dict(b=1, s=100, h=4, dk=64, dv=128, chunk=32, dtype=f32,
                  init=False),                              # test_kernels.py
             dict(b=1, s=100, h=4, dk=64, dv=128, chunk=32, dtype=bf16,
                  init=False)]
    # the chunk-parallel state passes: four and eight chunks (the combine
    # over several contributions), the main path's shortest prompt (one
    # partial chunk), a carried state over three chunks; drawn from their
    # own generator so the cases above and the later phases keep theirs
    more = [dict(full, s=1024, dtype=f32, init=False),
            dict(full, s=2048, dtype=f32, init=False),
            dict(full, s=min(MAIN["prompt_lens"]), dtype=f32, init=False),
            dict(full, s=700, dtype=f32, init=True)]
    gen_more = torch.Generator(device=DEVICE).manual_seed(17)
    worst = 0.0
    for g, c in [(gen, c) for c in cases] + [(gen_more, c) for c in more]:
        args, state = _mlstm_inputs(g, c["b"], c["s"], c["h"], c["dk"],
                                    c["dv"], c["dtype"], c["init"])
        e, report = _mlstm_compare(args, dict(chunk=c["chunk"],
                                              initial_state=state), c)
        if c["dtype"] == f32:
            worst = max(worst, e)
        print(f"mlstm {c}: {report}")
    return worst


def _mlstm_compare(args, kw, where) -> tuple:
    """The mLSTM kernel against its plain version on one input set; fails
    the run on a disagreement.  Returns (worst max-abs error, report).

    An element passes if it is within tests/test_kernels.py's tolerance of
    the plain version (atol 5e-4 f32 / 1e-1 bf16, rtol 1e-5), or within
    c eps32 kappa |x_f64| of an f64 evaluation of the same algorithm, c = 2
    (``probe.C_BOUND``): kappa is the element's condition number over the
    elementary products it is made of (``probe.abs_sums``), the bound any
    f32 order of those sums meets with a small c, however the plain
    version's own order happens to round.  y's mean error against the
    plain version stays below 1e-5 (f32) or 1e-3 (bf16).  The report
    gives, per tensor, the elements each arm passed and the largest c the
    bound's arm needed."""
    from repro_torch.kernels.mlstm_scan import ops, probe
    from repro_torch.kernels.mlstm_scan.ref import mlstm_chunked_ref
    y, st = ops.mlstm_scan(*args, **kw)
    torch.cuda.synchronize()
    py, pst = mlstm_chunked_ref(*args, **kw)
    rterms = []
    ry, rst = mlstm_chunked_ref(*args, **kw, dtype=torch.float64,
                                terms=rterms)
    scales = probe.abs_sums(args, kw["chunk"], kw.get("initial_state"),
                            rterms)
    del rterms
    worst, report = 0.0, []
    for name, got, plain, exact in zip(("y", "C", "n", "m"), (y, *st),
                                       (py, *pst), (ry, *rst)):
        atol, mean_bound = MLSTM_TOL[got.dtype]
        arms = probe.criterion(got, plain, exact, scales.get(name), atol)
        err = (got.double() - plain.double()).abs()
        mean, e = float(err.mean()), float(err.max())
        report.append(
            f"{name} max_abs_err {e:.3g} mean {mean:.3g} (kernel vs f64 "
            f"{float((got.double() - exact).abs().max()):.3g}, plain vs "
            f"f64 {float((plain.double() - exact).abs().max()):.3g}; "
            f"{arms['tol']} in tolerance, {arms['kappa']} by the kappa "
            f"bound (largest c {arms['c_max']:.3g}), {arms['out']} out)")
        check(math.isfinite(e) and arms["out"] == 0
              and (name != "y" or mean < mean_bound),
              f"mlstm kernel disagrees with its plain version at {where}: "
              f"{name} {arms['out']} elements out of the criterion, max "
              f"{e}, mean {mean}")
        worst = max(worst, e)
    return worst, "; ".join(report)


def _bit_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    """f32 tensors equal bit for bit (-0.0 apart from +0.0), NaN as NaN."""
    nan = torch.isnan(want)
    return (got.shape == want.shape and got.dtype == want.dtype
            and torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan].view(torch.int32),
                            want[~nan].view(torch.int32)))


#: the list calls phase_dequant makes, by label: values per segment (the
#: restore's 32 full-width olmo-1b KV blocks; 64 and 65 segments, the
#: last crossing the launch split; ragged segments)
DEQUANT_LISTS = {
    "2": [300 * 128, 77],
    "32": [8192 * 128] * 32,
    "64": [(128, 127 * 128, 300 * 128, 77)[i % 4] for i in range(64)],
    "65": [(128, 127 * 128, 300 * 128, 77)[i % 4] for i in range(65)],
    "ragged": [77, 1, 129, 16 * 128 + 15],
}


def _every_code(gen, n: int, half: int) -> torch.Tensor:
    """``n`` seeded codes beginning with every one of the 256 codes (the
    first or second half of them when ``n`` is under 256)."""
    codes = torch.randint(0, 256, (n,), generator=gen, device=DEVICE,
                          dtype=torch.int32).to(torch.uint8)
    every = torch.arange(256, device=DEVICE, dtype=torch.int32).to(
        torch.uint8)
    if n < 256:
        every = every[128:] if half else every[:128]
    m = min(n, every.numel())
    codes[:m] = every[:m]
    return codes


def phase_dequant(gen) -> float:
    """The dequant kernel against its plain version on the card, bit for
    bit: int8 and fp8, 1, 127, 8,192 (one full-width olmo-1b KV block) and
    8,193 blocks, every one of the 256 codes present, NaN compared as NaN;
    then the list calls of DEQUANT_LISTS (their own generator), each with
    its launch count ceil(n / 64) and its segments at their offsets in one
    buffer.  Then the torch encode on the card against the same encode on
    the CPU, on a seeded full-width KV block.  Returns the worst max-abs
    error over the finite values (0 when bit-equal)."""
    from repro_torch.kernels.dequant import ops
    from repro_torch.kernels.dequant.ref import dequant_many_ref, dequant_ref
    from repro_torch.quant import get_codec
    worst = 0.0
    every = torch.arange(256, device=DEVICE, dtype=torch.int32).to(torch.uint8)
    lgen = torch.Generator(device=DEVICE).manual_seed(18)
    for codec in ("int8", "fp8"):
        for nblocks in (1, 127, 8192, 8193):
            codes = torch.randint(0, 256, (nblocks * 128,), generator=gen,
                                  device=DEVICE, dtype=torch.int32
                                  ).to(torch.uint8)
            n = min(256, codes.numel())
            codes[:n] = every[:n] if nblocks > 1 else every[128:]
            codes = codes.reshape(nblocks, 128)
            scales = torch.randn(nblocks, generator=gen, device=DEVICE) * 4
            out = ops.dequant(codes, scales, codec=codec)
            torch.cuda.synchronize()
            plain = dequant_ref(codes, scales[:, None], codec=codec)
            finite = torch.isfinite(plain)
            err = (out[finite] - plain[finite]).abs().max().item()
            print(f"dequant {codec} nblocks={nblocks}: bit-equal "
                  f"{_bit_equal(out, plain)}, max_abs_err {err:.3g}, "
                  f"{int((~finite).sum())} NaN codes")
            check(_bit_equal(out, plain), f"dequant kernel ({codec}, "
                  f"{nblocks} blocks) differs from its plain version")
            worst = max(worst, err)
        for label, values in DEQUANT_LISTS.items():
            codes = [_every_code(lgen, v, i % 2)
                     for i, v in enumerate(values)]
            scales = [torch.randn(-(-v // 128), generator=lgen,
                                  device=DEVICE) * 4 for v in values]
            before = ops.dequant.launches
            outs = ops.dequant_many(codes, scales, codec=codec)
            torch.cuda.synchronize()
            launched = ops.dequant.launches - before
            plain = dequant_many_ref(codes, scales, codec=codec)
            equal = all(_bit_equal(o, p) for o, p in zip(outs, plain))
            offsets = ops.block_offsets(values)
            placed = all(o.data_ptr() == outs[0].data_ptr() + 512 * b
                         for o, b in zip(outs, offsets))
            err = max(torch.where(torch.isfinite(p), o - p, 0).abs().max()
                      .item() for o, p in zip(outs, plain))
            ragged = sum(v % 128 != 0 for v in values)
            print(f"dequant {codec} list of {len(values)} segments "
                  f"({offsets[-1]} blocks, {ragged} ragged): bit-equal "
                  f"{equal}, max_abs_err {err:.3g}, launches {launched}, "
                  f"views at their offsets in one buffer {placed}")
            check(equal, f"dequant list call ({codec}, {label}) differs "
                         f"from its plain version")
            check(launched == -(-len(values) // ops.MAX_SEGMENTS),
                  f"dequant list call ({codec}, {label}): {launched} "
                  f"launches")
            check(placed, f"dequant list call ({codec}, {label}): segments "
                          f"not at their offsets of one buffer")
            worst = max(worst, err)
            del codes, scales, outs, plain
        x = torch.randn((2, 16, 16, 16, 128), generator=gen, device=DEVICE)
        x = (x * 3).to(torch.bfloat16)
        card, host = get_codec(codec).encode(x), get_codec(codec).encode(
            x.cpu())
        same = (torch.equal(card.codes.cpu(), host.codes)
                and torch.equal(card.scales.cpu().view(torch.int32),
                                host.scales.view(torch.int32)))
        print(f"encode {codec} on the card vs the CPU ({card.raw_bytes} raw, "
              f"{card.wire_bytes} wire bytes): codes and scales equal {same}")
        check(same, f"{codec} encode on the card differs from the CPU's")
    return worst


def _prefill_and_decode(model, prompt_len: int,
                        frontend: dict = None) -> torch.Tensor:
    """A ``prompt_len``-token prefill (with an encoder-decoder's frames or
    a vlm's patch embeddings, ``frontend``) and four teacher-forced decode
    steps; all their logits, flattened, in f32."""
    prompt = torch.arange(1, prompt_len + 1, device=DEVICE,
                          dtype=torch.int32)[None]
    frontend = frontend or {}
    prefix = 0 if "patch_embeds" not in frontend else \
        frontend["patch_embeds"].shape[1]
    logits, cache, idx = model.prefill(prompt, prefix + prompt_len + 28,
                                       **frontend)
    out = [logits]
    for i, t in enumerate((5, 6, 7, 8)):
        out.append(model.decode_step(
            cache, torch.tensor([[t]], device=DEVICE, dtype=torch.int32),
            torch.tensor([idx + i], device=DEVICE, dtype=torch.int32))[0])
    return torch.cat([o.float().reshape(-1) for o in out])


def _rel(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


#: the end-to-end limit of a dense model's check: its logits with the
#: kernels within 2e-2 (rel L2) of its logits with the plain versions, or,
#: where the stack amplifies attention's bf16 roundings past that, no
#: further from them than MODEL_FLOOR_FACTOR times an exact (f64)
#: evaluation of attention lands (full-width qwen3-32b: 0.022; PERF.md §6)
MODEL_REL_L2, MODEL_FLOOR_FACTOR = 2e-2, 1.25


def _flash_f64(q, k, v, *, causal, window=None):
    """The flash kernel's function evaluated in f64, rounded to bf16 at the
    end as every version is: the model check's exact attention."""
    from repro_torch.kernels.flash_attention.ref import NEG_INF
    rep = q.shape[2] // k.shape[2]
    k, v = (t.repeat_interleave(rep, dim=2).double() for t in (k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.double(), k) / math.sqrt(
        q.shape[-1])
    qpos = torch.arange(q.shape[1], device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones_like(logits[0, 0], dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    probs = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


def _paged_f64(q, k_pages, v_pages, block_tables, lengths):
    """The paged kernel's function evaluated in f64 (as ``_flash_f64``)."""
    b, h, d = q.shape
    kv = k_pages.shape[2]
    tables = block_tables.long()
    k, v = (t[tables].reshape(b, -1, kv, d).repeat_interleave(
        h // kv, dim=2).double() for t in (k_pages, v_pages))
    logits = torch.einsum("bhd,bkhd->bhk", q.double(), k) / math.sqrt(d)
    pos = torch.arange(k.shape[1], device=q.device)[None, :]
    logits = torch.where((pos < lengths.long()[:, None])[:, None], logits,
                         -1e30)
    return torch.einsum("bhk,bkhd->bhd", torch.softmax(logits, dim=-1),
                        v).to(q.dtype)


def _window_mask(sq: int, sk: int, causal: bool, window: int):
    """The (Sq, Sk) boolean mask of a causal or full sliding window."""
    qpos = torch.arange(sq, device=DEVICE)[:, None]
    kpos = torch.arange(sk, device=DEVICE)[None, :]
    mask = kpos > qpos - window
    return mask & (kpos <= qpos) if causal else mask


def _flash_sdpa(q, k, v, *, causal, window=None):
    """SDPA in the flash kernel's place (a yardstick, printed only); a
    window goes in as a boolean mask."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window is None:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                             enable_gqa=True)
    else:
        out = F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True,
            attn_mask=_window_mask(q.shape[1], k.shape[1], causal, window))
    return out.transpose(1, 2)


def _paged_sdpa(q, k_pages, v_pages, block_tables, lengths):
    """SDPA over the gathered pages with a length mask, in the paged
    kernel's place (a yardstick, printed only)."""
    b, h, d = q.shape
    kv = k_pages.shape[2]
    tables = block_tables.long()
    k, v = (t[tables].reshape(b, -1, kv, d).transpose(1, 2)
            for t in (k_pages, v_pages))
    pos = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = (pos < lengths.long()[:, None])[:, None, None]
    return F.scaled_dot_product_attention(q[:, :, None], k, v, attn_mask=mask,
                                          enable_gqa=True)[:, :, 0]


def _with_attention(model, flash, paged, calls=None,
                    prompt_len: int = 100, frontend: dict = None
                    ) -> torch.Tensor:
    """``_prefill_and_decode(model, prompt_len, frontend)`` with ``flash``
    and ``paged`` in the attention kernels' places (every flash call: an
    encoder's, the decoder's self and cross attention); with ``calls``,
    every call's inputs are kept there as ("flash" | "paged", args,
    kwargs)."""
    from repro_torch.models import layers, transformer
    core, kernel = layers.attention_core, transformer.pa_ops.paged_attention

    def flash_kept(q, k, v, **kw):
        if calls is not None:
            calls.append(("flash", tuple(t.contiguous() for t in (q, k, v)),
                          kw))
        return flash(q, k, v, **kw)

    def paged_kept(*args):
        if calls is not None:
            calls.append(("paged", args, {}))
        return paged(*args)

    layers.attention_core = flash_kept
    transformer.pa_ops.paged_attention = paged_kept
    try:
        with model.decode_graphs.eager():   # a replay calls no patch
            return _prefill_and_decode(model, prompt_len, frontend)
    finally:
        layers.attention_core, transformer.pa_ops.paged_attention = core, kernel


def phase_model_check(model, prompt_len: int = 100,
                      frontend: dict = None) -> None:
    """An attention model (the dense ones, hymba-1.5b, deepseek-moe-16b,
    deepseek-v2-lite-16b, seamless-m4t-medium, internvl2-76b) with its
    kernels against the same model with the kernels' plain versions
    swapped in, on the card: a ``prompt_len``-token prefill (with
    ``frontend``: an encoder-decoder's frames, whose encoder and cross
    attention run the flash kernel too, or a vlm's patch prefix) and four
    teacher-forced decode steps (an MLA model's decode is absorbed
    attention in torch and makes no paged call; hymba's at 1536 and 1100
    tokens decodes its sliding layers through their rings; an
    encoder-decoder's cross attention decodes on the flash kernel with one
    query row).

    (1) Every flash and paged call of the plain run, on its own inputs (the
    model's activations and cache), the kernel against the plain version
    within the kernel cases' limits (BF16_TOL max abs, FLASH_REL_L2 /
    PAGED_REL_L2 rel L2).  (2) End to end, the logits within MODEL_REL_L2
    (rel L2) of the plain run's, or within MODEL_FLOOR_FACTOR times the
    distance of an exact run (attention in f64, ``_flash_f64`` /
    ``_paged_f64``) from the plain run, whichever is larger: a deep stack
    of random layers amplifies the bf16 rounding of any attention output
    that differs in its last bit, so even exact attention lands that far
    from the plain version (PERF.md §6).  SDPA in both kernels'
    places is printed beside them as a yardstick."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    kernel = _prefill_and_decode(model, prompt_len, frontend)
    calls = []
    plain = _with_attention(model, flash_attention_ref, paged_attention_ref,
                            calls, prompt_len, frontend)
    exact = _with_attention(model, _flash_f64, _paged_f64,
                            prompt_len=prompt_len, frontend=frontend)
    sdpa = _with_attention(model, _flash_sdpa, _paged_sdpa,
                           prompt_len=prompt_len, frontend=frontend)
    worst = {"flash": [0.0, 0.0, 0], "paged": [0.0, 0.0, 0]}
    for kind, args, kw in calls:
        fn, ref = ((fa.flash_attention, flash_attention_ref)
                   if kind == "flash" else
                   (pa.paged_attention, paged_attention_ref))
        got, want = fn(*args, **kw).float(), ref(*args, **kw).float()
        w = worst[kind]
        w[0] = max(w[0], (got - want).abs().max().item())
        w[1] = max(w[1], _rel(got, want))
        w[2] += 1
    rel, floor = _rel(kernel, plain), _rel(exact, plain)
    limit = max(MODEL_REL_L2, MODEL_FLOOR_FACTOR * floor)
    finite = bool(torch.isfinite(kernel).all())
    what = ""
    if frontend:
        what = " with " + ", ".join(f"{k} {tuple(v.shape)}"
                                    for k, v in frontend.items())
    print(f"model check ({model.cfg.name}, {prompt_len}-token prefill{what} "
          f"+ 4 decode steps): every attention call on its own inputs, "
          f"kernel vs "
          f"plain "
          f"version: " + ", ".join(
              f"{k} {n} calls, worst max_abs_err {a:.3g} rel_l2 {r:.3g}"
              for k, (a, r, n) in worst.items())
          + f"; logits rel L2 kernels vs plain versions {rel:.5f}, exact "
          f"(f64) attention vs plain {floor:.5f}, kernels vs exact "
          f"{_rel(kernel, exact):.5f}, sdpa vs plain {_rel(sdpa, plain):.5f} "
          f"(limit {limit:.5f}); finite {finite}")
    for kind, rel_limit in (("flash", FLASH_REL_L2), ("paged", PAGED_REL_L2)):
        a, r, n = worst[kind]
        needed = kind == "flash" or not model.cfg.use_mla
        check((n > 0 or not needed) and a <= BF16_TOL and r <= rel_limit,
              f"{model.cfg.name}: the {kind} kernel disagrees with its plain "
              f"version on the model's own inputs: max abs {a}, rel L2 {r}")
    check(finite and rel <= limit,
          f"model with kernels disagrees with plain versions: {rel} > "
          f"{limit}")


def phase_xlstm_model_check(model) -> None:
    """xlstm-1.3b with the mLSTM kernel against the same model with the
    kernel's plain version swapped in: a 300-token prefill (two chunks)
    and four teacher-forced decode steps.

    The random-weight 48-block stack amplifies any f32 rounding difference
    block by block (two orderings of the plain version itself, chunk 128
    and 256, end far apart at the logits), so the logits cannot hold the
    kernel to a fixed tolerance.  Instead: (1) on the plain run, every
    mLSTM block's scan inputs are kept and the kernel is held to the plain
    version on each, at phase_mlstm's tolerance; (2) end to end, the
    kernel must move the logits no more than twice as far from the plain
    run as the plain version at chunk 128 moves them (another f32
    ordering).  The residual stream's divergence after each block is
    printed for both pairs; a single block's value is not bounded, as it
    counts bf16 roundings that happen to flip, which either pair may or
    may not hit."""
    from repro_torch.kernels.mlstm_scan import ops
    from repro_torch.kernels.mlstm_scan.ref import mlstm_chunked_ref
    from repro_torch.models import model as model_mod
    block_apply, kernel = model_mod.xlstm_block_apply, ops.mlstm_scan

    def run(scan, inputs=None):
        resid = []

        def block(*a, **k):
            out = block_apply(*a, **k)
            resid.append(out[1].float().clone())
            return out

        def scan_kept(*a, **k):
            if inputs is not None:
                inputs.append((a, k))
            return scan(*a, **k)

        model_mod.xlstm_block_apply = block
        if scan is not kernel:
            ops.mlstm_scan = scan_kept
        try:
            with model.decode_graphs.eager():   # a replay calls no patch
                logits = _prefill_and_decode(model, 300)
        finally:
            model_mod.xlstm_block_apply, ops.mlstm_scan = block_apply, kernel
        return logits, resid

    inputs = []
    plain, plain_res = run(mlstm_chunked_ref, inputs)
    other, other_res = run(lambda *a, chunk, **k: mlstm_chunked_ref(
        *a, chunk=128, **k))
    got, got_res = run(kernel)
    worst = max(_mlstm_compare(a, k, f"mLSTM block {i} of the model")[0]
                for i, (a, k) in enumerate(inputs))
    div = [(_rel(g, p), _rel(o, p))
           for g, o, p in zip(got_res, other_res, plain_res)]
    n = model.cfg.n_layers
    moved, floor = _rel(got, plain), _rel(other, plain)
    print(f"model check ({model.cfg.name}, 300-token prefill + 4 decode "
          f"steps): kernel vs plain on every mLSTM block's own "
          f"inputs ({len(inputs)} scans): worst max_abs_err {worst:.3g}; "
          f"logits rel L2 kernel vs plain {moved:.3g}, plain chunk 128 vs "
          f"256 {floor:.3g}; finite {bool(torch.isfinite(got).all())}")
    for step in range(len(div) // n):
        part = div[step * n:(step + 1) * n]
        print(f"  residual rel L2 after block (kernel vs plain | plain "
              f"orderings), {'prefill' if step == 0 else f'decode {step}'}: "
              + ", ".join(f"{i}: {g:.3g}|{o:.3g}"
                          for i, (g, o) in enumerate(part) if i % 8 in (0, 7)))
    check(bool(torch.isfinite(got).all()) and moved <= 2 * floor,
          f"the kernel moves the logits further ({moved}) than twice "
          f"another f32 ordering of the plain version does ({floor})")


def init_model(arch: str, cache: tuple = None, **over):
    """Full-width ``arch`` (an attention model) on the card, random
    weights from seed 0; prints its shape, parameters and bytes, the cache
    the main path holds (``MAIN``'s slots and length, or ``cache`` =
    (slots, length, encoder length): KV, MLA latents, ring caches, Mamba-2
    state, cross K/V), the init's wall time and the peak memory allocated
    by the init.  ``over`` replaces config fields (a depth cut)."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model, init_cache
    cfg = dataclasses.replace(get_config(arch), **over)
    slots, length, enc_len = cache or (MAIN["max_batch"], MAIN["max_len"], 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in model.buffers())
    p_bytes = sum(t.numel() * t.element_size() for t in model.buffers())
    kv = init_cache(cfg, slots, length, cfg.dtype, device="meta",
                    enc_len=enc_len)
    kv_bytes = sum(t.numel() * t.element_size() for t in _leaves(kv))
    family = ""
    if cfg.hybrid:
        family = (f"; hybrid: Mamba-2 (e {cfg.ssm_expand * cfg.d_model}, "
                  f"state {cfg.ssm_state}) beside attention, window "
                  f"{cfg.sliding_window} except layers {cfg.global_layers}")
    if cfg.n_routed_experts:
        family += (f"; MoE: {cfg.n_routed_experts} routed experts of "
                   f"{cfg.d_expert} (top {cfg.moe_top_k}) + "
                   f"{cfg.n_shared_experts} shared, dense layer 0 "
                   f"{cfg.first_layer_dense}")
    if cfg.use_mla:
        family += (f"; MLA: latent {cfg.kv_lora_rank}, rope "
                   f"{cfg.rope_head_dim}, nope {cfg.nope_head_dim}, v "
                   f"{cfg.v_head_dim}")
    if cfg.encoder_layers:
        family += (f"; encoder-decoder: {cfg.encoder_layers} encoder layers, "
                   f"{cfg.frontend} frontend stub of {cfg.frontend_tokens} "
                   f"frames, cross attention in every decoder layer")
    if cfg.family == "vlm":
        family += (f"; vision-language: {cfg.frontend_tokens} stub patch "
                   f"embeddings before the tokens")
    if over:
        family += f"; reduced: {over} (published {get_config(arch).n_layers})"
    print(f"{arch} at full width: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads ({cfg.n_kv_heads} KV) of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff} ({cfg.mlp_kind}), vocab "
          f"{cfg.vocab_size}, qkv_bias {cfg.qkv_bias}, qk_norm "
          f"{cfg.qk_norm}, tied {cfg.tie_embeddings}{family}; {n_params} "
          f"parameters ({cfg.param_count()} without the norms' scales), "
          f"{p_bytes} bytes; decode cache of {slots} slots of "
          f"{length}{f' (+ {enc_len} encoder positions)' if enc_len else ''} "
          f"{kv_bytes} bytes; init {init_s:.1f} s, peak "
          f"allocated {torch.cuda.max_memory_allocated()} bytes of "
          f"{torch.cuda.get_device_properties(0).total_memory}")
    return model


def _leaves(tree):
    """The tensors of a nested dict / list tree."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def attention_launches(cfg):
    """``phase_main``'s expected launches for an attention model: one flash
    launch per request and layer; one paged launch per decode step and
    layer, none for MLA (absorbed decode in torch).  Every layer's cache
    holds ``MAIN``'s ``max_len`` (hymba's window is 1024), so no layer
    decodes through a ring."""
    paged = 0 if cfg.use_mla else cfg.n_layers
    return lambda stats, n_req: {
        "flash_attention": n_req * cfg.n_layers,
        "paged_attention": stats["steps"] * paged, "mlstm_scan": 0,
        "dequant": 0}


def phase_drift() -> None:
    """The port's drift checks on the card: ``repro_torch.bench.packed``,
    ``.obs``, ``.chaos``, ``.tp`` and ``.quant`` recompute the
    virtual-clock rows of ``BENCH_packed.json``, ``BENCH_obs.json``,
    ``BENCH_chaos.json``, ``BENCH_tp.json`` and ``BENCH_quant.json`` with
    their smoke models on the card (chaos, tp and quant assert their
    claims inline: tokens identical at every fault rate, TP degree and
    codec, among others); every value must equal the file's within
    ``REL_TOL``.  Each check's kernel launches are counted and printed.
    Then the obs-on / obs-off host wall-time ratio of the 2x open-loop run,
    printed (host wall time, no part of the drift file).  The paper's own
    benches and ``bench.run``'s fourteen modules run in
    ``phase_benchmarks``."""
    from repro_torch.bench import REL_TOL, chaos, obs, packed, quant, tp
    counters = _counters()
    for mod, name in ((packed, "BENCH_packed.json"), (obs, "BENCH_obs.json"),
                      (chaos, "BENCH_chaos.json"), (tp, "BENCH_tp.json"),
                      (quant, "BENCH_quant.json")):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        problems = mod.check_drift(os.path.join(ROOT, name), DEVICE)
        counts = {k: fn.launches for k, fn in counters.items()}
        print(f"drift check {name} on the card (rel tol {REL_TOL:g}): "
              f"{'OK' if not problems else f'{len(problems)} values differ'}"
              f" ({time.perf_counter() - t0:.1f} s; launches {counts})")
        for p in problems:
            print(f"  {p}")
        check(not problems, f"{name}: the port's recomputation on the card "
                            f"differs from the file")
    from repro_torch.trace.harness import smoke_model
    model = smoke_model(device=DEVICE)
    rate = obs.calibrate_capacity_rps(model) * obs.LOAD_MULTIPLES[-1]
    ratio = obs.measure_overhead_ratio(model, rate)
    print(f"obs overhead on the card: obs-on / obs-off host wall time "
          f"{ratio:.4f} (interleaved min-of-3; the reference's bound "
          f"{obs.OVERHEAD_LIMIT}, host wall time, not gated here)")


def phase_benchmarks() -> dict:
    """``repro_torch.bench.run``'s fourteen modules on the card at their
    own (smoke) sizes, one module at a time as the runner calls them
    (``bench.run.module_lines``).  The eight paper benches' rows are held
    to ``bench/reference_rows.json`` (the reference's rows on the CPU):
    names exactly, values within ``REL_TOL``, derived strings equal, the
    host-wall items exempt; any difference fails the run.  Prints each
    module's host wall and its kernel launches by wrapper; the rows go to
    ``build/chip_smoke/bench_rows.csv``.  Returns the launches of all
    fourteen, by kernel."""
    from repro_torch.bench import PAPER_BENCHES, REL_TOL, reference_diff
    from repro_torch.bench.run import MODULES, module_lines
    launches = dict.fromkeys(_counters(), 0)
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    rows = ["name,us_per_call,derived"]
    for title, name in MODULES:
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lines = module_lines(name, DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _launch_counts()
        launches = {k: n + counts[k] for k, n in launches.items()}
        rows += [f"# --- {title} ---"] + lines
        held = ""
        if name in PAPER_BENCHES:
            problems = reference_diff(name, lines)
            held = ("; rows equal reference_rows.json (rel tol "
                    f"{REL_TOL:g})" if not problems else
                    f"; {len(problems)} rows differ from reference_rows.json")
            for p in problems:
                print(f"  {p}")
            check(not problems, f"bench {name}: rows on the card differ "
                                f"from the reference's")
        if name == "replay":
            held += (" (the *_s rows are modelled seconds of the virtual "
                     "clock's tpu-v5e bridge profile, not device times)")
        print(f"bench {name} on the card: {len(lines)} rows, host wall "
              f"{wall:.2f} s, launches {counts}{held}")
    with open(os.path.join(out_dir, "bench_rows.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return launches


def phase_bench_full_width(model) -> dict:
    """The paper's engine benches on full-width ``model`` (olmo-1b): the
    bridge_opt ablation (``run_variant`` for all five variants), its
    scheduling ladder at c = 2 and 8, overlap guardrail and slot-masked
    sweep, and the cluster bench's budget, routing and tenancy rows.
    Every claim of ``BENCH_CLAIMS`` must hold.  Prints each row beside the
    smoke-width value of ``reference_rows.json`` (virtual-clock values;
    the full-width model's crossings differ a little), each part's host
    wall and its kernel launches.  Returns the launches, by kernel."""
    from repro_torch.bench import REFERENCE_ROWS, load, parse_row
    from repro_torch.bench import bridge_opt, cluster

    def cluster_lines(fn):
        return lambda m: [f"{n},{v:.4f},{d}" for n, v, d in fn(m)]
    parts = [("bridge_opt ablation", bridge_opt.ablation_rows),
             ("bridge_opt scheduling ladder",
              bridge_opt.scheduling_ladder_rows),
             ("bridge_opt overlap guardrail",
              bridge_opt.overlap_guardrail_rows),
             ("bridge_opt slot-masked", bridge_opt.slot_masked_rows),
             ("cluster budget", cluster_lines(cluster.budget_throughput_rows)),
             ("cluster routing", cluster_lines(cluster.routing_rows)),
             ("cluster tenancy", cluster_lines(cluster.tenancy_rows))]
    ref = load(REFERENCE_ROWS)["rows"]
    smoke = {r["name"]: r["value"] for m in ("bridge_opt", "cluster")
             for r in ref[m]}
    launches = dict.fromkeys(_counters(), 0)
    values = {}
    for label, fn in parts:
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lines = fn(model)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _launch_counts()
        launches = {k: n + counts[k] for k, n in launches.items()}
        print(f"bench full width {label} ({model.cfg.name}, {len(lines)} "
              f"rows): host wall {wall:.2f} s, launches {counts}")
        check(counts["flash_attention"] > 0 and counts["paged_attention"] > 0,
              f"{label}: the engines launched no flash or no paged kernel")
        for line in lines:
            row = parse_row(line)
            values[row["name"]] = row["value"]
            print(f"  {row['name']} = {row['value']!r} (smoke width "
                  f"{smoke[row['name']]!r}) {row['derived']}")
    for name, holds in BENCH_CLAIMS.items():
        check(name in values, f"full width: no row {name}")
        check(holds(values[name]), f"full width: claim {name} fails "
                                   f"({values[name]!r})")
    held = ", ".join(f"{n} {values[n]!r}" for n in BENCH_CLAIMS)
    print(f"bench full width: all {len(BENCH_CLAIMS)} claims hold ({held})")
    return launches


class _Tee(io.TextIOBase):
    """Standard output that is also kept (an example's printed lines)."""

    def __init__(self):
        self.kept = io.StringIO()

    def write(self, text: str) -> int:
        self.kept.write(text)
        return sys.__stdout__.write(text)

    def flush(self) -> None:
        sys.__stdout__.flush()


def _example(name: str, argv: list) -> tuple:
    """Run ``repro_torch.examples.<name>.main(argv + --device)`` on the card:
    its printed lines (shown as they come), its result, its host wall and
    its kernel launches."""
    import contextlib
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    argv = argv + ["--device", DEVICE]
    print(f"example: python -m repro_torch.examples.{name} {' '.join(argv)}")
    _zero_counts()
    tee = _Tee()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        result = mod.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    print(f"example {name}: host wall {wall:.2f} s, launches {counts}")
    return tee.kept.getvalue(), result, counts


def phase_examples(card: str) -> dict:
    """The examples on the card: quickstart, serve_cluster and
    loader_and_offload; serve_cc_policies for olmo-1b and xlstm-1.3b (the
    mLSTM scan) at the example's smoke width; train_lm at its own full
    width (olmo-100m) for ``TRAIN_LM``'s steps into a fresh directory
    under ``build/``, then resumed to ``resume_steps`` (its first printed
    step must be the checkpoint's); the loss at the last step must be
    below the loss at step 0.  Prints the step wall (median), tok/s, peak
    memory and the checkpoints committed, with the card.  Returns the
    launches, by kernel."""
    import shutil
    from repro_torch.training.checkpoint import committed_steps
    launches = dict.fromkeys(_counters(), 0)

    def add(counts):
        return {k: n + counts[k] for k, n in launches.items()}

    text, _, counts = _example("quickstart", [])
    launches = add(counts)
    check(text.count("tokens=48") == 2, "quickstart: the two engines did "
                                        "not each serve 48 tokens")
    check(counts["flash_attention"] > 0 and counts["paged_attention"] > 0,
          "quickstart: no flash or paged launch")

    _, result, counts = _example("serve_cluster", [])
    launches = add(counts)
    check(result["finished"] == 10 and result["isolation"]["isolated"],
          f"serve_cluster: {result['finished']} of 10 finished, "
          f"isolation {result['isolation']}")
    check(counts["flash_attention"] > 0 and counts["paged_attention"] > 0,
          "serve_cluster: no flash or paged launch")

    _, result, counts = _example("loader_and_offload", [])
    launches = add(counts)
    check(result["bit_exact"], "loader_and_offload: the load through the "
                               "prewarmed pool is not bit-exact")

    for arch, kernels in (("olmo-1b", ("flash_attention", "paged_attention")),
                          ("xlstm-1.3b", ("mlstm_scan",))):
        _, result, counts = _example("serve_cc_policies", ["--arch", arch])
        launches = add(counts)
        tokens = [st["total_tokens"] for st in result.values()]
        check(tokens == [100] * 6, f"serve_cc_policies {arch}: tokens "
                                   f"{tokens}")
        check(all(counts[k] > 0 for k in kernels),
              f"serve_cc_policies {arch}: launches {counts}")

    ckpt_dir = os.path.join(ROOT, "build", f"train_lm_{os.getpid()}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    common = ["--batch", str(TRAIN_LM["batch"]), "--seq", str(TRAIN_LM["seq"]),
              "--ckpt-dir", ckpt_dir]
    try:
        torch.cuda.reset_peak_memory_stats()
        _, first, counts = _example(
            "train_lm", ["--steps", str(TRAIN_LM["steps"])] + common)
        peak = torch.cuda.max_memory_allocated()
        commits = committed_steps(ckpt_dir)
        check(all(n == 0 for n in counts.values()),
              f"train_lm launched kernels: {counts}")
        losses = first["losses"]
        last = TRAIN_LM["steps"] - 1
        check(sorted(losses) == list(range(TRAIN_LM["steps"])),
              "train_lm: a step is missing")
        check(all(math.isfinite(x) for x in losses.values()),
              "train_lm: non-finite loss")
        check(losses[last] < losses[0], f"train_lm: loss {losses[0]:.4f} at "
                                        f"step 0, {losses[last]:.4f} at "
                                        f"step {last}")
        walls = [first["step_s"][i]
                 for i in range(TRAIN_LM["median_from"], TRAIN_LM["steps"])]
        step = statistics.median(walls)
        tokens = TRAIN_LM["batch"] * TRAIN_LM["seq"]
        print(f"train_lm at full width ({first['n_params']} parameters, "
              f"{TRAIN_LM['batch']}x{TRAIN_LM['seq']}) on {card}: loss "
              f"{losses[0]:.4f} at step 0 -> {losses[last]:.4f} at step "
              f"{last}; step wall {step * 1e3:.2f} ms (median of steps "
              f"{TRAIN_LM['median_from']}-{last}; min "
              f"{min(walls) * 1e3:.2f}, max {max(walls) * 1e3:.2f}), "
              f"{tokens / step:.0f} tok/s; peak allocated {peak} bytes; "
              f"checkpoints committed at {commits}")
        every = list(range(50, TRAIN_LM["steps"] + 1, 50))
        want = every + [TRAIN_LM["steps"]] * (TRAIN_LM["steps"] % 50 != 0)
        check(commits == want, f"train_lm: committed {commits}, expected "
                               f"{want} (every 50 steps and the last)")

        text, second, _ = _example(
            "train_lm", ["--steps", str(TRAIN_LM["resume_steps"])] + common)
        printed = [int(ln.split()[1]) for ln in text.splitlines()
                   if ln.startswith("step ")]
        trained = sorted(second["losses"])
        check(printed and min(printed) >= TRAIN_LM["steps"]
              and trained[0] == TRAIN_LM["steps"],
              f"train_lm resume: printed steps {printed}, trained "
              f"{trained[:3]}...")
        commits = committed_steps(ckpt_dir)
        print(f"train_lm resume on {card}: first step trained {trained[0]}, "
              f"first printed {printed[0]} (resumed from the "
              f"step-{TRAIN_LM['steps']} checkpoint), {len(trained)} steps, "
              f"loss {second['losses'][trained[-1]]:.4f} at step "
              f"{trained[-1]}; checkpoints committed at {commits}")
        check(commits[-1] == TRAIN_LM["resume_steps"],
              f"train_lm resume: committed {commits}")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    _train_lm_profile(card)
    return launches


def _train_lm_profile(card: str) -> None:
    """One more train_lm step of the same shape (fresh weights and
    state), split by ``_train_sections`` into forward / backward /
    optimizer device time beside its host ranges."""
    from repro_torch.data.pipeline import DataConfig, batches
    from repro_torch.examples.train_lm import olmo_100m
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import (batch_to_device,
                                                 init_train_state,
                                                 make_train_step)
    cfg = olmo_100m()
    opt = AdamWConfig(lr=3e-3, warmup_steps=30,
                      total_steps=TRAIN_LM["steps"])
    params = Model(cfg, seed=0, device=DEVICE).train().params
    state = init_train_state(params, opt)
    batch = batch_to_device(next(batches(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_LM["seq"],
        global_batch=TRAIN_LM["batch"]))), DEVICE)
    step = make_train_step(cfg, opt)
    step(params, state, batch)      # the first step's allocations
    prof = _train_sections(step, params, state, batch)
    secs = prof["sections"]
    print(f"train_lm step profile ({cfg.name}, {TRAIN_LM['batch']}x"
          f"{TRAIN_LM['seq']}) on {card}: wall {prof['wall_us'] / 1e3:.2f} "
          f"ms without the profiler; device busy "
          f"{prof['busy_us'] / 1e3:.2f} ms, idle share "
          f"{_fmt(prof['idle'], '.4f')}; by section (device busy / host "
          f"range, ms): " + ", ".join(
              f"{n} {b / 1e3:.2f} / {_fmt(w and w / 1e3, '.2f')}"
              for n, (b, w) in secs.items())
          + f"; device time no section launched {prof['other_us'] / 1e3:.3f}"
          f" ms")
    for name, (n, us) in prof["top"]:
        print(f"  {us / 1e3:9.3f} ms  {n:5d} calls  {name}")


def _counters() -> dict:
    """Every kernel wrapper of the port, by name (each counts launches)."""
    from repro_torch.kernels.dequant import ops as dq
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mlstm_scan import ops as ml
    from repro_torch.kernels.paged_attention import ops as pa
    return {"flash_attention": fa.flash_attention,
            "paged_attention": pa.paged_attention,
            "mlstm_scan": ml.mlstm_scan,
            "dequant": dq.dequant}


def _main_prompts(cfg, n: int) -> list:
    """``n`` prompts at MAIN's lengths in turn, tokens drawn from seed 1
    (the first eight are the main path's)."""
    gen = torch.Generator().manual_seed(1)
    lens = MAIN["prompt_lens"]
    return [torch.randint(1, cfg.vocab_size, (lens[i % len(lens)],),
                          generator=gen).tolist() for i in range(n)]


def phase_width_probes(model, max_lens: tuple, wide: bool = False) -> dict:
    """``model``'s width probes through the engine (``_width_probe``) at
    MAIN's max_batch and each of ``max_lens`` over widths 1 ... max_batch,
    on MAIN's prompts: every row must be width-independent and every pad
    row equal to its original.  With ``wide``, also PROBES' wide slots at
    MAIN's max_len over its wide widths, gated the same way, and beside it
    the raw model at those widths as a report: above 8 rows a projection's
    GEMM runs another algorithm for another row count, and the report
    names the first op whose output differs.  Returns the gated probes by
    max_len (the wide one under ``"wide"``)."""
    def gated(n_slots, max_len, **kw):
        probe = _width_probe(model, _main_prompts(model.cfg, n_slots),
                             n_slots, max_len, **kw)
        check(probe["independent"], f"width probe {model.cfg.name}, "
              f"{n_slots} slots at max_len {max_len}: rows depend on the "
              f"width or a pad row differs from its original "
              f"({probe['first_difference']})")
        return probe

    probes = {max_len: gated(MAIN["max_batch"], max_len)
              for max_len in max_lens}
    if wide:
        probes["wide"] = gated(PROBES["wide"], MAIN["max_len"],
                               widths=PROBES["wide_widths"])
        _width_probe(model, _main_prompts(model.cfg, PROBES["wide"]),
                     PROBES["wide"], MAIN["max_len"],
                     widths=PROBES["wide_widths"], via_engine=False)
    torch.cuda.empty_cache()
    return probes


def _serve_run(model, prompts: list, new_tokens: list, *, policy,
               max_batch: int, max_len: int, packed: bool = True) -> dict:
    """Serve ``prompts`` (request i greedy for ``new_tokens[i]`` tokens)
    on a fresh engine of ``max_batch`` slots at ``max_len`` under
    ``policy``, CC on (``packed`` False: the dense step).  Each token is
    recorded with its forward's widths and top-2 gap (``_record_widths``).
    Checks every request finished with its tokens, all in the vocab,
    finite logits and a lawful tape.  Returns the stats, the tokens and
    records by request, the kernel launches, the run's and the prefills'
    host walls, the stepping rows of each decode step and the tape's
    crossings."""
    import dataclasses
    from repro_torch.core.policy import cc_aware_defaults
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import SamplingParams
    from repro_torch.trace import TraceRecorder, check_tape

    vocab = model.cfg.vocab_size
    counters = _counters()
    engine = ServingEngine(model, max_batch=max_batch, max_len=max_len,
                           policy=policy, cc_on=True, seed=0, device=DEVICE,
                           defaults=dataclasses.replace(
                               cc_aware_defaults(True), packed_decode=packed))
    finite = torch.ones((), dtype=torch.bool, device=DEVICE)
    prefill_s = [0.0]
    inner_prefill, inner_decode = model.prefill, model.decode_step
    records, stash = {}, {}

    def prefill(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner_prefill(*a, **k)
        finite.logical_and_(torch.isfinite(out[0]).all())
        stash["gap"] = _top2_gap(out[0])
        torch.cuda.synchronize()
        prefill_s[0] += time.perf_counter() - t0
        return out

    def decode_step(*a, **k):
        out = inner_decode(*a, **k)
        finite.logical_and_(torch.isfinite(out[0]).all())
        stash["gap"] = _top2_gap(out[0])
        return out

    model.prefill, model.decode_step = prefill, decode_step
    _record_widths(engine, records, stash)
    recorder = TraceRecorder(engine.gateway, policy=policy.value,
                             label=f"chip-smoke-{policy.value}")
    for i, p in enumerate(prompts):
        engine.submit(Request(f"r{i}", prompt=p, sampling=SamplingParams(
            max_new_tokens=new_tokens[i])))
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with recorder:
            stats = engine.run()
        torch.cuda.synchronize()
    finally:
        engine.close()
        del model.prefill, model.decode_step
        # the record patches hold the engine: drop them with its caches
        del engine._prefill_into_slot, engine._consume
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in counters.items()}

    label = f"{model.cfg.name} {policy.value}{'' if packed else ' dense'}"
    check(stats["finished"] == len(prompts), f"{label}: "
          f"{stats['finished']} of {len(prompts)} requests finished")
    for r in engine.finished:
        want = new_tokens[int(r.request_id[1:])]
        check(len(r.output_tokens) == want, f"{label}: {r.request_id} has "
              f"{len(r.output_tokens)} tokens, not {want}")
        check(all(0 <= t < vocab for t in r.output_tokens),
              f"{label}: token outside the vocab")
    check(bool(finite), f"{label}: non-finite logits")
    report = check_tape(recorder.tape())
    check(report.ok, f"{label}: tape violates the bridge law:\n"
                     f"{report.format()}")
    return dict(stats=stats, counts=counts, wall=wall, prefill_s=prefill_s[0],
                tokens={r.request_id: r.output_tokens
                        for r in engine.finished},
                records=records, rows=[t.active for t in engine.trace],
                crossings=recorder.tape().n_crossings(),
                profile=engine.bridge.profile.name)


def _decode_rate(run: dict, n_req: int) -> str:
    """The run's decode tokens over its host wall less its prefills'."""
    tokens = run["stats"]["total_tokens"] - n_req
    wall = run["wall"] - run["prefill_s"]
    return (f"run wall {run['wall']:.4f} s, prefill wall "
            f"{run['prefill_s']:.4f} s, decode {tokens} tokens in "
            f"{wall:.4f} s = {tokens / wall:.1f} decode tok/s")


def phase_main(model, expected, probe: dict = None) -> dict:
    """Serve MAIN's requests under each policy (``_serve_run``);
    ``expected(stats, n_req)`` gives each kernel's launch count for one
    run.  The async and worker runs' tokens are held to the sync run's by
    ``_token_criterion`` against ``probe`` (the model's engine width probe
    at MAIN's shape; run here only if tokens differ and none was given).
    Returns the launches of the three runs together, by kernel."""
    from repro_torch.core.policy import SchedulingPolicy

    cfg = model.cfg
    prompts = _main_prompts(cfg, len(MAIN["prompt_lens"]))
    n_req = len(prompts)
    launches = dict.fromkeys(_counters(), 0)
    runs = {}
    for policy in (SchedulingPolicy.SYNC_DRAIN, SchedulingPolicy.ASYNC_OVERLAP,
                   SchedulingPolicy.WORKER_DRAIN):
        run = _serve_run(model, prompts, [MAIN["new_tokens"]] * n_req,
                         policy=policy, max_batch=MAIN["max_batch"],
                         max_len=MAIN["max_len"])
        stats, counts = run["stats"], run["counts"]
        for name, n in counts.items():
            launches[name] += n
        want = expected(stats, n_req)
        check(counts == want, f"{policy.value}: kernel launches {counts}, "
                              f"expected {want}")
        print(f"main path {cfg.name} {policy.value}: {n_req} requests, "
              f"{stats['total_tokens']} tokens, {stats['steps']} decode steps; "
              f"launches {counts}; tape ok ({run['crossings']} crossings)")
        print(f"  modelled (virtual clock, {run['profile']} bridge "
              f"profile, CC on): virtual_time_s {stats['virtual_time_s']!r} "
              f"bridge_time_s {stats['bridge_time_s']!r} compute_time_s "
              f"{stats['compute_time_s']!r} crossings {stats['crossings']} "
              f"mean_ttft_s {stats['mean_ttft_s']!r}")
        print(f"  measured on the card: {_decode_rate(run, n_req)}")
        runs[policy.value] = run
    base, others = runs.pop("sync"), runs
    if probe is None and any(r["tokens"] != base["tokens"]
                             for r in others.values()):
        probe = _width_probe(model, prompts, MAIN["max_batch"],
                             MAIN["max_len"])
    explained = {name: _token_criterion(f"main path {cfg.name} {name}", base,
                                        run, probe, base_name="sync")
                 for name, run in others.items()}
    same = sum(all(r["tokens"][rid] == want for r in others.values())
               for rid, want in base["tokens"].items())
    widths = sorted({r[:2] for recs in base["records"].values()
                     for r in recs if r[0]})
    print(f"main path {cfg.name} tokens across policies: {same} of "
          f"{len(base['tokens'])} requests equal under sync, async and "
          f"worker; explained by width {explained}; decode widths (stepping, "
          f"executed rows) in the sync run {widths}; rows width-independent "
          f"{'not probed' if probe is None else probe['independent']}")
    return launches


def phase_wide(model) -> dict:
    """More than 8 rows on the paper's model with its 1k-token prompts
    (``WIDE``): 48 greedy requests through 32 slots, so the stepping rows
    shrink as requests finish and regrow as queued ones are admitted,
    served sync packed, worker packed and sync dense.  Every request's
    tokens must be equal across the three, with no width criterion, and
    the packed runs must have stepped at most 8 and at least 17 rows.
    Then one 32-row decode step's host and device time (``_profile_steps``)
    and the peak memory.  Returns the launches of the three runs."""
    from repro_torch.core.policy import SchedulingPolicy
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import SamplingParams

    cfg = model.cfg
    n_req, slots = WIDE["n_requests"], WIDE["max_batch"]
    new_tokens = [8 + 8 * (i % 5) for i in range(n_req)]
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(1, cfg.vocab_size, (WIDE["prompt_len"],),
                             generator=gen).tolist() for _ in range(n_req)]
    expected = attention_launches(cfg)
    launches = dict.fromkeys(_counters(), 0)
    runs = {}
    for name, policy, packed in (
            ("sync packed", SchedulingPolicy.SYNC_DRAIN, True),
            ("worker packed", SchedulingPolicy.WORKER_DRAIN, True),
            ("sync dense", SchedulingPolicy.SYNC_DRAIN, False)):
        run = _serve_run(model, prompts, new_tokens, policy=policy,
                         max_batch=slots, max_len=WIDE["max_len"],
                         packed=packed)
        gc.collect()
        torch.cuda.empty_cache()
        want = expected(run["stats"], n_req)
        check(run["counts"] == want, f"wide {name}: kernel launches "
              f"{run['counts']}, expected {want}")
        for k, n in run["counts"].items():
            launches[k] += n
        executed = sorted({r[1] for recs in run["records"].values()
                           for r in recs if r[0]})
        print(f"wide {cfg.name} {name} ({n_req} requests of "
              f"{WIDE['prompt_len']} tokens, {slots} slots at max_len "
              f"{WIDE['max_len']}, CC on): {run['stats']['total_tokens']} "
              f"tokens, {run['stats']['steps']} decode steps, stepping rows "
              f"min {min(run['rows'])} max {max(run['rows'])}, executed "
              f"rows {executed}; launches {run['counts']}; tape ok "
              f"({run['crossings']} crossings); {_decode_rate(run, n_req)}")
        if packed:
            check(min(run["rows"]) <= 8 and max(run["rows"]) >= 17,
                  f"wide {name}: stepping rows {min(run['rows'])}-"
                  f"{max(run['rows'])}, not both <= 8 and >= 17")
        runs[name] = run
    base = runs["sync packed"]["tokens"]
    same = {name: sum(r["tokens"][rid] == want for rid, want in base.items())
            for name, r in runs.items()}
    print(f"wide {cfg.name} tokens: requests equal to sync packed's {same} "
          f"of {n_req}")
    check(all(r["tokens"] == base for r in runs.values()),
          f"wide {cfg.name}: tokens differ across sync packed, worker "
          f"packed and sync dense ({same} of {n_req} equal)")

    engine = ServingEngine(model, max_batch=slots, max_len=WIDE["max_len"],
                           policy=SchedulingPolicy.SYNC_DRAIN, cc_on=True,
                           device=DEVICE)
    for i in range(slots):
        engine.submit(Request(f"p{i}", prompt=prompts[i],
                              sampling=SamplingParams(max_new_tokens=12)))
    _profile_steps(engine, f"profile {cfg.name} wide: decode step of "
                           f"{slots} rows (prompts of {WIDE['prompt_len']})")
    print(f"wide {cfg.name}: peak allocated {torch.cuda.max_memory_allocated()}"
          f" bytes of {torch.cuda.get_device_properties(0).total_memory}")
    torch.cuda.empty_cache()
    return launches


def phase_moe_routing(model) -> None:
    """The MoE prefills' capacity drops: MAIN's prompts prefilled one by
    one (as the engine admits them), every MoE layer's dispatch counted;
    prints, per prompt, the token-slots kept and dropped over the layers
    (capacity ``max(k, ceil(t*k/e*1.25))`` a layer and expert)."""
    from repro_torch.models import layers
    cfg = model.cfg
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen)
               for n in MAIN["prompt_lens"]]
    dispatch = layers.moe_dispatch
    seen = []

    def counted(idx, n_experts, capacity):
        out = dispatch(idx, n_experts, capacity)
        seen.append((out[2].sum(), out[2].numel(), capacity))
        return out

    layers.moe_dispatch = counted
    parts = []
    try:
        for p in prompts:
            seen.clear()
            model.prefill(p.to(DEVICE, torch.int32)[None], MAIN["max_len"])
            kept = int(sum(k for k, _, _ in seen))
            slots = sum(n for _, n, _ in seen)
            parts.append(f"{len(p)}: kept {kept} dropped {slots - kept} "
                         f"(capacity {seen[0][2]}, {len(seen)} layers)")
            check(len(seen) == cfg.n_layers - 1 and kept <= slots,
                  f"{cfg.name}: {len(seen)} MoE dispatches in a prefill")
    finally:
        layers.moe_dispatch = dispatch
    print(f"moe routing {cfg.name} (prefills of MAIN's prompts, token-slots "
          f"over the MoE layers): " + "; ".join(parts))


def phase_hymba_ring(model) -> dict:
    """hymba-1.5b past its window: the model check at 1536 and 1100
    tokens (every flash call, the window biting in the sliding layers, and
    every paged call of the global layers held to the plain versions; the
    logits of the prefill and four ring decode steps to the plain run's),
    then RING's three requests served under each policy at ``max_len``
    2048: flash once per request and layer, paged once per decode step in
    each global layer, every sliding layer's decode through its ring
    (counted); tokens equal across the policies.  Returns the launches of
    the three runs together, by kernel."""
    from repro_torch.core.policy import SchedulingPolicy
    from repro_torch.models import transformer
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import SamplingParams
    cfg = model.cfg
    n_global = sum(transformer.layer_window(cfg, i) is None
                   for i in range(cfg.n_layers))
    for n in RING["prompt_lens"][:2]:
        check(n > cfg.sliding_window, "the ring phase's prompts must pass "
                                      "the window")
        phase_model_check(model, prompt_len=n)
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in RING["prompt_lens"]]
    counters = _counters()
    launches = dict.fromkeys(counters, 0)
    ring = transformer.ring_decode_attention
    rings = [0]

    def ring_counted(*a, **k):
        rings[0] += 1
        return ring(*a, **k)

    tokens = {}
    transformer.ring_decode_attention = ring_counted
    try:
        with model.decode_graphs.eager():  # a replay counts no ring decode
            for policy in (SchedulingPolicy.SYNC_DRAIN,
                           SchedulingPolicy.ASYNC_OVERLAP,
                           SchedulingPolicy.WORKER_DRAIN):
                engine = ServingEngine(model, max_batch=RING["max_batch"],
                                       max_len=RING["max_len"], policy=policy,
                                       cc_on=True, seed=0, device=DEVICE)
                for i, p in enumerate(prompts):
                    engine.submit(Request(
                        f"r{i}", prompt=p, sampling=SamplingParams(
                            max_new_tokens=RING["new_tokens"])))
                for fn in counters.values():
                    fn.launches = 0
                rings[0] = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    stats = engine.run()
                    torch.cuda.synchronize()
                finally:
                    engine.close()
                wall = time.perf_counter() - t0
                counts = {name: fn.launches for name, fn in counters.items()}
                for name, c in counts.items():
                    launches[name] += c
                tokens[policy.value] = {r.request_id: list(r.output_tokens)
                                        for r in engine.finished}
                want = {"flash_attention": len(prompts) * cfg.n_layers,
                        "paged_attention": stats["steps"] * n_global,
                        "mlstm_scan": 0, "dequant": 0}
                print(f"ring {cfg.name} {policy.value} (prompts "
                      f"{RING['prompt_lens']}, max_len {RING['max_len']}, "
                      f"window {cfg.sliding_window}): {stats['steps']} "
                      f"decode steps, {stats['total_tokens']} tokens; "
                      f"launches {counts}; ring decodes {rings[0]} "
                      f"({cfg.n_layers - n_global} sliding layers a step); "
                      f"wall {wall:.3f} s")
                check(stats["finished"] == len(prompts) and all(
                    len(t) == RING["new_tokens"]
                    for t in tokens[policy.value].values()),
                    f"ring {policy.value}: requests unfinished")
                check(counts == want, f"ring {policy.value}: launches "
                                      f"{counts}, expected {want}")
                check(rings[0] == stats["steps"] * (cfg.n_layers - n_global),
                      f"ring {policy.value}: {rings[0]} ring decodes in "
                      f"{stats['steps']} steps")
    finally:
        transformer.ring_decode_attention = ring
    same = len({json.dumps(t, sort_keys=True) for t in tokens.values()}) == 1
    print(f"ring token criterion: tokens equal across the three policies "
          f"{same}")
    check(same, "ring: the policies' tokens differ")
    return launches


# ---------------------------------------------------------------------------------
# training and the encoder-decoder / vision families
# ---------------------------------------------------------------------------------

def _launch_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def _zero_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def _train_sections(step, params, state, batch) -> dict:
    """Where a train step's time goes: ``step`` (``make_train_step``'s
    closure, whose sections are marked ``train/forward``,
    ``train/backward`` and ``train/optimizer``) runs once timed, after a
    synchronize, for the step's wall, then once under the profiler.  A
    device event belongs to the section whose host range holds the host
    op that launched it (the profiler lists each op's device events as
    its ``kernels``, and again on a runtime call that shares the op's id:
    each id is read once); the device time no op in a section claims is
    counted apart.  The idle share is what the device leaves of the
    unprofiled step's wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = ("train/forward", "train/backward", "train/optimizer")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(params, state, batch)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, state, batch)
        torch.cuda.synchronize()
    events = prof.events()
    ranges = {n: [e.time_range for e in events if e.name == n
                  and e.device_type != DeviceType.CUDA] for n in names}
    busy = dict.fromkeys(names, 0.0)
    total = 0.0
    by_name: dict = {}
    seen = set()
    for e in events:
        if e.name in names:
            continue
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            total += us
            n_us = by_name.setdefault(e.name[:60], [0, 0.0])
            n_us[0] += 1
            n_us[1] += us
        elif e.kernels and e.id not in seen:
            seen.add(e.id)
            at = e.time_range.start
            for name in names:
                if any(r.start <= at <= r.end for r in ranges[name]):
                    busy[name] += sum(k.duration for k in e.kernels)
                    break
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return dict(wall_us=wall_us, busy_us=total,
                other_us=total - sum(busy.values()), top=top,
                sections={n.split("/")[1]: (busy[n], sum(
                    r.elapsed_us() for r in ranges[n]) or None)
                          for n in names},
                idle=1 - total / wall_us if total else None)


def _all_position_logits(model, tokens, **frontend) -> torch.Tensor:
    """The prefill-mode trunk (the flash kernel, no cache kept) over a
    whole batch, logits at every position, in f32."""
    from repro_torch.models import model as model_mod
    with torch.no_grad():
        x, pos, enc, prefix = model_mod._assemble_inputs(
            model.params, model.cfg, tokens, **frontend)
        x, _, _ = model_mod._trunk(model.params, model.cfg, x,
                                   mode="prefill", positions=pos,
                                   max_len=x.shape[1], enc_out=enc)
        return model_mod._logits(model.params, model.cfg,
                                 x[:, prefix:]).float()


def phase_train_vs_kernels(model, tokens) -> None:
    """The training path and the serving path compute one model: on
    ``tokens``, the train-mode logits (``models.model.forward``: blockwise
    torch attention, autograd on) and the prefill-mode logits (the flash
    kernel) each against the prefill-mode logits with the kernel's plain
    version swapped in, within phase_model_check's logits limit
    (max(MODEL_REL_L2, MODEL_FLOOR_FACTOR x exact attention's distance))."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import layers
    from repro_torch.models.model import forward
    cfg = model.cfg
    _zero_counts()
    with torch.enable_grad():
        logits, _ = forward(model.params, cfg, {"tokens": tokens})
        check(logits.requires_grad, "train mode built no autograd graph")
        train = logits.detach().float()
    del logits
    train_launches = _launch_counts()
    kernel = _all_position_logits(model, tokens)
    core = layers.attention_core
    out = {}
    for name, fn in (("plain", flash_attention_ref), ("exact", _flash_f64)):
        layers.attention_core = lambda q, k, v, **kw: fn(
            q.contiguous(), k.contiguous(), v.contiguous(), **kw)
        try:
            out[name] = _all_position_logits(model, tokens)
        finally:
            layers.attention_core = core
    plain, exact = out["plain"], out["exact"]
    floor = _rel(exact, plain)
    limit = max(MODEL_REL_L2, MODEL_FLOOR_FACTOR * floor)
    rel_train, rel_kernel = _rel(train, plain), _rel(kernel, plain)
    print(f"train vs kernels ({cfg.name}, B={tokens.shape[0]} "
          f"S={tokens.shape[1]}, attn_impl {cfg.attn_impl} block "
          f"{cfg.attn_block_kv}): logits rel L2 train mode vs plain "
          f"{rel_train:.5f}, prefill mode (flash kernel) vs plain "
          f"{rel_kernel:.5f}, train vs prefill {_rel(train, kernel):.5f}, "
          f"exact (f64) vs plain {floor:.5f} (limit {limit:.5f}); kernel "
          f"launches in train mode {train_launches}")
    check(all(n == 0 for n in train_launches.values()),
          f"train mode launched kernels: {train_launches}")
    check(bool(torch.isfinite(train).all()) and rel_train <= limit
          and rel_kernel <= limit,
          f"train mode {rel_train} / prefill mode {rel_kernel} against the "
          f"plain version's logits, limit {limit}")


def phase_train(card: str) -> None:
    """Full-width olmo-1b trained on the card.  (1) ``launch/train.py``'s
    path (the data pipeline's batches, ``TrainLoop`` with the step wall
    after a synchronize, AdamW in place, remat as the config says) for
    TRAIN's steps at its batch and length: its own lines (loss per step,
    step wall, tok/s), the peak memory, no kernel launched; one more step
    timed and one profiled, split into forward, backward and optimizer
    (``_train_sections``).  (2) Train mode
    against the kernels (``phase_train_vs_kernels``).  (3) Memorisation:
    the optimizer state zeroed, ``memorise_steps`` on one repeated batch;
    the loss must fall by ``memorise_drop``.  (4) One async checkpoint of
    the full state under ``build/`` (deleted after): the step wall while
    it is pending, its write and read rates, and the restore bit-equal to
    the state saved."""
    import shutil
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, batches
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import Model
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.optimizer import AdamWConfig, leaves
    from repro_torch.training.train_loop import (batch_to_device,
                                                 make_train_step)
    cfg = get_config("olmo-1b")
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", "olmo-1b", "--steps", str(TRAIN["steps"]), "--batch",
            str(TRAIN["batch"]), "--seq", str(TRAIN["seq"]), "--lr",
            str(TRAIN["lr"]), "--device", DEVICE]
    print(f"train {cfg.name}: python -m repro_torch.launch.train "
          f"{' '.join(argv)} (remat {cfg.remat}, policy {cfg.remat_policy}, "
          f"attn_impl {cfg.attn_impl}) on {card}")
    t0 = time.perf_counter()
    result = launch_train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = _launch_counts()
    losses = [result["losses"][i] for i in sorted(result["losses"])]
    params, state = result["params"], result["opt_state"]
    n_params = sum(t.numel() for t in leaves(params))
    state_bytes = sum(t.numel() * t.element_size()
                      for t in leaves(params) + leaves(state["mu"])
                      + leaves(state["nu"]))
    tokens = TRAIN["steps"] * TRAIN["batch"] * TRAIN["seq"]
    print(f"train {cfg.name} at full width: {n_params} parameters, state "
          f"{state_bytes} bytes (bf16 parameters, f32 mu and nu); "
          f"{TRAIN['steps']} steps of {TRAIN['batch']}x{TRAIN['seq']} in "
          f"{wall:.2f} s with the first step's allocations "
          f"({tokens / wall:.0f} tok/s); loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; stragglers {result['stragglers']}; peak "
          f"allocated {peak} bytes; kernel launches {counts}")
    check(all(math.isfinite(x) for x in losses), "non-finite training loss")
    check(all(n == 0 for n in counts.values()),
          f"training launched kernels: {counts}")
    check(n_params == cfg.param_count(), f"{cfg.name} has {n_params} "
                                         f"parameters, its config "
                                         f"{cfg.param_count()}")

    model = Model(cfg, params=params, device=DEVICE)
    opt = AdamWConfig(lr=TRAIN["lr"], warmup_steps=3,
                      total_steps=TRAIN["steps"])
    data = batches(DataConfig(vocab_size=cfg.vocab_size,
                              seq_len=TRAIN["seq"],
                              global_batch=TRAIN["batch"], seed=1))
    prof = _train_sections(make_train_step(cfg, opt), params, state,
                           batch_to_device(next(data), DEVICE))
    secs = prof["sections"]
    print(f"train step profile ({cfg.name}, {TRAIN['batch']}x"
          f"{TRAIN['seq']}): wall {prof['wall_us'] / 1e3:.2f} ms without "
          f"the profiler ({TRAIN['batch'] * TRAIN['seq'] / prof['wall_us'] * 1e6:.0f}"
          f" tok/s); device busy {prof['busy_us'] / 1e3:.2f} ms, idle share "
          f"{_fmt(prof['idle'], '.4f')}; by section (device busy / host "
          f"range, ms): " + ", ".join(
              f"{n} {b / 1e3:.2f} / {_fmt(w and w / 1e3, '.2f')}"
              for n, (b, w) in secs.items())
          + f"; device time no section launched {prof['other_us'] / 1e3:.3f}"
          f" ms; {sum(n for _, (n, _) in prof['top'])} launches in the top "
          f"{len(prof['top'])} kernels")
    for name, (n, us) in prof["top"]:
        print(f"  {us / 1e3:9.3f} ms  {n:5d} calls  {name}")

    phase_train_vs_kernels(model, batch_to_device(next(data), DEVICE)[
        "tokens"][:1])

    for t in leaves(state["mu"]) + leaves(state["nu"]):
        t.zero_()
    state["step"] = torch.zeros((), dtype=torch.int32, device=DEVICE)
    mem_opt = AdamWConfig(lr=TRAIN["memorise_lr"], warmup_steps=2,
                          total_steps=TRAIN["memorise_steps"])
    step = make_train_step(cfg, mem_opt)
    batch = next(data)
    mem, walls = [], []
    for _ in range(TRAIN["memorise_steps"]):
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        mem.append(float(metrics["loss"]))
    drop = mem[0] - mem[-1]
    print(f"train memorise ({cfg.name}, one batch repeated, lr "
          f"{TRAIN['memorise_lr']}): loss " + " ".join(f"{x:.4f}" for x in mem)
          + f"; fell by {drop:.4f} (at least {TRAIN['memorise_drop']}); "
          f"step wall median {statistics.median(walls) * 1e3:.1f} ms")
    check(drop >= TRAIN["memorise_drop"],
          f"the loss fell by {drop} over {len(mem)} steps on one batch")

    root = os.path.join(ROOT, "build", "train_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    free = shutil.disk_usage(root).free
    # the state as saved, kept in host memory: device copies would take
    # the allocator's cached blocks, so the next step would allocate anew
    # and its wall would not be the pending save's
    kept = [t.detach().to("cpu", copy=True)
            for t in leaves(params) + leaves(state["mu"])
            + leaves(state["nu"]) + [state["step"]]]
    nbytes = sum(t.numel() * t.element_size() for t in kept)
    at = int(state["step"])
    try:
        t0 = time.perf_counter()
        ckpt.save(root, params, state, at, async_commit=True)
        snap = time.perf_counter() - t0
        pending = []
        for _ in range(TRAIN["pending_steps"]):
            busy = any(t.is_alive() for t in ckpt._PENDING)
            t1 = time.perf_counter()
            params, state, _ = step(params, state, batch)
            torch.cuda.synchronize()
            pending.append((time.perf_counter() - t1, busy))
        ckpt.wait_for_pending()
        write = time.perf_counter() - t0
        t0 = time.perf_counter()
        got_p, got_s, got_step = ckpt.restore(root, at, params, state)
        torch.cuda.synchronize()
        read = time.perf_counter() - t0
        got = (leaves(got_p) + leaves(got_s["mu"]) + leaves(got_s["nu"])
               + [got_s["step"]])
        same = len(got) == len(kept) and all(
            _same_bits(a.detach().cpu(), b) for a, b in zip(got, kept))
        phase_elastic(cfg, root, kept, got_p)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"train checkpoint ({cfg.name}, step {at}, {nbytes} bytes, "
          f"{free} bytes free at build/): snapshot to host "
          f"{snap:.2f} s, committed after {write:.2f} s "
          f"({nbytes / write / 1e9:.3f} GB/s), restore {read:.2f} s "
          f"({nbytes / read / 1e9:.3f} GB/s); step wall while the save was "
          f"pending " + ", ".join(f"{w * 1e3:.1f} ms{'' if b else ' (done)'}"
                                  for w, b in pending)
          + f" against {statistics.median(walls) * 1e3:.1f} ms; restore "
          f"bit-equal {same} (parameters, mu, nu, step {got_step})")
    check(same and got_step == at, "the restored training state differs "
                                   "from the state saved")
    del model, params, state, kept, got, got_p, got_s, result
    torch.cuda.empty_cache()


def phase_elastic(cfg, root: str, kept: list, trained) -> None:
    """``launch/elastic.py::reshard`` of the checkpoint just written (the
    full training state: parameters, mu, nu, step) onto a 1x1 CUDA
    ``DeviceMesh`` of a one-rank NCCL group: every leaf must be bit-equal
    to the state saved (``kept``, on the host); the wall time and GB/s.
    Then ``MAIN``'s requests under the sync policy from the re-placed
    parameters must give the tokens of the in-memory ``trained`` ones.
    The group is destroyed after."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.elastic import free_port, reshard
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import leaves, tree_map
    dist.init_process_group("nccl" if DEVICE == "cuda" else "gloo",
                            rank=0, world_size=1,
                            init_method=f"tcp://localhost:{free_port()}")
    try:
        mesh = init_device_mesh(DEVICE, (1, 1),
                                mesh_dim_names=("data", "model"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reshard(root, cfg.name, mesh, cfg=cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        placed = (leaves(out["params"]) + leaves(out["opt"]["mu"])
                  + leaves(out["opt"]["nu"]) + [out["opt"]["step"]])
        local = [t.to_local() for t in placed]
        nbytes = sum(t.numel() * t.element_size() for t in local)
        same = len(local) == len(kept) and all(
            _same_bits(a.detach().cpu(), b) for a, b in zip(local, kept))
        kinds = sorted({str(tuple(t.placements)) for t in placed})
        print(f"elastic reshard ({cfg.name}, step {out['step']}, "
              f"{len(placed)} leaves, {nbytes} bytes) onto mesh "
              f"{out['mesh']} ({mesh.device_type}, placements {kinds}): "
              f"{wall:.2f} s ({nbytes / wall / 1e9:.3f} GB/s); every leaf "
              f"bit-equal to the state saved {same}")
        check(same, "the resharded state differs from the state saved")
        params = tree_map(lambda t: t.to_local(), out["params"])
        want, _, _ = _serve_sync(Model(cfg, params=trained, device=DEVICE),
                                 "elastic in-memory")
        got, counts, serve_wall = _serve_sync(
            Model(cfg, params=params, device=DEVICE), "elastic re-placed")
        print(f"elastic serving ({cfg.name}, {len(got)} requests, sync): "
              f"tokens of the re-placed parameters equal the in-memory "
              f"ones {got == want}; launches {counts}; wall "
              f"{serve_wall:.3f} s")
        check(got == want, "the re-placed parameters serve other tokens")
        del out, placed, local, params
    finally:
        dist.destroy_process_group()


def _kernel_flops(cfg, kind: str, lengths: list, rows: int = 1) -> float:
    """Analytic operations of the attention kernels of one step (they run
    through ctypes, out of the cost counter's sight): a causal prefill of
    each of ``lengths`` (4 H D per unmasked (q, k) pair, every layer), or
    one decode step of ``rows`` rows over ``lengths`` keys each."""
    per = 4.0 * cfg.n_heads * cfg.head_dim * cfg.n_layers
    if kind == "prefill":
        return per * sum(n * (n + 1) // 2 for n in lengths)
    return per * sum(lengths) * rows // len(lengths)


def phase_cost(model) -> None:
    """The cost counter (``launch/cost_analysis.py``) over three steps of
    full-width olmo-1b on the card: one decode step of ``MAIN``'s 8 rows,
    the prefills of ``MAIN``'s 8 prompts, and one 8 x 512 train step.  Per
    step: the counted flops and bytes, the kernel-substituted ones (the
    marked regions' bytes swapped for ``dryrun.kernel_bytes``, the
    kernels' analytic operations added: the counter cannot see inside a
    ctypes launch), compute_s and memory_s on the H100 constants, and the
    profiler's device-busy ms of the same step.  Each marked region must
    have been entered as often as its wrapper launched."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.cost_analysis import CostCounter
    from repro_torch.launch.dryrun import HBM_BW, PEAK_FLOPS, kernel_bytes
    from repro_torch.training.optimizer import AdamWConfig, tree_map
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)
    cfg = model.cfg
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(1, cfg.vocab_size, (1, n), generator=gen
                             ).to(DEVICE) for n in MAIN["prompt_lens"]]
    rows, at = len(prompts), max(MAIN["prompt_lens"])
    _, caches, _ = model.prefill(torch.randint(
        1, cfg.vocab_size, (rows, at), generator=gen).to(DEVICE),
        MAIN["max_len"])
    step_tok = torch.randint(1, cfg.vocab_size, (rows, 1), generator=gen
                             ).to(DEVICE)
    index = torch.full((rows,), at, dtype=torch.int64, device=DEVICE)
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      model.params)
    opt = AdamWConfig()
    state = init_train_state(params, opt)
    train_step = make_train_step(cfg, opt)
    batch = {k: torch.randint(1, cfg.vocab_size, (8, 512), generator=gen
                              ).to(DEVICE) for k in ("tokens", "targets")}
    batch["loss_mask"] = torch.ones((8, 512), device=DEVICE)
    steps = {
        "decode": (lambda: model.decode_step(caches, step_tok, index, None,
                                             MAIN["max_len"]),
                   [InputShape("decode", at + 1, rows, "decode")],
                   _kernel_flops(cfg, "decode", [at + 1] * rows, rows)),
        "prefill": (lambda: [model.prefill(p, MAIN["max_len"])
                             for p in prompts],
                    [InputShape("prefill", n, 1, "prefill")
                     for n in MAIN["prompt_lens"]],
                    _kernel_flops(cfg, "prefill", MAIN["prompt_lens"])),
        "train": (lambda: train_step(params, state, batch), [], 0.0),
    }
    counters = _counters()
    for name, (fn, shapes, k_flops) in steps.items():
        for f in counters.values():
            f.launches = 0
        with CostCounter() as counter:
            fn()
            torch.cuda.synchronize()
        r = counter.result()
        launched = {k: f.launches for k, f in counters.items() if f.launches}
        entered = r["region_entries"]
        kb = {}
        for sh in shapes:
            for k, v in kernel_bytes(cfg, sh).items():
                if k in launched:
                    kb[k] = kb.get(k, 0) + v
        marked = sum(r["marked_bytes"].values())
        sub_bytes = r["bytes_accessed"] - marked + sum(kb.values())
        sub_flops = r["flops"] + k_flops
        busy = _kernel_breakdown(fn, f"cost {name}", calls=1, show=False)
        print(f"cost counter {cfg.name} {name}: flops {r['flops']:.6g} "
              f"(kernel-substituted {sub_flops:.6g}), bytes "
              f"{r['bytes_accessed']:.6g} (no copies "
              f"{r['bytes_accessed_no_copy']:.6g}; marked {marked:.6g} "
              f"-> kernels {sum(kb.values()):.6g}: substituted "
              f"{sub_bytes:.6g}); compute_s {sub_flops / PEAK_FLOPS:.6g} "
              f"memory_s {sub_bytes / HBM_BW:.6g} (raw "
              f"{r['flops'] / PEAK_FLOPS:.6g} / "
              f"{r['bytes_accessed'] / HBM_BW:.6g}); device busy "
              f"{_fmt(busy, '.4f')} ms (profiler); regions entered "
              f"{entered}, launches {launched}; trip counts "
              f"{r['trip_counts']}")
        check(entered == launched, f"cost {name}: regions entered {entered}"
                                   f", wrappers launched {launched}")
    del params, state, caches
    torch.cuda.empty_cache()


def phase_dryrun() -> None:
    """``launch/dryrun.py::run_cell`` for ``DRYRUN``'s cells on the
    card's host: a fake process group of 256 or 512 ranks, meta DTensors,
    nothing on the card.  Every cell must come back ``ok``; each prints
    its roofline terms (H100 constants)."""
    from repro_torch.launch import dryrun
    out_dir = os.path.join(ROOT, "build", "dryrun")
    for arch, shape, multi_pod in DRYRUN:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod, force=True,
                              out_dir=out_dir)
        wall = time.perf_counter() - t0
        if rec.get("status") != "ok":
            print(f"dry run {arch} {shape} {rec['mesh']}: "
                  f"{rec.get('status')} {rec.get('error', '')}\n"
                  f"{rec.get('traceback', '')}")
        check(rec.get("status") == "ok", f"dry run {arch} {shape}: "
                                         f"{rec.get('status')}")
        print(f"dry run {arch} {shape} {rec['mesh']} ({rec['chips']} ranks "
              f"as {rec['exec_mesh']}, {wall:.1f} s): flops/device {rec['flops_per_device']:.6g}, "
              f"bytes/device {rec['bytes_per_device']:.6g}, collective "
              f"bytes {rec['collectives']['total_bytes']}; compute_s "
              f"{rec['compute_s']:.6g} memory_s {rec['memory_s']:.6g} "
              f"(kernel-substituted "
              f"{rec['kernel_substitution']['memory_s']:.6g}) collective_s "
              f"{rec['collective_s']:.6g}: {rec['dominant']}; useful "
              f"{rec['useful_flops_ratio']:.4f}; local ops "
              f"{rec['local_ops']}")


def _greedy_serve(model, tokens, new_tokens: int, **frontend) -> dict:
    """Model-level serving of one batch: a prefill (with ``frontend``)
    and ``new_tokens - 1`` greedy decode steps.  Returns the tokens (B,
    new_tokens), the prefill's and the decode's wall, the prefill's and the
    whole run's launches by kernel, and whether every logit was finite."""
    _zero_counts()
    b, s = tokens.shape
    prefix = frontend["patch_embeds"].shape[1] \
        if "patch_embeds" in frontend else 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache, idx = model.prefill(tokens, prefix + s + new_tokens,
                                       **frontend)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = _launch_counts()
    finite = torch.isfinite(logits).all()
    out = [logits[:, -1].float().argmax(-1)]
    index = torch.full((b,), idx, dtype=torch.int32, device=DEVICE)
    t0 = time.perf_counter()
    for _ in range(new_tokens - 1):
        logits, cache = model.decode_step(
            cache, out[-1][:, None].to(torch.int32), index)
        finite = finite & torch.isfinite(logits).all()
        out.append(logits[:, -1].float().argmax(-1))
        index += 1
    torch.cuda.synchronize()
    return dict(tokens=torch.stack(out, 1).cpu(), prefill_s=prefill_s,
                decode_s=time.perf_counter() - t0,
                prefill_launches=prefill_launches, launches=_launch_counts(),
                finite=bool(finite), index=idx)


def _serve_report(model, run: dict, want_prefill: dict, want: dict,
                  label: str) -> None:
    cfg = model.cfg
    toks = run["tokens"]
    b, n = toks.shape
    steps = n - 1
    print(f"serve {label}: {b} requests, prefill to position {run['index']} "
          f"in {run['prefill_s']:.4f} s, {steps} decode steps in "
          f"{run['decode_s']:.4f} s ({b * steps / run['decode_s']:.1f} decode "
          f"tok/s); launches prefill {run['prefill_launches']}, whole run "
          f"{run['launches']}; finite {run['finite']}; first request's tokens "
          f"{toks[0, :8].tolist()}")
    check(run["finite"], f"{label}: non-finite logits")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"{label}: token outside the vocab")
    check(run["prefill_launches"] == want_prefill,
          f"{label}: prefill launches {run['prefill_launches']}, expected "
          f"{want_prefill}")
    check(run["launches"] == want, f"{label}: launches {run['launches']}, "
                                   f"expected {want}")


def phase_encdec(model) -> dict:
    """seamless-m4t-medium at full width, model-level (the serving engine
    feeds only tokens, as the reference's does): the model check with 512
    stub frames (every encoder, self and cross attention call held to the
    kernel cases' limits), then ENCDEC's requests: one prefill (the
    encoder's flash calls, causal as the reference's scanned encoder; the
    decoder's causal self attention; cross attention over the frames at
    Sq = prompt, Sk = frames) and greedy decode (self attention on the
    paged kernel at D = 64, cross attention on the flash kernel with one
    query row over the cached cross K/V).  Returns the launches."""
    from repro_torch.models.frontends import synthetic_frontend_embeddings
    cfg = model.cfg
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    frames = synthetic_frontend_embeddings(gen, cfg, ENCDEC["batch"])
    tokens = torch.randint(1, cfg.vocab_size,
                           (ENCDEC["batch"], ENCDEC["prompt_len"]),
                           generator=gen, device=DEVICE, dtype=torch.int32)
    phase_model_check(model, prompt_len=ENCDEC["prompt_len"],
                      frontend={"frames": frames[:1]})
    run = _greedy_serve(model, tokens, ENCDEC["new_tokens"], frames=frames)
    steps = ENCDEC["new_tokens"] - 1
    none = {"mlstm_scan": 0, "dequant": 0}
    want_prefill = dict(flash_attention=cfg.encoder_layers + 2 * cfg.n_layers,
                        paged_attention=0, **none)
    want = dict(flash_attention=want_prefill["flash_attention"]
                + steps * cfg.n_layers,
                paged_attention=steps * cfg.n_layers, **none)
    _serve_report(model, run, want_prefill, want,
                  f"{cfg.name} ({frames.shape[1]} frames, prompts of "
                  f"{ENCDEC['prompt_len']}; flash a prefill: "
                  f"{cfg.encoder_layers} encoder + {cfg.n_layers} self + "
                  f"{cfg.n_layers} cross; a decode step: {cfg.n_layers} "
                  f"paged (self, D {cfg.head_dim}) + {cfg.n_layers} flash "
                  f"(cross, Sq 1 Sk {frames.shape[1]}))")
    return run["launches"]


def phase_encdec_train(model) -> None:
    """seamless-m4t-medium's train steps at full width (ENCDEC's batch and
    length, frames from the data pipeline) through ``make_train_step``:
    after the first, every encoder and cross-attention leaf's first moment
    (a tenth of its clipped gradient) must hold a nonzero element; the
    loss must stay finite; no kernel is launched."""
    from repro_torch.data.pipeline import DataConfig, batches
    from repro_torch.models.model import _flatten
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)
    cfg = model.cfg
    model.train()
    opt = AdamWConfig(lr=1e-4, warmup_steps=1,
                      total_steps=ENCDEC["train_steps"])
    data = batches(DataConfig(vocab_size=cfg.vocab_size,
                              seq_len=ENCDEC["train_seq"],
                              global_batch=ENCDEC["train_batch"]),
                   model_cfg=cfg)
    state = init_train_state(model.params, opt)
    step = make_train_step(cfg, opt)
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    walls, losses, reached = [], [], None
    for _ in range(ENCDEC["train_steps"]):
        t0 = time.perf_counter()
        _, state, metrics = step(model.params, state, next(data))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        if reached is None:
            reached = [(name, bool((mu != 0).any()))
                       for name, mu in _flatten(state["mu"])
                       if name.startswith("encoder") or "cross" in name]
    model.eval()
    counts = _launch_counts()
    missing = [name for name, ok in reached if not ok]
    print(f"train {cfg.name} ({ENCDEC['train_steps']} steps of "
          f"{ENCDEC['train_batch']}x{ENCDEC['train_seq']} with "
          f"{cfg.frontend_tokens} frames each): loss "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; step wall " + " ".join(f"{w * 1e3:.0f}" for w in walls)
          + f" ms; first moments nonzero after step 1 (a gradient arrived) "
          f"in {len(reached) - len(missing)} of {len(reached)} encoder and "
          f"cross-attention leaves; peak "
          f"allocated {torch.cuda.max_memory_allocated()} bytes; kernel "
          f"launches {counts}")
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    check(reached and not missing, f"no gradient reached {missing}")
    check(all(n == 0 for n in counts.values()),
          f"training launched kernels: {counts}")


def phase_vlm(model) -> dict:
    """internvl2-76b at full width and VLM's depth: the model check with
    the patch prefix, then VLM's requests (stub patch embeddings before
    the prompt tokens): one prefill (flash over patches and tokens, H64 /
    KV8) and greedy decode on the paged kernel.  Returns the launches."""
    from repro_torch.models.frontends import synthetic_frontend_embeddings
    cfg = model.cfg
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    patches = synthetic_frontend_embeddings(gen, cfg, VLM["batch"])
    tokens = torch.randint(1, cfg.vocab_size,
                           (VLM["batch"], VLM["prompt_len"]),
                           generator=gen, device=DEVICE, dtype=torch.int32)
    phase_model_check(model, prompt_len=VLM["prompt_len"],
                      frontend={"patch_embeds": patches[:1]})
    run = _greedy_serve(model, tokens, VLM["new_tokens"],
                        patch_embeds=patches)
    steps = VLM["new_tokens"] - 1
    none = {"mlstm_scan": 0, "dequant": 0}
    want_prefill = dict(flash_attention=cfg.n_layers, paged_attention=0,
                        **none)
    want = dict(flash_attention=cfg.n_layers,
                paged_attention=steps * cfg.n_layers, **none)
    check(run["index"] == patches.shape[1] + VLM["prompt_len"],
          f"the prefill ends at {run['index']}")
    _serve_report(model, run, want_prefill, want,
                  f"{cfg.name} at {cfg.n_layers} of "
                  f"80 layers ({patches.shape[1]} patches + "
                  f"{VLM['prompt_len']} tokens; H{cfg.n_heads} "
                  f"KV{cfg.n_kv_heads} D{cfg.head_dim})")
    return run["launches"]


def phase_profile(model) -> None:
    """Where a full-width decode step's time goes: ``_profile_steps`` over
    the sync-policy decode steps of 8 resident requests."""
    from repro_torch.core.policy import SchedulingPolicy
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import SamplingParams
    engine = ServingEngine(model, max_batch=MAIN["max_batch"],
                           max_len=MAIN["max_len"],
                           policy=SchedulingPolicy.SYNC_DRAIN, cc_on=True,
                           device=DEVICE)
    gen = torch.Generator().manual_seed(2)
    for i, n in enumerate(MAIN["prompt_lens"]):
        engine.submit(Request(f"p{i}", prompt=torch.randint(
            1, model.cfg.vocab_size, (n,), generator=gen).tolist(),
            sampling=SamplingParams(max_new_tokens=12)))
    prof = _profile_steps(engine, f"profile {model.cfg.name}: decode step "
                                  f"({len(MAIN['prompt_lens'])} rows)")
    if prof and prof["paged_us"]:
        PROFILED[model.cfg.name] = dict(lengths=prof["lengths"],
                                        paged_us=prof["paged_us"])


def _profile_steps(engine, label: str, steps: int = 4):
    """torch.profiler over ``steps`` decode steps of ``engine`` (whose
    submitted requests all fit its slots and outlast ``2 + 2 * steps``
    steps), after two untimed steps (admissions, prefills, the first
    decode) and ``steps`` timed without it; closes the engine.  Device
    busy time is the sum of the device-side events (kernels and copies;
    one stream, so they do not overlap); host-side operator rows, which
    repeat their kernels' time, are left out.  The idle share is what the
    device leaves of the unprofiled step's wall time.  Returns the paged
    kernel's launches (us, sorted) and the middle profiled step's lengths;
    None if the profiler saw no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    lengths = []                      # the paged kernel's, per profiled step
    try:
        engine.step()                 # admissions, prefills, first decode
        engine.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        plain_us = (time.perf_counter() - t0) * 1e6
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                lengths.append([engine.active[s].index + 1
                                for s in sorted(engine.active)])
                engine.step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        engine.close()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    if not events:
        print("profile: the profiler saw no device events; device busy "
              "time not measured")
        return None
    busy = sum(dev_us(e) for e in events)
    print(f"{label} {plain_us / steps:.1f} us on the host clock without "
          f"the profiler, {wall_us / steps:.1f} us with it; device busy "
          f"{busy / steps:.1f} us per step; idle share "
          f"{1 - busy / plain_us:.4f} (without the profiler)")
    for e in sorted(events, key=dev_us, reverse=True)[:8]:
        print(f"  {dev_us(e) / steps:9.1f} us/step  {e.count // steps:4d} "
              f"calls/step  {e.key[:90]}")
    paged = sorted(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA and "paged" in e.name)
    if paged:
        print(f"  paged kernel per launch in the profiled steps: "
              f"{len(paged)} launches, min {paged[0]:.1f} median "
              f"{paged[len(paged) // 2]:.1f} mean "
              f"{sum(paged) / len(paged):.1f} max {paged[-1]:.1f} us; "
              f"lengths per step {lengths}")
    return dict(paged_us=paged, lengths=lengths[steps // 2])


def _restore_run(model, kv_quant: str, blocks: list, shared: list,
                 shorts: list, *, faults=None, forced: bool = False) -> dict:
    """One restore-under-decode run: spill ``blocks`` through an
    ``OffloadManager`` on the engine's gateway, serve the shared prompt
    (``r0``) and the short ones, restore the blocks for ``r0`` after the
    first step, and run to the end.  Returns what the checks read.

    ``faults`` (a ``FaultPlan``) attaches a fault injector to the gateway
    before anything is spilled; ``forced`` puts its degradation ladder on
    the sync-restore rung just before the restore.  A faulted run takes no
    profiled breakdown."""
    from dataclasses import replace
    from repro_torch.core.bridge import B300, BridgeModel
    from repro_torch.core.policy import (OffloadPolicy, SchedulingPolicy,
                                         cc_aware_defaults)
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.offload import OffloadManager
    from repro_torch.serving.sampler import SamplingParams
    from repro_torch.trace import TraceRecorder, check_tape
    from repro_torch.trace import opclasses as oc

    sync = SchedulingPolicy.SYNC_DRAIN
    defaults = replace(cc_aware_defaults(True, bridge_opt=True),
                       scheduling=sync, slot_masked_decode=True,
                       kv_quant=kv_quant)
    engine = ServingEngine(model, max_batch=RESTORE["max_batch"],
                           max_len=RESTORE["max_len"], policy=sync,
                           bridge=BridgeModel(B300, cc_on=True),
                           defaults=defaults, seed=0, device=DEVICE)
    mgr = OffloadManager(engine.gateway, OffloadPolicy.REUSE_AWARE,
                         pipelined_restore=True,
                         restore_chunk_bytes=RESTORE["chunk_bytes"],
                         kv_quant=kv_quant, compute_model=engine.compute)
    mgr.on_restore_done.append(engine.mark_restore)
    engine.gateway.pool.prewarm()   # secure contexts up before serving
    recorder = TraceRecorder(engine.gateway, policy=sync.value,
                             label=f"chip-smoke-restore-{kv_quant or 'bf16'}")
    injector = None
    if faults is not None:
        from repro_torch.resilience import FaultInjector
        injector = FaultInjector(faults).attach(engine.gateway)
    counters = _counters()
    hashes = list(range(len(blocks)))
    try:
        with recorder:
            for fn in counters.values():
                fn.launches = 0
            for h, block in zip(hashes, blocks):
                for _ in range(mgr.store_threshold):
                    mgr.observe(h)
                check(mgr.evict(h, payload=block), f"block {h} not spilled")
            engine.submit(Request("r0", prompt=shared, sampling=SamplingParams(
                max_new_tokens=RESTORE["new_tokens"])))
            for i, p in enumerate(shorts):
                engine.submit(Request(f"r{i + 1}", prompt=p,
                                      sampling=SamplingParams(
                                          max_new_tokens=RESTORE[
                                              "short_new_tokens"])))
            engine.step()               # every request resident and decoding
            torch.cuda.synchronize()
            before = sum(len(r.output_tokens) for r in engine.active.values())
            if forced:
                # held for the ladder's quiet window: the restore reads it
                injector.ladder.escalate(engine.clock.now, reason="forced")
                injector.ladder.observe_fault(engine.clock.now)
            t0 = time.perf_counter()
            hits = mgr.restore(hashes, key="r0")
            torch.cuda.synchronize()
            restore_wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            stats = engine.run()
            torch.cuda.synchronize()
            run_wall = time.perf_counter() - t0
        counts = {name: fn.launches for name, fn in counters.items()}
        breakdown = None
        if faults is None:
            timed = dict(mgr.restored)
            breakdown = _restore_breakdown(mgr, hashes)
            mgr.restored = timed
    finally:
        engine.close()
    tape = recorder.tape()
    restore = [r for r in tape.records if r.kind == "crossing"
               and r.op_class in (oc.KV_RESTORE_H2D, oc.KV_RESTORE_PIPELINED,
                                  oc.KV_RESTORE_Q)]
    report = check_tape(tape)
    check(report.ok, f"restore {kv_quant or 'bf16'}: tape violates the "
                     f"bridge law:\n{report.format()}")
    return dict(
        mgr=mgr, stats=stats, counts=counts, hits=hits, tape=tape,
        tokens={r.request_id: list(r.output_tokens) for r in engine.finished},
        restore_wire=sum(r.nbytes for r in restore),
        restore_raw=sum(r.raw_bytes or r.nbytes for r in restore),
        dequant_s=sum(r.t_end - r.t_start for r in tape.records
                      if r.op_class == oc.DEQUANT_COMPUTE),
        restore_wall=restore_wall, run_wall=run_wall, breakdown=breakdown,
        decode_tokens=stats["total_tokens"] - before, injector=injector)


def _restore_breakdown(mgr, hashes: list) -> str:
    """One more restore of ``hashes`` (after the timed one, off the tape,
    unkeyed) under the profiler: device time of the host-to-device copies,
    of the dequant kernel and of every other kernel, and the host clock of
    the upload (the restore's start to the widen step, the copies synced)
    and of the widen step (synced).  Measures only: the manager's widen
    step is wrapped for this one call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    marks = {}
    widen = mgr._widen

    def timed_widen(hits, arrived):
        torch.cuda.synchronize()
        marks["upload"] = time.perf_counter()
        out = widen(hits, arrived)
        torch.cuda.synchronize()
        marks["widen"] = time.perf_counter()
        return out

    mgr._widen = timed_widen
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mgr.restore(hashes)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    finally:
        del mgr._widen
    parts = {"h2d": [0.0, 0], "dequant": [0.0, 0], "other": [0.0, 0]}
    other = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        part = ("h2d" if "HtoD" in e.key else
                "dequant" if "dequant" in e.key else "other")
        parts[part][0] += us
        parts[part][1] += e.count
        if part == "other":
            other.append(f"{e.key[:40]} x{e.count}")
    host = (f"host upload {(marks['upload'] - t0) * 1e3:.4f} ms, widen "
            f"{(marks['widen'] - marks['upload']) * 1e3:.4f} ms, rest "
            f"{(t1 - marks['widen']) * 1e3:.4f} ms of {(t1 - t0) * 1e3:.4f}")
    device = "; ".join(f"{k} {us / 1e3:.5f} ms device ({n} events)"
                       for k, (us, n) in parts.items())
    return f"{device} [{', '.join(other) or 'none'}]; {host}"


def _check_restored(kv_quant: str, mgr, blocks: list) -> str:
    """Every restored block against what was spilled: bit-identical when
    unquantized; quantized, equal bit for bit to the plain version on the
    card and to the CPU codec's decode of the same host-store codes, and
    within the codec's per-block bound of the spilled values."""
    from repro_torch.kernels.dequant.ref import dequant_ref
    from repro_torch.quant import get_codec, split_wire
    worst = 0.0
    for h, block in enumerate(blocks):
        got = mgr.restored.pop(h)
        if not kv_quant:
            check(got.dtype == block.dtype and torch.equal(got, block),
                  f"unquantized restore of block {h} differs from the "
                  f"spilled rows")
            continue
        host = mgr.host_store[h]
        qb = host.qblock
        check(host.payload.nbytes == qb.wire_bytes
              == qb.codes.numel() + 4 * qb.scales.numel(),
              f"block {h}: host wire buffer is not codes + scales")
        codes, scales = split_wire(torch.from_numpy(host.payload).to(DEVICE),
                                   qb.codes.numel())
        plain = dequant_ref(codes.reshape(-1, 128), scales[:, None],
                            codec=kv_quant).reshape(block.shape)
        on_cpu = get_codec(kv_quant).decode(qb)
        check(_bit_equal(got, plain) and _bit_equal(got.cpu(), on_cpu),
              f"{kv_quant}: widened block {h} differs from the plain "
              f"version or the CPU codec's decode")
        amax = block.float().abs().reshape(-1, 128).amax(1)
        err = (got - block.float()).abs().reshape(-1, 128).amax(1)
        rel = (err / amax.clamp_min(1e-30)).max().item()
        check(bool((err <= amax * (QUANT_BOUND[kv_quant] + F32_SLACK)).all()),
              f"{kv_quant}: block {h} off by {rel} of its block amax "
              f"(bound {QUANT_BOUND[kv_quant]})")
        worst = max(worst, rel)
    if not kv_quant:
        return f"{len(blocks)} blocks bit-identical to the spilled rows"
    return (f"{len(blocks)} blocks bit-equal to the plain version and the "
            f"CPU decode; worst per-block error {worst:.6g} of amax "
            f"(bound {QUANT_BOUND[kv_quant]:.6g})")


def phase_restore(model) -> int:
    """Full-width olmo-1b's KV restore under decode, once per codec in "",
    fp8 and int8: the shared prompt's K/V (from the model's prefill) spills
    as blocks of (2, layers, 16 tokens, KV heads, head dim) bf16 and is
    restored pipelined for ``r0`` while three short requests decode (the
    reference's bench_quant shape at full width, with real payloads).
    Checks tokens across codecs, restore bytes, the tapes (law Q
    included), the launch counts (one dequant launch per quantized
    restore) and every restored block, and prints each codec's restore
    breakdown.  Each quantized codec then restores twice more under
    seeded restore corruption (``_faulted_restores``).  Returns the
    dequant launches of the quantized runs."""
    cfg = model.cfg
    gen = torch.Generator().manual_seed(3)
    shared = torch.randint(1, cfg.vocab_size, (RESTORE["prompt_len"],),
                           generator=gen).tolist()
    shorts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
              for n in RESTORE["short_lens"]]
    _, cache, _ = model.prefill(
        torch.tensor([shared], dtype=torch.int32, device=DEVICE),
        RESTORE["max_len"])
    kv = cache["blocks"]["kv"]                  # (L, 1, cap, KV, D)
    bt = RESTORE["block_tokens"]
    blocks = [torch.stack([kv["k"][:, 0, t:t + bt], kv["v"][:, 0, t:t + bt]])
              .contiguous() for t in range(0, RESTORE["prompt_len"], bt)]
    del cache, kv
    n_req = 1 + len(RESTORE["short_lens"])
    runs, dequant_launches = {}, 0
    for q in ("", "fp8", "int8"):
        run = _restore_run(model, q, blocks, shared, shorts)
        stats, counts = run["stats"], run["counts"]
        name = q or "bf16"
        check(run["hits"] == (len(blocks),
                              len(blocks) * blocks[0].nbytes),
              f"restore {name}: {run['hits']} restored")
        check(stats["finished"] == n_req, f"restore {name}: "
              f"{stats['finished']} of {n_req} requests finished")
        want = {"flash_attention": n_req * cfg.n_layers,
                "paged_attention": stats["steps"] * cfg.n_layers,
                "mlstm_scan": 0, "dequant": 1 if q else 0}
        check(counts == want, f"restore {name}: kernel launches {counts}, "
                              f"expected {want}")
        clean = dict(run["mgr"].restored)
        checked = _check_restored(q, run["mgr"], blocks)
        dequant_launches += counts["dequant"]
        runs[q] = run
        vt = stats["virtual_time_s"]
        print(f"restore under decode {cfg.name} {name}: {len(blocks)} blocks "
              f"of {blocks[0].nbytes} bytes ({tuple(blocks[0].shape)} "
              f"{blocks[0].dtype}), {stats['total_tokens']} tokens, "
              f"{stats['steps']} decode steps; launches {counts}; tape ok "
              f"({run['tape'].n_crossings()} crossings); {checked}")
        print(f"  modelled (virtual clock, B300 bridge profile, CC on, "
              f"bridge_opt): virtual_time_s {vt!r} tok/s "
              f"{stats['total_tokens'] / vt!r} restore wire bytes "
              f"{run['restore_wire']} raw bytes {run['restore_raw']} "
              f"dequant_s {run['dequant_s']!r}")
        print(f"  measured on the card: restore wall "
              f"{run['restore_wall']:.4f} s (spilled blocks up, widened); "
              f"run wall {run['run_wall']:.4f} s, decode "
              f"{run['decode_tokens']} tokens = "
              f"{run['decode_tokens'] / run['run_wall']:.1f} decode tok/s")
        print(f"  restore breakdown (one more restore, profiled): "
              f"{run['breakdown']}")
        if q:
            dequant_launches += _faulted_restores(model, q, blocks, shared,
                                                  shorts, clean, run)
    base = runs[""]
    for q in ("fp8", "int8"):
        check(runs[q]["tokens"] == base["tokens"],
              f"restore {q}: greedy tokens differ from the unquantized run")
        ratio = runs[q]["restore_wire"] / base["restore_wire"]
        print(f"restore {q}: wire bytes {ratio:.6f} of the unquantized "
              f"run's; tokens identical to it")
        check(ratio <= 0.55, f"restore {q}: wire ratio {ratio} > 0.55")
    return dequant_launches


def _faulted_restores(model, kv_quant: str, blocks: list, shared: list,
                      shorts: list, clean: dict, base: dict) -> int:
    """The codec's restore again under ``RESTORE_FAULTS``, once with the
    degradation ladder at level 0 (the pipelined restore, whose integrity
    reject re-sends the whole prefix) and once forced to the sync-restore
    rung (per-block redos).  Every restored block must be bit-equal to the
    fault-free restore's (``clean``), redos are charged and move nothing
    (one dequant launch a restore, one RETRY record a redo), and at least
    one redo happens.  Returns the dequant launches."""
    from repro_torch.resilience import FaultPlan
    from repro_torch.trace import opclasses as oc
    cfg = model.cfg
    n_req = 1 + len(RESTORE["short_lens"])
    launches = 0
    for forced in (False, True):
        arm = "sync-restore rung" if forced else "ladder at level 0"
        run = _restore_run(model, kv_quant, blocks, shared, shorts,
                           faults=FaultPlan(**RESTORE_FAULTS), forced=forced)
        stats, mgr, counts = run["stats"], run["mgr"], run["counts"]
        fs = run["injector"].stats
        where = f"restore {kv_quant} under faults ({arm})"
        check(run["hits"] == base["hits"], f"{where}: {run['hits']} restored")
        check(stats["finished"] == n_req, f"{where}: {stats['finished']} "
                                          f"of {n_req} requests finished")
        want = {"flash_attention": n_req * cfg.n_layers,
                "paged_attention": stats["steps"] * cfg.n_layers,
                "mlstm_scan": 0, "dequant": 1}
        check(counts == want, f"{where}: kernel launches {counts}, "
                              f"expected {want}")
        retries = [r for r in run["tape"].records if oc.RETRY in r.tags]
        check(mgr.stats.restore_retries > 0
              and len(retries) == mgr.stats.restore_retries
              == fs.restore_corruptions,
              f"{where}: {mgr.stats.restore_retries} redos, "
              f"{len(retries)} RETRY records, {fs.restore_corruptions} "
              f"corruptions")
        check(mgr.stats.sync_restores_forced == int(forced)
              and mgr.stats.pipelined_restores == int(not forced),
              f"{where}: {mgr.stats.pipelined_restores} pipelined, "
              f"{mgr.stats.sync_restores_forced} forced sync")
        check(sorted(mgr.restored) == sorted(clean)
              and all(_bit_equal(mgr.restored[h], clean[h]) for h in clean),
              f"{where}: a restored block differs from the fault-free "
              f"restore's")
        launches += counts["dequant"]
        print(f"{where}: plan {RESTORE_FAULTS}; {mgr.stats.restore_retries} "
              f"redos ({len(retries)} RETRY records of "
              f"{sum(r.nbytes for r in retries)} bytes, charged, none "
              f"moved), {fs.injected_events} injected events; launches "
              f"{counts}; {len(clean)} blocks bit-equal to the fault-free "
              f"restore's; tokens identical to the fault-free run's: "
              f"{run['tokens'] == base['tokens']}")
        print(f"  modelled: redo s {fs.restore_redo_s!r}, virtual_time_s "
              f"{stats['virtual_time_s']!r} (fault-free "
              f"{base['stats']['virtual_time_s']!r})")
        print(f"  measured on the card: restore wall "
              f"{run['restore_wall']:.4f} s (fault-free "
              f"{base['restore_wall']:.4f} s), run wall "
              f"{run['run_wall']:.4f} s")
    return launches


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    return tree.clone()


def _top2_gap(logits: torch.Tensor) -> torch.Tensor:
    """Per row, the largest logit less the second largest (f32, on the
    card): how far a greedy token is from flipping."""
    top = logits.reshape(logits.shape[0], -1).float().topk(2, dim=-1).values
    return top[:, 0] - top[:, 1]


def _record_ops(record: list):
    """Patch the decode forward so each block's einsum outputs and its
    attention output (``_paged_core``'s) are appended to ``record`` as
    (label, tensor), the label naming the block (its call's number) and
    the einsum's equation with its call's number within the block (a dense
    block: q, k, v ``bsd,dhk->bshk`` [0-2], attention, ``bshk,hkd->bsd``,
    the MLP's ``bsd,df->bsf`` and ``bsf,fd->bsd``; the logits
    ``bsd,dv->bsv`` after the last block).  Returns a function that undoes
    the patch."""
    from repro_torch.models import model as model_mod
    from repro_torch.models import transformer
    block, seen = [-1], {}
    saved = torch.einsum, transformer._paged_core, model_mod.block_apply
    einsum, core, apply = saved

    def note(what, out):
        n = seen.get((block[0], what), 0)
        seen[(block[0], what)] = n + 1
        record.append((f"block {block[0]} {what}[{n}]", out.detach().clone()))
        return out

    def block_apply(*a, **k):
        block[0] += 1
        return apply(*a, **k)

    torch.einsum = lambda eq, *ops: note(eq, einsum(eq, *ops))
    transformer._paged_core = lambda *a: note("attention", core(*a))
    model_mod.block_apply = block_apply

    def undo():
        torch.einsum, transformer._paged_core, model_mod.block_apply = saved
    return undo


def _width_probe(model, prompts: list, max_batch: int, max_len: int,
                 widths=None, via_engine: bool = True) -> dict:
    """``max_batch`` resident rows (one per prompt, after one decode step
    of an engine of ``max_batch`` slots at ``max_len``) stepped in calls
    of each of ``widths`` rows (default 1 ... ``max_batch``): the calls of
    width w take rows s, ..., s+w-1 modulo the rows (s = 0, w, 2w, ...),
    so every row runs at every width; and dense (every slot, the second
    half as the dense step's padding, as ``_step_dense`` calls the
    model); each call on its own copy of the cache.  ``via_engine``: each
    packed call is the engine's own (``ServingEngine._decode_packed``,
    executed at ``_bucket``'s width, pad rows copying the first stepping
    row), and every pad row's logits must be bit-equal to the row it
    copies; otherwise ``model.decode_step`` runs at the call's width (the
    raw model, a report).  Returns whether every row's logits are
    bit-equal across the widths it ran at (and, via the engine, every pad
    row equal to its original), the largest difference against the widest
    call, by width, and the top-2 gaps there.  Where a row differs, the
    first differing call is run again beside the widest with
    ``_record_ops`` and the first block and op whose output for that row
    differs is named."""
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import SamplingParams
    widths = list(widths or range(1, max_batch + 1))
    engine = ServingEngine(model, max_batch=max_batch, max_len=max_len,
                           cc_on=True, seed=0, device=DEVICE)
    pads_equal = [True]
    try:
        for i, p in enumerate(prompts[:max_batch]):
            engine.submit(Request(f"p{i}", prompt=p,
                                  sampling=SamplingParams(max_new_tokens=4)))
        engine.step()               # all resident, one decode step taken
        slots = sorted(engine.active)
        check(len(slots) == max_batch, "width probe: not all rows resident")
        tokens = {s: engine.active[s].output_tokens[-1] for s in slots}
        index = {s: engine.active[s].index for s in slots}
        saved = engine.caches

        def run(rows, width, record=None):
            """Rows ``rows`` at their slots in a call of ``width`` rows
            (the rest, if any, padding at their slots), or through the
            engine when ``width`` is None: {slot: logits}, or with
            ``record`` {label: {slot: output row}} of ``_record_ops``."""
            if width is None:
                call, rows = list(range(max_batch)), sorted(rows)
                known = rows
            else:
                pad = [s for s in slots if s not in rows][:width - len(rows)]
                call = sorted(list(rows) + pad)
                known = call
            tok = torch.tensor([[tokens[s] if s in rows else 0]
                                for s in known], dtype=torch.int32,
                               device=DEVICE)
            idx = torch.tensor([index[s] if s in rows else 0 for s in known],
                               dtype=torch.int32, device=DEVICE)
            sl = torch.tensor(known, dtype=torch.int32, device=DEVICE)
            ops = []
            undo = _record_ops(ops) if record else None
            try:
                # a replay records no op
                with (model.decode_graphs.eager() if record
                      else contextlib.nullcontext()):
                    if width is None:
                        engine.caches = _clone_tree(saved)
                        logits = engine._decode_packed(tok, idx, sl)
                    else:
                        logits, _ = model.decode_step(
                            _clone_tree(saved), tok, idx, sl,
                            max_len=max_len)
            finally:
                if undo:
                    undo()
            if record:                  # the ops over the call's rows
                return {label: {s: out[j] for j, s in enumerate(call)
                                if s in rows} for label, out in ops
                        if out.shape[:1] == (len(call),)}
            lg = logits.reshape(len(call), -1).float()
            if width is None:
                pads_equal[0] &= all(torch.equal(lg[p], lg[rows[0]])
                                     for p in call if p not in rows)
            return {s: lg[j] for j, s in enumerate(call) if s in rows}

        def cyclic(w):
            return [[slots[(i + j) % max_batch] for j in range(w)]
                    for i in range(0, max_batch, w)]

        def width_of(w):
            return None if via_engine else w

        wide = max(widths)
        full = {}
        for rows in cyclic(wide):
            full.update(run(rows, width_of(wide)))
        half = slots[:max_batch // 2]
        configs = {f"packed {w}": (w, cyclic(w)) for w in widths if w != wide}
        configs[f"dense (rows {half[0]}-{half[-1]}, "
                f"{max_batch - len(half)} padding)"] = (max_batch, [half])
        equal, worst, by_config, first = ({s: True for s in slots}, 0.0, {},
                                          None)
        for name, (w, calls) in configs.items():
            diff = 0.0
            call_w = w if name.startswith("dense") else width_of(w)
            for rows in calls:
                for s, lg in run(rows, call_w).items():
                    diff = max(diff, (lg - full[s]).abs().max().item())
                    if not torch.equal(lg, full[s]):
                        equal[s] = False
                        first = first or (s, call_w, w, rows)
            by_config[name] = diff
            worst = max(worst, diff)
        where = None
        if first is not None:
            s, call_w, w, mine = first
            theirs = next(r for r in cyclic(wide) if s in r)
            a = run(theirs, width_of(wide), record=True)
            b = run(mine, call_w, record=True)
            where = "no recorded op differs"
            for label in (x for x in a if x in b):
                if not torch.equal(a[label][s], b[label][s]):
                    d = (a[label][s].float() - b[label][s].float()).abs()
                    where = (f"row at slot {s}, width {w} against {wide}: "
                             f"first at {label}, max |difference| "
                             f"{d.max().item()!r}")
                    break
        torch.cuda.synchronize()
    finally:
        engine.close()
    gaps = torch.stack([_top2_gap(full[s][None])[0] for s in slots])
    out = dict(independent=all(equal.values()) and pads_equal[0],
               max_diff=worst, rows_equal=[equal[s] for s in slots],
               by_config=by_config, gaps=gaps.tolist(),
               first_difference=where, pads_equal=pads_equal[0])
    per_config = ", ".join(f"{k} {v!r}" for k, v in by_config.items())
    mode = (f"through the engine, executed at {engine._bucket(1)} rows; pad "
            f"rows equal their originals {pads_equal[0]}"
            if via_engine else "the raw model at each width")
    print(f"width probe ({model.cfg.name}, {max_batch} slots at max_len "
          f"{max_len}, {mode}; resident rows at lengths "
          f"{[index[s] + 1 for s in slots]}, widths {widths} and dense): "
          f"rows bit-equal across widths {sum(out['rows_equal'])} of "
          f"{max_batch}; independent {out['independent']}; largest |logit "
          f"difference| against packed {wide}: {worst!r} ({per_config}); "
          f"top-2 gaps at packed {wide} "
          f"{[round(g, 6) for g in out['gaps']]}"
          + (f"; {where}" if where else ""))
    return out


def _record_widths(engine, records: dict, stash: dict) -> None:
    """Patch ``engine`` so each token it makes is recorded in
    ``records[request_id]`` as (the rows that stepped in the forward that
    made it, the rows that forward executed, both 0 for the prefill; that
    forward's top-2 logit gap for the token's row), the gaps read from
    ``stash["gap"]``, which the model's wrapped ``prefill`` /
    ``decode_step`` set (``_top2_gap``).  Packed and dense steps both call
    the model in the dense layout, so a row's gap is at its slot."""
    def admit(req, slot, _inner=engine._prefill_into_slot):
        _inner(req, slot)
        records[req.request_id] = [(0, 0, stash["gap"][0].item())]

    def consume(ready, host, *, by_position, _inner=engine._consume):
        step = engine.trace[-1]
        gaps = stash["gap"].cpu()
        executed = (engine._bucket(step.packed) if step.packed
                    else engine.max_batch)
        for s in ready:
            records[engine.active[s].request_id].append(
                (step.active, executed, gaps[s].item()))
        _inner(ready, host, by_position=by_position)

    engine._prefill_into_slot, engine._consume = admit, consume


def _chaos_run(model, prompts: list, plan, *, ladder: bool = True) -> dict:
    """One run of the chaos workload on a fresh two-replica cluster of
    ``model`` under ``plan`` (None: fault-free; ``ladder`` False pins the
    degradation ladders at level 0).  Records, per request and token, the
    stepping and executed rows of the forward that made it (0: the
    prefill) and that forward's top-2 logit gap for the token's row
    (``_record_widths``)."""
    from repro_torch.bench.chaos import summarize
    from repro_torch.cluster import ReplicaConfig, RoutingPolicy, build_cluster
    from repro_torch.obs import attribute_stalls
    from repro_torch.resilience import DegradationLadder
    from repro_torch.serving.engine import Request
    from repro_torch.serving.sampler import SamplingParams
    from repro_torch.trace import check_tape

    cfg = model.cfg
    kv_bytes = (2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
                * torch.finfo(cfg.dtype).bits // 8)
    cluster = build_cluster(
        model, n_replicas=CHAOS["n_replicas"],
        routing=RoutingPolicy.LEAST_LOADED, fault_plan=plan, seed=0,
        replica_cfg=ReplicaConfig(
            max_batch=CHAOS["max_batch"], max_len=CHAOS["max_len"],
            block_tokens=CHAOS["block_tokens"], n_pages=CHAOS["n_pages"],
            kv_bytes_per_token=kv_bytes, coalesce_small_crossings=True))
    if not ladder:
        for r in cluster.replicas:
            if r.faults is not None:
                r.faults.ladder = DegradationLadder(enabled=False)
    records, stash = {}, {}
    inner_prefill, inner_decode = model.prefill, model.decode_step

    def prefill(*a, **k):
        out = inner_prefill(*a, **k)
        stash["gap"] = _top2_gap(out[0])
        return out

    def decode_step(*a, **k):
        out = inner_decode(*a, **k)
        stash["gap"] = _top2_gap(out[0])
        return out

    for r in cluster.replicas:
        _record_widths(r.engine, records, stash)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    model.prefill, model.decode_step = prefill, decode_step
    submitted = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for wave in range(CHAOS["waves"]):
            for i in range(CHAOS["wave_size"]):
                rid = f"w{wave}r{i}"
                check(cluster.submit(Request(rid, prompt=prompts[submitted],
                                             sampling=SamplingParams(
                                                 max_new_tokens=CHAOS[
                                                     "new_tokens"])))
                      is not None, f"chaos: the cluster shed {rid}")
                submitted += 1
            cluster.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: fn.launches for name, fn in counters.items()}
        out = summarize(cluster, submitted)
        tapes = [r.tape() for r in cluster.replicas]
        for tape in tapes:
            report = check_tape(tape)
            check(report.ok, f"chaos: replica tape violates the bridge law:"
                             f"\n{report.format()}")
        closure = min(attribute_stalls(t).closure for t in tapes)
        prefills = sum(1 + e["request"].restarts for e in cluster.request_log)
        steps = sum(r.engine.step_count for r in cluster.replicas)
        out.update(
            wall=wall, counts=counts, closure=closure, records=records,
            expected={"flash_attention": prefills * cfg.n_layers,
                      "paged_attention": steps * cfg.n_layers,
                      "mlstm_scan": 0, "dequant": 0},
            restore_retries=sum(r.offload.stats.restore_retries
                                for r in cluster.replicas),
            crossings=sum(t.n_crossings() for t in tapes), steps=steps)
    finally:
        del model.prefill, model.decode_step
        cluster.close()
    return out


def _token_criterion(label: str, base: dict, run: dict, probe: dict,
                     base_name: str = "the fault-free run") -> int:
    """Hold ``run``'s tokens to ``base``'s (``base_name``).  With
    width-independent rows they must be equal; otherwise each request's
    tokens must equal the base run's up to a first difference, where a
    forward of that request up to the token ran at another width
    (stepping or executed rows) in the two runs (the token's own, or an
    earlier one whose K/V it reads) and
    the base run's top-2 logit gap is at most the width probe's largest
    difference.  Returns the number of such requests; any other difference
    fails.  ``probe`` is read only where tokens differ."""
    explained = at_token = 0
    for rid, want in base["tokens"].items():
        got = run["tokens"][rid]
        if got == want:
            continue
        check(not probe["independent"], f"{label}: {rid}'s tokens differ "
              f"from {base_name}'s, though rows are width-independent")
        check(len(got) == len(want), f"{label}: {rid} has {len(got)} "
                                     f"tokens, {base_name} {len(want)}")
        p = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
        bw = [r[:2] for r in base["records"][rid]]
        rw = [r[:2] for r in run["records"][rid]]
        gap = base["records"][rid][p][2]
        other = [i for i in range(p + 1) if bw[i] != rw[i]]
        check(bool(other) and gap <= probe["max_diff"],
              f"{label}: {rid} differs first at token {p} ({base_name} "
              f"{want[p]}, here {got[p]}); widths in {base_name} "
              f"{bw[:p + 1]}, here {rw[:p + 1]}; {base_name}'s top-2 gap "
              f"{gap!r} against the probe's largest difference "
              f"{probe['max_diff']!r}")
        explained += 1
        at_token += bw[p] != rw[p]
    if explained:
        print(f"  {label}: {explained} requests differ from {base_name}'s "
              f"tokens within the width criterion ({at_token} at a token "
              f"made at another width, {explained - at_token} after an "
              f"earlier forward at another width)")
    return explained


def phase_chaos(model) -> dict:
    """Full-width olmo-1b served by a two-replica cluster under seeded
    bridge faults (``CHAOS``; least-loaded routing, coalescer on): twice
    fault-free (the second must repeat the first byte for byte), under
    ``FaultPlan.transient`` and under the ablation plan (MAC rejects and
    restore corruption) with the degradation ladder on and off.  A width
    probe first says whether a row's logits depend on the width of the
    forward; the faulted runs' tokens are held to the fault-free run's by
    ``_token_criterion``.  Checks per run: nothing lost, faults injected
    where planned, a rung reached with the ladder on, every replica tape
    lawful with stall closure >= 0.99, flash and paged launches as
    expected.  Returns the launches of the runs, by kernel."""
    from repro_torch.resilience import FaultPlan
    gen = torch.Generator().manual_seed(4)
    vocab = model.cfg.vocab_size
    prefix = torch.randint(1, vocab, (CHAOS["prefix_len"],),
                           generator=gen).tolist()
    n = CHAOS["waves"] * CHAOS["wave_size"]
    prompts = [prefix + torch.randint(1, vocab, (CHAOS["own_len"],),
                                      generator=gen).tolist()
               for _ in range(n)]
    probe = _width_probe(model, prompts, CHAOS["max_batch"],
                         CHAOS["max_len"])
    seed, rate = CHAOS["seed"], CHAOS["rate"]
    ablation = FaultPlan(seed=seed, crossing_failure_p=rate,
                         restore_corruption_p=rate)
    arms = [("fault-free", None, True), ("fault-free again", None, True),
            (f"transient seed {seed} rate {rate}",
             FaultPlan.transient(seed=seed, rate=rate), True),
            ("ablation, ladder on", ablation, True),
            ("ablation, ladder off", ablation, False)]
    launches = dict.fromkeys(_counters(), 0)
    runs = {}
    for label, plan, ladder in arms:
        r = _chaos_run(model, prompts, plan, ladder=ladder)
        runs[label] = r
        for k, v in r["counts"].items():
            launches[k] += v
        print(f"chaos {label} ({model.cfg.name}, {CHAOS['n_replicas']} "
              f"replicas): {r['submitted']} requests, {r['lost']} lost, "
              f"{r['total_tokens']} tokens, {r['steps']} decode steps, "
              f"{r['crossings']} crossings; modelled goodput "
              f"{r['goodput_tok_s']!r} tok/s, TTFT p99 {r['ttft_p99_ms']!r} "
              f"ms, MTTR {r['mttr_ms']!r} ms; injected "
              f"{r['injected_events']}, max rung {r['max_rung']}, "
              f"restore_retries {r['restore_retries']}, warm blocks "
              f"restored {r['warm_blocks_restored']}; launches flash "
              f"{r['counts']['flash_attention']} (expected "
              f"{r['expected']['flash_attention']}) paged "
              f"{r['counts']['paged_attention']} (expected "
              f"{r['expected']['paged_attention']}); tapes ok, stall "
              f"closure >= {r['closure']:.6f}; wall {r['wall']:.3f} s")
        check(r["lost"] == 0, f"chaos {label}: {r['lost']} requests lost")
        check(r["counts"] == r["expected"], f"chaos {label}: launches "
              f"{r['counts']}, expected {r['expected']}")
        check(r["closure"] >= 0.99, f"chaos {label}: stall closure "
                                    f"{r['closure']}")
        if plan is not None:
            check(r["injected_events"] > 0, f"chaos {label}: no fault "
                                             f"injected")
        if plan is not None and ladder:
            check(r["max_rung"] >= 1, f"chaos {label}: the ladder never "
                                      f"left level 0")
    base = runs["fault-free"]
    check(runs["fault-free again"]["tokens"] == base["tokens"],
          "chaos: two fault-free runs gave different tokens")
    differ = {label: _token_criterion(f"chaos {label}", base, runs[label],
                                      probe)
              for label, plan, _ in arms if plan is not None}
    arms_equal = (runs["ablation, ladder on"]["tokens"]
                  == runs["ablation, ladder off"]["tokens"])
    print(f"chaos token criterion: rows width-independent "
          f"{probe['independent']}; requests differing from the fault-free "
          f"run within the criterion {differ}; two fault-free runs "
          f"identical; ablation arms' tokens identical {arms_equal}")
    return launches


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Two tensors of one dtype and shape equal bit for bit."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if want.is_floating_point():
        view = {2: torch.int16, 4: torch.int32}[want.element_size()]
        return torch.equal(got.view(view), want.view(view))
    return torch.equal(got, want)


def _unflatten(tree, flat: dict, prefix: str = ""):
    """``tree``'s structure with its leaves taken from ``flat`` by the
    names ``models.model._flatten`` gives them."""
    if isinstance(tree, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}__")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unflatten(v, flat, f"{prefix}{i}__")
                for i, v in enumerate(tree)]
    return flat[prefix[:-2]]


def _serve_sync(model, label: str) -> tuple:
    """``MAIN``'s requests under the sync policy: (tokens by request,
    launches by kernel, run wall seconds); launches must be as expected."""
    from repro_torch.core.policy import SchedulingPolicy
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import SamplingParams
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, model.cfg.vocab_size, (n,),
                             generator=gen).tolist()
               for n in MAIN["prompt_lens"]]
    engine = ServingEngine(model, max_batch=MAIN["max_batch"],
                           max_len=MAIN["max_len"],
                           policy=SchedulingPolicy.SYNC_DRAIN, cc_on=True,
                           seed=0, device=DEVICE)
    for i, p in enumerate(prompts):
        engine.submit(Request(f"r{i}", prompt=p, sampling=SamplingParams(
            max_new_tokens=MAIN["new_tokens"])))
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        stats = engine.run()
        torch.cuda.synchronize()
    finally:
        engine.close()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in counters.items()}
    want = attention_launches(model.cfg)(stats, len(prompts))
    check(counts == want, f"{label}: launches {counts}, expected {want}")
    check(stats["finished"] == len(prompts), f"{label}: {stats['finished']} "
          f"of {len(prompts)} requests finished")
    return ({r.request_id: list(r.output_tokens) for r in engine.finished},
            counts, wall)


def _h2d_device_ms(fn, tries: int = 3) -> tuple:
    """``fn`` under the profiler: the device time of its host-to-device
    copies (ms) and how many there were, from the first of ``tries``
    windows that saw any (a window now and then comes back empty; None
    where every one did)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        us, n = 0.0, 0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and "HtoD" in e.key:
                us += getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0.0))
                n += e.count
        if n:
            return us / 1e3, n
    return None, 0


def _host_memory() -> str:
    """The host's total and available RAM, as /proc/meminfo gives them."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            info[key] = int(val.split()[0]) * 1024
    return (f"host RAM {info['MemTotal']} bytes, available "
            f"{info['MemAvailable']} bytes")


def phase_loader(model) -> dict:
    """Full-width ``model``'s own weights through the port's loader: written
    with ``save_sharded`` (``LOADER["n_shards"]`` shards) into a temporary
    directory under ``build/`` (removed at the end) and loaded back with
    ``PooledLoader`` (B300 profile, CC on, ``LOADER["n_workers"]`` workers,
    PREWARMED) into a recorded gateway on the card: every tensor bit-equal
    to the model's, one LOADER_SHARD_H2D record a shard whose bytes sum to
    the checkpoint's, a lawful tape, and the loaded model serving
    ``MAIN``'s requests (sync) with the in-memory model's tokens.  Then
    ``weight_quant="int8"`` (WEIGHT_SHARD_Q records, one DEQUANT_COMPUTE
    charge, the same full-width tensors) and ``tp_degree=4`` (one
    P2P_SHARD_EXCHANGE of 3/4 of the bytes, the TP=1 load's bridge bytes).
    Measured: write and read walls, each load's wall (host clock, ending in
    ``torch.cuda.synchronize()``) and the H2D device time of one more load
    (profiler); the same tensors uploaded from pageable and from
    page-locked host buffers (allocated outside the timed window); the
    modelled breakdown of all six variants at this size.  Returns the
    launches of the two serving runs, by kernel."""
    import shutil
    import tempfile
    from repro_torch.core.bridge import B300, BridgeModel
    from repro_torch.core.gateway import TransferGateway
    from repro_torch.core.policy import cc_aware_defaults
    from repro_torch.loader import (LoaderVariant, PooledLoader,
                                    ShardedCheckpoint, save_sharded)
    from repro_torch.models.model import Model, _flatten
    from repro_torch.trace import TraceRecorder, check_tape
    from repro_torch.trace import opclasses as oc

    cfg = model.cfg
    params = dict(_flatten(model.params))
    p_bytes = sum(t.numel() * t.element_size() for t in params.values())
    n_shards, n_workers = LOADER["n_shards"], LOADER["n_workers"]
    bridge = BridgeModel(B300, cc_on=True)
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="loader_ckpt_", dir=build)
    launches = dict.fromkeys(_counters(), 0)
    try:
        disk = shutil.disk_usage(tmp)
        print(f"loader host ({cfg.name}): disk at the checkpoint's directory "
              f"{disk.free} bytes free of {disk.total}; {_host_memory()}; "
              f"{os.cpu_count()} CPUs")
        t0 = time.perf_counter()
        save_sharded(tmp, params, n_shards=n_shards)
        write_s = time.perf_counter() - t0
        ckpt = ShardedCheckpoint(tmp)
        total = ckpt.total_bytes()
        check(total == p_bytes, f"loader: checkpoint holds {total} bytes, "
                                f"the model {p_bytes}")
        t0 = time.perf_counter()
        host = [ckpt.read_tensor(name) for name in params]
        read_s = time.perf_counter() - t0
        print(f"loader checkpoint: {len(params)} tensors, {total} bytes in "
              f"{n_shards} shards; write {write_s:.3f} s "
              f"({total / write_s / 1e9:.3f} GB/s), read into host arrays "
              f"{read_s:.3f} s ({total / read_s / 1e9:.3f} GB/s)")

        def load(label, **kw):
            gw = TransferGateway(bridge, cc_aware_defaults(True),
                                 pool_workers=n_workers, device=DEVICE)
            loader = PooledLoader(bridge, n_workers=n_workers, gateway=gw,
                                  weight_quant=kw.pop("weight_quant", ""))
            recorder = TraceRecorder(gw, label=f"loader-{label}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with recorder:
                tensors, bd = loader.load(ckpt, LoaderVariant.PREWARMED,
                                          device=DEVICE, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            tape = recorder.tape()
            report = check_tape(tape)
            check(report.ok, f"loader {label}: tape violates the bridge "
                             f"law:\n{report.format()}")
            bad = [n for n, t in params.items()
                   if not _same_bits(tensors[n], t)]
            check(not bad, f"loader {label}: {len(bad)} tensors differ from "
                           f"the model's (first {bad[:3]})")
            parts = {k: v for k, v in bd.items() if k != "total"}
            print(f"loader {label}: {len(tensors)} tensors bit-equal to the "
                  f"model's; wall {wall:.4f} s = "
                  f"{total / wall / 1e9:.3f} GB/s (reads + pageable "
                  f"uploads); modelled (virtual clock, B300, CC on) "
                  f"{bd['total']!r} s {parts}; tape ok, bridge bytes "
                  f"{tape.bridge_bytes()}, p2p bytes {tape.p2p_bytes()}, "
                  f"records {tape.op_class_mix()}")
            return tensors, tape, wall

        tensors, tape1, wall1 = load("full width")
        shards = [r for r in tape1.records
                  if r.op_class == oc.LOADER_SHARD_H2D]
        check(len(shards) == n_shards
              and sum(r.nbytes for r in shards) == total,
              f"loader: {len(shards)} shard records of "
              f"{sum(r.nbytes for r in shards)} bytes, expected {n_shards} "
              f"of {total}")
        loaded = Model(cfg, params=_unflatten(model.params, tensors),
                       device=DEVICE)
        want, counts, wall_mem = _serve_sync(model, "loader, in-memory model")
        got, more, wall_ld = _serve_sync(loaded, "loader, loaded model")
        for c in (counts, more):
            for k, n in c.items():
                launches[k] += n
        check(got == want, "loader: the loaded model's tokens differ from "
                           "the in-memory model's")
        print(f"loader serving: the loaded model's {len(got)} requests "
              f"(sync, {MAIN['new_tokens']} new tokens each) give the "
              f"in-memory model's tokens; launches {more} a run; walls "
              f"{wall_mem:.3f} s in memory, {wall_ld:.3f} s loaded")
        del loaded, tensors

        tensors, tape_q, _ = load("int8 weight-only", weight_quant="int8")
        q = [r for r in tape_q.records if r.op_class == oc.WEIGHT_SHARD_Q]
        dq = [r for r in tape_q.records if r.op_class == oc.DEQUANT_COMPUTE]
        check(len(q) == n_shards and len(dq) == 1
              and all(oc.QUANTIZED in r.tags for r in q),
              f"loader int8: {len(q)} WEIGHT_SHARD_Q records, {len(dq)} "
              f"DEQUANT_COMPUTE charges")
        del tensors
        tensors, tape_tp, _ = load("tp_degree=4", tp_degree=4)
        ex = [r for r in tape_tp.records
              if r.op_class == oc.P2P_SHARD_EXCHANGE]
        check(len(ex) == 1 and ex[0].nbytes == int(total * 3 / 4)
              and tape_tp.bridge_bytes() == tape1.bridge_bytes(),
              f"loader tp=4: exchange {[r.nbytes for r in ex]} (expected "
              f"{int(total * 3 / 4)}), bridge bytes "
              f"{tape_tp.bridge_bytes()} vs {tape1.bridge_bytes()}")
        del tensors
        torch.cuda.empty_cache()

        plain = PooledLoader(bridge, n_workers=n_workers)
        h2d_ms, h2d_n = _h2d_device_ms(lambda: plain.load(
            ckpt, LoaderVariant.PREWARMED, device=DEVICE))
        print(f"loader H2D (one more full-width load, profiler): "
              f"{_ms(h2d_ms)} over {h2d_n} copies"
              + ("" if h2d_ms is None else
                 f" = {total / h2d_ms / 1e6:.3f} GB/s of device time"))

        pageable = [torch.from_numpy(a) for a in host]
        pinned = [t.pin_memory() for t in pageable]
        walls = {"pageable": [], "pinned": []}
        for name in ("pageable", "pinned", "pinned", "pageable"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = [t.to(DEVICE, non_blocking=True)
                   for t in (pinned if name == "pinned" else pageable)]
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            del out
        device_ms = {name: _h2d_device_ms(lambda: [
            t.to(DEVICE, non_blocking=True) for t in arrays])
            for name, arrays in (("pageable", pageable), ("pinned", pinned))}
        print("loader uploads of the same tensors from host memory (in "
              "turns pageable, pinned, pinned, pageable; page-locked buffers "
              "allocated outside the window): " + "; ".join(
                  f"{name} {min(w):.4f} s = {total / min(w) / 1e9:.3f} GB/s "
                  f"(walls {[round(x, 4) for x in w]}; one more under the "
                  f"profiler: H2D {_ms(device_ms[name][0])} over "
                  f"{device_ms[name][1]} copies)"
                  for name, w in walls.items())
              + f"; the loader's full-width load {wall1:.4f} s = "
              f"{total / wall1 / 1e9:.3f} GB/s with its reads")
        del pageable, pinned, host
        print(f"loader modelled ladder ({total} bytes, {n_shards} shards, "
              f"{n_workers} workers, B300, CC on; virtual clock): " + "; ".join(
                  f"{v.value} {plain.modeled_load_time(total, n_shards, v)['total']!r} s"
                  for v in LoaderVariant))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def phase_tp(model) -> dict:
    """Full-width ``model`` behind a one-replica confidential cluster at TP
    1, 2, 4 and 8 (``TP``): ``benchmarks/bench_tp.py``'s guardrail shape at
    full width (8 greedy requests sharing a prompt, each with tokens of its
    own).  TP is pricing only and one card runs the whole model, so: tokens
    identical across degrees, the same bridge bytes, P2P bytes only above
    TP=1 and there one P2P_ALLREDUCE a decode step (the replica prices
    prompts itself, so no engine prefill owes one), no fallbacks, lawful
    tapes with stall closure >= 0.99, flash and paged launches as
    expected.  Returns the launches of the four runs, by kernel."""
    from repro_torch.cluster import ReplicaConfig, RoutingPolicy, build_cluster
    from repro_torch.obs import attribute_stalls
    from repro_torch.serving.engine import Request
    from repro_torch.serving.sampler import SamplingParams
    from repro_torch.trace import check_tape
    from repro_torch.trace import opclasses as oc

    cfg = model.cfg
    gen = torch.Generator().manual_seed(5)
    shared = torch.randint(1, cfg.vocab_size, (TP["prompt_len"],),
                           generator=gen).tolist()
    kv_bytes = (2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
                * torch.finfo(cfg.dtype).bits // 8)
    decode_classes = (oc.DECODE_PACKED, oc.DECODE_COMPUTE, oc.DECODE_MASKED)
    launches = dict.fromkeys(_counters(), 0)
    runs = {}
    for tp in TP["degrees"]:
        cluster = build_cluster(
            model, cc_on=True, n_replicas=1,
            partition_size=TP["partition_size"],
            routing=RoutingPolicy.LEAST_LOADED, seed=0,
            replica_cfg=ReplicaConfig(
                tp_degree=tp, max_batch=TP["max_batch"],
                max_len=TP["max_len"], block_tokens=TP["block_tokens"],
                n_pages=TP["n_pages"], kv_bytes_per_token=kv_bytes))
        counters = _counters()
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            for i in range(TP["n_requests"]):
                check(cluster.submit(Request(
                    f"r{i}", prompt=shared + [40 + i] * TP["own_len"],
                    sampling=SamplingParams(
                        max_new_tokens=TP["new_tokens"] + i % 4)))
                    is not None, f"tp={tp}: the cluster shed r{i}")
            cluster.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {name: fn.launches for name, fn in counters.items()}
            replica = cluster.replicas[0]
            tape = replica.tape()
            report = check_tape(tape)
            check(report.ok, f"tp={tp}: tape violates the bridge law:\n"
                             f"{report.format()}")
            mix = tape.op_class_mix()
            steps = replica.engine.step_count
            prefills = sum(1 + e["request"].restarts
                           for e in cluster.request_log)
            r = dict(
                tokens={e["request"].request_id:
                        tuple(e["request"].output_tokens)
                        for e in cluster.request_log},
                finished=len(replica.engine.finished),
                virtual_s=replica.clock.now, counts=counts,
                bridge=tape.bridge_bytes(), p2p=tape.p2p_bytes(),
                p2p_s=tape.p2p_seconds(),
                allreduce=mix.get(oc.P2P_ALLREDUCE, 0),
                decode=sum(mix.get(c, 0) for c in decode_classes),
                fallbacks=replica.gateway.stats.p2p_fallback_crossings,
                closure=attribute_stalls(tape).closure,
                expected={"flash_attention": prefills * cfg.n_layers,
                          "paged_attention": steps * cfg.n_layers,
                          "mlstm_scan": 0, "dequant": 0})
        finally:
            cluster.close()
        runs[tp] = r
        for k, n in counts.items():
            launches[k] += n
        print(f"tp={tp} ({cfg.name}, one replica, partition "
              f"{TP['partition_size']}): {r['finished']} of "
              f"{TP['n_requests']} requests, {steps} decode steps; modelled "
              f"virtual time {r['virtual_s']!r} s, P2P {r['p2p']} bytes in "
              f"{r['p2p_s']!r} s ({r['allreduce']} allreduce records for "
              f"{r['decode']} decode steps), bridge {r['bridge']} bytes, "
              f"fallbacks {r['fallbacks']}, stall closure "
              f"{r['closure']:.6f}; launches flash "
              f"{counts['flash_attention']} paged "
              f"{counts['paged_attention']} (expected "
              f"{r['expected']['flash_attention']} / "
              f"{r['expected']['paged_attention']}); wall {wall:.3f} s")
        check(r["finished"] == TP["n_requests"], f"tp={tp}: requests lost")
        check(counts == r["expected"], f"tp={tp}: launches {counts}, "
                                       f"expected {r['expected']}")
        check(r["closure"] >= 0.99, f"tp={tp}: stall closure {r['closure']}")
        check(r["fallbacks"] == 0, f"tp={tp}: {r['fallbacks']} fallbacks")
        if tp == 1:
            check(r["p2p"] == 0 and r["allreduce"] == 0,
                  "tp=1 emitted P2P traffic")
        else:
            check(r["p2p"] > 0 and r["allreduce"] == r["decode"] > 0,
                  f"tp={tp}: {r['allreduce']} allreduce records for "
                  f"{r['decode']} decode steps, {r['p2p']} P2P bytes")
    base = runs[TP["degrees"][0]]
    check(all(r["tokens"] == base["tokens"] for r in runs.values()),
          "tp: token streams differ between degrees")
    check(len({r["bridge"] for r in runs.values()}) == 1,
          "tp: bridge bytes differ between degrees")
    print(f"tp token criterion: tokens identical across TP "
          f"{list(TP['degrees'])}; bridge bytes {base['bridge']} at every "
          f"degree; modelled virtual time "
          + ", ".join(f"tp={tp} {r['virtual_s']!r} s"
                      for tp, r in runs.items()))
    return launches


def mlstm_work(b, s, h, dk, dv, chunk) -> tuple:
    """Operations and bytes a chunked mLSTM scan from the empty state needs
    on these shapes (f32 inputs).  Per chunk of L steps and head: the
    causal scores (2 P dk, P = L(L+1)/2 pairs) and W.V (2 P dv), q.C
    (2 L dk dv; none in the first chunk, where C is zero), the state update
    (2 L dk dv), q.n and the n update (2 L dk each).  q, k, v and the
    gates are read once, y and the final state written once."""
    flops = 0
    for c0 in range(0, s, chunk):
        L = min(chunk, s - c0)
        pairs = L * (L + 1) // 2
        flops += 2 * pairs * (dk + dv) + 2 * L * dk * dv + 4 * L * dk
        if c0:
            flops += 2 * L * dk * dv
    nbytes = (b * s * h * (2 * dk + 2 * dv + 2) * 4
              + b * h * (dk * dv + dk + 1) * 4)
    return b * h * flops, nbytes


def _time_flash(gen, launches: dict, errs: dict) -> dict:
    """The flash kernel and SDPA (the one PyTorch call computing the same
    function) at olmo-1b's heads, causal, B=1, at each of the main path's
    prompt lengths and at LONG_PROMPT: device time per call (the profiler's; at
    these sizes events over back-to-back calls partly time the host's
    dispatch, and are printed beside it).  Prints the sums over one main
    path run's prefills (one launch per prompt and layer) and the share of
    the bound at LONG_PROMPT.  Returns the kernels row, timed at S=512.
    Event times never stand in for a device time: SDPA's is None where the
    profiler saw no device events, and so is any sum that needs it."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    layers, h, d = 16, 16, 128                   # olmo-1b
    per_len = {}
    for s in sorted(set(MAIN["prompt_lens"]) | {LONG_PROMPT}):
        q, k, v = (_randn(gen, 1, s, h, d) for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def kernel():
            return fa.flash_attention(q, k, v, causal=True)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

        ev, lib_ev = time_ms(kernel), time_ms(sdpa)
        got = _in_turns(dict(kernel=kernel, sdpa=sdpa), f"flash S={s}")
        dev = _measured(got["kernel"], f"the flash kernel at S={s}")
        lib_dev = got["sdpa"]
        pairs = s * (s + 1) // 2                  # causal (q, k) pairs
        bms, by = bound(4.0 * h * d * pairs, 4 * s * h * d * 2)
        per_len[s] = dict(ms=dev, library_ms=lib_dev, events_ms=ev,
                          library_events_ms=lib_ev, bound_ms=bms, bound_by=by)
        print(f"timing flash (B=1 S={s} H={h} D={d} causal): kernel {dev} ms "
              f"device ({ev:.4f} events), sdpa {_ms(lib_dev)} "
              f"({lib_ev:.4f} events), bound {bms:.5f} ms ({by}); kernel / "
              f"sdpa {_ratio(dev, lib_dev)}")
        if s == max(MAIN["prompt_lens"]):
            plain_ev = time_ms(lambda: flash_attention_ref(q, k, v,
                                                           causal=True))
            plain_dev = _kernel_breakdown(
                lambda: flash_attention_ref(q, k, v, causal=True),
                f"flash S={s} plain")
            per_len[s].update(
                plain_ms=_measured(plain_dev, f"flash's plain version at "
                                              f"S={s}"),
                plain_events_ms=plain_ev)
        del q, k, v, qt, kt, vt
    run = {key: _sum([per_len[s][key] for s in MAIN["prompt_lens"]], layers)
           for key in ("ms", "library_ms", "events_ms", "library_events_ms",
                       "bound_ms")}
    print(f"timing flash over one main path run's {len(MAIN['prompt_lens'])} "
          f"prefills ({layers} launches each): kernel {run['ms']:.4f} ms "
          f"device ({run['events_ms']:.4f} events), sdpa "
          f"{_ms(run['library_ms'])} ({run['library_events_ms']:.4f}"
          f" events), bound {run['bound_ms']:.4f} ms")
    long = per_len[LONG_PROMPT]
    print(f"timing flash at S={LONG_PROMPT}: kernel {long['ms']:.4f} ms = "
          f"{long['bound_ms'] / long['ms']:.4f} of its {long['bound_by']} "
          f"bound ({long['bound_ms']:.5f} ms; each product counted once, "
          f"bf16 at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s); sdpa "
          f"{_ms(long['library_ms'])} = "
          f"{_ratio(long['bound_ms'], long['library_ms'])}")
    main = per_len[max(MAIN["prompt_lens"])]
    return dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:90",
        launches=launches["flash_attention"],
        max_abs_err=errs["flash_attention"], ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=main["library_ms"],
        events_ms=main["events_ms"], plain_events_ms=main["plain_events_ms"],
        library_events_ms=main["library_events_ms"],
        per_prompt_len={s: [per_len[s]["ms"], per_len[s]["library_ms"]]
                        for s in sorted(per_len)},
        main_run_ms=run["ms"], main_run_library_ms=run["library_ms"],
        long_prompt=LONG_PROMPT, long_prompt_ms=long["ms"],
        long_prompt_library_ms=long["library_ms"],
        long_prompt_bound_share=long["bound_ms"] / long["ms"])


def _time_paged(gen, launches: dict, errs: dict) -> dict:
    """The paged kernel at the main path's decode shape, mid-run: 8 slots
    of a 1024-token cache, lengths = prompt + 16; 16 layers' caches cycled
    so every launch reads its pages from device memory, as a decode step
    does.  Beside it the one PyTorch call computing the same function on
    the engine's identity block table: SDPA over the slot cache (B, cap,
    KV, D) that the pages view, with a length mask (checked against the
    kernel once).  ms, plain_ms and library_ms are device time per call
    (the profiler's; library_ms None where it saw no device events), events
    beside them.  The same again with every slot full (1024 tokens), and
    the kernel at the lengths of phase_profile's olmo-1b decode step three
    ways: back to back, each call after 2 ms of idle card, and each call
    after a 64 MiB weight-streaming GEMM (as a decode step runs it between
    two layers' GEMMs)."""
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    b, h, kv, d, page, layers = len(MAIN["prompt_lens"]), 16, 16, 128, 16, 16
    pages_max = MAIN["max_len"] // page
    cap = pages_max * page
    qd = _randn(gen, b, h, d)
    shape = (layers, b * pages_max, page, kv, d)
    kc = torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)
    vc = torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)
    bt = (torch.arange(b, device=DEVICE)[:, None] * pages_max
          + torch.arange(pages_max, device=DEVICE)[None, :]).to(torch.int32)
    pps = pa.split_plan(kc[0], bt)
    turn = [0]

    def at(lengths) -> dict:
        """Kernel, plain version and SDPA at ``lengths``, layers cycled,
        and SDPA's max abs difference from the kernel."""
        ln = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
        mask = (torch.arange(cap, device=DEVICE)[None, :] < ln[:, None]
                )[:, None, None]                   # (B, 1, 1, cap)

        def sdpa(q, kp, vp, _bt, _ln):
            ck, cv = (t.view(b, cap, kv, d).transpose(1, 2) for t in (kp, vp))
            return F.scaled_dot_product_attention(
                q[:, :, None], ck, cv, attn_mask=mask, enable_gqa=True
            )[:, :, 0]

        def cycled(fn):
            def call():
                i = turn[0] = (turn[0] + 1) % layers
                return fn(qd, kc[i], vc[i], bt, ln)
            return call

        args = (qd, kc[0], vc[0], bt, ln)
        lib_err = (sdpa(*args).float() - pa.paged_attention(*args).float()
                   ).abs().max().item()
        check(math.isfinite(lib_err) and lib_err <= BF16_TOL,
              f"SDPA over the slot cache is not the paged kernel's function "
              f"at {lengths}: {lib_err}")
        return dict(kernel=cycled(pa.paged_attention),
                    plain=cycled(paged_attention_ref), sdpa=cycled(sdpa),
                    lib_err=lib_err)

    def timing(lengths) -> dict:
        fns = at(lengths)
        kernel, plain, sdpa = fns["kernel"], fns["plain"], fns["sdpa"]
        ev = time_ms(kernel, iters=64)
        plain_ev = time_ms(plain, iters=16)
        lib_ev = time_ms(sdpa, iters=64)
        got = _in_turns(dict(kernel=kernel, sdpa=sdpa), f"paged {lengths}")
        dev = _measured(got["kernel"], f"the paged kernel at {lengths}")
        lib_dev = got["sdpa"]
        plain_dev = _measured(_kernel_breakdown(plain, "paged plain",
                                                show=False),
                              f"paged's plain version at {lengths}")
        tokens = sum(min(n, cap) for n in lengths)
        nbytes = (2 * b * h * d * 2 + tokens * kv * d * 2 * 2
                  + sum(-(-min(n, cap) // page) for n in lengths) * 4 + b * 4)
        bms, by = bound(4.0 * h * d * tokens, nbytes)
        print(f"timing paged (B={b} H={h} KV={kv} D={d} page={page}, split "
              f"{pps} pages, lengths={lengths}): kernel {dev:.5f} ms device "
              f"({ev:.4f} events), plain {plain_dev:.5f} ms device "
              f"({plain_ev:.4f} events), sdpa over the slot cache with a "
              f"length mask {_ms(lib_dev)} ({lib_ev:.4f} events; "
              f"max_abs_err vs the kernel {fns['lib_err']:.3g}), bound "
              f"{bms:.5f} ms ({by}); kernel / sdpa {_ratio(dev, lib_dev)}, "
              f"bound / kernel {bms / dev:.4f}")
        return dict(ms=dev, plain_ms=plain_dev, library_ms=lib_dev,
                    bound_ms=bms, bound_by=by, events_ms=ev,
                    plain_events_ms=plain_ev, library_events_ms=lib_ev)

    main = timing([n + 16 for n in MAIN["prompt_lens"]])
    full = timing([cap] * b)
    seen = PROFILED.get("olmo-1b")
    profiled = None
    if seen:
        kernel = at(seen["lengths"])["kernel"]
        weights = torch.randn((MAIN["max_len"] * 2, 16384), generator=gen,
                              device=DEVICE).to(torch.bfloat16)
        x = _randn(gen, b, MAIN["max_len"] * 2)

        def after_idle():
            torch.cuda.synchronize()
            time.sleep(0.002)
            return kernel()

        def after_gemm():
            torch.mm(x, weights)
            return kernel()

        profiled = {name: _kernel_breakdown(fn, f"paged {name}", show=False,
                                            only="paged")
                    for name, fn in (("back_to_back", kernel),
                                     ("after_idle", after_idle),
                                     ("after_gemm", after_gemm))}
        us = seen["paged_us"]
        profiled["in_profile"] = sum(us) / len(us) / 1e3
        print(f"timing paged at the profiled olmo-1b step's lengths "
              f"{seen['lengths']}, ms per call: in the decode-step profile "
              f"{profiled['in_profile']:.5f}; here back to back "
              f"{_ms(profiled['back_to_back'])}, each after 2 ms idle "
              f"{_ms(profiled['after_idle'])}, each after a 64 MiB GEMM "
              f"{_ms(profiled['after_gemm'])}")
        del weights, x
    return dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/paged_attention.py:76",
        launches=launches["paged_attention"],
        max_abs_err=errs["paged_attention"], **main, pages_per_split=pps,
        all_1024={k: full[k] for k in ("ms", "plain_ms", "library_ms",
                                       "bound_ms", "bound_by")},
        profiled_lengths_ms=profiled)


def _time_mlstm(gen, launches: dict, errs: dict) -> dict:
    """The mLSTM kernel at the main path's longest prefill (xlstm-1.3b, one
    512-token prompt, two 256-step chunks, from the empty state, f32 as the
    model path computes it) beside its plain version (no single PyTorch
    call computes this scan): device time per call and per pass, and two
    bounds on the same work, the f32 products on the CUDA cores' peak and
    on the tensor cores' 3xTF32 rate (three TF32 products for each, the
    kernel's route, and the row's bound).  Then both summed over one main
    path run's prefills (each prompt length once per mLSTM block), timed
    in turns on inputs from their own generator.  Returns the kernels
    row."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.mlstm_scan import ops as ml
    from repro_torch.kernels.mlstm_scan.ref import mlstm_chunked_ref
    from repro_torch.models.transformer import block_kind
    b, s, h, dk, dv, chunk = 1, max(MAIN["prompt_lens"]), 4, 512, 1024, 256
    args, _ = _mlstm_inputs(gen, b, s, h, dk, dv, torch.float32, False)
    ev = time_ms(lambda: ml.mlstm_scan(*args, chunk=chunk))
    plain_ev = time_ms(lambda: mlstm_chunked_ref(*args, chunk=chunk),
                       iters=5)
    ms = _measured(_kernel_breakdown(
        lambda: ml.mlstm_scan(*args, chunk=chunk), "mlstm"),
        "the mLSTM kernel")
    plain = _measured(_kernel_breakdown(
        lambda: mlstm_chunked_ref(*args, chunk=chunk), "mlstm plain",
        show=False), "mLSTM's plain version")
    flops, nbytes = mlstm_work(b, s, h, dk, dv, chunk)
    bms, by = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
    f32_bms, _ = bound(flops, nbytes, PEAK_F32_FLOPS)
    print(f"timing mlstm (B={b} S={s} H={h} dk={dk} dv={dv} chunk={chunk}, "
          f"f32): kernel {ms:.5f} ms device ({ev:.4f} events), plain "
          f"{plain:.5f} ms device ({plain_ev:.4f} events), kernel / plain "
          f"{ms / plain:.4f}; bound {bms:.5f} ms ({by}; {flops / 1e9:.3f} "
          f"GFLOP of f32 products as 3xTF32 on the tensor cores at "
          f"{PEAK_TF32_FLOPS / 3e12:.0f} TFLOP/s, {nbytes / 1e6:.1f} MB) = "
          f"{bms / ms:.4f} of the kernel's time; on the f32 peak "
          f"({PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s) {f32_bms:.5f} ms = "
          f"{f32_bms / ms:.4f}")
    del args
    cfg = get_config("xlstm-1.3b")
    blocks = sum(block_kind(cfg, i) == "mlstm" for i in range(cfg.n_layers))
    gen_run = torch.Generator(device=DEVICE).manual_seed(18)
    per_len = {}
    for L in MAIN["prompt_lens"]:
        a, _ = _mlstm_inputs(gen_run, b, L, h, dk, dv, torch.float32, False)
        per_len[L] = _in_turns(dict(
            kernel=lambda: ml.mlstm_scan(*a, chunk=chunk),
            plain=lambda: mlstm_chunked_ref(*a, chunk=chunk)),
            f"mlstm S={L}")
    run = {key: _sum([per_len[L][key] for L in MAIN["prompt_lens"]], blocks)
           for key in ("kernel", "plain")}
    print(f"timing mlstm over one main path run's "
          f"{len(MAIN['prompt_lens'])} prefills ({blocks} launches each): "
          f"kernel {_ms(run['kernel'])}, plain {_ms(run['plain'])}; per "
          f"prompt length (kernel, plain ms): " + ", ".join(
              f"{L}: {_ms(per_len[L]['kernel'])} | "
              f"{_ms(per_len[L]['plain'])}" for L in MAIN["prompt_lens"]))
    return dict(
        name="mlstm_scan", route="cuda",
        source="src/repro_torch/kernels/mlstm_scan/csrc/mlstm_scan.cu",
        replaces="src/repro/kernels/mlstm_scan/mlstm_scan.py:83",
        launches=launches["mlstm_scan"], max_abs_err=errs["mlstm_scan"],
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
        events_ms=ev, plain_events_ms=plain_ev, f32_bound_ms=f32_bms,
        per_prompt_len={L: [per_len[L]["kernel"], per_len[L]["plain"]]
                        for L in MAIN["prompt_lens"]},
        main_run_ms=run["kernel"], main_run_plain_ms=run["plain"])


def _clocks() -> str:
    """The card's SM clock (now and its maximum), memory clock, power draw
    and temperature, as nvidia-smi reads them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,clocks.mem,"
         "power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return smi.stdout.strip() or f"not read ({smi.stderr.strip()})"


def phase_timings(gen, launches: dict, errs: dict) -> list:
    print(f"card before the timings (sm clock, max sm clock, memory clock, "
          f"power, temperature): {_clocks()}")
    rows = []

    rows.append(_time_flash(gen, launches, errs))
    print(f"card after the flash timings: {_clocks()}")
    rows.append(_time_paged(gen, launches, errs))
    rows[-1]["narrow_steps_of_a_32_row_pool"] = _time_paged_narrow()

    rows.append(_time_mlstm(gen, launches, errs))

    rows.append(_time_dequant(gen, launches, errs))
    layouts = _time_layouts(gen)
    layouts.update(_time_wide_flash(gen))
    layouts.update(_time_encdec_flash(gen))
    for row in rows[:2]:
        row["head_layouts"] = {arch: t[row["name"]]
                               for arch, t in layouts.items()
                               if row["name"] in t}
    return rows


def _time_paged_narrow() -> dict:
    """The paged kernel in calls of 1 and 8 rows of a pool of PROBES'
    wide rows (olmo-1b's heads, MAIN's length in pages of 16, each row
    full), device ms in turns: with the pool's plan, as the kernel launches
    now, and with the plan the call's rows chose before the plan followed
    the pool (the same table over the same pages seen as a pool of just
    the call's rows, whose ``split_plan`` is that plan).  Both are held to
    the plain version; a generator of its own keeps later inputs."""
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    gen = torch.Generator(device=DEVICE).manual_seed(27)
    rows, h, kv, d, page = PROBES["wide"], 16, 16, 128, 16
    pages_max = MAIN["max_len"] // page
    q = _randn(gen, rows, h, d)
    kc, vc = (_randn(gen, rows * pages_max, page, kv, d) for _ in range(2))
    out = {}
    for b in (1, 8):
        qb = q[:b]
        bt = (torch.arange(b, device=DEVICE)[:, None] * pages_max
              + torch.arange(pages_max, device=DEVICE)[None, :]).to(
                  torch.int32)
        ln = torch.full((b,), pages_max * page, dtype=torch.int32,
                        device=DEVICE)
        own = (kc[:b * pages_max], vc[:b * pages_max])
        fns = dict(pool=lambda: pa.paged_attention(qb, kc, vc, bt, ln),
                   width=lambda: pa.paged_attention(qb, *own, bt, ln))
        ref = paged_attention_ref(qb, kc, vc, bt, ln).float()
        for name, fn in fns.items():
            err = (fn().float() - ref).abs().max().item()
            check(math.isfinite(err) and err <= BF16_TOL,
                  f"paged narrow {name} plan at B={b}: {err}")
        got = _in_turns(fns, f"paged {b} rows of a {rows}-row pool")
        tokens = b * pages_max * page
        bms, by = bound(4.0 * h * d * tokens,
                        2 * b * h * d * 2 + tokens * kv * d * 2 * 2
                        + b * pages_max * 4 + b * 4)
        plans = dict(pool=pa.split_plan(kc, bt), width=pa.split_plan(own[0],
                                                                    bt))
        print(f"timing paged narrow step (B={b} of a {rows}-row pool, H={h} "
              f"KV={kv} D={d} page={page}, every row {pages_max * page} "
              f"tokens): the pool's plan ({plans['pool']} pages a split) "
              f"{_ms(got['pool'])}; the width-chosen plan ({plans['width']} "
              f"pages) {_ms(got['width'])}; pool / width "
              f"{_ratio(got['pool'], got['width'])}; bound {bms:.5f} ms "
              f"({by})")
        out[f"b{b}"] = dict(pool_ms=got["pool"], width_ms=got["width"],
                            pool_pages_per_split=plans["pool"],
                            width_pages_per_split=plans["width"],
                            bound_ms=bms)
    return out


def _time_wide_flash(gen) -> dict:
    """The flash kernel at deepseek-v2-lite-16b's MLA prefill (B=1 S=512
    H16 KV16 D=192 causal) and at hymba-1.5b's sliding layers (B=1
    S=1536 H25 KV5 D=64, causal, window 1024), beside SDPA (the window as
    a boolean mask), device time per call in turns, with the bound: the
    operations of the unmasked (q, k) pairs and the bytes of q, k, v and
    o."""
    from repro_torch.kernels.flash_attention import ops as fa
    out = {}
    for arch, s, h, kv, d, window in (
            ("deepseek-v2-lite-16b", 512, 16, 16, 192, None),
            ("hymba-1.5b", 1536, 25, 5, 64, 1024)):
        q, k, v = (_randn(gen, 1, s, n, d) for n in (h, kv, kv))
        got = _in_turns(dict(
            kernel=lambda: fa.flash_attention(q, k, v, causal=True,
                                              window=window),
            sdpa=lambda: _flash_sdpa(q, k, v, causal=True, window=window)),
            f"flash {arch} S={s} D={d}")
        pairs = sum(min(i + 1, window or s) for i in range(s))
        bms, by = bound(4.0 * h * d * pairs, 2 * s * (2 * h + 2 * kv) * d)
        print(f"timing flash at {arch}'s prefill (B=1 S={s} H={h} KV={kv} "
              f"D={d} causal, window {window}): kernel {_ms(got['kernel'])}, "
              f"sdpa {_ms(got['sdpa'])}, bound {bms:.5f} ms ({by}); kernel "
              f"/ sdpa {_ratio(got['kernel'], got['sdpa'])}")
        out[arch] = {"flash_attention": dict(
            ms=got["kernel"], library_ms=got["sdpa"], bound_ms=bms,
            bound_by=by, shape=dict(s=s, h=h, kv=kv, d=d, window=window))}
        del q, k, v
    return out


def _time_encdec_flash(gen) -> dict:
    """The flash kernel at seamless-m4t-medium's shapes (H16 KV16 D64,
    ENCDEC's batch): the cross attention of a prefill (Sq = the prompt,
    Sk = the 512 frames, non-causal) and the encoder's self attention over
    the frames, causal as the model runs it (the reference's scanned
    encoder) and non-causal, beside SDPA, device time per call in turns,
    with the bound: the operations of the unmasked (q, k) pairs and the
    bytes of q, k, v and o."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    cfg = get_config("seamless-m4t-medium")
    b, h, d, f = ENCDEC["batch"], cfg.n_heads, cfg.head_dim, \
        cfg.frontend_tokens
    out = {}
    for label, sq, causal in (("cross", ENCDEC["prompt_len"], False),
                              ("encoder", f, True),
                              ("encoder non-causal", f, False)):
        q = _randn(gen, b, sq, h, d)
        k, v = (_randn(gen, b, f, h, d) for _ in range(2))
        got = _in_turns(dict(
            kernel=lambda: fa.flash_attention(q, k, v, causal=causal),
            sdpa=lambda: _flash_sdpa(q, k, v, causal=causal)),
            f"flash {cfg.name} {label}")
        pairs = b * (sq * (sq + 1) // 2 if causal else sq * f)
        bms, by = bound(4.0 * h * d * pairs, 2 * b * (2 * sq + 2 * f) * h * d)
        print(f"timing flash at {cfg.name}'s {label} (B={b} Sq={sq} Sk={f} "
              f"H={h} D={d}, causal {causal}): kernel {_ms(got['kernel'])}, "
              f"sdpa {_ms(got['sdpa'])}, bound {bms:.5f} ms ({by}); kernel / "
              f"sdpa {_ratio(got['kernel'], got['sdpa'])}")
        out[f"{cfg.name} {label}"] = {"flash_attention": dict(
            ms=got["kernel"], library_ms=got["sdpa"], bound_ms=bms,
            bound_by=by, shape=dict(b=b, sq=sq, sk=f, h=h, d=d,
                                    causal=causal))}
        del q, k, v
    return out


def _time_layouts(gen) -> dict:
    """The flash and paged kernels at the head layouts of qwen1.5-4b (H20
    KV20), qwen3p6-27b (H40 KV8) and qwen3-32b (H64 KV8), D=128, and
    nemotron-4-340b (H96 KV8, D=192), beside SDPA (device time per
    call, in turns) and their bounds: flash at S=512 causal, B=1; paged at
    the main path's decode shape (8 slots of a 1024-token cache, lengths =
    prompt + 16, one layer's cache: the timing line of the olmo-1b shape
    cycles 16).  Returns, by arch and kernel, ms, library_ms and
    bound_ms."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    b, page = len(MAIN["prompt_lens"]), 16
    pages_max = MAIN["max_len"] // page
    cap = pages_max * page
    lengths = [n + 16 for n in MAIN["prompt_lens"]]
    out = {}
    for arch, h, kv, d in (("qwen1.5-4b", 20, 20, 128),
                           ("qwen3p6-27b", 40, 8, 128),
                           ("qwen3-32b", 64, 8, 128),
                           ("nemotron-4-340b", 96, 8, 192)):
        s = max(MAIN["prompt_lens"])
        q, k, v = (_randn(gen, 1, s, n, d) for n in (h, kv, kv))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        got = _in_turns(dict(
            kernel=lambda: fa.flash_attention(q, k, v, causal=True),
            sdpa=lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
            f"flash {arch} S={s}")
        bms, by = bound(4.0 * h * d * s * (s + 1) // 2,
                        2 * s * (2 * h + 2 * kv) * d)
        print(f"timing flash at {arch}'s heads (B=1 S={s} H={h} KV={kv} "
              f"D={d} causal): kernel {_ms(got['kernel'])}, sdpa "
              f"{_ms(got['sdpa'])}, bound {bms:.5f} ms ({by}); kernel / "
              f"sdpa {_ratio(got['kernel'], got['sdpa'])}")
        out[arch] = {"flash_attention": dict(
            ms=got["kernel"], library_ms=got["sdpa"], bound_ms=bms)}
        del q, k, v, qt, kt, vt
        qd = _randn(gen, b, h, d)
        kc, vc = (_randn(gen, b * pages_max, page, kv, d) for _ in range(2))
        bt = (torch.arange(b, device=DEVICE)[:, None] * pages_max
              + torch.arange(pages_max, device=DEVICE)[None, :]).to(
                  torch.int32)
        ln = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
        mask = (torch.arange(cap, device=DEVICE)[None, :] < ln[:, None]
                )[:, None, None]
        ck, cv = (t.view(b, cap, kv, d).transpose(1, 2) for t in (kc, vc))
        got = _in_turns(dict(
            kernel=lambda: pa.paged_attention(qd, kc, vc, bt, ln),
            sdpa=lambda: F.scaled_dot_product_attention(
                qd[:, :, None], ck, cv, attn_mask=mask, enable_gqa=True)),
            f"paged {arch}")
        tokens = sum(lengths)
        bms, by = bound(4.0 * h * d * tokens,
                        2 * b * h * d * 2 + tokens * kv * d * 2 * 2
                        + sum(-(-n // page) for n in lengths) * 4 + b * 4)
        print(f"timing paged at {arch}'s heads (B={b} H={h} KV={kv} D={d} "
              f"page={page}, split {pa.split_plan(kc, bt)}"
              f" pages, lengths={lengths}): kernel {_ms(got['kernel'])}, "
              f"sdpa over the slot cache with a length mask "
              f"{_ms(got['sdpa'])}, bound {bms:.5f} ms ({by}); kernel / sdpa "
              f"{_ratio(got['kernel'], got['sdpa'])}")
        out[arch]["paged_attention"] = dict(
            ms=got["kernel"], library_ms=got["sdpa"], bound_ms=bms)
        del qd, kc, vc, ck, cv
    return out


#: the restore's shape: 32 full-width olmo-1b KV blocks of 8,192 quant
#: blocks each, widened by one list call
RESTORE_SEGMENTS, RESTORE_BLOCKS = 32, 8192


def _time_dequant(gen, launches: dict, errs: dict) -> dict:
    """The dequant kernel at the restore's shape (the row's numbers): one
    list call over 32 segments of 8,192 x 128 codes against the same 32
    segments as 32 single-segment calls (the path before the list call)
    and the plain version, device time in turns, two rounds (the median
    of four windows each; every window printed).  L2-cold: each call reads
    an 80 MiB buffer first (a reduction, left out of the times), which
    evicts the codes a streaming-store kernel leaves in L2 and writes back
    the last call's output, and the codes rotate over 3 sets (33.8 MB of
    codes and scales each).  Beside it the widen step as the restore runs
    it (split_wire, then decode_many; or per block split_wire and decode),
    event time, host and device together, back to back.  Then one block's
    shape (8,192 x 128, 64 rotating sets, the same flush).  fp8 is the
    row's codec; int8 rides beside it.  No single PyTorch call computes
    this function, so the two-op expression the plain version is written
    as is timed beside the single block (events), labelled as such."""
    import dataclasses
    from repro_torch.kernels.dequant import ops as dq
    from repro_torch.kernels.dequant.ref import (CODE_DTYPES, dequant_many_ref,
                                                 dequant_ref)
    from repro_torch.quant import QuantizedBlock, get_codec, split_wire
    nseg, nblocks, rsets = RESTORE_SEGMENTS, RESTORE_BLOCKS, 3
    values = nblocks * 128
    rcodes = torch.randint(0, 256, (rsets, nseg, values), generator=gen,
                           device=DEVICE, dtype=torch.int32).to(torch.uint8)
    rscales = torch.rand((rsets, nseg, nblocks), generator=gen, device=DEVICE)
    lists = [([rcodes[k, i] for i in range(nseg)],
              [rscales[k, i] for i in range(nseg)]) for k in range(rsets)]
    wires = [[torch.cat([c, s.view(torch.uint8)]) for c, s in zip(*lists[k])]
             for k in range(rsets)]
    r_bytes = nseg * (values * (1 + 4) + nblocks * 4)
    r_bms, r_by = bound(nseg * values, r_bytes, PEAK_F32_FLOPS)
    flush = torch.ones(80 << 18, device=DEVICE)
    turn = [0]

    def rotate(fn, sets, cold=True):
        def call():
            i = turn[0] = (turn[0] + 1) % sets
            if cold:
                flush.sum()
            return fn(i)
        return call

    def windows(w: dict) -> str:
        return "; ".join(f"{name} " + " ".join(f"{ms:.5f}" for ms in v)
                         for name, v in w.items())

    per_codec = {}
    for codec in ("fp8", "int8"):
        qb = QuantizedBlock(codec=codec, raw_bytes=2 * values,
                            wire_bytes=values + 4 * nblocks,
                            codes=rcodes[0, 0], scales=rscales[0, 0],
                            shape=(values,), dtype="bfloat16")
        dec = get_codec(codec)

        def blocks(k):
            out = []
            for w in wires[k]:
                c, s = split_wire(w, values)
                out.append(dataclasses.replace(qb, codes=c, scales=s))
            return out

        fns = {
            "list call": rotate(lambda k: dq.dequant_many(
                *lists[k], codec=codec), rsets),
            "32 calls": rotate(lambda k: [
                dq.dequant(c.view(nblocks, 128), s, codec=codec)
                for c, s in zip(*lists[k])], rsets),
            "plain": rotate(lambda k: dequant_many_ref(
                *lists[k], codec=codec), rsets),
        }
        seen = {}
        dev = _in_turns(fns, f"dequant {codec} restore shape", rounds=2,
                        skip="reduce_kernel", windows=seen)
        for name in fns:
            _measured(dev[name], f"dequant {codec} {name} at the restore "
                                 f"shape")
        widen_many = time_ms(rotate(lambda k: dec.decode_many(blocks(k)),
                                    rsets, cold=False), iters=30)
        widen_each = time_ms(rotate(lambda k: [dec.decode(b) for b in
                                               blocks(k)], rsets,
                                    cold=False), iters=30)
        per_codec[codec] = dict(
            ms=dev["list call"], calls32_ms=dev["32 calls"],
            plain_ms=dev["plain"], windows_ms=seen,
            widen_events_ms=widen_many,
            widen_per_block_events_ms=widen_each)
        print(f"timing dequant {codec} at the restore shape ({nseg} segments "
              f"x {nblocks} x 128 codes, L2-cold): list call "
              f"{dev['list call']:.5f} ms device (1 launch), 32 calls "
              f"{dev['32 calls']:.5f} ms (32 launches), plain "
              f"{dev['plain']:.5f} ms; bound {r_bms:.5f} ms ({r_by}; "
              f"{r_bytes} bytes): list call {r_bms / dev['list call']:.4f} "
              f"of the bound, {dev['list call'] / dev['32 calls']:.4f}x the "
              f"32 calls (windows: {windows(seen)}); widen step "
              f"(split_wire + decode, events, host and device) "
              f"{widen_many:.5f} ms with decode_many, {widen_each:.5f} ms "
              f"block by block")
    del rcodes, rscales, lists, wires

    # one restored block's shape: 8,192 quant blocks, 64 sets cycled (66 MB
    # of codes and scales) after the same flush.  A call this short is
    # bound by its host-side dispatch when calls run back to back (CUDA
    # events then time the dispatch), so the profiler's device time per
    # call is the number
    sets = 64
    codes = torch.randint(0, 256, (sets, nblocks, 128), generator=gen,
                          device=DEVICE, dtype=torch.int32).to(torch.uint8)
    scales = torch.rand((sets, nblocks), generator=gen, device=DEVICE)
    scales2d = scales[:, :, None].contiguous()
    nbytes = nblocks * 128 * (1 + 4) + nblocks * 4
    bms, by = bound(nblocks * 128, nbytes, PEAK_F32_FLOPS)
    for codec in ("fp8", "int8"):
        ms = time_ms(rotate(lambda i: dq.dequant(codes[i], scales[i],
                                                 codec=codec), sets,
                            cold=False), iters=160)
        plain = time_ms(rotate(lambda i: dequant_ref(
            codes[i], scales2d[i], codec=codec), sets, cold=False),
            iters=160)
        expr = time_ms(rotate(lambda i: codes[i].view(
            CODE_DTYPES[codec]).float() * scales2d[i], sets, cold=False),
            iters=160)
        seen = {}
        dev = _in_turns({
            "kernel": rotate(lambda i: dq.dequant(codes[i], scales[i],
                                                  codec=codec), sets),
            "plain": rotate(lambda i: dequant_ref(codes[i], scales2d[i],
                                                  codec=codec), sets)},
            f"dequant {codec} one block", rounds=2, skip="reduce_kernel",
            windows=seen)
        device = _measured(dev["kernel"], f"the dequant kernel ({codec})")
        plain_device = _measured(dev["plain"],
                                 f"dequant's plain version ({codec})")
        per_codec[codec]["single_block"] = dict(
            ms=device, plain_ms=plain_device, bound_ms=bms, events_ms=ms,
            plain_events_ms=plain, torch_expr_events_ms=expr,
            windows_ms=seen)
        print(f"timing dequant {codec} ({nblocks} x 128 codes, one restored "
              f"block, L2-cold): kernel {device:.5f} ms device ({ms:.5f} ms "
              f"events), plain {plain_device:.5f} ms device ({plain:.5f} ms "
              f"events), two-op torch expression codes.view("
              f"{CODE_DTYPES[codec]}).float() * scales {expr:.5f} ms events, "
              f"bound {bms:.5f} ms ({by}; {nbytes} bytes): "
              f"{bms / device:.4f} of the bound (windows: {windows(seen)})")
    # the row's ms, plain_ms and bound are the restore shape's (device
    # time per call, the profiler's); event times ride beside them
    fp8 = per_codec["fp8"]
    return dict(
        name="dequant", route="cuda",
        source="src/repro_torch/kernels/dequant/csrc/dequant.cu",
        replaces="src/repro/kernels/dequant/dequant.py:50",
        launches=launches["dequant"], max_abs_err=errs["dequant"],
        ms=fp8["ms"], plain_ms=fp8["plain_ms"], bound_ms=r_bms,
        bound_by=r_by, library_ms=None, codec="fp8",
        shape=f"{nseg} segments x {nblocks} x 128 codes, one list call",
        calls32_ms=fp8["calls32_ms"], windows_ms=fp8["windows_ms"],
        widen_events_ms=fp8["widen_events_ms"],
        widen_per_block_events_ms=fp8["widen_per_block_events_ms"],
        single_block=fp8["single_block"], int8=per_codec["int8"])


def _in_turns(fns: dict, label: str, rounds: int = 1, skip: str = "",
              windows: dict = None) -> dict:
    """Device time per call of each of ``fns`` (by name), measured in turns
    a, b, ..., ..., b, a (``rounds`` times) so a drift of the card's clock
    falls on all alike; the median of each one's windows (None where the
    profiler saw nothing), kernels whose name holds ``skip`` left out.
    Each one's first window is printed; ``windows`` collects them all."""
    order = (list(fns) + list(fns)[::-1]) * rounds
    got = {name: [] for name in fns}
    for i, name in enumerate(order):
        ms = _kernel_breakdown(fns[name], f"{label} {name}",
                               show=i < len(fns), skip=skip)
        if ms is not None:
            got[name].append(ms)
    if windows is not None:
        windows.update(got)
    return {name: statistics.median(v) if v else None
            for name, v in got.items()}


def _measured(ms, what: str) -> float:
    """A device time the kernels line must carry; the run fails without
    it (an event time never stands in for it)."""
    check(ms is not None, f"no device time for {what}: the profiler saw no "
                          f"device events")
    return ms


def _sum(terms: list, times: int = 1):
    """``times`` the sum of ``terms``, or None if any one was not
    measured."""
    return None if None in terms else times * sum(terms)


def _ms(ms) -> str:
    """A device time as printed: "not measured" where it is None."""
    return "not measured" if ms is None else f"{ms:.5f} ms device"


def _fmt(x, spec: str) -> str:
    """``x`` formatted, or "not measured" where it is None."""
    return "not measured" if x is None else format(x, spec)


def _ratio(a, b) -> str:
    return "not measured" if a is None or b is None else f"{a / b:.4f}"


def _kernel_breakdown(fn, label: str, calls: int = 10, show: bool = True,
                      only: str = "", skip: str = ""):
    """Device time per call of each kernel ``fn`` launches (torch.profiler
    over ``calls`` calls, after calls that keep the card busy for at least
    20 ms), printed unless not ``show``; returns their sum in ms per call
    (of the kernels whose name holds ``only`` and not ``skip``), or None
    where the profiler saw no such device events in five windows.

    A window now and then comes back empty, or holding fewer launches of a
    kernel than were made (``count`` below calls x launches per call), so
    a total over the window divided by ``calls`` would read low.  A window
    whose every kernel count is a multiple of ``calls`` is taken as it is;
    failing one in five, the window holding the most launches is read as
    each kernel's mean time per launch seen, times ceil(count / calls)
    launches per call, and the label says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.02:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    best, whole = [], False
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)), e.key,
                 e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and only in e.key
                and not (skip and skip in e.key)]
        rows = [(us, key, n) for us, key, n in rows if us > 0 and n > 0]
        if rows and all(n % calls == 0 for _, _, n in rows):
            best, whole = rows, True
            break
        if sum(n for _, _, n in rows) > sum(n for _, _, n in best):
            best = rows
    if not best:
        print(f"  {label} per kernel: not measured (no device events)")
        return None
    per_call = sorted(((us / n * -(-n // calls), key) for us, key, n in best),
                      reverse=True)

    def short(key):   # "void (anonymous namespace)::name<T>(...)" -> name
        key = key.replace("(anonymous namespace)::", "")
        return key.split("(")[0].split("<")[0].split()[-1]

    if show:
        seen = "" if whole else (" (the profiler lost launches in every "
                                 "window; mean per launch seen)")
        print(f"  {label} per kernel, ms per call{seen}: " + "; ".join(
            f"{short(key)} {us / 1e3:.5f}" for us, key in per_call))
    return sum(us for us, _ in per_call) / 1e3


def _syncs_of(fn) -> list:
    """The lines that synchronised the card while ``fn()`` ran (torch's
    sync debug mode warns at each; a graph capture cannot hold one)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sorted({f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                   for w in seen
                   if "called a synchronizing" in str(w.message)})


def _host_and_wall_ms(fn, calls: int) -> tuple:
    """(host ms a call, wall ms a call) over ``calls`` calls of ``fn``:
    the host's time to return, and the time to the card's end."""
    torch.cuda.synchronize()
    host = 0.0
    t0 = time.perf_counter()
    for _ in range(calls):
        h0 = time.perf_counter()
        fn()
        host += time.perf_counter() - h0
    torch.cuda.synchronize()
    return host / calls * 1e3, (time.perf_counter() - t0) / calls * 1e3


def _graph_family(arch: str) -> dict:
    """One smoke-width family: its decode calls eager and through
    ``Model.decode_step`` (recorded and replayed where the configuration
    allows it), the logits compared, the syncs an eager call makes, and
    both timed."""
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.models.model import Model, decode_step
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              **GRAPH_SHARES.get(arch, {}))
    model = Model(cfg, seed=0, device=DEVICE)
    b, max_len = GRAPHS["rows"], GRAPHS["max_len"]
    enc = cfg.frontend_tokens if cfg.encoder_layers else 0
    eager_c = model.init_cache(b, max_len, enc_len=enc)
    graph_c = model.init_cache(b, max_len, enc_len=enc)
    slots = torch.arange(b, device=DEVICE, dtype=torch.int32)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    calls0, launches = dict(Model.decode_calls), [0, 0]
    equal, diff, syncs = 0, 0.0, []
    for step in range(GRAPHS["steps"]):
        tok = torch.randint(1, cfg.vocab_size, (b, 1), generator=gen,
                            device=DEVICE, dtype=torch.int32)
        idx = slots + step
        got = {}

        def eager():
            got["want"] = decode_step(model.params, cfg, eager_c, tok, idx,
                                      slots, max_len)[0]
        if step == 1:                   # first calls build what they keep
            syncs = _syncs_of(eager)
        else:
            eager()
        n0 = pa_ops.paged_attention.launches
        got["got"] = model.decode_step(graph_c, tok, idx, slots, max_len)[0]
        launches[0] += pa_ops.paged_attention.launches - n0
        launches[1] = pa_ops.paged_attention.launches - n0
        equal += torch.equal(got["got"], got["want"])
        diff = max(diff, (got["got"].float() - got["want"].float()).abs()
                   .max().item())
    calls = {k: Model.decode_calls[k] - calls0[k] for k in calls0}
    tok, idx = torch.ones((b, 1), device=DEVICE, dtype=torch.int32), slots
    replay_ms = _host_and_wall_ms(
        lambda: model.decode_step(graph_c, tok, idx, slots, max_len),
        GRAPHS["timed"])
    eager_ms = _host_and_wall_ms(
        lambda: decode_step(model.params, cfg, graph_c, tok, idx, slots,
                            max_len), GRAPHS["timed"])
    print(f"decode graph {arch} (smoke width, {b} rows, {cfg.family}"
          f"{', MLA' if cfg.use_mla else ''}{', hybrid' if cfg.hybrid else ''}"
          f", mlp {cfg.mlp_kind}): calls "
          f"{calls}; logits bit-equal in {equal} of {GRAPHS['steps']}, "
          f"largest difference {diff}; paged launches {launches[0]} "
          f"(last call {launches[1]}); syncs of an eager call "
          f"{syncs or 'none'}; host / wall ms a call: eager "
          f"{eager_ms[0]:.3f} / {eager_ms[1]:.3f}, through decode_step "
          f"{replay_ms[0]:.3f} / {replay_ms[1]:.3f}")
    del model, eager_c, graph_c
    torch.cuda.empty_cache()
    return dict(calls=calls, equal=equal, syncs=syncs)


def _prefill_graph_family(arch: str) -> dict:
    """One smoke-width family's prefill of one prompt length through
    ``Model.prefill`` with a graph kept (eager, captured, then replayed),
    each call's logits and one-row cache against an eager prefill's."""
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.models.model import Model, prefill
    from repro_torch.training.optimizer import leaves
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              prefill_graphs=1, **GRAPH_SHARES.get(arch, {}),
                              **PREFILL_GRAPH_ARCHS[arch])
    model = Model(cfg, seed=0, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    calls0, equal = dict(Model.prefill_calls), 0
    for _ in range(GRAPHS["steps"]):
        tok = torch.randint(1, cfg.vocab_size, (1, GRAPHS["max_len"] // 2),
                            generator=gen, device=DEVICE)
        with torch.no_grad():
            want = prefill(model.params, cfg, tok, GRAPHS["max_len"])
        got = model.prefill(tok, GRAPHS["max_len"])
        equal += (got[2] == want[2] and all(
            torch.equal(g, w) for g, w in
            zip([got[0]] + leaves(got[1]), [want[0]] + leaves(want[1]))))
    calls = {k: Model.prefill_calls[k] - calls0[k] for k in calls0}
    print(f"prefill graph {arch} (smoke width, one prompt of "
          f"{GRAPHS['max_len'] // 2}): calls {calls}; logits and cache "
          f"bit-equal in {equal} of {GRAPHS['steps']}")
    del model
    torch.cuda.empty_cache()
    return dict(calls=calls, equal=equal)


def _written(caches, slots, index) -> list:
    """Copies of what a decode call of rows ``slots`` at positions
    ``index`` writes into attention caches: every leaf of each ``kv``
    cache at row ``slots[i]``, position ``index[i] % cap`` (the benchmark
    cells' caches hold nothing else)."""
    out = []

    def walk(tree):
        if isinstance(tree, dict) and "pos" in tree:
            lead, cap = tree["pos"].ndim - 2, tree["pos"].shape[-1]
            at = (slice(None),) * lead + (slots, index % cap)
            out.extend(tree[k][at].clone() for k in sorted(tree))
        elif isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k])
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)
    walk(caches)
    return out


class _EagerBeside:
    """The engine's model, each decode call compared with an eager call of
    the same inputs made just after it on the same caches, which rewrites
    the positions the first call wrote before it reads them (the caches of
    a benchmark cell have no room for a copy): ``compared`` holds, per
    call, whether its logits are bit-equal to the eager call's, the
    largest difference, and whether the positions it wrote hold what the
    eager call writes there; ``launches`` the paged launches of the calls
    through the model."""

    def __init__(self, model):
        self._model, self.compared, self.launches = model, [], 0
        #: host ms of the calls through the model, by how they ran
        self.host_ms = {}

    def __getattr__(self, name):
        return getattr(self._model, name)

    def decode_step(self, caches, tokens, index, slots=None, max_len=0):
        from repro_torch.kernels.paged_attention import ops as pa_ops
        from repro_torch.models.model import decode_step
        m = self._model
        n0 = pa_ops.paged_attention.launches
        calls0 = dict(type(m).decode_calls)
        t0 = time.perf_counter()
        got, caches = m.decode_step(caches, tokens, index, slots, max_len)
        how = [k for k, n in type(m).decode_calls.items() if n != calls0[k]]
        self.host_ms.setdefault(how[0], []).append(
            (time.perf_counter() - t0) * 1e3)
        self.launches += pa_ops.paged_attention.launches - n0
        b = tokens.shape[0]
        rows = (torch.arange(b, device=tokens.device) if slots is None
                else slots).long()
        at = index.reshape(-1).expand(b).long()
        wrote = _written(caches, rows, at)
        with torch.no_grad():
            want = decode_step(m.params, m.cfg, caches, tokens, index, slots,
                               max_len)[0]
        self.compared.append((
            torch.equal(got, want),
            (got.float() - want.float()).abs().max().item(),
            all(torch.equal(g, w) for g, w in
                zip(wrote, _written(caches, rows, at)))))
        return got, caches


def _graph_cell(name: str) -> dict:
    """A benchmark cell's configuration at its width: ``cell_calls`` decode
    calls through ``Model.decode_step``, each beside an eager call, with
    prefills between them; then engine steps timed with the graphs and
    without."""
    import numpy as np
    sys.path.insert(0, ROOT)
    from portbench import serve, spec, weights
    from repro_torch.core.bridge import PROFILES, BridgeModel
    from repro_torch.core.policy import cc_aware_defaults
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import SamplingParams
    bench = spec.load_benchmark()
    cell = spec.workload(bench, name)
    mix = spec.mix(cell["traffic"])
    cfg, dm = serve.port_config(spec.config(bench, cell["config"]))
    torch.cuda.reset_peak_memory_stats()
    params = weights.make(dm, GRAPHS["cell_seed"], DEVICE)
    model = Model(cfg, params=params, device=DEVICE)
    engine = ServingEngine(
        model, max_batch=mix["max_batch"], max_len=mix["max_len"],
        bridge=BridgeModel(PROFILES[mix["bridge_profile"]],
                           cc_on=mix["cc_on"]),
        defaults=cc_aware_defaults(mix["cc_on"], concurrency=mix["clients"]),
        seed=GRAPHS["cell_seed"], device=DEVICE)
    beside = engine.model = _EagerBeside(model)
    rng = np.random.default_rng(GRAPHS["cell_seed"])
    n_req, prefills, calls0 = 0, 0, dict(Model.decode_calls)

    def admit(n, new_tokens=GRAPHS["cell_new_tokens"]):
        nonlocal n_req
        for _ in range(n):
            engine.submit(Request(
                f"g{n_req}", prompt=rng.integers(
                    1, cfg.vocab_size, GRAPHS["cell_prompt"]).tolist(),
                sampling=SamplingParams(max_new_tokens=new_tokens)))
            n_req += 1
    while len(beside.compared) < GRAPHS["cell_calls"]:
        if len(beside.compared) % GRAPHS["cell_admit_every"] == 0:
            admit(2)
            prefills += 2
        engine.step()
    calls = {k: Model.decode_calls[k] - calls0[k] for k in calls0}
    equal = sum(e for e, _, _ in beside.compared)
    diff = max(d for _, d, _ in beside.compared)
    writes = sum(w for _, _, w in beside.compared)
    n_calls = len(beside.compared)
    print(f"decode graph {name}: {n_calls} decode calls at width "
          f"{mix['max_batch']} ({engine.policy.value}), {prefills} prefills "
          f"between them; calls {calls}; logits bit-equal to the eager "
          f"call's in {equal} of {n_calls}, largest difference {diff}; "
          f"paged launches {beside.launches} = calls x layers "
          f"{n_calls * cfg.n_layers}: "
          f"{beside.launches == n_calls * cfg.n_layers}; positions written "
          f"equal to the eager call's in {writes} of {n_calls}; host ms a "
          f"call: "
          + ", ".join(f"{how} {statistics.median(ms):.3f} (median of "
                      f"{len(ms)}, max {max(ms):.3f})"
                      for how, ms in beside.host_ms.items()))
    engine.model = model
    admit(4, new_tokens=4 * GRAPHS["timed"])
    walls = {}
    for label in ("graphs", "eager", "graphs"):
        with (model.decode_graphs.eager() if label == "eager"
              else contextlib.nullcontext()):
            engine.step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(GRAPHS["timed"]):
                engine.step()
            torch.cuda.synchronize()
        walls.setdefault(label, []).append(
            (time.perf_counter() - t0) / GRAPHS["timed"] * 1e3)
    print(f"decode graph {name}: engine step wall ms (in turns "
          f"graphs, eager, graphs; {len(engine.active)} rows stepping): "
          f"graphs {walls['graphs']}, eager {walls['eager']}; peak "
          f"allocated {torch.cuda.max_memory_allocated()} bytes")
    engine.close()
    engine.caches = None
    del engine, beside, model, params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(calls=calls, equal=equal, writes=writes, n=n_calls,
                diff=diff)


def phase_decode_graphs() -> None:
    """Which families replay their decode calls as a CUDA graph, the syncs
    that hold the others eager, the prefill graphs of
    ``PREFILL_GRAPH_ARCHS``, and each benchmark cell's decode calls
    replayed beside eager ones at the cell's width."""
    bad = []
    for arch in GRAPH_ARCHS:
        try:
            got = _graph_family(arch)
        except Exception as exc:    # report every family before failing
            print(f"decode graph {arch}: FAILED {type(exc).__name__}: {exc}")
            bad.append(arch)
            continue
        if (got["syncs"] or got["calls"]["captured"] != 1
                or got["equal"] != GRAPHS["steps"]):
            bad.append(arch)
    for arch in PREFILL_GRAPH_ARCHS:
        try:
            got = _prefill_graph_family(arch)
        except Exception as exc:    # report every family before failing
            print(f"prefill graph {arch}: FAILED {type(exc).__name__}: "
                  f"{exc}")
            bad.append(f"{arch} prefill")
            continue
        if (got["calls"]["captured"] != 1
                or got["equal"] != GRAPHS["steps"]):
            bad.append(f"{arch} prefill")
    for name in ("nemotron-4-340b-l4.paper-1k1k-c256",
                 "deepseek-moe-16b.paper-1k1k-c64"):
        got = _graph_cell(name)
        if (got["calls"]["captured"] != 1
                or got["calls"]["replayed"] < got["n"] - 2
                or got["equal"] != got["n"] or got["writes"] != got["n"]):
            bad.append(name)
    check(not bad, f"decode graphs: {bad}")


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import block_kind

    if sys.argv[1:] == ["decode_graphs"]:      # this phase alone
        card = phase_card()
        phase_build()
        phase_decode_graphs()
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    t_start = time.perf_counter()
    card = phase_card()
    phase_build()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    errs = {"flash_attention": phase_flash(gen),
            "paged_attention": phase_paged(gen)}
    phase_paged_widths()
    errs.update(mlstm_scan=phase_mlstm(gen), dequant=phase_dequant(gen))

    # olmo-1b: flash prefill, paged decode
    model = init_model("olmo-1b")
    phase_model_check(model)
    launches = phase_main(model, attention_launches(model.cfg))
    phase_width_probes(model, (PROBES["long_len"],), wide=True)
    phase_profile(model)
    launches["dequant"] += phase_restore(model)
    for phase in (phase_chaos, phase_loader, phase_tp,
                  phase_bench_full_width):
        more = phase(model)
        launches = {k: n + more[k] for k, n in launches.items()}
    phase_cost(model)
    del model
    torch.cuda.empty_cache()

    # olmo-1b trained at full width (autograd over the train mode: no
    # kernel), held to the flash path, checkpointed
    phase_train(card)

    # xlstm-1.3b: the mLSTM scan on every mLSTM block's prefill
    t0 = time.perf_counter()
    model = Model(get_config("xlstm-1.3b"), seed=0, device=DEVICE)
    cfg = model.cfg
    n_params = sum(t.numel() for t in model.buffers())
    p_bytes = sum(t.numel() * t.element_size() for t in model.buffers())
    n_mlstm = sum(block_kind(cfg, i) == "mlstm" for i in range(cfg.n_layers))
    state = model.init_cache(MAIN["max_batch"], 1)
    s_bytes = sum(t.numel() * t.element_size() for layer in state["blocks"]
                  for t in layer["ssm"].values())
    del state
    print(f"xlstm-1.3b at full width: {cfg.n_layers} blocks ({n_mlstm} "
          f"mLSTM, {cfg.n_layers - n_mlstm} sLSTM), d_model {cfg.d_model}; "
          f"{n_params} parameters ({p_bytes} bytes); recurrent state of "
          f"{MAIN['max_batch']} slots {s_bytes} bytes; init "
          f"{time.perf_counter() - t0:.1f} s")
    phase_xlstm_model_check(model)
    x_launches = phase_main(model, lambda stats, n_req: {
        "flash_attention": 0, "paged_attention": 0,
        "mlstm_scan": n_req * n_mlstm, "dequant": 0})
    phase_width_probes(model, (MAIN["max_len"],))
    phase_profile(model)
    del model
    torch.cuda.empty_cache()
    launches = {k: n + x_launches[k] for k, n in launches.items()}

    # qwen1.5-4b (MHA, QKV bias, untied), qwen3p6-27b (the paper's own
    # serving workload: GQA 40/8, qk_norm; ~39 GB of weights; also 32
    # slots with its 1k-token prompts, phase_wide) and qwen3-32b (GQA
    # 64/8, qk_norm; 65.5 GB): the flash and paged kernels at their head
    # layouts; each is freed before the next is drawn
    for arch in ("qwen1.5-4b", "qwen3p6-27b", "qwen3-32b"):
        model = init_model(arch)
        phase_model_check(model)
        probes = (phase_width_probes(model, (MAIN["max_len"],))
                  if arch == "qwen1.5-4b" else {})
        more = phase_main(model, attention_launches(model.cfg),
                          probes.get(MAIN["max_len"]))
        launches = {k: n + more[k] for k, n in launches.items()}
        if arch != "qwen1.5-4b":
            phase_profile(model)
        if arch == "qwen3p6-27b":
            more = phase_wide(model)
            launches = {k: n + more[k] for k, n in launches.items()}
        print(f"{arch}: peak allocated over its phases "
              f"{torch.cuda.max_memory_allocated()} bytes")
        del model
        torch.cuda.empty_cache()

    # nemotron-4-340b at NEMOTRON's depth: GQA 96/8 at head dim 192 (flash
    # and the paged kernel's D = 192 instantiation), squared-ReLU MLP of
    # 73728, vocab 256000 untied
    model = init_model("nemotron-4-340b", **NEMOTRON)
    phase_model_check(model)
    more = phase_main(model, attention_launches(model.cfg))
    launches = {k: n + more[k] for k, n in launches.items()}
    phase_profile(model)
    print(f"nemotron-4-340b: peak allocated over its phases "
          f"{torch.cuda.max_memory_allocated()} bytes")
    del model
    torch.cuda.empty_cache()

    # hymba-1.5b (parallel attention + Mamba-2 heads, sliding-window ring
    # caches), deepseek-moe-16b (MoE after a dense layer 0) and
    # deepseek-v2-lite-16b (MLA on MoE: flash at D = 192, absorbed decode
    # without the paged kernel); each is freed before the next is drawn
    for arch in ("hymba-1.5b", "deepseek-moe-16b", "deepseek-v2-lite-16b"):
        model = init_model(arch)
        phase_model_check(model)
        more = phase_main(model, attention_launches(model.cfg))
        phase_width_probes(model, (MAIN["max_len"],))
        if model.cfg.hybrid:
            ring = phase_hymba_ring(model)
            more = {k: n + ring[k] for k, n in more.items()}
        if model.cfg.n_routed_experts:
            phase_moe_routing(model)
        launches = {k: n + more[k] for k, n in launches.items()}
        phase_profile(model)
        print(f"{arch}: peak allocated over its phases "
              f"{torch.cuda.max_memory_allocated()} bytes")
        del model
        torch.cuda.empty_cache()

    # seamless-m4t-medium (encoder-decoder: the encoder and cross attention
    # on the flash kernel, self attention decode on the paged kernel at
    # D = 64; trained too) and internvl2-76b at VLM's depth (a patch
    # prefix; H64 KV8), model-level; each is freed before the next is drawn
    seamless = get_config("seamless-m4t-medium")
    model = init_model("seamless-m4t-medium", cache=(
        ENCDEC["batch"], ENCDEC["prompt_len"] + ENCDEC["new_tokens"],
        seamless.frontend_tokens))
    more = phase_encdec(model)
    launches = {k: n + more[k] for k, n in launches.items()}
    phase_encdec_train(model)
    del model
    torch.cuda.empty_cache()
    vlm = get_config("internvl2-76b")
    model = init_model("internvl2-76b", cache=(
        VLM["batch"], vlm.frontend_tokens + VLM["prompt_len"]
        + VLM["new_tokens"], 0), n_layers=VLM["n_layers"])
    more = phase_vlm(model)
    launches = {k: n + more[k] for k, n in launches.items()}
    print(f"{vlm.name}: peak allocated over its phases "
          f"{torch.cuda.max_memory_allocated()} bytes")
    del model
    torch.cuda.empty_cache()

    phase_decode_graphs()
    phase_drift()
    for more in (phase_benchmarks(), phase_examples(card)):
        launches = {k: n + more[k] for k, n in launches.items()}
    phase_dryrun()
    rows = phase_timings(gen, launches, errs)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
