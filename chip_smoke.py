"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc`` with
nvcc (sm_90a), holds each kernel to its plain PyTorch version on the card,
serves full-width olmo-1b (random weights from a seed) through the port's
``ServingEngine`` under the sync, async and worker policies, checks that
the main path went through the kernels (launch counters) and that its
crossing tapes obey the bridge law, and times each kernel, its plain
version and the PyTorch call computing the same function.  It prints the
card's name and power limit, one ``{"kernels": [...]}`` line, and as its
last line ``{"ok": true, "device": {...}}``.  Without a CUDA card, or
without the repository's ``src`` beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BF16_TOL = 3e-2
#: the card's published peaks (H100 SXM, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

#: where every phase runs (the card; a CPU rehearsal may rebind it)
DEVICE = "cuda"
MAIN = dict(max_batch=8, max_len=1024, new_tokens=32,
            prompt_lens=[16, 87, 158, 229, 299, 370, 441, 512])


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


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time the card could take: ops over the bf16 peak or bytes over
    the memory rate, whichever is larger (ms, which bounds it)."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
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
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)


def phase_flash(gen) -> float:
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    cases = [dict(b=1, sq=s, sk=s, h=16, kv=16, d=128, causal=True)
             for s in (1, 17, 128, 500, 1024)]
    cases += [dict(b=1, sq=512, sk=512, h=40, kv=8, d=128, causal=True),
              dict(b=2, sq=300, sk=300, h=16, kv=4, d=128, causal=True,
                   window=100),
              dict(b=2, sq=96, sk=384, h=8, kv=4, d=64, causal=False)]
    worst = 0.0
    for c in cases:
        q = _randn(gen, c["b"], c["sq"], c["h"], c["d"])
        k = _randn(gen, c["b"], c["sk"], c["kv"], c["d"])
        v = _randn(gen, c["b"], c["sk"], c["kv"], c["d"])
        kw = dict(causal=c["causal"], window=c.get("window"))
        out = ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out.float() - flash_attention_ref(q, k, v, **kw).float()
               ).abs().max().item()
        print(f"flash {c}: max_abs_err {err:.3g}")
        check(math.isfinite(err) and err <= BF16_TOL,
              f"flash kernel disagrees with its plain version at {c}: {err}")
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
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    lens8 = [1, 7, 16, 17, 32, 333, 1023, 1024]   # 1, < page, boundaries, max
    cases = [dict(b=8, h=16, kv=16, d=128, page=16, pages_max=64,
                  lengths=lens8, identity=False),
             dict(b=8, h=16, kv=16, d=128, page=16, pages_max=64,
                  lengths=lens8, identity=True),
             dict(b=4, h=40, kv=8, d=128, page=16, pages_max=64,
                  lengths=[1, 15, 500, 1024], identity=False)]
    worst = 0.0
    for c in cases:
        args = _paged_inputs(gen, **c)
        out = ops.paged_attention(*args)
        torch.cuda.synchronize()
        err = (out.float() - paged_attention_ref(*args).float()
               ).abs().max().item()
        print(f"paged {c}: max_abs_err {err:.3g}")
        check(math.isfinite(err) and err <= BF16_TOL,
              f"paged kernel disagrees with its plain version at {c}: {err}")
        worst = max(worst, err)
    return worst


def phase_model_check(model) -> None:
    """The model with its kernels against the same model with the kernels'
    plain versions swapped in, on the card: a 100-token prefill and four
    teacher-forced decode steps, logits within 2e-2 relative (L2)."""
    from repro_torch.models import layers, transformer
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    prompt = torch.arange(1, 101, device=DEVICE, dtype=torch.int32)[None]
    steps = [torch.tensor([[t]], device=DEVICE, dtype=torch.int32)
             for t in (5, 6, 7, 8)]

    def run():
        logits, cache, idx = model.prefill(prompt, 128)
        out = [logits]
        for i, tok in enumerate(steps):
            out.append(model.decode_step(
                cache, tok, torch.tensor([idx + i], device=DEVICE,
                                         dtype=torch.int32))[0])
        return torch.cat([o.float().reshape(-1) for o in out])

    kernel = run()
    core, paged = layers.attention_core, transformer.pa_ops.paged_attention
    layers.attention_core = (lambda q, k, v, *, causal, window=None:
                             flash_attention_ref(q, k, v, causal=causal,
                                                 window=window))
    transformer.pa_ops.paged_attention = paged_attention_ref
    try:
        plain = run()
    finally:
        layers.attention_core, transformer.pa_ops.paged_attention = core, paged
    rel = ((kernel - plain).norm() / plain.norm()).item()
    print(f"model check: kernels vs plain versions, logits rel L2 {rel:.3g}; "
          f"finite {bool(torch.isfinite(kernel).all())}")
    check(bool(torch.isfinite(kernel).all()) and rel <= 2e-2,
          f"model with kernels disagrees with plain versions: {rel}")


def phase_main(model) -> dict:
    from repro_torch.core.policy import SchedulingPolicy
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import SamplingParams
    from repro_torch.trace import TraceRecorder, check_tape

    cfg = model.cfg
    vocab = cfg.vocab_size
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, vocab, (n,), generator=gen).tolist()
               for n in MAIN["prompt_lens"]]
    launches = {"flash_attention": 0, "paged_attention": 0}
    for policy in (SchedulingPolicy.SYNC_DRAIN, SchedulingPolicy.ASYNC_OVERLAP,
                   SchedulingPolicy.WORKER_DRAIN):
        engine = ServingEngine(model, max_batch=MAIN["max_batch"],
                               max_len=MAIN["max_len"], policy=policy,
                               cc_on=True, seed=0, device=DEVICE)
        finite = torch.ones((), dtype=torch.bool, device=DEVICE)
        prefill_s = [0.0]
        inner_prefill, inner_decode = model.prefill, model.decode_step

        def prefill(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner_prefill(*a, **k)
            finite.logical_and_(torch.isfinite(out[0]).all())
            torch.cuda.synchronize()
            prefill_s[0] += time.perf_counter() - t0
            return out

        def decode_step(*a, **k):
            out = inner_decode(*a, **k)
            finite.logical_and_(torch.isfinite(out[0]).all())
            return out

        model.prefill, model.decode_step = prefill, decode_step
        recorder = TraceRecorder(engine.gateway, policy=policy.value,
                                 label=f"chip-smoke-{policy.value}")
        for i, p in enumerate(prompts):
            engine.submit(Request(f"r{i}", prompt=p, sampling=SamplingParams(
                max_new_tokens=MAIN["new_tokens"])))
        fa.flash_attention.launches = 0
        pa.paged_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with recorder:
                stats = engine.run()
            torch.cuda.synchronize()
        finally:
            engine.close()
            del model.prefill, model.decode_step
        wall = time.perf_counter() - t0
        n_flash, n_paged = fa.flash_attention.launches, pa.paged_attention.launches
        launches["flash_attention"] += n_flash
        launches["paged_attention"] += n_paged

        n_req = len(prompts)
        check(stats["finished"] == n_req, f"{policy.value}: "
              f"{stats['finished']} of {n_req} requests finished")
        for r in engine.finished:
            check(len(r.output_tokens) == MAIN["new_tokens"],
                  f"{policy.value}: {r.request_id} has "
                  f"{len(r.output_tokens)} tokens")
            check(all(0 <= t < vocab for t in r.output_tokens),
                  f"{policy.value}: token outside the vocab")
        check(bool(finite), f"{policy.value}: non-finite logits")
        check(n_flash == n_req * cfg.n_layers,
              f"{policy.value}: flash launches {n_flash} != prefills "
              f"{n_req} x {cfg.n_layers}")
        check(n_paged == stats["steps"] * cfg.n_layers,
              f"{policy.value}: paged launches {n_paged} != decode steps "
              f"{stats['steps']} x {cfg.n_layers}")
        report = check_tape(recorder.tape())
        check(report.ok, f"{policy.value}: tape violates the bridge law:\n"
                         f"{report.format()}")
        decode_tokens = stats["total_tokens"] - n_req
        decode_wall = wall - prefill_s[0]
        print(f"main path {policy.value}: {n_req} requests, "
              f"{stats['total_tokens']} tokens, {stats['steps']} decode steps; "
              f"launches flash {n_flash} paged {n_paged}; tape ok "
              f"({recorder.tape().n_crossings()} crossings)")
        print(f"  modelled (virtual clock, {engine.bridge.profile.name} bridge "
              f"profile, CC on): virtual_time_s {stats['virtual_time_s']!r} "
              f"bridge_time_s {stats['bridge_time_s']!r} compute_time_s "
              f"{stats['compute_time_s']!r} crossings {stats['crossings']} "
              f"mean_ttft_s {stats['mean_ttft_s']!r}")
        print(f"  measured on the card: run wall {wall:.4f} s, prefill wall "
              f"{prefill_s[0]:.4f} s, decode {decode_tokens} tokens in "
              f"{decode_wall:.4f} s = {decode_tokens / decode_wall:.1f} "
              f"decode tok/s")
    return launches


def phase_profile(model) -> None:
    """Where a full-width decode step's time goes: torch.profiler over four
    sync-policy decode steps of 8 resident requests, after four timed
    without it.  Device busy time is
    the sum of the device-side events (kernels and copies; one stream, so
    they do not overlap); host-side operator rows, which repeat their
    kernels' time, are left out.  The idle share is what the device leaves
    of the unprofiled step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
    steps = 4
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
        return
    busy = sum(dev_us(e) for e in events)
    print(f"profile: decode step ({len(MAIN['prompt_lens'])} rows) "
          f"{plain_us / steps:.1f} us on the host clock without the "
          f"profiler, {wall_us / steps:.1f} us with it; device busy "
          f"{busy / steps:.1f} us per step; idle share "
          f"{1 - busy / plain_us:.4f} (without the profiler)")
    for e in sorted(events, key=dev_us, reverse=True)[:8]:
        print(f"  {dev_us(e) / steps:9.1f} us/step  {e.count // steps:4d} "
              f"calls/step  {e.key[:90]}")


def phase_timings(gen, launches: dict, errs: dict) -> list:
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    rows = []

    # flash at the main path's largest prompt: olmo-1b, S = 512, causal
    b, s, h, d = 1, max(MAIN["prompt_lens"]), 16, 128
    q, k, v = (_randn(gen, b, s, h, d) for _ in range(3))
    ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    plain = time_ms(lambda: flash_attention_ref(q, k, v, causal=True))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    pairs = s * (s + 1) // 2                      # causal (q, k) pairs
    bms, by = bound(4.0 * b * h * d * pairs, 4 * b * s * h * d * 2)
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:90",
        launches=launches["flash_attention"],
        max_abs_err=errs["flash_attention"], ms=ms, plain_ms=plain,
        bound_ms=bms, bound_by=by, library_ms=lib))
    print(f"timing flash (B={b} S={s} H={h} D={d} causal): kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bms:.5f} ms ({by})")

    # paged at the main path's decode shape, mid-run: 8 slots of a
    # 1024-token cache, lengths = prompt + 16; 16 layers' caches cycled so
    # every launch reads its pages from device memory, as a decode step does
    b, kv, page, layers = len(MAIN["prompt_lens"]), 16, 16, 16
    pages_max = MAIN["max_len"] // page
    lengths = [n + 16 for n in MAIN["prompt_lens"]]
    qd = _randn(gen, b, h, d)
    shape = (layers, b * pages_max, page, kv, d)
    kc = torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)
    vc = torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)
    bt = (torch.arange(b, device=DEVICE)[:, None] * pages_max
          + torch.arange(pages_max, device=DEVICE)[None, :]).to(torch.int32)
    ln = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
    turn = [0]

    def cycled(fn):
        def call():
            i = turn[0] = (turn[0] + 1) % layers
            return fn(qd, kc[i], vc[i], bt, ln)
        return call

    ms = time_ms(cycled(pa.paged_attention), iters=64)
    plain = time_ms(cycled(paged_attention_ref), iters=16)
    tokens = sum(lengths)
    nbytes = (2 * b * h * d * 2 + tokens * kv * d * 2 * 2
              + bt.numel() * 4 + ln.numel() * 4)
    bms, by = bound(4.0 * h * d * tokens, nbytes)
    rows.append(dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/paged_attention.py:76",
        launches=launches["paged_attention"],
        max_abs_err=errs["paged_attention"], ms=ms, plain_ms=plain,
        bound_ms=bms, bound_by=by, library_ms=None))
    print(f"timing paged (B={b} H={h} KV={kv} D={d} page={page} "
          f"lengths={lengths}): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"bound {bms:.5f} ms ({by})")
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model

    t_start = time.perf_counter()
    card = phase_card()
    phase_build()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    errs = {"flash_attention": phase_flash(gen),
            "paged_attention": phase_paged(gen)}
    t0 = time.perf_counter()
    model = Model(get_config("olmo-1b"), seed=0, device=DEVICE)
    n_params = sum(t.numel() for t in model.buffers())
    print(f"olmo-1b at full width: {n_params} parameters, init "
          f"{time.perf_counter() - t0:.1f} s")
    phase_model_check(model)
    launches = phase_main(model)
    phase_profile(model)
    del model
    torch.cuda.empty_cache()
    rows = phase_timings(gen, launches, errs)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
