"""End-to-end serving driver: batched requests through the CC-aware engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke \\
        --requests 16 --policy sync --cc

runs full-width olmo-1b on the card (``--smoke``, the default, runs the
reduced config; ``--device cpu`` runs on the CPU).  The TransferGateway
charges bridge-law costs to the virtual clock while the model runs for
real, so one run reports real tokens, the wall-clock time they took, and
the modelled CC economics of the chosen scheduling policy.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import PORTED_ARCH_IDS, get_config, smoke_config
from repro_torch.core.policy import SchedulingPolicy
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.scheduler import Scheduler

POLICIES = {p.value: p for p in SchedulingPolicy}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(PORTED_ARCH_IDS), default="olmo-1b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True, help="reduced config (--no-smoke: full width)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--policy", choices=list(POLICIES), default=None,
                    help="default: CC-aware selection")
    ap.add_argument("--cc", action="store_true", help="confidential mode")
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    model = Model(cfg, seed=0, device=device)
    policy = POLICIES[args.policy] if args.policy else None

    engine = ServingEngine(model, max_batch=args.batch, max_len=256,
                           policy=policy, cc_on=args.cc, device=device)
    sched = Scheduler(engine)
    print(f"arch={cfg.name} device={device} cc={'on' if args.cc else 'off'} "
          f"policy={engine.policy.value} batch={args.batch}")

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        prompt = rng.integers(1, cfg.vocab_size, 8).tolist()
        sched.submit(Request(
            f"req-{i}", prompt=prompt,
            sampling=SamplingParams(temperature=args.temperature,
                                    max_new_tokens=args.max_new_tokens)))

    t0 = time.perf_counter()
    stats = sched.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    engine.close()
    print("--- serving stats ---")
    for k, v in stats.items():
        print(f"{k:18s} {v:.4f}" if isinstance(v, float) else f"{k:18s} {v}")
    tput = stats["total_tokens"] / max(stats["virtual_time_s"], 1e-9)
    print(f"{'virtual tok/s':18s} {tput:.0f}  (bridge-law model, "
          f"{engine.bridge.profile.name} profile)")
    print(f"{'wall tok/s':18s} {stats['total_tokens'] / wall:.1f}  "
          f"(measured on {device})")
    sample = engine.finished[0]
    print(f"sample request {sample.request_id}: prompt={sample.prompt[:4]}... "
          f"-> {sample.output_tokens[:8]}...")
    return stats


if __name__ == "__main__":
    main()
