"""Quickstart: the serialized-bridge law in five minutes.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Walks the paper's argument end to end:
  1. the bridge law and what CC does to one crossing,
  2. policy inversion on a calibrated serving workload,
  3. the recovery hierarchy (flag -> worker thread),
  4. a real CC-aware engine serving requests on a tiny model, on the card
     unless ``--device cpu``.

The port's counterpart of ``examples/quickstart.py``; the same lines.
"""

from __future__ import annotations

import argparse

from repro_torch.configs.base import get_config, smoke_config
from repro_torch.core.bridge import (B300, BridgeModel, Crossing, Direction,
                                     StagingKind)
from repro_torch.core.policy import SchedulingPolicy as SP, cc_aware_defaults
from repro_torch.core.simulator import Observation, fit_workload, tpot_ms
from repro_torch.models.model import Model
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.sampler import SamplingParams

US = 1e-6


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)

    print("=" * 72)
    print("1. The bridge law: compute at parity, crossings taxed")
    print("=" * 72)
    on, off = BridgeModel(B300, cc_on=True), BridgeModel(B300, cc_on=False)
    print(f"  BF16 matmul ratio CC-on/off      : {B300.compute_parity:.3f}  "
          f"(paper: 0.998)")
    print(f"  single-context H2D bandwidth     : "
          f"{on.sustained_ratio(Direction.H2D):.3f}x native  (paper: 0.203x)")
    small = Crossing(64, Direction.H2D, StagingKind.FRESH)
    print(f"  one small fresh-staged crossing  : "
          f"{off.crossing_time(small)/US:5.1f}us CC-off "
          f"-> {on.crossing_time(small)/US:6.1f}us CC-on "
          f"({on.crossing_time(small)/off.crossing_time(small):.0f}x — the "
          f"§5.2 class)")

    print()
    print("=" * 72)
    print("2. Policy inversion (Qwen3.6-27B-FP8 @ c=128, calibrated to §5.4)")
    print("=" * 72)
    w = fit_workload("qwen", 128, B300, [
        Observation(SP.ASYNC_OVERLAP, False, tpot_ms=23.64),
        Observation(SP.ASYNC_OVERLAP, True, tpot_ms=31.10),
        Observation(SP.SYNC_DRAIN, False, tpot_ms=26.56),
        Observation(SP.SYNC_DRAIN, True, tpot_ms=26.92)])
    for cc in (False, True):
        b = BridgeModel(B300, cc_on=cc)
        a, s = tpot_ms(SP.ASYNC_OVERLAP, b, w), tpot_ms(SP.SYNC_DRAIN, b, w)
        best = "async" if a < s else "SYNC"
        print(f"  CC-{'on ' if cc else 'off'}: async={a:5.2f}ms  "
              f"sync={s:5.2f}ms   best: {best}")
    print("  -> the best default without CC is the worst with it.")

    print()
    print("=" * 72)
    print("3. Recovery hierarchy under CC")
    print("=" * 72)
    rows = [("vanilla async (default)", tpot_ms(SP.ASYNC_OVERLAP, on, w)),
            ("--no-async-scheduling", tpot_ms(SP.SYNC_DRAIN, on, w)),
            ("worker-thread drain (v10c)", tpot_ms(SP.WORKER_DRAIN, on, w)),
            ("CC-off gold", tpot_ms(SP.ASYNC_OVERLAP, off, w))]
    for name, t in rows:
        print(f"  {name:28s} TPOT = {t:5.2f} ms")

    print()
    print("=" * 72)
    print("4. A real CC-aware engine on a tiny model (real tokens, costed "
          "bridge)")
    print("=" * 72)
    model = Model(smoke_config(get_config("olmo-1b")), seed=0,
                  device=args.device)
    for policy in (SP.ASYNC_OVERLAP,
                   cc_aware_defaults(True, concurrency=8).scheduling):
        eng = ServingEngine(model, max_batch=4, max_len=64, policy=policy,
                            cc_on=True, device=model.device)
        for i in range(6):
            eng.submit(Request(f"r{i}", prompt=[1, 2, 3],
                               sampling=SamplingParams(max_new_tokens=8)))
        st = eng.run()
        eng.close()
        print(f"  policy={policy.value:7s} "
              f"bridge_time={st['bridge_time_s']*1e3:7.2f}ms "
              f"crossings={st['crossings']:3d} tokens={st['total_tokens']}")
    print("  -> same tokens, ~40x less bridge time under the CC-aware "
          "default.")


if __name__ == "__main__":
    main()
