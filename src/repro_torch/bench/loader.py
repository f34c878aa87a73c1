"""§6.1: the context-pooled loader ladder, both Blackwell platforms.

Cross-platform transfer within 5% is the paper's headline here: the
bottleneck (and the fix) is the confidential data path, not the GPU.

The port's counterpart of ``benchmarks/bench_loader.py``: the same rows, on the
virtual clock only (no model, no device).

    PYTHONPATH=src python -m repro_torch.bench.loader
"""

from __future__ import annotations

from repro_torch.core.bridge import B300, RTX_PRO_6000, BridgeModel
from repro_torch.loader.pooled_loader import LoaderVariant, PooledLoader

GIB = 1 << 30
MODEL_BYTES = int(59 * GIB)   # GPT-OSS-120B, 15 shards
N_SHARDS = 15

PAPER = {
    "b300-hgx": {"baseline": 287.09, "threads8": 56.82, "fastsafetensors": 36.34,
                 "naive_pool": 253.66, "pooled": 19.99, "prewarmed": 8.36},
    "rtx-pro-6000": {"baseline": 287.41, "threads8": 66.79,
                     "fastsafetensors": 36.83, "naive_pool": 253.66,
                     "pooled": 20.46, "prewarmed": 8.80},
}


def rows() -> list[tuple[str, float, str]]:
    out = []
    for profile in (B300, RTX_PRO_6000):
        loader = PooledLoader(BridgeModel(profile, cc_on=True), n_workers=8)
        for v in LoaderVariant:
            t = loader.modeled_load_time(MODEL_BYTES, N_SHARDS, v)
            tgt = PAPER[profile.name].get(v.value)
            err = f" err={100*(t['total']-tgt)/tgt:+.1f}%" if tgt else ""
            out.append((f"6.1/{profile.name}/{v.value}_s", t["total"],
                        f"paper={tgt}{err}"))
        lc = loader.bridge.pool_lifecycle_cost(8)
        out.append((f"6.1/{profile.name}/lifecycle_create_s", lc["create"],
                    "paper=5.20 (8 workers)"))
        out.append((f"6.1/{profile.name}/lifecycle_destroy_s", lc["destroy"],
                    "paper=3.90"))
    # headline speedup
    b = PooledLoader(BridgeModel(B300, cc_on=True), n_workers=8)
    base = b.modeled_load_time(MODEL_BYTES, N_SHARDS, LoaderVariant.BASELINE)["total"]
    best = b.modeled_load_time(MODEL_BYTES, N_SHARDS, LoaderVariant.PREWARMED)["total"]
    out.append(("6.1/speedup_x", base / best, "paper=34x (287 -> 8.4 s)"))
    return out


def run() -> list[str]:
    return [f"loader/{n},{v:.3f},{d}" for n, v, d in rows()]


if __name__ == "__main__":
    print("\n".join(run()))
