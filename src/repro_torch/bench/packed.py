"""Packed ragged decode on the port: roofline table + packed-vs-dense sweep,
held against ``BENCH_packed.json``.

    PYTHONPATH=src python -m repro_torch.bench.packed --check [PATH] [--device cpu]

The port's counterpart of ``benchmarks/bench_packed.py``, on the same axes.
Two payloads:

1. **The peak-throughput roofline table**: the port's ``ComputeModel``
   (the pricing its engine charges per step) over configs x batch x
   (input, output) lengths, CC-on B300.  Pure arithmetic.
2. **Does packing ever lose?**  The port's ``ServingEngine`` serves a
   ragged workload (heterogeneous ``max_new_tokens``, 1.5x oversubscribed)
   on the smoke qwen1.5-4b twice per batch, ``packed_decode`` on and off:
   identical greedy token streams, and packed virtual tok/s at least the
   dense path's.  The model runs for real on ``--device``; the rows are
   virtual-clock quantities.  The port's packed step runs at exactly the
   packed width where the reference's pads it to a power of two; both
   price the real width, so the rows agree.
"""

from __future__ import annotations

import dataclasses

from repro_torch.bench import REL_TOL, diff_rows, drift_main, load
from repro_torch.configs.base import get_config, smoke_config
from repro_torch.core.bridge import B300, BridgeModel
from repro_torch.core.compute import ComputeModel
from repro_torch.core.policy import cc_aware_defaults

#: the roofline table axes: 3 configs x batch 8..512 x (input, output)
CONFIGS = ("qwen1p5-4b", "deepseek-moe-16b", "qwen3p6-27b")
BATCHES = (8, 32, 128, 512)
#: (input_len, output_len) pairs; the priced KV depth is the mean decode
#: context, input + output/2
LENGTH_PAIRS = ((128, 128), (1024, 512), (4096, 1024))

#: engine sweep: max_batch values for the packed-vs-dense runs
ENGINE_BATCHES = (4, 8, 16)


def _config(name: str):
    # ARCH_IDS spells qwen1.5-4b with a dot; the drift file's axis does not
    return get_config({"qwen1p5-4b": "qwen1.5-4b"}.get(name, name))


def roofline_table() -> list[dict]:
    """Peak decode throughput per (config, batch, lengths) off the roofline
    the engine charges per step."""
    bridge = BridgeModel(B300, cc_on=True)
    rows = []
    for name in CONFIGS:
        cm = ComputeModel(_config(name), bridge)
        for batch in BATCHES:
            for in_len, out_len in LENGTH_PAIRS:
                kv = float(in_len + out_len / 2)
                charge = cm.decode_charge(batch, kv_len=kv)
                step_s = charge.seconds
                rows.append({
                    "config": name,
                    "batch": batch,
                    "input_len": in_len,
                    "output_len": out_len,
                    "kv_len": kv,
                    "step_ms": step_s * 1e3,
                    "tok_s": batch / step_s,
                    "bound": charge.bound,
                })
    return rows


def _ragged_run(model, max_batch: int, *, packed: bool) -> dict:
    """One engine run on the ragged workload with packed decode on or
    off."""
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import SamplingParams
    defaults = dataclasses.replace(
        cc_aware_defaults(True, concurrency=max_batch), packed_decode=packed)
    engine = ServingEngine(
        model, max_batch=max_batch, max_len=64,
        bridge=BridgeModel(B300, cc_on=True), defaults=defaults, seed=0,
        device=model.device)
    try:
        for i in range(max_batch + max_batch // 2):
            # output lengths cycle 3..12, so the ready set shrinks slot by
            # slot and packed widths sweep
            engine.submit(Request(
                f"r{i}", prompt=[1, 2, 3 + (i % 5)],
                sampling=SamplingParams(max_new_tokens=3 + (i * 3) % 10)))
        stats = engine.run()
        return {
            "tokens": tuple(sorted((r.request_id, tuple(r.output_tokens))
                                   for r in engine.finished)),
            "tok_s": stats["total_tokens"] / stats["virtual_time_s"],
            "steps": stats["steps"],
            "finished": stats["finished"],
        }
    finally:
        engine.close()


def engine_sweep(device) -> list[dict]:
    """Packed against dense at every ``ENGINE_BATCHES`` batch, on the smoke
    qwen1.5-4b (weights from seed 0) on ``device``."""
    from repro_torch.models.model import Model
    model = Model(smoke_config(_config("qwen1p5-4b")), seed=0, device=device)
    rows = []
    for max_batch in ENGINE_BATCHES:
        p = _ragged_run(model, max_batch, packed=True)
        d = _ragged_run(model, max_batch, packed=False)
        rows.append({
            "max_batch": max_batch,
            "finished": p["finished"],
            "packed_tok_s": p["tok_s"],
            "dense_tok_s": d["tok_s"],
            "ratio": p["tok_s"] / d["tok_s"],
            "packed_steps": p["steps"],
            "dense_steps": d["steps"],
            "tokens_identical": p["tokens"] == d["tokens"],
        })
    return rows


def payload(device) -> dict:
    return {"roofline": roofline_table(), "engine": engine_sweep(device)}


def check_drift(path: str, device) -> list[str]:
    """Recompute the payload on ``device`` and list what differs from
    ``path``."""
    golden, fresh = load(path), payload(device)
    problems: list[str] = []
    diff_rows("roofline", golden.get("roofline", []), fresh["roofline"],
              ("config", "batch", "input_len", "output_len"), problems)
    diff_rows("engine", golden.get("engine", []), fresh["engine"],
              ("max_batch",), problems)
    return problems


def rows(device) -> list[str]:
    """The payload as CSV rows; raises where packing lost or its tokens
    differ from the dense path's."""
    data = payload(device)
    lines = [
        f"packed/roofline_{r['config']}_b{r['batch']}_i{r['input_len']}"
        f"_o{r['output_len']},{r['tok_s']:.1f},tok/s at kv={r['kv_len']:g} "
        f"({r['bound']}-bound, step {r['step_ms']:.3f} ms)"
        for r in data["roofline"]]
    for e in data["engine"]:
        lines.append(
            f"packed/engine_b{e['max_batch']}_ratio,{e['ratio']:.6f},packed "
            f"{e['packed_tok_s']:.1f} vs dense {e['dense_tok_s']:.1f} tok/s "
            f"on a ragged workload ({e['finished']} reqs, on {device})")
        if not e["tokens_identical"]:
            raise AssertionError(f"packed token stream diverged from dense "
                                 f"at max_batch={e['max_batch']}")
        if e["ratio"] < 1.0 - REL_TOL:
            raise AssertionError(f"packed decode lost to dense at max_batch="
                                 f"{e['max_batch']}: ratio {e['ratio']:.6f}")
    return lines


def main(argv=None) -> None:
    drift_main(argv, filename="BENCH_packed.json", doc=__doc__,
               check_drift=check_drift, rows=rows)


if __name__ == "__main__":
    main()
