"""§Roofline: the 40-cell (arch x shape) table from the port's dry-run
records.

PyTorch counterpart of ``benchmarks/bench_roofline.py``: reads
``build/dryrun/*.json`` (written by ``repro_torch.launch.dryrun``; the
reference's records under ``artifacts/dryrun/`` are not read) and emits,
per cell, the three roofline terms on the H100's constants, the dominant
bottleneck, MODEL_FLOPS / counted flops usefulness, and the
kernel-substituted memory term.

    PYTHONPATH=src python -m repro_torch.bench.roofline
"""

from __future__ import annotations

import json
import os

from repro_torch.bench import ROOT

RECORDS = os.path.join(ROOT, "build", "dryrun")


def load_cells(mesh: str = "pod16x16", records: str = RECORDS) -> list[dict]:
    cells = []
    if not os.path.isdir(records):
        return cells
    for name in sorted(os.listdir(records)):
        if name.endswith(f"__{mesh}.json"):
            with open(os.path.join(records, name)) as f:
                cells.append(json.load(f))
    return cells


def rows(mesh: str = "pod16x16",
         records: str = RECORDS) -> list[tuple[str, float, str]]:
    out = []
    for c in load_cells(mesh, records):
        cell = f"{c['arch']}/{c['shape']}"
        if c.get("status") == "skip":
            out.append((f"roofline/{cell}/skipped", 1.0,
                        c["skip_reason"][:80]))
            continue
        if c.get("status") != "ok":
            out.append((f"roofline/{cell}/ERROR", 0.0,
                        c.get("error", "?")[:80]))
            continue
        dom = c["dominant"]
        ks = c.get("kernel_substitution", {})
        out.append((
            f"roofline/{cell}/{dom}", c[dom],
            f"compute={c['compute_s']:.3f}s mem={c['memory_s']:.3f}s "
            f"coll={c['collective_s']:.3f}s "
            f"useful={c['useful_flops_ratio']:.2f} "
            f"mem_kernelsub={ks.get('memory_s', float('nan')):.3f}s"))
    return out


def summary(mesh: str = "pod16x16", records: str = RECORDS) -> dict:
    cells = [c for c in load_cells(mesh, records) if c.get("status") == "ok"]
    if not cells:
        return {}
    worst = min(cells, key=lambda c: c["useful_flops_ratio"])
    most_coll = max(cells, key=lambda c: c["collective_s"] / max(
        1e-12, c["compute_s"] + c["memory_s"] + c["collective_s"]))
    return {"n_ok": len(cells),
            "worst_useful": f"{worst['arch']}/{worst['shape']}",
            "most_collective_bound":
                f"{most_coll['arch']}/{most_coll['shape']}"}


def sweep_checks(records: str = RECORDS) -> dict:
    """The sweep's acceptance, as the reference's ``test_system`` asks of
    its own: per mesh the cells, ok / skip / error counts, skips that are
    not the sub-quadratic one, dominant terms outside the three, useful
    ratios outside [0, 1.5]; and the cells whose multi-pod flops per
    device pass their single-pod flops."""
    out = {}
    by_mesh = {m: {(c["arch"], c["shape"]): c
                   for c in load_cells(m, records)}
               for m in ("pod16x16", "pod2x16x16")}
    for mesh, cells in by_mesh.items():
        ok = [c for c in cells.values() if c.get("status") == "ok"]
        out[mesh] = {
            "cells": len(cells), "ok": len(ok),
            "skip": sum(c.get("status") == "skip" for c in cells.values()),
            "error": sum(c.get("status") == "error"
                         for c in cells.values()),
            "other_skips": sorted(
                f"{a}/{s}" for (a, s), c in cells.items()
                if c.get("status") == "skip"
                and "sub-quadratic" not in c.get("skip_reason", "")),
            "bad_dominant": sorted(
                f"{c['arch']}/{c['shape']}" for c in ok if c["dominant"]
                not in ("compute_s", "memory_s", "collective_s")),
            "bad_useful": sorted(
                f"{c['arch']}/{c['shape']}" for c in ok
                if not 0 <= c["useful_flops_ratio"] <= 1.5),
            "useful_range": [min((c["useful_flops_ratio"] for c in ok),
                                 default=None),
                             max((c["useful_flops_ratio"] for c in ok),
                                 default=None)]}
    single, multi = by_mesh["pod16x16"], by_mesh["pod2x16x16"]
    out["multi_pod_above_single"] = sorted(
        f"{a}/{s}" for (a, s), c in multi.items()
        if c.get("status") == "ok" and single.get((a, s), {}).get(
            "status") == "ok"
        and c["flops_per_device"] > single[(a, s)]["flops_per_device"])
    return out


def run(records: str = RECORDS) -> list[str]:
    lines = [f"roofline/{n.split('/', 1)[1]},{v:.4f},{d}"
             for n, v, d in rows(records=records)]
    s = summary(records=records)
    if s:
        lines.append(f"roofline/summary,{s['n_ok']},"
                     f"worst={s['worst_useful']} "
                     f"most_collective={s['most_collective_bound']}")
    # multi-pod pass/fail count
    mp = load_cells("pod2x16x16", records)
    ok = sum(1 for c in mp if c.get("status") == "ok")
    skip = sum(1 for c in mp if c.get("status") == "skip")
    err = sum(1 for c in mp if c.get("status") == "error")
    if mp:
        lines.append(f"roofline/multipod_cells,{ok},ok={ok} skip={skip} "
                     f"err={err}")
    checks = sweep_checks(records)
    for mesh in ("pod16x16", "pod2x16x16"):
        c = checks[mesh]
        lines.append(
            f"roofline/sweep/{mesh},{c['cells']},ok={c['ok']} "
            f"skip={c['skip']} err={c['error']} "
            f"other_skips={c['other_skips']} "
            f"bad_dominant={c['bad_dominant']} bad_useful={c['bad_useful']}"
            f" useful={c['useful_range']}")
    lines.append(f"roofline/sweep/multi_pod_above_single,"
                 f"{len(checks['multi_pod_above_single'])},"
                 f"{checks['multi_pod_above_single']}")
    return lines


if __name__ == "__main__":
    print("\n".join(run()))
