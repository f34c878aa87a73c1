"""Drift checks: the port recomputes the virtual-clock payload of one of the
repository's ``BENCH_*.json`` files and compares it with the file.

    PYTHONPATH=src python -m repro_torch.bench.packed --check [PATH] [--device cpu]
    PYTHONPATH=src python -m repro_torch.bench.obs --check [PATH] [--device cpu]
    PYTHONPATH=src python -m repro_torch.bench.chaos --check [PATH] [--device cpu]
    PYTHONPATH=src python -m repro_torch.bench.tp --check [PATH] [--device cpu]
    PYTHONPATH=src python -m repro_torch.bench.quant --check [PATH] [--device cpu]

``--check`` reads the file at the repository's root unless given a path,
prints ``<file>: OK`` or every value that differs, and exits 1 on a
difference.  Without ``--check`` each module prints its rows.  ``--device``
is the card (``cuda``) unless the caller asks for the CPU.  The modules
never write a drift file: the JAX package's benchmarks own them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

#: relative tolerance of a drift check (virtual-clock quantities are
#: deterministic; this absorbs only float round-tripping)
REL_TOL = 1e-9

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def close(a: float, b: float) -> bool:
    return abs(a - b) <= REL_TOL * max(abs(a), abs(b), 1e-30)


def diff_rows(kind: str, gold: list, fresh: list, keyfields: tuple,
              problems: list) -> None:
    """Append to ``problems`` every value of ``fresh``'s rows that differs
    from ``gold``'s (floats within ``REL_TOL``, the rest exactly)."""
    if len(gold) != len(fresh):
        problems.append(f"{kind} row count {len(gold)} -> {len(fresh)}")
        return
    for g, f_ in zip(gold, fresh):
        label = "/".join(str(f_[k]) for k in keyfields)
        for key, val in f_.items():
            gv = g.get(key)
            ok = close(val, gv) if isinstance(val, float) else val == gv
            if not ok:
                problems.append(f"{kind} {label} {key}: {gv!r} -> {val!r}")


def diff_tree(kind: str, gold, fresh, problems: list) -> None:
    """Append to ``problems`` every leaf of the nested dicts and lists
    ``fresh`` that differs from ``gold``'s (floats within ``REL_TOL``, the
    rest exactly)."""
    if isinstance(fresh, dict):
        for key, val in fresh.items():
            diff_tree(f"{kind}.{key}", (gold or {}).get(key), val, problems)
        return
    if isinstance(fresh, list):
        if not isinstance(gold, list) or len(gold) != len(fresh):
            problems.append(f"{kind} shape changed")
            return
        for i, (g, f_) in enumerate(zip(gold, fresh)):
            diff_tree(f"{kind}[{i}]", g, f_, problems)
        return
    ok = (close(fresh, gold) if isinstance(fresh, float)
          and isinstance(gold, float) else fresh == gold)
    if not ok:
        problems.append(f"{kind}: {gold!r} -> {fresh!r}")


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def drift_main(argv, *, filename: str, doc: str, check_drift, rows) -> None:
    """The command line of every module: ``--check [PATH]`` runs
    ``check_drift(path, device)`` and exits 1 on a difference; without it
    ``rows(device)`` is printed line by line."""
    from repro_torch.device import resolve_device
    ap = argparse.ArgumentParser(description=doc.split("\n", 1)[0])
    ap.add_argument("--check", metavar="PATH", nargs="?",
                    const=os.path.join(ROOT, filename), default=None,
                    help=f"compare PATH (default: the repository's "
                         f"{filename}) with a fresh recomputation")
    ap.add_argument("--device", default="cuda",
                    help="default: the CUDA card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.check:
        problems = check_drift(args.check, device)
        if problems:
            print(f"{os.path.basename(args.check)} differs from the port's "
                  f"recomputation on {device}:")
            for p in problems:
                print(f"  {p}")
            sys.exit(1)
        print(f"{os.path.basename(args.check)}: OK (recomputed on {device})")
        return
    print("\n".join(rows(device)))
