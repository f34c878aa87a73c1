"""The port's benchmarks: the paper's tables, the drift checks and the
runner that prints them all (the port's ``benchmarks/``).

The eight paper benches print the reference's rows, one
``name,value,derived`` line each (``run()``; those that serve a model take
``device``):

    PYTHONPATH=src python -m repro_torch.bench.bridge     (§4.1-4.3)
    PYTHONPATH=src python -m repro_torch.bench.serving    (§5.1-5.5)
    PYTHONPATH=src python -m repro_torch.bench.loader     (§6.1)
    PYTHONPATH=src python -m repro_torch.bench.offload    (§6.2) [--device cpu]
    PYTHONPATH=src python -m repro_torch.bench.fabric     (§7)
    PYTHONPATH=src python -m repro_torch.bench.replay     [--device cpu]
    PYTHONPATH=src python -m repro_torch.bench.cluster    [--device cpu]
    PYTHONPATH=src python -m repro_torch.bench.bridge_opt [--device cpu]

``reference_rows.json`` holds the rows the reference's benches print on the
CPU; ``reference_diff`` holds a fresh run to them (``chip_smoke.py`` does so
on the card).  The five drift checks recompute the virtual-clock payload of
one of the repository's ``BENCH_*.json`` files and compare it with the
file:

    PYTHONPATH=src python -m repro_torch.bench.packed --check [PATH] [--device cpu]
    PYTHONPATH=src python -m repro_torch.bench.obs --check [PATH] [--device cpu]
    PYTHONPATH=src python -m repro_torch.bench.chaos --check [PATH] [--device cpu]
    PYTHONPATH=src python -m repro_torch.bench.tp --check [PATH] [--device cpu]
    PYTHONPATH=src python -m repro_torch.bench.quant --check [PATH] [--device cpu]

``--check`` reads the file at the repository's root unless given a path,
prints ``<file>: OK`` or every value that differs, and exits 1 on a
difference.  Without ``--check`` each module prints its rows.  ``roofline``
prints the dry run's table.  ``python -m repro_torch.bench.run`` runs all
fourteen modules as ``python -m benchmarks.run`` does.  ``--device`` is the
card (``cuda``) unless the caller asks for the CPU.  No module writes a
``BENCH_*.json`` file: the JAX package's benchmarks own them.
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import os
import sys

#: relative tolerance of a drift check (virtual-clock quantities are
#: deterministic; this absorbs only float round-tripping)
REL_TOL = 1e-9

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


#: the reference's rows of the eight paper benches, as its ``run()`` prints
#: them on the CPU (``tests/test_torch_bench_run.py`` regenerates them)
REFERENCE_ROWS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "reference_rows.json")

#: the benches held to ``REFERENCE_ROWS``, in ``bench.run``'s order
PAPER_BENCHES = ("bridge", "serving", "loader", "offload", "fabric",
                 "cluster", "replay", "bridge_opt")

#: host wall time, never held to the reference: row name (a pattern) ->
#: the fields that are exempt
EXEMPT = {
    "replay/counterfactuals_per_engine_run": ("value", "derived"),
    "meta/*_wall_s": ("value",),
}


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


def bench_main(argv, *, doc: str, run) -> None:
    """The command line of a paper bench that serves a model:
    ``[--device D]`` (the card unless 'cpu'), then ``run(device)``'s lines
    printed."""
    ap = argparse.ArgumentParser(description=doc.split("\n", 1)[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the CPU")
    print("\n".join(run(ap.parse_args(argv).device)))


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


def parse_row(line: str) -> dict:
    """One printed ``name,value,derived`` line as a row, its exempt fields
    None."""
    name, _, rest = line.partition(",")
    value, _, derived = rest.partition(",")
    row = {"name": name, "value": float(value), "derived": derived}
    for pattern, fields in EXEMPT.items():
        if fnmatch.fnmatchcase(name, pattern):
            row.update(dict.fromkeys(fields))
    return row


def reference_diff(module: str, lines: list) -> list[str]:
    """Every way ``lines`` (a paper bench's ``run()``) differs from the
    reference's rows of ``module``: names exactly and in order, values
    within ``REL_TOL``, derived strings equal; exempt fields are skipped."""
    want = load(REFERENCE_ROWS)["rows"][module]
    got = [parse_row(line) for line in lines]
    if [r["name"] for r in got] != [r["name"] for r in want]:
        return [f"{module}: row names {[r['name'] for r in want]} -> "
                f"{[r['name'] for r in got]}"]
    problems = []
    for g, w in zip(got, want):
        if g["value"] is not None and not close(g["value"], w["value"]):
            problems.append(f"{g['name']} value: {w['value']!r} -> "
                            f"{g['value']!r}")
        if g["derived"] is not None and g["derived"] != w["derived"]:
            problems.append(f"{g['name']} derived: {w['derived']!r} -> "
                            f"{g['derived']!r}")
    return problems
