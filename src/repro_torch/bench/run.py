"""Every benchmark of the port, one row per paper table: the port's
``python -m benchmarks.run``.

    PYTHONPATH=src python -m repro_torch.bench.run [--only NAME] \\
        [--json PATH] [--device cpu]

Runs the fourteen modules in the reference's order under its titles and
prints the same ``name,us_per_call,derived`` CSV; ``--json`` writes the
same ``{rows, modules, module_wall_s, failures}`` document (one
``meta/<module>_wall_s`` row of host wall time per module).  The exit
code is 1 if a module raised.  ``--device`` is the card (``cuda``) unless
the caller asks for the CPU.  The five drift modules print their
``rows(device)``, whose rows name the device; ``roofline`` reads the dry
run's records under ``build/dryrun/`` where they exist.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
import traceback

#: (title, module of ``repro_torch.bench``), in the reference's order
MODULES = [
    ("bridge (SS4.1-4.3)", "bridge"),
    ("serving (SS5.1-5.5)", "serving"),
    ("loader (SS6.1)", "loader"),
    ("offload (SS6.2)", "offload"),
    ("fabric (SS7)", "fabric"),
    ("roofline (SSRoofline)", "roofline"),
    ("cluster (SS7 x SS4 L4)", "cluster"),
    ("replay (SS5.2 bridge-tape counterfactuals)", "replay"),
    ("bridge_opt (SS5.2 x SS8 arena+coalescer+pipelined-restore)",
     "bridge_opt"),
    ("obs (SS9 spans+stall-attribution+overhead)", "obs"),
    ("packed (SS10 ragged decode roofline + packed-vs-dense gate)", "packed"),
    ("chaos (SS11 fault injection + recovery ladder)", "chaos"),
    ("tp (SS12 fabric-P2P tensor parallelism + fallback repricing)", "tp"),
    ("quant (SS13 quantized bridge crossings + un-quantize replay)", "quant"),
]

#: modules on the virtual clock alone: ``run()`` takes no device
NO_DEVICE = {"bridge", "serving", "loader", "fabric", "roofline"}
#: the drift checks: ``rows(device)`` is their printed table
DRIFT = {"obs", "packed", "chaos", "tp", "quant"}


def module_lines(name: str, device) -> list[str]:
    """The CSV lines of one module of ``MODULES`` on ``device``."""
    mod = importlib.import_module(f"repro_torch.bench.{name}")
    if name in DRIFT:
        return mod.rows(device)
    return mod.run() if name in NO_DEVICE else mod.run(device)


def main(argv=None) -> None:
    from repro_torch.device import resolve_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write a machine-readable JSON summary")
    ap.add_argument("--only", metavar="NAME", default=None,
                    help="run only modules whose title contains NAME")
    ap.add_argument("--device", default="cuda",
                    help="default: the CUDA card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    modules = [(t, n) for t, n in MODULES if not args.only or args.only in t]
    print("name,us_per_call,derived")
    failures = 0
    rows = []
    module_status = {}
    module_wall_s = {}
    for title, name in modules:
        print(f"# --- {title} ---")
        t0 = time.perf_counter()
        try:
            for line in module_lines(name, device):
                print(line)
                row, _, rest = line.partition(",")
                value, _, derived = rest.partition(",")
                try:
                    rows.append({"name": row, "value": float(value),
                                 "derived": derived})
                except ValueError:
                    rows.append({"name": row, "value": None, "derived": rest})
            module_status[title] = "ok"
        except Exception:
            failures += 1
            module_status[title] = "error"
            traceback.print_exc()
        wall = time.perf_counter() - t0
        module_wall_s[title] = wall
        slug = title.split(" ", 1)[0]
        rows.append({"name": f"meta/{slug}_wall_s", "value": wall,
                     "derived": f"module wall time ({module_status[title]})"})
        print(f"# {title}: {wall:.2f}s")

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"rows": rows, "modules": module_status,
                       "module_wall_s": module_wall_s,
                       "failures": failures}, f, indent=1)
        print(f"# wrote {len(rows)} rows to {args.json}")

    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
