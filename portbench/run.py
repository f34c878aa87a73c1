"""The benchmark of ``repro_torch`` on one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout holding ``src/repro_torch``.  Prints, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``, each number the correctness check
compared beside its limit (also the last lines of standard error).
Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), or if ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``repro`` is loaded once the window has closed.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

#: top-level module names that may not be loaded in the run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return got.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def pin_cores(n) -> None:
    """Keep the process, and every thread it starts, on the last ``n`` of
    the cores it may use (a mix's ``host_cores``; None leaves it alone).
    Called before torch is imported, so its thread pools size to them."""
    if n:
        allowed = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, allowed[-n:])


def result_line(got: dict, metrics: dict, device: dict,
                trace: bool) -> dict:
    line = {"correct": got["correct"], "attempted": got["attempted"],
            "failed": got["failed"], "metrics": metrics, "device": device}
    if trace and "profile" in got["rec"]:
        from portbench.trace import breakdown
        line["breakdown"] = breakdown(got["rec"]["profile"])
    line["compared"] = got["compared"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    # torch's runtime-compiled kernels are cached inside the checkout
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(ROOT / "build" /
                                                  "torch_kernels")
    from portbench import spec
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    mix = spec.mix(cell["traffic"])
    pin_cores(mix.get("host_cores"))
    import torch
    from portbench import serve
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['name']} needs {cell['chips']} devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    cfg = spec.config(bench, cell["config"])
    limits = spec.limits(cell["name"])
    trace = bool(args.trace)
    got = serve.run_cell(cfg, mix, args.seed, args.seconds, trace=trace,
                         device="cuda", t0=T0, limits=limits)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    metrics = {}
    for m in spec.metrics(bench, cell["name"], trace):
        value = spec.reader(m["name"])(got["rec"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": got["memory_peak_bytes"]}
    prof = got["rec"].get("profile")
    if trace and prof is not None:
        device.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
    line = result_line(got, metrics, device, trace)
    rec = got["rec"]
    print(f"portbench: {cell['name']} seed {args.seed}: card {card()}; "
          f"setup {rec['setup_s']:.3f} s, window {rec['window_s']:.3f} s, "
          f"{len(rec['steps'])} steps, {rec['tokens']} tokens, "
          f"{got['attempted']} requests; check {got['check']}",
          file=sys.stderr)
    for name, c in got["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
