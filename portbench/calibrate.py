"""The readings a cell's correctness limits are set from: runs of the
cell on several seeds in one process, each printing the program's gaps
(``logit_gap``, ``mean_gap``) and the float8 control's (``control_*``).
Not part of the benchmark's own runs.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...] [--published] [--out <file>]
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _with_perturbed(gaps):
    """``check.gaps`` that also reads ``perturbed_gap`` and
    ``perturbed_mean_gap``: the gaps, under the float32 reference, of the
    first choices of the same reference with each MoE layer's input
    rounded to bf16, as the program's is.  How far top-k routing alone
    moves the reference under a bf16-sized change of its input."""
    import torch
    from portbench.reference import moe

    def wrapped(weights, spec, seqs, *, control=False):
        out = gaps(weights, spec, seqs, control=control)
        real = moe.moe_sublayer

        def rounded(p, h, *args):
            return real(p, h.to(torch.bfloat16).to(torch.float32), *args)
        with torch.no_grad():
            ref = moe.logits(weights, spec,
                             moe.hidden(weights, spec, seqs, False), False)
            moe.moe_sublayer = rounded
            try:
                pert = moe.logits(weights, spec,
                                  moe.hidden(weights, spec, seqs, False),
                                  False)
            finally:
                moe.moe_sublayer = real
            g = ref.max(-1).values - ref.gather(
                1, pert.argmax(-1)[:, None])[:, 0]
        out.update(perturbed_gap=float(g.max()),
                   perturbed_mean_gap=float(g.mean()))
        return out
    return wrapped


def _with_published(gaps):
    """``check.gaps`` that also reads ``published_*``: the gaps of the
    served tokens under the reference run as the published model is
    (``runs_as`` updated by the file's ``as_published``), how far the
    port's departures move what it serves."""
    def wrapped(weights, spec, seqs, *, control=False):
        out = gaps(weights, spec, seqs, control=control)
        pub = dict(spec, runs_as=dict(spec["runs_as"],
                                      **spec["as_published"]))
        got = gaps(weights, pub, seqs)
        out.update({"published_" + k: got[k]
                    for k in ("logit_gap", "mean_gap", "first_choice")})
        return out
    return wrapped


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default="")
    ap.add_argument("--perturb", action="store_true",
                    help="also read the gaps of the float32 reference with "
                         "each MoE layer's input rounded to bf16")
    ap.add_argument("--published", action="store_true",
                    help="also read the gaps under the reference run as "
                         "the published model is (the file's as_published)")
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from portbench import check, serve, spec
    if args.perturb:
        check.gaps = _with_perturbed(check.gaps)
    if args.published:
        check.gaps = _with_published(check.gaps)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    mix = spec.mix(cell["traffic"])
    for seed in args.seeds:
        t0 = time.time()
        got = serve.run_cell(cfg, mix, seed, args.seconds, trace=False,
                             device="cuda", t0=t0, control=True)
        row = dict(workload=cell["name"], seed=seed, **got["check"],
                   tokens=got["rec"]["tokens"],
                   window_s=got["rec"]["window_s"],
                   setup_s=got["rec"]["setup_s"],
                   memory_peak_bytes=got["memory_peak_bytes"],
                   wall_s=time.time() - t0)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        del got
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
