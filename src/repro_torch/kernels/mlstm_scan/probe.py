"""How far the mLSTM kernel and its plain version each sit from an f64
evaluation of the same chunked algorithm, over several input draws.

    PYTHONPATH=src python -m repro_torch.kernels.mlstm_scan.probe --seeds 0 8

Each seed draws xlstm-1.3b's prefill shape (B1 S512 H4 dk512 dv1024,
chunk 256, f32, from the empty state) as ``chip_smoke.py``'s mLSTM phase
draws it (q pre-scaled, k and v normal, log_i normal x 2, log_f
log_sigmoid(normal + 1)) from a generator seeded with it, and prints one
JSON line per seed: for y and the final (C, n, m), max |kernel - f64|,
max |plain - f64|, and the elements (and rows of y) outside the
per-element criterion ``chip_smoke.py`` holds the kernel to (atol 5e-4 +
1e-5 |plain| + 2 |plain - f64|).  Nothing is gated: it measures whether
the kernel is as accurate as its plain version on draws other than the
smoke's.  Runs on the card unless ``--device cpu`` (where the wrapper runs
the plain version, so kernel and plain agree by construction).
"""

from __future__ import annotations

import argparse
import json
import math

import torch
import torch.nn.functional as F

from ...device import resolve_device
from . import ops
from .ref import mlstm_chunked_ref

#: xlstm-1.3b's mLSTM prefill at the main path's longest prompt
FULL = dict(b=1, s=512, h=4, dk=512, dv=1024, chunk=256)


def draw(seed: int, device, b, s, h, dk, dv):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    q, k, v = rn(b, s, h, dk) / math.sqrt(dk), rn(b, s, h, dk), rn(b, s, h, dv)
    return q, k, v, rn(b, s, h) * 2.0, F.logsigmoid(rn(b, s, h) + 1.0)


def read(seed: int, device=None, **shape) -> dict:
    """One draw's readings (see the module's docstring)."""
    shape = {**FULL, **shape}
    dev = resolve_device(device)
    chunk = shape.pop("chunk")
    args = draw(seed, dev, **shape)
    y, st = ops.mlstm_scan(*args, chunk=chunk)
    py, pst = mlstm_chunked_ref(*args, chunk=chunk)
    ry, rst = mlstm_chunked_ref(*args, chunk=chunk, dtype=torch.float64)
    out = {"seed": seed}
    for name, got, plain, exact in zip(("y", "C", "n", "m"), (y, *st),
                                       (py, *pst), (ry, *rst)):
        got, plain = got.double(), plain.double()
        bad = ((got - plain).abs() > 5e-4 + 1e-5 * plain.abs()
               + 2.0 * (plain - exact).abs())
        out[name] = dict(kernel_vs_f64=float((got - exact).abs().max()),
                         plain_vs_f64=float((plain - exact).abs().max()),
                         out_of_criterion=int(bad.sum()))
        if name == "y":
            out[name]["rows_out"] = int(bad.any(dim=-1).sum())
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=list(range(16)))
    p.add_argument("--device", default=None)
    a = p.parse_args(argv)
    for seed in a.seeds:
        print(json.dumps(read(seed, a.device)), flush=True)


if __name__ == "__main__":
    main()
