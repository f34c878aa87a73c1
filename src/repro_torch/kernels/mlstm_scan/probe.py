"""How far the mLSTM kernel and its plain version each sit from an f64
evaluation of the same chunked algorithm, over several input draws.

    PYTHONPATH=src python -m repro_torch.kernels.mlstm_scan.probe --seeds 0 8

Each seed draws xlstm-1.3b's prefill shape (B1 S512 H4 dk512 dv1024,
chunk 256, f32, from the empty state) as ``chip_smoke.py``'s mLSTM phase
draws it (q pre-scaled, k and v normal, log_i normal x 2, log_f
log_sigmoid(normal + 1)) from a generator seeded with it, and prints one
JSON line per seed: for y and the final (C, n, m), max |kernel - f64|,
max |plain - f64|, and the elements (and rows of y) outside the
per-element criterion ``chip_smoke.py`` holds the kernel to
(``criterion``): within tests/test_kernels.py's tolerance of the plain
version (atol 5e-4, rtol 1e-5), or within C_BOUND eps32 kappa |x_f64| of
the f64 value, kappa the element's condition number over the elementary
products it is made of (``abs_sums``), with the largest c seen.  Nothing
is gated: it measures whether the kernel is as accurate as f32 allows on
draws other than the smoke's.  Runs on the card unless ``--device cpu``
(where the wrapper runs the plain version, so kernel and plain agree by
construction).

Each line also carries ``worst_row``: the row of y (b, t, h) where the
kernel is furthest from f64, read term by term at its worst column, with
the kernel's, the plain version's and the f64 value of each quantity:
the stabiliser m_t and e^{-m_t}; the denominator's intra-chunk sum
sum_s W[t,s] (W[t,s] = (q_t . k_s) e^{D[t,s]-m_t}) and inter-chunk term
e^{m+F_t-m_t} q_t . n, their sum q.n and the denominator max(|q.n|,
e^{-m_t}); the numerator's two sums (sum_s W[t,s] v_s and e^{m+F_t-m_t}
q_t . C) and y.  The kernel's values come from its workspace (m_t, the
row sum of its W, the inter-chunk term and the denominator as it computed
them; its W summed again in f64 for the numerator; C at the chunk's start
from the kernel run on the sequence up to that chunk).
Beside them the condition numbers of the denominator and numerator over
the f64 values, kappa = sum |terms| / |sum|: ``kappa_den_s`` over the
terms W[t,s] and the inter-chunk term, and ``kappa_den`` and
``kappa_num`` over the products the sums are made of (q_ti k_si w_s,
times v_s where the numerator's, and the inter-chunk products), which is
what f32 rounds.  For each implementation c = |y - y_f64| / (eps32 kappa
|y_f64|), kappa = kappa_den + kappa_num and eps32 = 2^-23: an
implementation is as accurate as some order of f32 summation allows when
its c is small (the classical bound lets c grow with the number of terms
summed in turn, 512 products and up to 256 steps here).  ``W_term_c``:
the largest single term's error against the row's products, max_s |W_s -
W_f64,s| / (eps32 sum_s w_s |q_t|.|k_s|); a term dropped or misweighted
(a tile edge, a mask) puts it near its share of the row over eps32 (8e4
for a term of 1%), rounding keeps it near 1 or below.
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
    ws = None
    if dev.type == "cuda":
        y, st, ws = ops.mlstm_scan_with_workspace(*args, chunk=chunk)
    else:
        y, st = ops.mlstm_scan(*args, chunk=chunk)
    pterms, rterms = [], []
    py, pst = mlstm_chunked_ref(*args, chunk=chunk, terms=pterms)
    ry, rst = mlstm_chunked_ref(*args, chunk=chunk, dtype=torch.float64,
                                terms=rterms)
    scales = abs_sums(args, chunk, None, rterms)
    out = {"seed": seed}
    for name, got, plain, exact in zip(("y", "C", "n", "m"), (y, *st),
                                       (py, *pst), (ry, *rst)):
        got_c = criterion(got, plain, exact, scales.get(name), ATOL[got.dtype])
        out[name] = dict(kernel_vs_f64=float((got.double() - exact).abs().max()),
                         plain_vs_f64=float((plain.double() - exact).abs().max()),
                         out_of_criterion=got_c["out"],
                         by_kappa=got_c["kappa"], c_max=got_c["c_max"])
        if name == "y":
            out[name]["rows_out"] = int(got_c["bad"].any(dim=-1).sum())
    out["worst_row"] = worst_row(args, chunk, y, ws, (py, pterms),
                                 (ry, rterms))
    return out


EPS32 = 2.0 ** -23
#: the criterion's constant c: the worst rows of y of two f32 orders of
#: the scan (the plain version's and a chunk-serial kernel's) reached
#: c <= 1.85 over seeds 0-15 at the probe's shape
C_BOUND = 2.0
#: tests/test_kernels.py's tolerances: atol by dtype, rtol 1e-5
ATOL = {torch.float32: 5e-4, torch.bfloat16: 1e-1}
RTOL = 1e-5


def abs_sums(args, chunk, initial_state, rterms) -> dict:
    """kappa |x_f64| for every element of y, C and n (f64): the sum of the
    absolute values of the elementary products the element is made of.
    ``rterms``: ``mlstm_chunked_ref``'s terms in f64 on ``args``.

    y = num / den: (sum_s w_s |q_t|.|k_s| |v_s| + |q_t e^{m+F_t-m_t}|.|C|
    + |y| (sum_s w_s |q_t|.|k_s| + |q_t e^{m+F_t-m_t}|.|n|)) / den, i.e.
    (kappa_num + kappa_den) |y| with both condition numbers taken over
    den = max(|q.n|, e^{-m_t}) (where the floor holds, q.n's error does not
    reach y).  C: |C| w_carry + |k kv_w|^T |v| chunk by chunk, from |C0|;
    n likewise.  m is a max of sums, held by the tolerance alone."""
    q, k, v = (a.double() for a in args[:3])
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    pad = len(rterms) * chunk - s
    kp, vp = (F.pad(t, (0, 0, 0, 0, 0, pad)).abs() for t in (k, v))
    if initial_state is None:
        C = torch.zeros((b, h, dk, dv), dtype=torch.float64, device=q.device)
        n = torch.zeros((b, h, dk), dtype=torch.float64, device=q.device)
    else:
        C, n = (t.double().abs() for t in initial_state[:2])
    ys = []
    for c, T in enumerate(rterms):
        sl = slice(c * chunk, (c + 1) * chunk)
        wq = T["w"] * T["qk_abs"]                            # (b,t,h,s)
        num = torch.einsum("bths,bshv->bthv", wq, vp[:, sl]) \
            + T["num_inter_abs"]
        den_abs = wq.sum(-1) + T["qn_inter_abs"]
        y = (T["num_intra"] + T["num_inter"]) / T["denom"][..., None]
        ys.append((num + den_abs[..., None] * y.abs())
                  / T["denom"][..., None])
        kw = kp[:, sl] * T["kv_w"][..., None]
        C = C * T["w_carry"][..., None, None] + torch.einsum(
            "bshk,bshv->bhkv", kw, vp[:, sl])
        n = n * T["w_carry"][..., None] + kw.sum(1)
    return {"y": torch.cat(ys, 1)[:, :s], "C": C, "n": n}


def criterion(got, plain, exact, scale, atol) -> dict:
    """The per-element criterion: ``got`` within ``atol`` + RTOL |plain| of
    the plain version (tests/test_kernels.py's tolerance), or within
    C_BOUND eps32 ``scale`` of the f64 value ``exact`` (``scale`` =
    kappa |x_f64| from ``abs_sums``; None: the tolerance alone).  Returns
    the elements each arm passed (``tol``; ``kappa``: by the bound alone),
    those outside both (``out``, and the mask ``bad``) and the largest c =
    |got - exact| / (eps32 scale) among the elements only the bound
    passed (0.0 if none)."""
    got, plain = got.double(), plain.double()
    in_tol = (got - plain).abs() <= atol + RTOL * plain.abs()
    if scale is None:
        c = torch.full_like(got, math.inf)
    else:
        c = (got - exact).abs() / (EPS32 * scale)
    by_kappa = ~in_tol & (c <= C_BOUND)
    bad = ~in_tol & ~by_kappa
    return dict(tol=int(in_tol.sum()), kappa=int(by_kappa.sum()),
                out=int(bad.sum()), bad=bad,
                c_max=float(c[by_kappa].max()) if bool(by_kappa.any())
                else 0.0)


def _plain_row(y, terms, at) -> dict:
    """The row's quantities from ``mlstm_chunked_ref``'s terms."""
    b, t, h, col, c, tl = at
    T = terms[c]
    qn_intra, qn_inter = T["qn_intra"][b, tl, h], T["qn_inter"][b, tl, h]
    m_t = T["m_t"][b, tl, h]
    return dict(m_t=m_t, exp_neg_m=torch.exp(-m_t), qn_intra=qn_intra,
                qn_inter=qn_inter, qdotn=qn_intra + qn_inter,
                denom=T["denom"][b, tl, h],
                num_intra=T["num_intra"][b, tl, h, col],
                num_inter=T["num_inter"][b, tl, h, col], y=y[b, t, h, col])


def _kernel_row(args, chunk, y, ws, at) -> dict:
    """The row's quantities from the kernel's workspace: m_t, the row sum
    of W, the inter-chunk term and the denominator as it computed them;
    its W summed again in f64 for the numerator, and C at the chunk's start
    from the kernel run on the sequence before the chunk."""
    q, _, v, _, _ = args
    b, t, h, col, c, tl = at
    H = q.shape[2]
    bh, t0 = b * H + h, c * chunk
    m_t = ws["mt"][bh, t0 + tl]
    W = ws["W"][bh, c, tl, :tl + 1].double()
    iw = ws["interw"][bh, t0 + tl]
    qn_intra = ws["rowsum"][bh, t0 + tl].double()
    qn_inter = ws["qn"][bh, t0 + tl].double()
    if c == 0:
        inter = torch.zeros((), dtype=torch.float64, device=q.device)
    else:
        _, (C, _, _) = ops.mlstm_scan(
            *(a[:, :t0].contiguous() for a in args), chunk=chunk)
        inter = iw.double() * (q[b, t, h].double() @ C[b, h, :, col].double())
    return dict(m_t=m_t, exp_neg_m=torch.exp(-m_t), qn_intra=qn_intra,
                qn_inter=qn_inter, qdotn=qn_intra + qn_inter,
                denom=ws["denom"][bh, t0 + tl],
                num_intra=W @ v[b, t0:t0 + tl + 1, h, col].double(),
                num_inter=inter, y=y[b, t, h, col])


def worst_row(args, chunk, y, ws, plain, exact) -> dict:
    """The readout of the row of y furthest from f64 (module docstring).
    ``ws``: the kernel's workspace views, or None where the wrapper ran the
    plain version (its terms then stand in for the kernel's); ``plain``
    and ``exact``: (y, terms) of the plain version in f32 and f64."""
    (py, pterms), (ry, rterms) = plain, exact
    err = (y.double() - ry).abs()
    b, t, h = (int(i) for i in torch.unravel_index(
        err.amax(-1).argmax(), err.shape[:3]))
    col = int(err[b, t, h].argmax())
    c, tl = t // chunk, t % chunk
    at = (b, t, h, col, c, tl)
    got = (_plain_row(y, pterms, at) if ws is None
           else _kernel_row(args, chunk, y, ws, at))
    rows = dict(kernel=got, plain=_plain_row(py, pterms, at),
                f64=_plain_row(ry, rterms, at))
    T = rterms[c]
    W = T["W"][b, tl, h, :tl + 1]
    elem = T["w"][b, tl, h, :tl + 1] * T["qk_abs"][b, tl, h, :tl + 1]
    v = args[2][b, c * chunk:c * chunk + tl + 1, h, col].double()
    f = rows["f64"]
    num = (f["num_intra"] + f["num_inter"]).abs()
    kappa_den_s = float((W.abs().sum() + f["qn_inter"].abs())
                        / f["qdotn"].abs())
    kappa_den = float((elem.sum() + T["qn_inter_abs"][b, tl, h])
                      / f["qdotn"].abs())
    kappa_num = float(((elem * v.abs()).sum()
                       + T["num_inter_abs"][b, tl, h, col]) / num)
    scale = EPS32 * (kappa_den + kappa_num) * float(f["y"].abs())
    Wk = (pterms[c]["W"][b, tl, h, :tl + 1] if ws is None else
          ws["W"][b * args[0].shape[2] + h, c, tl, :tl + 1])
    Wp = pterms[c]["W"][b, tl, h, :tl + 1]

    def term_c(w_impl):
        return float((w_impl.double() - W).abs().max()
                     / (EPS32 * elem.sum()))

    quantities = {name: {impl: float(rows[impl][name]) for impl in rows}
                  for name in f}
    return dict(b=b, t=t, h=h, col=col, chunk=c, kappa_den_s=kappa_den_s,
                kappa_den=kappa_den, kappa_num=kappa_num,
                c_kernel=float((y[b, t, h, col].double() - f["y"]).abs())
                / scale,
                c_plain=float((py[b, t, h, col].double() - f["y"]).abs())
                / scale,
                W_term_c_kernel=term_c(Wk), W_term_c_plain=term_c(Wp),
                **quantities)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=list(range(16)))
    p.add_argument("--device", default=None)
    a = p.parse_args(argv)
    for seed in a.seeds:
        print(json.dumps(read(seed, a.device)), flush=True)


if __name__ == "__main__":
    main()
