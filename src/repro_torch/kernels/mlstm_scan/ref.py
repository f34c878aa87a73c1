"""Plain PyTorch versions of the chunked mLSTM scan.

``mlstm_chunked_ref`` is the reference model's chunkwise-parallel mLSTM
(``mlstm_chunked``'s per-chunk body) op for op: the sequence is padded to
a multiple of ``chunk`` (q/k/v with zeros, ``log_i`` with -1e30, ``log_f``
with 0, which leaves the carried state unchanged) and the state (C, n, m)
is carried across chunks with stabilised exponential gating, all in f32.
The model path on the CPU runs it, and ``chip_smoke.py`` holds the CUDA
kernel to it on the card (and, with ``dtype=torch.float64``, measures how
far f32 itself is from the exact result, which bounds any f32 ordering).

``mlstm_sequential_ref`` is the sequential oracle, one timestep at a time,
independent of the chunked reformulation; the tests use it to check the
math rather than the implementation.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def empty_state(b: int, h: int, dk: int, dv: int, device,
                dtype=torch.float32) -> tuple:
    """The empty state: C and n zero, m at -1e30."""
    return (torch.zeros((b, h, dk, dv), dtype=dtype, device=device),
            torch.zeros((b, h, dk), dtype=dtype, device=device),
            torch.full((b, h), NEG_INF, dtype=dtype, device=device))


def _chunk_step(qb, kb, vb, li, lf, C, n, m, terms=None):
    """One chunk: (b, chunk, h, *) inputs and the carried (C, n, m) in;
    the chunk's output and the state at its end out.  With ``terms`` (a
    dict) it also keeps the output's parts: the stabiliser ``m_t``, the
    denominator's intra- and inter-chunk sums ``qn_intra`` and
    ``qn_inter``, the decay weights ``w[t, s] = e^{D[t,s]-m_t}`` and
    weighted scores ``W[t, s] = (q_t . k_s) w[t, s]`` (b, t, h, s), the
    numerator's two sums ``num_intra`` and ``num_inter``, the denominator
    ``denom``, and the magnitudes of the products the sums are made of:
    ``qk_abs`` = |q_t| . |k_s|, ``qn_inter_abs`` and ``num_inter_abs``
    (the inter-chunk sums over |q_t e^{m+F_t-m_t}| and |n|, |C|), and
    the state update's weights ``kv_w`` (b, s, h) and ``w_carry`` (b, h)."""
    chunk = qb.shape[1]
    Fc = torch.cumsum(lf, dim=1)                           # (b,chunk,h)
    # intra-chunk log decay D[t, s] = F_t - F_s + li_s   (s <= t)
    Dmat = Fc[:, :, None, :] - Fc[:, None, :, :] + li[:, None, :, :]
    tpos = torch.arange(chunk, device=qb.device)
    causal = tpos[:, None] >= tpos[None, :]
    Dmat = torch.where(causal[None, :, :, None], Dmat, NEG_INF)
    # inter-chunk contribution has magnitude m + F_t
    m_inter = m[:, None, :] + Fc                           # (b,chunk,h)
    m_t = torch.maximum(Dmat.amax(dim=2), m_inter)         # stabiliser
    intra_w = torch.exp(Dmat - m_t[:, :, None, :])         # (b,t,s,h)
    inter_w = torch.exp(m_inter - m_t)                     # (b,t,h)

    scores = torch.einsum("bthk,bshk->bths", qb, kb)       # (b,t,h,s)
    intra = torch.einsum("bths,bshv->bthv",
                         scores * intra_w.permute(0, 1, 3, 2), vb)
    q_inter = qb * inter_w[..., None]
    inter = torch.einsum("bthk,bhkv->bthv", q_inter, C)
    num = intra + inter

    norm_intra = torch.einsum("btsh,bshk->bthk", intra_w, kb)
    qdotn = (torch.einsum("bthk,bthk->bth", qb, norm_intra)
             + torch.einsum("bthk,bhk->bth", q_inter, n))
    denom = torch.maximum(torch.abs(qdotn), torch.exp(-m_t))
    out = num / denom[..., None]
    if terms is not None:
        aq, ai = qb.abs(), q_inter.abs()
        terms.update(m_t=m_t, w=intra_w.permute(0, 1, 3, 2),
                     W=scores * intra_w.permute(0, 1, 3, 2),
                     qk_abs=torch.einsum("bthk,bshk->bths", aq, kb.abs()),
                     qn_intra=torch.einsum("bthk,bthk->bth", qb, norm_intra),
                     qn_inter=torch.einsum("bthk,bhk->bth", q_inter, n),
                     qn_inter_abs=torch.einsum("bthk,bhk->bth", ai, n.abs()),
                     num_intra=intra, num_inter=inter,
                     num_inter_abs=torch.einsum("bthk,bhkv->bthv", ai,
                                                C.abs()),
                     denom=denom)

    # state update to the end of the chunk
    F_tot = Fc[:, -1]                                      # (b,h)
    m_new = torch.maximum(m + F_tot,
                          (F_tot[:, None] - Fc + li).amax(dim=1))
    w_carry = torch.exp(m + F_tot - m_new)
    kv_w = torch.exp(F_tot[:, None] - Fc + li - m_new[:, None])  # (b,chunk,h)
    C_new = C * w_carry[..., None, None] + torch.einsum(
        "bshk,bshv->bhkv", kb * kv_w[..., None], vb)
    n_new = n * w_carry[..., None] + torch.einsum("bshk,bsh->bhk", kb, kv_w)
    if terms is not None:
        terms.update(kv_w=kv_w, w_carry=w_carry)
    return out, (C_new, n_new, m_new)


def mlstm_chunked_ref(q, k, v, log_i, log_f, *, chunk: int,
                      initial_state: Optional[tuple] = None,
                      dtype=torch.float32, terms: Optional[list] = None):
    """q, k: (B,S,H,dk) pre-scaled; v: (B,S,H,dv); log_i/log_f: (B,S,H).

    Returns (y (B,S,H,dv) in q's dtype, (C (B,H,dk,dv), n (B,H,dk),
    m (B,H)) in ``dtype``, the type everything is computed in).  With
    ``terms`` (a list) each chunk appends its ``_chunk_step`` terms."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    nchunk = -(-s // chunk)
    pad = nchunk * chunk - s
    qf, kf, vf, li, lf = (t.to(dtype) for t in (q, k, v, log_i, log_f))
    if pad:
        qf, kf, vf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (qf, kf, vf))
        li = F.pad(li, (0, 0, 0, pad), value=NEG_INF)
        lf = F.pad(lf, (0, 0, 0, pad))
    if initial_state is None:
        C, n, m = empty_state(b, h, dk, dv, q.device, dtype)
    else:
        C, n, m = (t.to(dtype) for t in initial_state)
    outs = []
    for c in range(nchunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        parts = None if terms is None else {}
        out, (C, n, m) = _chunk_step(qf[:, sl], kf[:, sl], vf[:, sl],
                                     li[:, sl], lf[:, sl], C, n, m, parts)
        if terms is not None:
            terms.append(parts)
        outs.append(out)
    y = torch.cat(outs, dim=1)[:, :s]
    return y.to(q.dtype), (C, n, m)


def mlstm_sequential_ref(q, k, v, log_i, log_f, *,
                         initial_state: Optional[tuple] = None):
    """The recurrence one timestep at a time (same contract as
    ``mlstm_chunked_ref``, no chunking)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if initial_state is None:
        C, n, m = empty_state(b, h, dk, dv, q.device)
    else:
        C, n, m = (t.float() for t in initial_state)
    ys = []
    for t in range(s):
        qt, kt, vt = q[:, t].float(), k[:, t].float(), v[:, t].float()
        li, lf = log_i[:, t].float(), log_f[:, t].float()
        m_new = torch.maximum(lf + m, li)
        fw = torch.exp(lf + m - m_new)
        iw = torch.exp(li - m_new)
        C = C * fw[..., None, None] + iw[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = n * fw[..., None] + iw[..., None] * kt
        m = m_new
        num = torch.einsum("bhk,bhkv->bhv", qt, C)
        den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", qt, n)),
                            torch.exp(-m))
        ys.append(num / den[..., None])
    return torch.stack(ys, dim=1).to(q.dtype), (C, n, m)
