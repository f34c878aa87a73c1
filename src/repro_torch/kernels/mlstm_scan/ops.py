"""Wrapper of the chunked mLSTM scan kernel.

``mlstm_scan`` launches ``csrc/mlstm_scan.cu`` for tensors on the card and
runs the plain version (``ref.mlstm_chunked_ref``) for tensors on the CPU.
There is no fallback: a CUDA tensor the kernel does not take raises, and
so does an input that requires grad under grad mode (the kernel has no
backward; the model trains through ``ref.mlstm_chunked_ref``).
``mlstm_scan.launches`` counts kernel launches (one per call; the call
runs the source's passes in order: stats, products (scores and the
chunks' state contributions), combine (more than one chunk), out, after
a widening of bf16 inputs).  Meta tensors (the dry run) run the plain
version as shape analysis under the region ``KERNEL_mlstm_scan``, which
also marks the launch on the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import kernel_region, plain_on_meta, refuse_autograd

from .ref import mlstm_chunked_ref


def _check(q, k, v, log_i, log_f, chunk, initial_state):
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 \
            or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"mlstm_scan: q, k (B,S,H,dk), v (B,S,H,dv); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if log_i.shape != q.shape[:3] or log_f.shape != q.shape[:3]:
        raise ValueError(f"mlstm_scan: gates must be (B,S,H) = "
                         f"{tuple(q.shape[:3])}; got {tuple(log_i.shape)}, "
                         f"{tuple(log_f.shape)}")
    if chunk < 1 or q.shape[1] < 1:
        raise ValueError(f"mlstm_scan: chunk {chunk} and length "
                         f"{q.shape[1]} must be >= 1")
    if initial_state is not None:
        b, _, h, dk = q.shape
        want = ((b, h, dk, v.shape[3]), (b, h, dk), (b, h))
        got = tuple(tuple(t.shape) for t in initial_state)
        if got != want:
            raise ValueError(f"mlstm_scan: initial state (C, n, m) must be "
                             f"{want}, got {got}")


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_i: torch.Tensor, log_f: torch.Tensor, *, chunk: int,
               initial_state: Optional[tuple] = None):
    """q, k: (B,S,H,dk) pre-scaled; v: (B,S,H,dv); log_i, log_f: (B,S,H)
    f32; ``initial_state`` (C (B,H,dk,dv), n (B,H,dk), m (B,H)) f32 or the
    empty state.  Returns (y (B,S,H,dv) in q's dtype, (C, n, m) f32)."""
    _check(q, k, v, log_i, log_f, chunk, initial_state)
    refuse_autograd("mlstm_scan", q, k, v, log_i, log_f,
                    *(initial_state or ()))
    if q.device.type == "meta":
        # y keeps q's placements; C, n, m are (B, H, ...), q's batch and
        # head dims
        state_dims = {0: 0, 2: 1}
        y, *state = plain_on_meta(
            "mlstm_scan", _plain_flat, q, k, v, log_i, log_f, chunk=chunk,
            initial_state=initial_state, align=True,
            out_dims=({0: 0, 1: 1, 2: 2},) + (state_dims,) * 3)
        return y, tuple(state)
    if q.device.type == "cpu":
        return mlstm_chunked_ref(q, k, v, log_i, log_f, chunk=chunk,
                                 initial_state=initial_state)
    with kernel_region("mlstm_scan"):
        y, state, _ = _launch(q, k, v, log_i, log_f, chunk, initial_state)
    return y, state


def mlstm_scan_with_workspace(q, k, v, log_i, log_f, *, chunk: int,
                              initial_state: Optional[tuple] = None):
    """``mlstm_scan`` on the card, also returning the kernel's workspace as
    ``workspace_views`` names it (what ``probe`` reads)."""
    _check(q, k, v, log_i, log_f, chunk, initial_state)
    refuse_autograd("mlstm_scan", q, k, v, log_i, log_f,
                    *(initial_state or ()))
    y, state, ws = _launch(q, k, v, log_i, log_f, chunk, initial_state)
    b, s, h, dk = q.shape
    return y, state, workspace_views(ws, b, s, h, dk, v.shape[3], chunk)


def _up4(n: int) -> int:
    return (n + 3) // 4 * 4


def workspace_views(ws: torch.Tensor, b: int, s: int, h: int, dk: int,
                    dv: int, chunk: int) -> dict:
    """The kernel's f32 workspace cut as ``carve`` in csrc/mlstm_scan.cu
    cuts it (every part starting on a multiple of 4 floats), per (b*H + h):
    over the padded sequence (B*H, nc*chunk) F64 (each chunk's cumulative
    log forget gate, in f64), dmax (max_s D[t,s] within the chunk), mt
    (the stabiliser m_t), interw (e^{m+F_t-m_t}), rowsum (sum_s W[t,s]),
    qn (the denominator's inter-chunk term e^{m+F_t-m_t} q_t . n) and
    denom; rsp (B*H, nc*chunk, chunk / 64 rounded up), W's row sums by key
    tile of 64; per chunk (B*H, nc) Ftot, g (the chunk's max of (F_tot -
    F_s) + li_s) and wcarry; W per chunk (B*H, nc, chunk, chunk), the
    weighted scores (q_t . k_s) e^{D[t,s]-m_t} (zero above the diagonal);
    Cst (B*H, nc, dk, dv) and nst (B*H, nc, dk): the state at each chunk's
    start from chunk 1 on when there is more than one chunk (slot 0 holds
    chunk 0's own contribution)."""
    nc = -(-s // chunk)
    bh, sp, ldw = b * h, nc * chunk, _up4(chunk)
    shapes = [("F64", (bh, 2 * sp))]
    shapes += [(name, (bh, sp)) for name in
               ("dmax", "mt", "interw", "rowsum", "qn", "denom")]
    shapes += [("rsp", (bh, sp, -(-chunk // 64)))]
    shapes += [(name, (bh, nc)) for name in ("Ftot", "g", "wcarry")]
    shapes += [("W", (bh, nc, chunk, ldw)), ("Cst", (bh, nc, dk, dv)),
               ("nst", (bh, nc, dk))]
    views, off = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        views[name] = ws[off:off + n].view(shape)
        off += _up4(n)
    views["F64"] = views["F64"].view(torch.float64)
    views["W"] = views["W"][..., :chunk]
    return views


def _launch(q, k, v, log_i, log_f, chunk, initial_state):
    """Launch the kernel; returns (y, (C, n, m), workspace)."""
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_scan: no kernel for {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mlstm_scan: q/k/v must be f32 or bf16, got "
                         f"{q.dtype}")
    named = [("q", q, q.dtype), ("k", k, q.dtype), ("v", v, q.dtype),
             ("log_i", log_i, torch.float32), ("log_f", log_f, torch.float32)]
    if initial_state is not None:
        named += [(n, t, torch.float32)
                  for n, t in zip(("C", "n", "m"), initial_state)]
    for name, t, dtype in named:
        if t.device != q.device or t.dtype != dtype:
            raise ValueError(f"mlstm_scan: {name} must be {dtype} on "
                             f"{q.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"mlstm_scan: {name} must be contiguous")
        if name in ("q", "k", "v", "C") and t.data_ptr() % 16:
            raise ValueError(f"mlstm_scan: {name} must start on 16 bytes "
                             f"(the kernel copies it in 16-byte pieces)")
    b, s, h, dk = q.shape
    dv = v.shape[3]
    if dk % 4 or dv % 4:
        raise ValueError(f"mlstm_scan: dk {dk} and dv {dv} must be "
                         f"multiples of 4")
    if -(-s // chunk) * b * h > 65535:
        raise ValueError(f"mlstm_scan: {-(-s // chunk)} chunks x {b * h} "
                         f"heads > 65535 (the out pass's grid)")
    bf16 = int(q.dtype == torch.bfloat16)
    lib = _lib()
    dev, f32 = q.device, torch.float32
    y = torch.empty((b, s, h, dv), dtype=q.dtype, device=dev)
    C = torch.empty((b, h, dk, dv), dtype=f32, device=dev)
    n = torch.empty((b, h, dk), dtype=f32, device=dev)
    m = torch.empty((b, h), dtype=f32, device=dev)
    ws = torch.empty(
        lib.mlstm_scan_workspace_bytes(b, s, h, dk, dv, chunk, bf16) // 4,
        dtype=f32, device=dev)
    state = ([t.data_ptr() for t in initial_state]
             if initial_state is not None else [None] * 3)
    rc = lib.mlstm_scan_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_i.data_ptr(),
        log_f.data_ptr(), *state, y.data_ptr(), C.data_ptr(), n.data_ptr(),
        m.data_ptr(), ws.data_ptr(), b, s, h, dk, dv, chunk, bf16,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mlstm_scan kernel launch failed: CUDA error "
                           f"{rc}")
    mlstm_scan.launches += 1
    return y, (C, n, m), ws


mlstm_scan.launches = 0


def _plain_flat(*args, **kw):
    y, state = mlstm_chunked_ref(*args, **kw)
    return (y, *state)


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load("mlstm_scan")
    fn = lib.mlstm_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        ws = lib.mlstm_scan_workspace_bytes
        ws.argtypes = [ctypes.c_int] * 7
        ws.restype = ctypes.c_size_t
    return lib
