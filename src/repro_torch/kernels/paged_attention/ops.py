"""Wrapper of the paged-attention decode kernel.

``paged_attention`` launches ``csrc/paged_attention.cu`` for tensors on the
card and runs the plain version (``ref.paged_attention_ref``) for tensors
on the CPU.  There is no fallback: a CUDA tensor the kernel does not take
raises.  ``paged_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .ref import paged_attention_ref


def _check(q, k_pages, v_pages, block_tables, lengths):
    if (q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape
            or block_tables.dim() != 2 or lengths.dim() != 1):
        raise ValueError("paged_attention: q (B,H,D), pages (P,page,KV,D), "
                         "block_tables (B,pages_max), lengths (B,)")
    b, h, d = q.shape
    if (k_pages.shape[3] != d or h % k_pages.shape[2]
            or block_tables.shape[0] != b or lengths.shape[0] != b):
        raise ValueError(f"paged_attention: mismatched q {tuple(q.shape)}, "
                         f"pages {tuple(k_pages.shape)}, block_tables "
                         f"{tuple(block_tables.shape)}, lengths "
                         f"{tuple(lengths.shape)} (H % KV must be 0)")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, D); k_pages/v_pages: (P, page, KV, D); block_tables:
    (B, pages_max) int32; lengths: (B,) int32.  Returns (B, H, D)."""
    _check(q, k_pages, v_pages, block_tables, lengths)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    for name, t, dtype in (("q", q, torch.bfloat16),
                           ("k_pages", k_pages, torch.bfloat16),
                           ("v_pages", v_pages, torch.bfloat16),
                           ("block_tables", block_tables, torch.int32),
                           ("lengths", lengths, torch.int32)):
        if t.device != q.device or t.dtype != dtype:
            raise ValueError(f"paged_attention: {name} must be {dtype} on "
                             f"{q.device}, got {t.dtype} on {t.device}")
        align = 16 if dtype == torch.bfloat16 else 4  # the kernel's loads
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"paged_attention: {name} must be contiguous "
                             f"and {align}-byte aligned")
    b, h, d = q.shape
    page, kv = k_pages.shape[1], k_pages.shape[2]
    if d % 8:
        raise ValueError(f"paged_attention: head dim {d} is not a multiple "
                         f"of 8")
    out = torch.empty_like(q)
    lib = _lib()
    rc = lib.paged_attention_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, h, kv, d, page, block_tables.shape[1], 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load("paged_attention")
    fn = lib.paged_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib
