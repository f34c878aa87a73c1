"""Wrapper of the flash-attention (prefill) kernel.

``flash_attention`` launches ``csrc/flash_attention.cu`` for tensors on the
card and runs the plain version (``ref.flash_attention_ref``) for tensors
on the CPU.  There is no fallback: a CUDA tensor the kernel does not take
raises, and so does an input that requires grad under grad mode (the
kernel has no backward).  ``flash_attention.launches`` counts kernel
launches.  Meta tensors (the dry run) run the plain version as shape
analysis under the region ``KERNEL_flash_attention``, which also marks
the launch on the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import (gqa_local, host_counter, kernel_region,
                                 plain_on_meta, refuse_autograd)

from .ref import flash_attention_ref

#: head dims the kernel is instantiated for (192: MLA's nope + rope)
HEAD_DIMS = (32, 64, 128, 192)


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q (B,Sq,H,D), k/v (B,Sk,KV,D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"flash_attention: mismatched q {tuple(q.shape)} "
                         f"and k {tuple(k.shape)} (H % KV must be 0)")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D).  Returns (B, Sq, H, D).
    ``scale`` multiplies the logits; 1 / sqrt(D) by default."""
    _check(q, k, v, window)
    refuse_autograd("flash_attention", q, k, v)
    if q.device.type == "meta":
        return plain_on_meta("flash_attention", _plain_local, q, k, v,
                             causal=causal, window=window, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention: {name} must be bf16 on "
                             f"{q.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"and 16-byte aligned")
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    lib = _lib()
    with kernel_region("flash_attention"):
        out = torch.empty_like(q)
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, sk, h, kv, d, int(causal), int(window or 0),
            1.0 / math.sqrt(d) if scale is None else scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return out


host_counter(flash_attention, "launches")


def _plain_local(q, k, v, **kw):
    k, v = gqa_local(q, k, v, head_dim=2)
    return flash_attention_ref(q, k, v, **kw)


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib
