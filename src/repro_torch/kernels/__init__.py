"""Hand-written Hopper (sm_90a) kernels for the port's hot paths.

Each kernel package holds its CUDA source (``csrc/*.cu``, a plain C
interface), an ``ops.py`` wrapper and the plain PyTorch version beside it
(``ref.py``).  The wrapper runs the plain version for a tensor on the CPU;
for a tensor on the card it launches the kernel or raises.  On either it
refuses an input that requires grad under grad mode (``refuse_autograd``).
Libraries are built at first use by ``_build.py``.
"""

import torch


def refuse_autograd(kernel: str, *tensors) -> None:
    """Raise if grad mode is on and any of ``tensors`` requires grad.

    The kernels are forward-only (their outputs are filled from C and carry
    no ``grad_fn``), as the reference's Pallas kernels have no VJP either:
    a backward pass through one would leave the gradients before it unset,
    with no error.  The check runs on every device, the CPU's plain
    versions included, so a training path that reaches a wrapper fails on
    the CPU as it would on the card.  ``None`` entries are skipped."""
    if not torch.is_grad_enabled():
        return
    if any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: an input requires grad, but the kernel has no "
            f"backward (the reference's Pallas kernel has no VJP in the JAX "
            f"package either); train through the model's train mode, or "
            f"call it under torch.no_grad()")
