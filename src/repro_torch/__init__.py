"""repro_torch — the serialized-bridge serving system in PyTorch and CUDA.

The port of ``repro`` (JAX on a TPU) to an NVIDIA H100.  It imports
``torch`` and numpy and nothing of JAX or ``repro``; its layout mirrors
``repro``'s so each module's counterpart is easy to find.  Entry points run
on the card unless the caller passes ``device="cpu"``.
"""
