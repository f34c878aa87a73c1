"""Hand-written Hopper (sm_90a) kernels for the port's hot paths.

Each kernel package holds its CUDA source (``csrc/*.cu``, a plain C
interface), an ``ops.py`` wrapper and the plain PyTorch version beside it
(``ref.py``).  The wrapper runs the plain version for a tensor on the CPU;
for a tensor on the card it launches the kernel or raises.  Libraries are
built at first use by ``_build.py``.
"""
