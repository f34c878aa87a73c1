"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` is the command ``BENCHMARK.json`` names.  Everything that
belongs to one configuration, traffic mix, cell or metric is a file of its
own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the model as it is run (published keys, the
  cut, the port's arch id and overrides, where the port departs);
- ``mixes/<mix>.json``: the traffic (loop, clients, length distributions,
  engine sizes, CC, sampling);
- ``limits/<cell>.json``: the limit of each number the correctness check
  compares, with the readings it was set from;
- ``metrics/<metric>.py``: one reader per metric, ``read(rec)`` -> a
  number or None (``<metric>.<suffix>`` is read by ``<metric>.py`` where
  it has no file of its own);
- ``counts/``: the operations and bytes behind every roofline and MFU;
- ``families/<family>.py``: what a model family adds to the shared sizes,
  weight layout, operation count and port config;
- ``reference/<family>.py``: the plain float32 forward that judges the
  served tokens.

Nothing here imports ``jax``, ``jaxlib``, ``flax`` or the JAX package
``repro``; ``reference/`` imports nothing of ``repro_torch`` either.
"""
