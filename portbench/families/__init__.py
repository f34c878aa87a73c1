"""What differs between model families, one module each
(``families/<family>.py``), found by a configuration file's ``family``
key.  Each gives:

- ``dims(spec)``: the family's sizes beyond the shared ones (``{}`` if
  none), from the file's published keys;
- ``blocks(dm)``: its layers' weight leaves, ``{name: tree}`` beside the
  shared embedding, final norm and head (``weights.layout``);
- ``per_token(dm)``: the operations one token needs in its layers,
  without attention products and head (``counts.model``);
- ``port_fields(dm, runs_as)``: the port's config fields its sizes set,
  which ``serve.port_config`` holds against the port's config.

The plain forward that judges a family's served tokens is
``reference/<family>.py``.  A new family is these two files."""

import importlib


def get(name: str):
    return importlib.import_module(f"portbench.families.{name}")
