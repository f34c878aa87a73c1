"""Under a share of the experts, the share of the expert slots a MoE
decode call computes that carry an assignment to a held expert: the
program's device tally ``moe_block.decode_held_assignments`` (read once,
after the window) over its count of slots computed
(``moe_block.decode_slots``: the held experts times the capacity), over
every decode call of the run, in per cent.  None where the program keeps
no such tally, or tallied nothing (no share)."""

import sys


def read(rec):
    mod = sys.modules.get("repro_torch.models.layers")
    block = getattr(mod, "moe_block", None)
    held = getattr(block, "decode_held_assignments", None)
    slots = getattr(block, "decode_slots", 0)
    if held is None or not slots:
        return None
    n = held.value()
    return 100.0 * n / slots if n else None
