"""Dense decoders (nemotron-4-340b): every layer attention and one MLP."""

from portbench.counts.model import mlp_flops, proj_flops
from portbench.weights import dense_block


def dims(spec: dict) -> dict:
    return {}


def blocks(dm: dict) -> dict:
    return {"blocks": dense_block(dm, (dm["layers"],))}


def per_token(dm: dict) -> float:
    return dm["layers"] * (proj_flops(dm) + mlp_flops(dm, dm["d_ff"]))


def port_fields(dm: dict, runs_as: dict) -> dict:
    return {}
