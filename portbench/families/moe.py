"""Mixture-of-experts decoders (deepseek-moe-16b): dense layers first,
then layers whose MLP is a float32 router over routed experts beside
shared ones (the port stacks the MoE layers under ``blocks`` and keeps
the one dense layer apart as ``block0``)."""

from portbench.counts.model import mlp_flops, proj_flops
from portbench.weights import dense_block, mlp_leaves


def dims(spec: dict) -> dict:
    return dict(experts=spec["n_routed_experts"],
                shared=spec["n_shared_experts"],
                top_k=spec["num_experts_per_tok"],
                d_expert=spec["moe_intermediate_size"],
                dense_layers=spec["first_k_dense_replace"])


def blocks(dm: dict) -> dict:
    if dm["dense_layers"] != 1:
        raise ValueError("the port carries exactly one dense layer before "
                         "the MoE layers")
    lead = (dm["layers"] - 1,)
    d, e, f = dm["d"], dm["experts"], dm["d_expert"]
    moe = dense_block(dm, lead)
    moe["mlp"] = {"router": (lead + (d, e), d, "f32"),
                  "wi": (lead + (e, d, f), d, "bf16"),
                  "wg": (lead + (e, d, f), d, "bf16"),
                  "wo": (lead + (e, f, d), f, "bf16")}
    if dm["shared"]:
        moe["mlp"]["shared"] = mlp_leaves(d, f * dm["shared"], dm["mlp"],
                                          lead)
    return {"block0": dense_block(dm, ()), "blocks": moe}


def per_token(dm: dict) -> float:
    """A token passes the router, its top-k routed experts and the shared
    ones, never the experts it skips."""
    d, f, k, e = dm["d"], dm["d_expert"], dm["top_k"], dm["experts"]
    moe = 2.0 * (d * e + 3 * d * f * (k + dm["shared"]))
    n_moe = dm["layers"] - dm["dense_layers"]
    return (dm["layers"] * proj_flops(dm)
            + dm["dense_layers"] * mlp_flops(dm, dm["d_ff"]) + n_moe * moe)


def port_fields(dm: dict, runs_as: dict) -> dict:
    return dict(n_routed_experts=dm["experts"],
                n_shared_experts=dm["shared"], moe_top_k=dm["top_k"],
                d_expert=dm["d_expert"],
                first_layer_dense=dm["dense_layers"] == 1,
                capacity_factor=runs_as["moe_prefill_capacity_factor"])
