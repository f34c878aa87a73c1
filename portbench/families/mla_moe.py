"""Latent attention on mixture-of-experts decoders (DeepSeek-V3): every
layer's attention is MLA (the query through its own low-rank latent where
``q_lora_rank`` is set, a latent KV cache of ``kv_lora_rank`` plus a
shared rope key, YaRN-scaled rotary positions), the leading dense layers
(the port carries one, as ``block0``) then MoE layers whose float32
router, scored by a sigmoid with a correction bias, routes over every
published expert while this card holds a share of them
(``n_routed_experts`` here, ``published["n_routed_experts"]`` routed
over, from ``expert_offset``) beside the shared experts.

``head_dim`` (the file's key of that name, which the configuration
states as nope + rope, 192) is the width at which MLA's prefill runs
the flash kernel (queries and per-head keys at 192, V padded to it), so
``kernel.flash_roofline`` counts what the kernel is given, and
``model.mfu`` counts MLA's attention products at 4 H 192 operations a key,
whatever computes them (the flash kernel in a prefill, the absorbed
plain-torch products in decode).  ``absorbed_flops`` / ``absorbed_bytes``
are what a decode call's absorbed attention needs, for the roofline of a
kernel that would compute it."""

from portbench.counts.attention import BF16
from portbench.counts.model import mlp_flops
from portbench.weights import mlp_leaves, norm_leaves


def dims(spec: dict) -> dict:
    nope, rope = spec["qk_nope_head_dim"], spec["qk_rope_head_dim"]
    yarn = spec["rope_scaling"]
    return dict(experts=spec["published"]["n_routed_experts"],
                held=spec["n_routed_experts"], offset=spec["expert_offset"],
                shared=spec["n_shared_experts"],
                top_k=spec["num_experts_per_tok"],
                d_expert=spec["moe_intermediate_size"],
                dense_layers=spec["first_k_dense_replace"],
                groups=spec["n_group"], topk_groups=spec["topk_group"],
                router_scale=spec["routed_scaling_factor"],
                q_lora=spec["q_lora_rank"], kv_lora=spec["kv_lora_rank"],
                nope=nope, rope=rope, v_head=spec["v_head_dim"],
                yarn=(float(yarn["factor"]),
                      yarn["original_max_position_embeddings"],
                      float(yarn["beta_fast"]), float(yarn["beta_slow"]),
                      float(yarn["mscale"]), float(yarn["mscale_all_dim"])))


def mla_leaves(dm: dict, lead: tuple) -> dict:
    d, h, dq, dc = dm["d"], dm["heads"], dm["q_lora"], dm["kv_lora"]
    dn, dr, dv = dm["nope"], dm["rope"], dm["v_head"]
    if dq:
        q = {"wdq": (lead + (d, dq), d, "bf16"),
             "q_norm": norm_leaves(dq, "rmsnorm", lead),
             "wuq": (lead + (dq, h, dn + dr), dq, "bf16")}
    else:
        q = {"wq": (lead + (d, h, dn + dr), d, "bf16")}
    return q | {"wdkv": (lead + (d, dc + dr), d, "bf16"),
                "kv_norm": norm_leaves(dc, "rmsnorm", lead),
                "wuk": (lead + (dc, h, dn), dc, "bf16"),
                "wuv": (lead + (dc, h, dv), dc, "bf16"),
                "wo": (lead + (h, dv, d), h * dv, "bf16")}


def blocks(dm: dict) -> dict:
    if dm["dense_layers"] != 1:
        raise ValueError("the port carries exactly one dense layer before "
                         "the MoE layers")
    d, e, f, held = dm["d"], dm["experts"], dm["d_expert"], dm["held"]

    def block(lead, mlp):
        return {"attn_norm": norm_leaves(d, dm["norm"], lead),
                "attn": mla_leaves(dm, lead),
                "mlp_norm": norm_leaves(d, dm["norm"], lead), "mlp": mlp}
    lead = (dm["layers"] - 1,)
    moe = {"router": (lead + (d, e), d, "f32"),
           # the correction bias: drawn from the seed (``assumed``)
           "router_bias": (lead + (e,), e, "f32"),
           "wi": (lead + (held, d, f), d, "bf16"),
           "wg": (lead + (held, d, f), d, "bf16"),
           "wo": (lead + (held, f, d), f, "bf16")}
    if dm["shared"]:
        moe["shared"] = mlp_leaves(d, f * dm["shared"], dm["mlp"], lead)
    return {"block0": block((), mlp_leaves(d, dm["d_ff"], dm["mlp"], ())),
            "blocks": block(lead, moe)}


def mla_flops(dm: dict) -> float:
    """A token's MLA projections in one layer: the query (through its
    latent), the KV latent and rope key, the per-head K and V
    up-projections (in decode the same products absorbed into the query
    and the output) and the output projection."""
    d, h, dq, dc = dm["d"], dm["heads"], dm["q_lora"], dm["kv_lora"]
    dn, dr, dv = dm["nope"], dm["rope"], dm["v_head"]
    q = d * dq + dq * h * (dn + dr) if dq else d * h * (dn + dr)
    return 2.0 * (q + d * (dc + dr) + dc * h * dn + dc * h * dv + h * dv * d)


def per_token(dm: dict) -> float:
    """A token passes the router (over every expert), the shared experts,
    and of its top k the share that falls to the experts held here, k *
    held / experts on average (the groups are symmetric, so every share
    expects the same)."""
    d, f, k, e = dm["d"], dm["d_expert"], dm["top_k"], dm["experts"]
    routed = k * dm["held"] / e
    moe = 2.0 * (d * e + 3 * d * f * (routed + dm["shared"]))
    n_moe = dm["layers"] - dm["dense_layers"]
    return (dm["layers"] * mla_flops(dm)
            + dm["dense_layers"] * mlp_flops(dm, dm["d_ff"]) + n_moe * moe)


def absorbed_flops(lengths, h: int, dc: int, dr: int) -> float:
    """One layer's absorbed decode attention over the stepping rows, row i
    attending to ``lengths[i]`` positions: the logits against the latent
    and the rope key (2 h (dc + dr) a position) and the weighted sum of the
    latent (2 h dc)."""
    return sum(2.0 * h * n * (2 * dc + dr) for n in lengths)


def absorbed_bytes(lengths, h: int, dc: int, dr: int) -> float:
    """Its bytes, bf16, each input once: a row's latent and rope key over
    its positions, its absorbed query (h (dc + dr)) and latent output
    (h dc)."""
    return sum(BF16 * (n * (dc + dr) + h * (dc + dr) + h * dc)
               for n in lengths)


def port_fields(dm: dict, runs_as: dict) -> dict:
    return dict(use_mla=True, q_lora_rank=dm["q_lora"],
                kv_lora_rank=dm["kv_lora"], nope_head_dim=dm["nope"],
                rope_head_dim=dm["rope"], v_head_dim=dm["v_head"],
                yarn=dm["yarn"],
                router_scoring=runs_as["router"], router_groups=dm["groups"],
                router_topk_groups=dm["topk_groups"],
                router_scale=dm["router_scale"],
                n_routed_experts=dm["experts"], experts_held=dm["held"],
                experts_offset=dm["offset"], n_shared_experts=dm["shared"],
                moe_top_k=dm["top_k"], d_expert=dm["d_expert"],
                first_layer_dense=dm["dense_layers"] == 1,
                capacity_factor=runs_as["moe_prefill_capacity_factor"])
