"""Smoke-size versions of the benchmark's configurations and mixes, for
runs on the CPU: every published width cut down alike in the file's keys
and in the port's overrides, so the two still agree."""

from __future__ import annotations

import copy

from portbench import spec

#: the published keys cut for the CPU, and the port's field for each
DENSE = {"hidden_size": (64, "d_model"), "num_hidden_layers": (2, "n_layers"),
         "num_attention_heads": (4, "n_heads"),
         "num_key_value_heads": (2, "n_kv_heads"),
         "head_dim": (16, "head_dim"), "intermediate_size": (96, "d_ff"),
         "vocab_size": (256, "vocab_size")}
MOE = {"n_routed_experts": (8, "n_routed_experts"),
       "num_experts_per_tok": (2, "moe_top_k"),
       "moe_intermediate_size": (32, "d_expert"),
       "n_shared_experts": (1, "n_shared_experts")}


def config(name: str) -> dict:
    cfg = copy.deepcopy(spec.config(spec.load_benchmark(), name))
    cuts = dict(DENSE, **(MOE if cfg["family"] == "moe" else {}))
    if cfg["family"] == "moe":
        cuts["num_hidden_layers"] = (3, "n_layers")
    for key, (value, field) in cuts.items():
        cfg[key] = value
        cfg["port"]["overrides"][field] = value
    return cfg


def mix(name: str, clients: int = 4) -> dict:
    m = copy.deepcopy(spec.mix(name))
    m.update(clients=clients, max_batch=clients, max_len=64, block=8,
             check_requests=8,
             prompt=dict(m["prompt"], median=12, min=4, max=24),
             output=dict(m["output"], median=6, min=3, max=12))
    return m
