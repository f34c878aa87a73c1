"""Model configuration system.

One frozen dataclass covers every assigned architecture family (dense / MoE /
MLA / SSM / hybrid / enc-dec / VLM / audio).  Arch-specific files in this
package instantiate it with the exact assigned values and register it under
its ``--arch`` id.  Input shapes (the assigned seq_len x global_batch cells)
are defined here too, so launch/dryrun.py can enumerate (arch x shape) cells.
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads

    # layer options
    norm_kind: str = "rmsnorm"        # rmsnorm | layernorm | nonparametric_ln
    mlp_kind: str = "swiglu"          # swiglu | squared_relu | gelu
    qk_norm: bool = False
    qkv_bias: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    dtype: object = torch.bfloat16
    attn_impl: str = "blockwise"      # dense | blockwise | pallas
    attn_block_kv: int = 1024

    # MoE
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_expert: int = 0
    first_layer_dense: bool = True    # deepseek: layer 0 is a dense MLP
    capacity_factor: float = 1.25

    # MLA
    use_mla: bool = False
    kv_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # SSM / xLSTM / hybrid
    ssm_kind: str = ""                # xlstm | mamba
    slstm_every: int = 0              # xLSTM: every Nth block is sLSTM (0=never)
    ssm_state: int = 0
    ssm_expand: int = 2
    conv_width: int = 4
    hybrid: bool = False              # hymba: parallel attn + mamba heads
    sliding_window: int = 0           # 0 = full attention
    global_layers: tuple = ()         # layer idxs keeping full attention

    # encoder-decoder / multimodal frontends (STUBS per assignment)
    encoder_layers: int = 0
    frontend: str = ""                # audio | vision
    frontend_tokens: int = 0          # frames/patches supplied by input_specs

    # distribution / memory policy
    scan_layers: bool = True
    remat: bool = True
    remat_policy: str = "nothing"     # nothing | dots | full(=no remat)
    fsdp: bool = False                # shard params over the data axis too
    seq_shard_activations: bool = False  # Megatron-style sequence sharding

    # logit / loss
    logits_dtype: object = torch.bfloat16
    z_loss: float = 1e-4
    moe_aux_weight: float = 1e-2

    # the port's own fields (``PORT_FIELDS``), beyond the reference's: each
    # default leaves a reference arch as the reference runs it
    # MLA's query path through a low-rank latent: wdq -> RMSNorm -> wuq
    # (0: one wq, as deepseek-v2-lite)
    q_lora_rank: int = 0
    # YaRN's rotary scaling as (factor, original_max_len, beta_fast,
    # beta_slow, mscale, mscale_all_dim), () for plain rope: the frequencies
    # blended between theta's and theta's over the factor by the ramp
    # between the correction dims of beta_fast / beta_slow rotations over
    # original_max_len positions; an MLA softmax scale times
    # mscale(factor, mscale_all_dim)^2
    yarn: tuple = ()
    # the MoE router: "softmax" (top-k of the softmax, renormalised) or
    # "sigmoid_noaux_tc" (sigmoid scores; the experts chosen by the scores
    # plus ``router_bias`` inside the ``router_topk_groups`` of
    # ``router_groups`` groups whose two best biased scores sum highest;
    # gated by the unbiased scores, renormalised); gates times
    # ``router_scale``
    router_scoring: str = "softmax"
    router_groups: int = 1
    router_topk_groups: int = 1
    router_scale: float = 1.0
    # the routed experts held on this device, ``experts_offset`` ..
    # ``experts_offset + experts_held - 1`` of ``n_routed_experts`` (0: all):
    # one expert-parallel rank's share, computed without the exchange
    experts_held: int = 0
    experts_offset: int = 0
    # the prompt shapes whose ``Model.prefill`` is recorded as a CUDA graph
    # on the card, each at its second call, and replayed (0: every prefill
    # eager); the least recently used goes first
    prefill_graphs: int = 0

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def experts_here(self) -> int:
        """The routed experts whose weights this device holds."""
        return self.experts_held or self.n_routed_experts

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM state and/or sliding-window attention."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has an autoregressive decoder

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), for 6ND roofline."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        h, kv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.frontend:
            emb += self.frontend_tokens * 0  # frontend stubbed: embeddings arrive precomputed
        total = emb
        enc_layers = self.encoder_layers
        dec_layers = self.n_layers

        def attn_params() -> int:
            if self.use_mla:
                dc, dr = self.kv_lora_rank, self.rope_head_dim
                dn, dv = self.nope_head_dim, self.v_head_dim
                dq = self.q_lora_rank
                q = d * dq + dq * h * (dn + dr) if dq else d * h * (dn + dr)
                return (q + d * (dc + dr)
                        + dc * h * dn + dc * h * dv + h * dv * d)
            p = d * h * hd + 2 * d * kv * hd + h * hd * d
            if self.qkv_bias:
                p += h * hd + 2 * kv * hd
            return p

        def mlp_params(width: int) -> int:
            mult = 3 if self.mlp_kind == "swiglu" else 2
            return mult * d * width

        def ssm_params() -> int:
            # xLSTM / mamba block: in/out proj + gates (approximate, matches init)
            dex = self.ssm_expand * d
            return 2 * d * dex + 4 * dex * (self.head_dim or 64)

        for i in range(dec_layers):
            if self.family == "ssm":
                total += ssm_params() + mlp_params(f) * (1 if f else 0)
                continue
            total += attn_params()
            if self.hybrid:
                total += ssm_params()
            if self.n_routed_experts and not (i == 0 and self.first_layer_dense):
                e_mlp = 3 * d * self.d_expert
                total += (self.experts_here * e_mlp
                          + self.n_shared_experts * e_mlp + d * self.n_routed_experts)
            else:
                width = f if not self.n_routed_experts else self.d_expert * (
                    self.moe_top_k + self.n_shared_experts)
                total += mlp_params(width)
        for _ in range(enc_layers):
            total += attn_params() + mlp_params(f)
            if self.encoder_layers and self.family == "encdec":
                total += attn_params()  # decoder cross-attention (paired per dec layer)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: shared + top-k experts only)."""
        if not self.n_routed_experts:
            return self.param_count()
        full = self.param_count()
        e_mlp = 3 * self.d_model * self.d_expert
        moe_layers = self.n_layers - (1 if self.first_layer_dense else 0)
        if self.experts_held:
            # a share's experts take their share of each token's top k
            active = self.moe_top_k * self.experts_held / self.n_routed_experts
            return full - int(moe_layers * (self.experts_held - active) * e_mlp)
        inactive = moe_layers * (self.n_routed_experts - self.moe_top_k) * e_mlp
        return full - inactive


# ---------------------------------------------------------------------------------
# Input shapes (the assigned shape set for LM-family transformers)
# ---------------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Whether an (arch x shape) cell is assigned-runnable (DESIGN.md §4)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{cfg.name} is pure full-attention — documented skip")
    return True, ""


# ---------------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------------

ARCH_IDS = (
    "olmo-1b", "qwen3-32b", "qwen1.5-4b", "nemotron-4-340b",
    "seamless-m4t-medium", "deepseek-moe-16b", "deepseek-v2-lite-16b",
    "xlstm-1.3b", "internvl2-76b", "hymba-1.5b",
    # the paper's own serving model (dense FP8-class 27B — §5.2 workload)
    "qwen3p6-27b",
)

#: archs the port registers beyond the reference's ``ARCH_IDS``
#: (published models the benchmark serves; the reference has no config of
#: theirs to compare with)
PORT_ARCH_IDS = ("deepseek-v3",)

#: the ``ModelConfig`` fields the port adds to the reference's, each at a
#: default under which a reference arch runs as the reference runs it
PORT_FIELDS = ("q_lora_rank", "yarn", "router_scoring", "router_groups",
               "router_topk_groups", "router_scale", "experts_held",
               "experts_offset", "prefill_graphs")

#: the archs the serving engine runs: every arch but the encoder-decoder,
#: whose prefill needs frames the engine does not feed (it passes a
#: request's tokens only, as the reference's ``_prefill_into_slot`` does;
#: ``Model.prefill`` serves it model-level).  internvl2-76b serves its
#: token-only prompts.  ``Model`` itself runs every arch in ``ARCH_IDS``
PORTED_ARCH_IDS = ("olmo-1b", "qwen1.5-4b", "qwen3-32b", "nemotron-4-340b",
                   "qwen3p6-27b", "xlstm-1.3b", "hymba-1.5b",
                   "deepseek-moe-16b", "deepseek-v2-lite-16b",
                   "internvl2-76b") + PORT_ARCH_IDS

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(arch: str) -> ModelConfig:
    known = ARCH_IDS + PORT_ARCH_IDS
    if arch not in known:
        raise KeyError(f"unknown arch {arch!r} (known: {', '.join(known)})")
    if arch not in _REGISTRY:
        module = arch.replace("-", "_").replace(".", "p")
        importlib.import_module(f"repro_torch.configs.{module}")
    return _REGISTRY[arch]


def all_configs() -> dict[str, ModelConfig]:
    for arch in ARCH_IDS + PORT_ARCH_IDS:
        get_config(arch)
    return dict(_REGISTRY)


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: small layers/width,
    few experts, tiny embeddings — one forward/train step must run on CPU."""
    updates = dict(
        n_layers=min(cfg.n_layers, 2 + (1 if cfg.first_layer_dense and cfg.n_routed_experts else 0)),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        attn_impl="dense",
        scan_layers=cfg.scan_layers,
        fsdp=False,
        seq_shard_activations=False,
    )
    if cfg.n_routed_experts:
        updates.update(n_routed_experts=8, n_shared_experts=min(cfg.n_shared_experts, 1),
                       moe_top_k=2, d_expert=64)
    if cfg.use_mla:
        updates.update(kv_lora_rank=32, rope_head_dim=16, nope_head_dim=32, v_head_dim=32)
        if cfg.q_lora_rank:
            updates.update(q_lora_rank=32)
    if cfg.router_groups > 1:           # 8 experts in 4 groups, 2 kept
        updates.update(router_groups=4, router_topk_groups=2)
    if cfg.experts_held:                # the first half of the 8
        updates.update(experts_held=4, experts_offset=0)
    if cfg.encoder_layers:
        updates.update(encoder_layers=2)
    if cfg.frontend:
        updates.update(frontend_tokens=8)
    if cfg.ssm_kind:
        updates.update(ssm_state=min(cfg.ssm_state or 8, 8), ssm_expand=2, head_dim=32)
    if cfg.global_layers:
        updates.update(global_layers=(0,), sliding_window=min(cfg.sliding_window or 64, 64))
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **updates)
