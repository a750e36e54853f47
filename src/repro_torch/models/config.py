"""Model configuration for the assigned architecture pool.

A copy of ``repro.models.config`` (pure Python), kept in the port so that
it imports nothing of the JAX package.  ``remat`` recomputes each repeat
of the pattern in the backward pass when the model trains
(``LanguageModel.forward``); ``scan_layers`` is a dry-run knob that the
port accepts and ignores.

One frozen dataclass covers dense / MoE / SSM / hybrid / audio / vlm
families.  Heterogeneous stacks (jamba, vision) are expressed as a
``block_pattern``: the layer stack is ``n_layers / len(pattern)`` repeats of
the pattern, and the trainer scans over pattern repeats (so each distinct
layer TYPE is stacked and scanned — static shapes, one compile per type).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

# layer kinds usable inside a block pattern
ATTN = "attn"          # self-attention + dense MLP
ATTN_MOE = "attn_moe"  # self-attention + MoE FFN
ATTN_MOE_DENSE = "attn_moe_dense"  # arctic: attention + (dense MLP || MoE)
MAMBA = "mamba"        # Mamba-2 SSD block + dense MLP
MAMBA_MOE = "mamba_moe"
CROSS = "cross"        # self-attn + cross-attn(image) + dense MLP


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    block_pattern: tuple[str, ...] = (ATTN,)
    head_dim: int = 0             # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k_experts: int = 0
    capacity_factor: float = 1.25
    # --- SSM (Mamba-2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    # --- modality stubs ---
    embed_input: bool = True      # False: input_specs provides embeddings
    vision_tokens: int = 0        # >0: cross-attn context length (vlm stub)
    # --- common ---
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- runtime knobs (overridable per run) ---
    remat: bool = True
    scan_layers: bool = True   # False: unroll (dry-run cost probes)
    kv_cache_dtype: str = "bf16"   # "int8": quantized KV cache (§Perf it.8)
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    moe_sharding: str = "tp"      # "tp": d_ff over model axis; "ep": experts
    seq_shard_longctx: bool = True

    def __post_init__(self):
        assert self.n_layers % len(self.block_pattern) == 0, (
            self.name, self.n_layers, self.block_pattern)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def d_inner(self) -> int:      # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return all(k in (MAMBA, MAMBA_MOE) for k in self.block_pattern)

    @property
    def has_attention(self) -> bool:
        return any(k.startswith(("attn", "cross")) for k in self.block_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM or hybrid w/ O(1)-ish KV)."""
        n_attn = sum(1 for k in self.block_pattern if not k.startswith("mamba"))
        return n_attn == 0 or (n_attn / len(self.block_pattern)) <= 0.25

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline terms)."""
        d, dff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        qkv = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
        attn = qkv + (self.n_heads * hd) * d
        mlp = 3 * d * dff
        moe = self.n_experts * 3 * d * dff
        di = self.d_inner
        nh = self.ssm_heads if self.ssm_state else 0
        # in_proj (z,x,B,C,dt) + out_proj + conv + dt/A/D
        mamba = (
            d * (2 * di + 2 * self.ssm_state + nh)
            + di * d
            + self.conv_width * (di + 2 * self.ssm_state)
            + 3 * nh
        ) if self.ssm_state else 0
        total = 0
        for kind in self.block_pattern:
            if kind == ATTN:
                total += attn + mlp
            elif kind == ATTN_MOE:
                total += attn + moe + d * self.n_experts
            elif kind == ATTN_MOE_DENSE:
                total += attn + moe + mlp + d * self.n_experts
            elif kind == MAMBA:
                total += mamba + mlp
            elif kind == MAMBA_MOE:
                total += mamba + moe + d * self.n_experts
            elif kind == CROSS:
                total += 2 * attn + mlp
        total *= self.n_repeats
        total += v * d * (1 if self.tie_embeddings else 2)   # embed + head
        total += self.n_layers * 2 * d + d                   # norms
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE uses top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        d, dff = self.d_model, self.d_ff
        expert = 3 * d * dff
        dead = (self.n_experts - self.top_k_experts) * expert
        n_moe_layers = sum(
            1 for k in self.block_pattern if k.endswith("moe") or k == ATTN_MOE_DENSE
        ) * self.n_repeats
        return self.param_count() - n_moe_layers * dead


def validate(cfg: ModelConfig) -> None:
    assert cfg.d_model % cfg.n_heads == 0 or cfg.head_dim
    if cfg.n_experts:
        assert cfg.top_k_experts > 0
    if any(k.startswith("mamba") for k in cfg.block_pattern):
        assert cfg.ssm_state > 0
    if CROSS in cfg.block_pattern:
        assert cfg.vision_tokens > 0
