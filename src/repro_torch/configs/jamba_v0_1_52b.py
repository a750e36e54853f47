"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887].  Block pattern of 8 layers: attention at position 4,
Mamba elsewhere; MoE on every other layer (odd positions).  Runs the
long_500k cell (KV cache only at 4/32 layers).
"""
import dataclasses
from repro_torch.models.config import (ModelConfig, ATTN_MOE, MAMBA, MAMBA_MOE)

_PATTERN = (
    MAMBA, MAMBA_MOE, MAMBA, MAMBA_MOE,
    ATTN_MOE, MAMBA_MOE, MAMBA, MAMBA_MOE,
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=_PATTERN,
    n_experts=16,
    top_k_experts=2,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=8, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512, n_experts=4, top_k_experts=2, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=32, remat=False,
        attn_q_chunk=64, attn_kv_chunk=64)
