"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1]."""
import dataclasses
from repro_torch.models.config import ModelConfig, ATTN_MOE

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    block_pattern=(ATTN_MOE,),
    n_experts=8,
    top_k_experts=2,
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512, n_experts=4, top_k_experts=2, remat=False,
        attn_q_chunk=64, attn_kv_chunk=64)
