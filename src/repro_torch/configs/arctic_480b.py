"""arctic-480b [moe] — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base]."""
import dataclasses
from repro_torch.models.config import ModelConfig, ATTN_MOE_DENSE

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    block_pattern=(ATTN_MOE_DENSE,),
    n_experts=128,
    top_k_experts=2,
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=192,
        vocab_size=512, n_experts=8, top_k_experts=2, remat=False,
        attn_q_chunk=64, attn_kv_chunk=64)
