"""llama-3.2-vision-11b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision].  The vision encoder is a STUB per the
assignment: input_specs() provides precomputed patch embeddings
(batch, vision_tokens, d_model); the text backbone with gated cross-attn
every 5th layer is real.
"""
import dataclasses
from repro_torch.models.config import ModelConfig, ATTN, CROSS

_PATTERN = (ATTN, ATTN, ATTN, ATTN, CROSS)

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    block_pattern=_PATTERN,
    vision_tokens=1024,
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=5, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512, vision_tokens=16, remat=False,
        attn_q_chunk=64, attn_kv_chunk=64)
