"""musicgen-medium [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284].  The EnCodec frontend is a STUB per the assignment:
input_specs() provides precomputed frame embeddings (embed_input=False);
the backbone + 2048-way codebook head are real.
"""
import dataclasses
from repro_torch.models.config import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,     # kv=24 -> MHA
    d_ff=6144,
    vocab_size=2048,
    block_pattern=(ATTN,),
    embed_input=False,
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=128, remat=False, attn_q_chunk=64, attn_kv_chunk=64)
