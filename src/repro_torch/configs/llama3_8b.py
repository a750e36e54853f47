"""llama3-8b [dense] — GQA, 128k vocab [arXiv:2407.21783]."""
import dataclasses
from repro_torch.models.config import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    block_pattern=(ATTN,),
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512, remat=False, attn_q_chunk=64, attn_kv_chunk=64)
