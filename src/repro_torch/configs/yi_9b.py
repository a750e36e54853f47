"""yi-9b [dense] — llama-arch GQA [arXiv:2403.04652]."""
import dataclasses
from repro_torch.models.config import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    block_pattern=(ATTN,),
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512, remat=False, attn_q_chunk=64, attn_kv_chunk=64)
