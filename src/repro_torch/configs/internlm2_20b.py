"""internlm2-20b [dense] — GQA [arXiv:2403.17297]."""
import dataclasses
from repro_torch.models.config import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    block_pattern=(ATTN,),
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512, remat=False, attn_q_chunk=64, attn_kv_chunk=64)
