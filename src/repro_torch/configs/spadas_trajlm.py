"""spadas-trajlm — paper-native config: a small trajectory LM trained on
z-order-tokenized spatial data curated by the Spadas index (the end-to-end
script examples/train_lm.py).  Vocab = 4^theta Morton cells + specials.
"""
import dataclasses
from repro_torch.models.config import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="spadas-trajlm",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=4160,   # 4^6 cells + 64 specials
    block_pattern=(ATTN,),
    tie_embeddings=True,
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=1088, remat=False, attn_q_chunk=64, attn_kv_chunk=64)
