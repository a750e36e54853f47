"""mamba2-780m [ssm] — SSD state-space duality [arXiv:2405.21060].

48L d_model=1536, attention-free (d_ff=0: pure Mamba-2 stack), vocab 50280,
ssm_state=128.  Runs the long_500k cell (O(1) decode state).
"""
import dataclasses
from repro_torch.models.config import ModelConfig, MAMBA

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=24,          # unused (attention-free); kept for config parity
    n_kv_heads=24,
    d_ff=0,
    vocab_size=50280,
    block_pattern=(MAMBA,),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    tie_embeddings=True,
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
        vocab_size=512, ssm_state=16, ssm_head_dim=16, ssm_chunk=32,
        remat=False)
