"""Mamba2-2.7B [arXiv:2405.21060; unverified]. SSD, attention-free."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=128,
)
