"""Zamba2-7B [arXiv:2411.15242; unverified]. Mamba2 backbone + ONE shared
attention+MLP transformer block applied after every 6 Mamba2 layers
(capacity-faithful approximation of the Zamba2 shared-block scheme)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab=32000, head_dim=112, ssm_state=64, ssm_headdim=64, ssm_expand=2,
    ssm_chunk=128, shared_attn_every=6,
)
