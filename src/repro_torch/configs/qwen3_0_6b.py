"""Qwen3-0.6B [hf:Qwen/Qwen3-8B family; hf]. qk_norm, GQA kv=8, hd=128."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=3072,
    vocab=151936, head_dim=128, rope_theta=1e6, qk_norm=True,
    tie_embeddings=True,
)
