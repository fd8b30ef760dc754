"""Gemma3-1B [hf:google/gemma-3-1b-pt; unverified]. 5:1 local:global,
sliding window 512, 128k-class context, tied embeddings, huge vocab."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, d_ff=6912,
    vocab=262144, head_dim=256, rope_theta=1e6, qk_norm=True,
    sliding_window=512, global_every=6, tie_embeddings=True,
)
