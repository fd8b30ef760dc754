"""Whisper-base [arXiv:2212.04356; unverified]. Enc-dec; conv frontend stub
(input_specs provides frame embeddings at seq_len/2 frames)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="encdec",
    n_layers=6, encoder_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, head_dim=64, rope_style="none", tie_embeddings=True,
)
