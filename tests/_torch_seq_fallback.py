"""The reduced configs that sequence sharding runs in the fallback layouts
over "model" (JAX-free; ``test_torch_mesh_seq_fallback.py`` and
``test_torch_mesh_ref_seq_fallback.py`` share them).

``dataclasses.replace`` overrides of each family's reduced config that do
not divide "model": on model=4, 6 heads on 2 KV heads (1 for gemma3) at
head_dim 16 (head_dim sharded), d_ff 90 (the MLP replicated), d_model 48
for 6 SSM heads (the whole mixer), vocab 257 with d_model 66 (the embedding
and head replicated); on model=2, 3 heads on 1 KV head, d_ff 45, d_model 33
(with vocab 257: the head replicated) or 40 (5 SSM heads). ``MIXED`` keeps
a head_dim-sharded attention beside Megatron-SP's MLP and mixer on
model=2.
"""
ON4 = {"n_heads": 6, "n_kv_heads": 2, "head_dim": 16}
ON2 = {"n_heads": 3, "n_kv_heads": 1, "head_dim": 16}
# family -> overrides
MODEL4 = {"qwen2_0_5b": {**ON4, "d_ff": 90, "vocab": 257, "d_model": 66},
          "gemma3_1b": {"n_heads": 6, "head_dim": 16},
          "mamba2_2_7b": {"d_model": 48},
          "zamba2_7b": {**ON4, "n_layers": 2, "d_model": 48, "d_ff": 90}}
MODEL2 = {"qwen2_0_5b": {**ON2, "d_ff": 45, "vocab": 257, "d_model": 33},
          "gemma3_1b": {"n_heads": 3, "head_dim": 16},
          "mamba2_2_7b": {"d_model": 40, "vocab": 257},
          "zamba2_7b": {**ON2, "n_layers": 2, "d_model": 40, "d_ff": 45}}
MIXED = {"qwen2_0_5b": {**ON2, "vocab": 257},
         "gemma3_1b": {"n_heads": 3, "head_dim": 16},
         "mamba2_2_7b": {"d_model": 40},
         "zamba2_7b": {**ON2, "n_layers": 2}}
