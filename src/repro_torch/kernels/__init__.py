"""Hand-written Hopper (sm_90a) CUDA kernels.

- ``gf256_matmul``: the GF(256) matrix product behind every RS encode,
  decode and repair (``repro_torch.erasure.rs``).
- ``cdc_gearhash``: the gear-hash boundary bitmap behind every write's
  content-defined block division (``repro_torch.core.fragment``).
- ``flash_attention``: fused attention with online softmax, the attention
  of every layer of the LM prefill (``repro_torch.models.lm``).

Each kernel package ships ``ops.py`` (the checked wrapper, which launches
the CUDA kernel for a CUDA tensor and counts the launch in ``launches``)
and ``ref.py`` (the plain PyTorch version of the same function, which the
wrapper runs for a CPU tensor). The CUDA sources live in ``repro_torch/csrc``
and are built at first use by ``repro_torch.kernels._build``.
"""
