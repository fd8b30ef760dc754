"""Fragmented ARES on PyTorch + CUDA (NVIDIA Hopper).

The port of ``repro``'s erasure-coded large-object storage path, CoARESECF:
``DSS(...)`` through ``Session.write/read/stat/recon``, crash, repair and
recon. The control plane (the virtual-time network, its RNG streams, the
wire codec, the protocols) stays numpy so that its traces equal the
reference's; the data plane (RS coding and content-defined chunking) runs
on the device named by ``DSSParams.device`` through two hand-written CUDA
kernels (``repro_torch.kernels``). Results leave the data plane as host
``numpy`` arrays or ``bytes``.

And the serving path of the dense LM family (``repro_torch.models``,
``repro_torch.train.steps``, ``repro_torch.launch.serve``): prefill, whose
attention is the hand-written flash-attention kernel, and greedy decode
over a KV cache.

It depends on torch and numpy alone, and imports nothing of ``repro``.
"""
