from repro_torch.kernels.gf256_matmul.ops import gf256_matmul, rs_encode_parity

__all__ = ["gf256_matmul", "rs_encode_parity"]
