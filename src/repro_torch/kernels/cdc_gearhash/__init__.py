from repro_torch.kernels.cdc_gearhash.ops import boundary_bitmap, gearhash

__all__ = ["gearhash", "boundary_bitmap"]
