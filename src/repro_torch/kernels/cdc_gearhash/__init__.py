from repro_torch.kernels.cdc_gearhash.ops import boundary_bitmap, gearhash, gearhash_bitmap

__all__ = ["gearhash", "gearhash_bitmap", "boundary_bitmap"]
