"""The LM stack of the port: the dense family (``lm.LM``), its layer library
(``layers``), construction and inputs (``registry``), the carrying over of
parameter trees from numpy (``convert``) and the mesh context and sharding
specs (``sharding``).

Parameters are nested dicts of tensors with the reference's names, stacked
layers included, so that the reference's weights load unchanged.
"""
from repro_torch.models.registry import build_model

__all__ = ["build_model"]
