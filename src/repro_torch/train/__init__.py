"""Training substrate of the port: the EC checkpoint store
(``checkpoint.ECCheckpointStore``, ``serialize_tree``/``deserialize_tree``
over torch state dicts), the synthetic data pipeline (``data.SyntheticLM``)
and the serving step builders (``steps.make_prefill_step``,
``steps.make_serve_step``). The train step, optimizer, gradient compression
and sharding wait for the training slice (ROADMAP A10)."""
from repro_torch.train.checkpoint import (
    CheckpointStats,
    ECCheckpointStore,
    deserialize_tree,
    serialize_tree,
)
from repro_torch.train.data import DataConfig, SyntheticLM

__all__ = [
    "CheckpointStats",
    "ECCheckpointStore",
    "deserialize_tree",
    "serialize_tree",
    "DataConfig",
    "SyntheticLM",
]
