"""Training stack of the port: AdamW (``optimizer``; its ZeRO-1 sharded
form ``adamw_update_sharded`` on a mesh), the train, prefill and serve step
builders (``steps.make_train_step``, ``steps.make_prefill_step``,
``steps.make_serve_step``; data-parallel with a ``MeshCtx``, with
``steps.batch_shardings`` and ``steps.training_state_specs``),
error-feedback int8 gradient compression (``compress``), the EC checkpoint
store (``checkpoint.ECCheckpointStore``, ``serialize_tree``/
``deserialize_tree`` over torch state dicts), elastic resizing through it
(``elastic.elastic_resize``, ``elastic.reshard_state``) and the synthetic
data pipeline (``data.SyntheticLM``). The launcher is
``repro_torch.launch.train``."""
from repro_torch.train.checkpoint import (
    CheckpointStats,
    ECCheckpointStore,
    deserialize_tree,
    serialize_tree,
)
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.steps import make_train_step

__all__ = [
    "AdamWConfig",
    "CheckpointStats",
    "DataConfig",
    "ECCheckpointStore",
    "SyntheticLM",
    "adamw_init",
    "adamw_update",
    "deserialize_tree",
    "make_train_step",
    "serialize_tree",
]
