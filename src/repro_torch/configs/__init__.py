"""Configurations: the storage deployments (``paper_store``) and the model
architectures (``get_arch(<id>)``, one data file per id, the same ids as the
reference's ``--arch``)."""
import importlib

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, shapes_for

_ARCH_IDS = [
    "qwen2_vl_7b", "olmoe_1b_7b", "qwen3_moe_30b_a3b", "gemma3_1b",
    "chatglm3_6b", "qwen3_0_6b", "qwen2_0_5b", "mamba2_2_7b",
    "whisper_base", "zamba2_7b",
]

__all__ = ["SHAPES", "ArchConfig", "ShapeConfig", "all_archs", "get_arch", "shapes_for"]


def get_arch(name: str) -> ArchConfig:
    key = name.replace("-", "_").replace(".", "_")
    if key not in _ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; have {_ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{key}").CONFIG


def all_archs() -> dict[str, ArchConfig]:
    return {a: get_arch(a) for a in _ARCH_IDS}
