"""Assigned architecture configs (the port's own copy of ``repro.configs``).

Every module exports CONFIG (the exact assigned configuration) and the
registry below maps --arch ids to them.  ``reduced(CONFIG)`` gives the
CPU smoke-test variant.  The schema is pure data, so the port keeps a
copy instead of importing the JAX package; the input shapes
(``repro.configs.shapes``) wait for the training slice.
"""

from repro_torch.configs.base import ArchConfig, MoEConfig, MLAConfig, SSMConfig, reduced


def get_config(name: str) -> ArchConfig:
    import importlib
    mod = importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG


ARCH_IDS = [
    "stablelm-1.6b",
    "nemotron-4-15b",
    "gemma3-4b",
    "qwen3-4b",
    "seamless-m4t-medium",
    "internvl2-76b",
    "arctic-480b",
    "deepseek-v3-671b",
    "rwkv6-1.6b",
    "zamba2-7b",
]

__all__ = ["ArchConfig", "MoEConfig", "MLAConfig", "SSMConfig", "reduced",
           "get_config", "ARCH_IDS"]
