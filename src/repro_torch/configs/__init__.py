"""Assigned-architecture registry: ``--arch <id>`` resolves here."""
from repro_torch.configs import (dbrx_132b, nemotron_4_15b, phi3_5_moe_42b,
                                 phi3_mini_3_8b, qwen1_5_0_5b, qwen2_vl_2b, rwkv6_7b,
                                 seamless_m4t_medium, smollm_360m, zamba2_7b)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

_MODULES = {
    "nemotron-4-15b": nemotron_4_15b,
    "qwen1.5-0.5b": qwen1_5_0_5b,
    "phi3-mini-3.8b": phi3_mini_3_8b,
    "smollm-360m": smollm_360m,
    "seamless-m4t-medium": seamless_m4t_medium,
    "rwkv6-7b": rwkv6_7b,
    "zamba2-7b": zamba2_7b,
    "qwen2-vl-2b": qwen2_vl_2b,
    "phi3.5-moe-42b-a6.6b": phi3_5_moe_42b,
    "dbrx-132b": dbrx_132b,
}

ARCHS: dict[str, ModelConfig] = {k: m.CONFIG for k, m in _MODULES.items()}
SMOKES: dict[str, ModelConfig] = {k: m.SMOKE for k, m in _MODULES.items()}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    table = SMOKES if smoke else ARCHS
    if arch not in table:
        raise KeyError(f"unknown arch '{arch}'; known: {sorted(table)}")
    return table[arch]


def cells() -> list[tuple[str, str]]:
    """All 40 (arch x shape) dry-run cells, including recorded skips."""
    return [(a, s) for a in ARCHS for s in SHAPES]


__all__ = ["ARCHS", "SHAPES", "SMOKES", "ModelConfig", "ShapeConfig", "cells",
           "get_config"]
