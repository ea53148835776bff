"""Arch-id -> ModelConfig registry: the paper's three classifiers and the
LMs the port serves (dense, moe, Mamba2, the Jamba hybrid, whisper's
encoder-decoder and pixtral's vlm) — the reference's registry whole."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.config import ModelConfig

# CLI id -> module name under repro_torch.configs
ARCH_IDS: Dict[str, str] = {
    "fedtest-cnn": "fedtest_cnn",
    "fedtest-cnn-mnist": "fedtest_cnn_mnist",
    "fedtest-mlp-mnist": "fedtest_mlp_mnist",
    "qwen2-0.5b": "qwen2_0p5b",
    "qwen3-1.7b": "qwen3_1p7b",
    "qwen2-72b": "qwen2_72b",
    "qwen1.5-110b": "qwen1p5_110b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "mamba2-2.7b": "mamba2_2p7b",
    "jamba-1.5-large-398b": "jamba_1p5_large_398b",
    "whisper-base": "whisper_base",
    "pixtral-12b": "pixtral_12b",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_IDS[arch_id]}")
    return mod.config()


def list_configs() -> List[str]:
    return sorted(ARCH_IDS)
