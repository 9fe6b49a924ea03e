"""Architecture registry: ``--arch <id>`` resolution, as in
``repro.configs.registry``: the ten assigned LM archs and the paper's
deepfm-criteo."""

from __future__ import annotations

from importlib import import_module

from ..models.lm import LMConfig

# id -> module name in the JAX package's configs
ARCH_MODULES = {
    "granite-20b": "granite_20b",
    "stablelm-3b": "stablelm_3b",
    "musicgen-large": "musicgen_large",
    "rwkv6-7b": "rwkv6_7b",
    "gemma3-12b": "gemma3_12b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "internvl2-26b": "internvl2_26b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "zamba2-2.7b": "zamba2_2_7b",
    # the paper's own model/dataset config
    "deepfm-criteo": "deepfm_criteo",
}

ASSIGNED_ARCHS = tuple(k for k in ARCH_MODULES if k != "deepfm-criteo")


def get_config(arch: str):
    if arch not in ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch!r}; available: {', '.join(ARCH_MODULES)}"
        )
    mod = import_module(f".{ARCH_MODULES[arch]}", __package__)
    cfg = mod.CONFIG
    if isinstance(cfg, LMConfig):
        cfg.validate()
    return cfg
