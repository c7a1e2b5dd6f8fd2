"""Architecture registry of the port: the dense GQA decoders (gemma2's
local/global windows, softcaps and sandwich norms among them), MLA
(minicpm3), mixture-of-experts (deepseek-moe-16b, and deepseek-v2-lite
with MLA), the pure Mamba-1 falcon-mamba, the jamba hybrid (Mamba,
attention and MoE layers), llava-next's Mistral backbone behind the
vision stub and the whisper encoder-decoder behind the audio stub.
`get_config(name)` is the published config, `get_smoke(name)` the reduced
same-family config the CPU tests use."""

from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = ("h2o_danube_1_8b", "nemotron_4_340b", "falcon_mamba_7b",
            "gemma2_27b", "minicpm3_4b", "deepseek_moe_16b",
            "deepseek_v2_lite_16b", "jamba_v0_1_52b",
            "llava_next_mistral_7b", "whisper_large_v3")
ALIASES = {"h2o-danube-1.8b": "h2o_danube_1_8b",
           "nemotron-4-340b": "nemotron_4_340b",
           "falcon-mamba-7b": "falcon_mamba_7b",
           "gemma2-27b": "gemma2_27b",
           "minicpm3-4b": "minicpm3_4b",
           "deepseek-moe-16b": "deepseek_moe_16b",
           "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
           "jamba-v0.1-52b": "jamba_v0_1_52b",
           "llava-next-mistral-7b": "llava_next_mistral_7b",
           "whisper-large-v3": "whisper_large_v3"}


def _module(name: str):
    mod = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod not in ARCH_IDS:
        raise ValueError(f"unknown arch '{name}'; known: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str, **overrides):
    cfg = _module(name).CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke(name: str, **overrides):
    cfg = _module(name).smoke_config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
