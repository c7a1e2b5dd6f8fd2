"""Architecture registry of the port: the dense GQA decoders (gemma2's
local/global windows, softcaps and sandwich norms among them), MLA
(minicpm3) and the pure Mamba-1 falcon-mamba. `get_config(name)` is the
published config, `get_smoke(name)` the reduced same-family config the CPU
tests use. The other five archs of `repro.configs` (MoE, the jamba hybrid,
encoder-decoder, vision) are not ported yet (ROADMAP.md queue 1, item 7)."""

from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = ("h2o_danube_1_8b", "nemotron_4_340b", "falcon_mamba_7b",
            "gemma2_27b", "minicpm3_4b")
ALIASES = {"h2o-danube-1.8b": "h2o_danube_1_8b",
           "nemotron-4-340b": "nemotron_4_340b",
           "falcon-mamba-7b": "falcon_mamba_7b",
           "gemma2-27b": "gemma2_27b",
           "minicpm3-4b": "minicpm3_4b"}


def _module(name: str):
    mod = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod not in ARCH_IDS:
        raise NotImplementedError(
            f"arch '{name}' is not ported yet (ROADMAP.md queue 1, item 7); "
            f"ported: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str, **overrides):
    cfg = _module(name).CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke(name: str, **overrides):
    cfg = _module(name).smoke_config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
