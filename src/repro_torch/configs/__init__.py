"""Configurations of the port (copies of the reference's, not imports).

Architecture registry: --arch <id> resolves here, as in
`repro/configs/__init__.py`.  The files are shapes only, so nothing needs
downloading.
"""

from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "minitron-8b": "minitron_8b",
    "stablelm-12b": "stablelm_12b",
    "stablelm-3b": "stablelm_3b",
    "internlm2-1.8b": "internlm2_1_8b",
    "musicgen-medium": "musicgen_medium",
    "jamba-v0.1-52b": "jamba_52b",
    "dbrx-132b": "dbrx_132b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "xlstm-125m": "xlstm_125m",
    "internvl2-1b": "internvl2_1b",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def _module(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE


def long_context_mode(name: str) -> str:
    """'native' | 'retrieval' | 'skip' — how this arch serves long_500k."""
    return _module(name).LONG_CONTEXT
