"""Lightweight YAML config system.

JAX replacement for the reference's Hydra/OmegaConf stack (reference
cfgs/*.yaml + ``@hydra.main`` decorators, SURVEY.md §5.6): plain YAML files
under ``bunmpc_tpu/configs/``, loaded into nested dicts with dotted-path CLI
overrides (``key.subkey=value``), plus dataclass hydration. No Slurm launcher
block — device parallelism replaces job farming (SURVEY.md §2.9).
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Any

import yaml

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs")


def load_yaml(name: str, config_dir: str | None = None) -> dict:
    path = name if os.path.exists(name) else os.path.join(config_dir or CONFIG_DIR, f"{name}.yaml")
    with open(path) as fh:
        return yaml.safe_load(fh) or {}


def _parse_value(v: str) -> Any:
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def apply_overrides(cfg: dict, overrides: list[str]) -> dict:
    """Apply ``a.b.c=value`` CLI overrides (Hydra-style)."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must be key=value")
        key, _, val = ov.partition("=")
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(val)
    return cfg


def load_config(name: str, overrides: list[str] | None = None, config_dir: str | None = None) -> dict:
    cfg = load_yaml(name, config_dir)
    if overrides:
        apply_overrides(cfg, overrides)
    return cfg


def hydrate(cls, cfg: dict):
    """Build a dataclass from a dict, ignoring unknown keys."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in cfg.items() if k in names})
