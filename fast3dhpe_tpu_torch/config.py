"""The part of the YAML config (the reference schema, as read by
fast3dhpe_tpu/config.py) that the model and the inferencer read:
MODEL.NAME / IMAGE_SIZE / NUM_JOINTS / NUM_LAYERS and
MODEL.EXTRA.HEATMAP_SIZE / DLT_METHOD. Other keys are accepted and ignored.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List

import yaml


@dataclass
class ExtraConfig:
    HEATMAP_SIZE: List[int] = field(default_factory=lambda: [64, 64])
    DLT_METHOD: str = "jacobi"


@dataclass
class ModelConfig:
    NAME: str = "model"
    IMAGE_SIZE: List[int] = field(default_factory=lambda: [256, 256])
    NUM_JOINTS: int = 19
    NUM_LAYERS: int = 101
    EXTRA: ExtraConfig = field(default_factory=ExtraConfig)


@dataclass
class Config:
    MODEL: ModelConfig = field(default_factory=ModelConfig)


def _pick(cls, data):
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in (data or {}).items() if k in names}


def config_from_dict(data: dict) -> Config:
    model = _pick(ModelConfig, (data or {}).get("MODEL"))
    model["EXTRA"] = ExtraConfig(**_pick(ExtraConfig, model.get("EXTRA")))
    cfg = Config(MODEL=ModelConfig(**model))
    if cfg.MODEL.NUM_LAYERS not in (18, 34, 50, 101, 152):
        raise ValueError(f"NUM_LAYERS must be a ResNet depth, got "
                         f"{cfg.MODEL.NUM_LAYERS}")
    if cfg.MODEL.EXTRA.DLT_METHOD not in ("jacobi", "svd", "sii"):
        raise ValueError(f"Unknown MODEL.EXTRA.DLT_METHOD "
                         f"{cfg.MODEL.EXTRA.DLT_METHOD!r}")
    return cfg


def load_config(path: str) -> Config:
    with open(path, "r") as f:
        return config_from_dict(yaml.safe_load(f))
