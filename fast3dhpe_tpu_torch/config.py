"""The part of the YAML config (the reference schema, as read by
fast3dhpe_tpu/config.py) that the model, the inferencer, the input
pipeline, the loaders, the train steps and loops read: MODEL.NAME / TYPE /
PRETRAINED / IMAGE_SIZE / NUM_JOINTS / NUM_LAYERS, MODEL.EXTRA.SIGMA /
HEATMAP_SIZE / DLT_METHOD / VOLUME_SIZE,
DATASET.TYPE / ROOT / TRAIN_SET / TEST_SET / FLIP / ROT_FACTOR /
SCALE_FACTOR / OCCLUSION / CACHE_BYTES / DEVICE_CACHE_BYTES,
TRAIN.BATCH_SIZE / WARMUP / EPOCH / LR / LR_STEP / LR_FACTOR /
LOSS_3D_WEIGHT, TEST.BATCH_SIZE and LOSS.USE_TARGET_WEIGHT / TYPE. Other
keys are accepted and ignored.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

import yaml


@dataclass
class ExtraConfig:
    SIGMA: int = 3           # gaussian target sigma, in heatmap pixels
    HEATMAP_SIZE: List[int] = field(default_factory=lambda: [64, 64])
    DLT_METHOD: str = "jacobi"
    VOLUME_SIZE: int = 64    # the volumetric model's voxels a side


@dataclass
class ModelConfig:
    NAME: str = "model"
    TYPE: str = "cdrnet"     # the stereo model: "cdrnet" | "volumetric"
    PRETRAINED: str = ""     # a .pth whose encoder the training loops take
    IMAGE_SIZE: List[int] = field(default_factory=lambda: [256, 256])
    NUM_JOINTS: int = 19
    NUM_LAYERS: int = 101
    EXTRA: ExtraConfig = field(default_factory=ExtraConfig)


@dataclass
class DatasetConfig:
    TYPE: str = "MADS_3d"              # "MADS_3d" | "MADS_2d" | "MPII"
    ROOT: str = "data/MADS_extract"
    TEST_SET: str = "valid"
    TRAIN_SET: str = "train"
    FLIP: bool = True
    ROT_FACTOR: float = 30
    SCALE_FACTOR: float = 0.25
    OCCLUSION: Optional[str] = None    # None | "None" | "CUTOUT" | "HNS"
    CACHE_BYTES: int = 0               # budget of the host RAM frame cache
    DEVICE_CACHE_BYTES: int = 0        # budget of the device frame cache


@dataclass
class TrainConfig:
    BATCH_SIZE: int = 32
    WARMUP: int = 0          # 2D-only warmup epochs of the CDR loop
    EPOCH: int = 50
    LR: float = 1e-4
    LR_STEP: List[int] = field(default_factory=lambda: [40])
    LR_FACTOR: float = 0.1
    LOSS_3D_WEIGHT: float = 4.0


@dataclass
class TestConfig:
    BATCH_SIZE: int = 32


@dataclass
class LossConfig:
    USE_TARGET_WEIGHT: bool = True
    TYPE: str = "JointsMSE"  # "JointsMSE" | "JointsMSESmooth" | "MPJPE"


@dataclass
class Config:
    MODEL: ModelConfig = field(default_factory=ModelConfig)
    DATASET: DatasetConfig = field(default_factory=DatasetConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    LOSS: LossConfig = field(default_factory=LossConfig)


def _pick(cls, data):
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in (data or {}).items() if k in names}


def config_from_dict(data: dict) -> Config:
    data = data or {}
    model = _pick(ModelConfig, data.get("MODEL"))
    model["EXTRA"] = ExtraConfig(**_pick(ExtraConfig, model.get("EXTRA")))
    cfg = Config(
        MODEL=ModelConfig(**model),
        DATASET=DatasetConfig(**_pick(DatasetConfig, data.get("DATASET"))),
        TRAIN=TrainConfig(**_pick(TrainConfig, data.get("TRAIN"))),
        TEST=TestConfig(**_pick(TestConfig, data.get("TEST"))),
        LOSS=LossConfig(**_pick(LossConfig, data.get("LOSS"))))
    if cfg.LOSS.TYPE not in ("JointsMSE", "JointsMSESmooth", "MPJPE"):
        raise ValueError(f"Unknown LOSS.TYPE {cfg.LOSS.TYPE}")
    if cfg.MODEL.NUM_LAYERS not in (18, 34, 50, 101, 152):
        raise ValueError(f"NUM_LAYERS must be a ResNet depth, got "
                         f"{cfg.MODEL.NUM_LAYERS}")
    if cfg.MODEL.EXTRA.DLT_METHOD not in ("jacobi", "svd", "sii"):
        raise ValueError(f"Unknown MODEL.EXTRA.DLT_METHOD "
                         f"{cfg.MODEL.EXTRA.DLT_METHOD!r}")
    if cfg.MODEL.TYPE not in ("cdrnet", "volumetric"):
        raise ValueError(f"Unknown MODEL.TYPE {cfg.MODEL.TYPE!r}")
    if cfg.DATASET.OCCLUSION not in (None, "None", "CUTOUT", "HNS"):
        raise ValueError(f"Unknown DATASET.OCCLUSION "
                         f"{cfg.DATASET.OCCLUSION!r}")
    return cfg


def load_config(path: str) -> Config:
    with open(path, "r") as f:
        return config_from_dict(yaml.safe_load(f))
