"""Constants and configuration.

Copies of the JAX package's ``config.py`` constants and dataclass tree,
held to the originals by exact-equality tests (``Config().to_dict()`` is
the JAX package's, key for key). The port keeps its own copy so that it
loads nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Mapping

#: Per-pyramid-level patch edge length in pixels; all four levels cover the
#: same physical field of view at four magnifications.
PATCH_SIZES: dict[int, int] = {0: 1792, 1: 896, 2: 448, 3: 224}

#: Patches are skipped as background when their mean RGB exceeds this.
TISSUE_MEAN_RGB_THRESHOLD: float = 240.0

#: Pad-to-grid fill value: white.
PAD_FILL_VALUE: int = 255

#: Default emission floor (probability space) for the detection CSV. The
#: FROC consumer sweeps thresholds itself, so a low floor only adds
#: operating points at the high-FP end of the curve.
DETECTION_PROB_THRESHOLD: float = 0.05

#: ImageNet normalization of every classifier input.
IMAGENET_MEAN: tuple[float, float, float] = (0.485, 0.456, 0.406)
IMAGENET_STD: tuple[float, float, float] = (0.229, 0.224, 0.225)

#: Default model artifact directory (the JAX CLI's ``Config.models_dir``).
MODELS_DIR: str = "models_out"

#: Model input resolution (the JAX package's ``INPUT_SIZE``).
INPUT_SIZE: int = 224

#: Global batch size (the JAX package's ``BATCH_SIZE``).
BATCH_SIZE: int = 512

#: FROC evaluation constants: masks at level 5, 0.243 µm a level-0 pixel,
#: annotations expanded by 75 µm, isolated tumor cells below 275 µm.
EVALUATION_MASK_LEVEL: int = 5
L0_RESOLUTION_UM_PER_PX: float = 0.243
FROC_ANNOTATION_EXPANSION_UM: float = 75.0
FROC_ITC_THRESHOLD_UM: float = 275.0

#: CAMELYON16 download source (``io/download.py``).
CAMELYON16_BASE_URL: str = (
    "https://s3.ap-northeast-1.wasabisys.com/gigadb-datasets/live/pub/"
    "10.5524/100001_101000/100439/"
)

#: Files of each category that ``--download --remote`` fetches.
SUBSET_LIMITS: dict[str, int] = {
    "train_normal": 50,
    "train_tumor": 110,
    "test_images": 30,
}


@dataclasses.dataclass
class DataConfig:
    """Paths and dataset layout."""

    data_dir: str = "data"
    train_img_subdir: str = os.path.join("train", "img")
    test_img_subdir: str = os.path.join("test", "img")
    annotations_subdir: str = "annotations"
    patches_subdir: str = "patches"
    features_subdir: str = "features"
    #: "png" = one PNG per patch; "packed" = memmapped uint8 store + manifest
    #: (the CLI's ``--store``)
    patch_store_format: str = "packed"
    #: Macenko stain normalization of the stored patches at extraction
    #: (``--stain_norm``; ``data/stain.py``)
    stain_norm: bool = False
    #: slide-level train/val split: sklearn's ``test_size`` and
    #: ``random_state``; the seed of the validation set's class balancing
    val_fraction: float = 0.2
    split_seed: int = 42
    balance_val_seed: int = 42
    #: patches a class (kept for the JAX package's config; nothing reads it)
    max_samples_per_class: int = 7480

    @property
    def train_img_dir(self) -> str:
        return os.path.join(self.data_dir, self.train_img_subdir)

    @property
    def test_img_dir(self) -> str:
        return os.path.join(self.data_dir, self.test_img_subdir)

    @property
    def annotations_dir(self) -> str:
        return os.path.join(self.data_dir, self.annotations_subdir)

    @property
    def patches_dir(self) -> str:
        return os.path.join(self.data_dir, self.patches_subdir)

    @property
    def features_dir(self) -> str:
        return os.path.join(self.data_dir, self.features_subdir)

    def patch_level_dir(self, level: int) -> str:
        return os.path.join(self.patches_dir, f"level_{level}")


@dataclasses.dataclass
class ModelConfig:
    """ResNet18 patch classifier: every field and default of the JAX
    package's ``ModelConfig``."""

    num_classes: int = 2
    feature_dim: int = 512
    #: parameter dtype; compute runs in ``compute_dtype``
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    #: start from torchvision's ImageNet weights when the file is on disk
    #: (``models/torch_import.py``); He init otherwise
    pretrained: bool = True


@dataclasses.dataclass
class TrainConfig:
    """Patch-classifier training: every field and default of the JAX
    package's ``TrainConfig``."""

    epochs: int = 30
    learning_rate: float = 1e-4
    batch_size: int = BATCH_SIZE
    checkpoint_every_epochs: int = 10
    strategy_epochs: int = 5  # the strategy trainer's
    log_every_steps: int = 50
    seed: int = 0
    #: fine-tune with frozen BatchNorm statistics (γ and β still train);
    #: the CLI's ``--freeze_bn``
    freeze_bn: bool = False


@dataclasses.dataclass
class SimCLRConfig:
    """SimCLR pretraining: every field and default of the JAX package's
    ``SimCLRConfig``."""

    epochs: int = 200
    batch_size: int = BATCH_SIZE
    learning_rate: float = 1e-3
    temperature: float = 0.5
    projection_dim: int = 128  # 512 -> 512 -> 128
    projection_hidden_dim: int = 512
    early_stop_patience: int = 20
    early_stop_check_every: int = 20
    checkpoint_every_epochs: int = 50
    seed: int = 0
    #: "xla": the dense loss (``models/simclr.py::nt_xent_loss``), the
    #: default; "pallas": the streaming loss, which here runs the hand-written
    #: CUDA kernels (``ops/nt_xent.py``). The JAX spellings stay, so a config
    #: means the same to both packages.
    loss_impl: str = "xla"


@dataclasses.dataclass
class MILConfig:
    """Attention-MIL bag classifier: every field and default of the JAX
    package's ``MILConfig``."""

    input_dim: int = 512
    attention_hidden_dim: int = 128
    head_hidden_dim: int = 128
    num_classes: int = 2
    pooling: str = "attention"  # attention | mean | max
    #: head dropout; also the MC-dropout noise rate
    dropout_rate: float = 0.25
    #: bags are padded with a mask to this size (longer ones are cut)
    max_bag_size: int = 4096
    #: bags with >= this many instances pool through the streaming kernel
    #: at inference (``ops/mil_pool.py``); smaller ones through the module
    streaming_bag_threshold: int = 4096
    learning_rate: float = 1e-3
    epochs: int = 20


@dataclasses.dataclass
class UncertaintyConfig:
    """Uncertainty estimation: every field and default of the JAX package's
    ``UncertaintyConfig``."""

    softmax_threshold: float = 0.7
    monte_carlo_samples: int = 100


@dataclasses.dataclass
class MeshConfig:
    """The JAX package's device-mesh section, carried so that a config
    JSON means the same to both packages; nothing in either reads it (the
    port's layouts come from ``torchrun`` and ``--group_size``)."""

    #: data-parallel axis name
    data_axis: str = "data"
    #: number of devices; None = all visible
    num_devices: int | None = None


@dataclasses.dataclass
class Config:
    """The whole configuration: one section a subsystem."""

    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    simclr: SimCLRConfig = dataclasses.field(default_factory=SimCLRConfig)
    mil: MILConfig = dataclasses.field(default_factory=MILConfig)
    uncertainty: UncertaintyConfig = dataclasses.field(
        default_factory=UncertaintyConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    models_dir: str = MODELS_DIR
    #: where the trainers write their per-epoch history JSON
    log_dir: str = "logs"

    def replace(self, **updates: Any) -> "Config":
        return dataclasses.replace(self, **updates)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Config":
        """A config from a (JSON) mapping as the JAX package's
        ``Config.from_dict`` builds it: nested sections by name, keys that
        are no field skipped."""
        def _build(dc_type, values):
            fields = {f.name for f in dataclasses.fields(dc_type)}
            kwargs = {}
            for key, val in values.items():
                if key not in fields:
                    continue
                sub = _FIELD_TYPES.get((dc_type.__name__, key))
                kwargs[key] = _build(sub, val) if sub else val
            return dc_type(**kwargs)

        return _build(cls, dict(d))

    def print_config(self) -> None:
        print(self.to_json())


_FIELD_TYPES = {
    ("Config", "data"): DataConfig,
    ("Config", "model"): ModelConfig,
    ("Config", "train"): TrainConfig,
    ("Config", "simclr"): SimCLRConfig,
    ("Config", "mil"): MILConfig,
    ("Config", "uncertainty"): UncertaintyConfig,
    ("Config", "mesh"): MeshConfig,
}

_default_config: Config | None = None


def get_config() -> Config:
    """One process-wide default :class:`Config`, made at the first call."""
    global _default_config
    if _default_config is None:
        _default_config = Config()
    return _default_config
