"""Config system: attribute-dict tree + YAML merge + CLI overrides.

The port's own copy of the JAX package's config module: the same default
tree (key for key, value for value; ``tests/test_torch_guards.py`` holds the
two equal), so the existing ``cfg/*.yml`` files load unchanged. Keys that
only steer the JAX package's layouts (``GAN.S2D``, ``GAN.REMAT``, ...) are
read by nothing in the port; they stay so that a YAML file's type checks
behave the same in both packages. ``MESH`` is read by
``parallel.make_mesh_if_configured``: ``MESH.DATA_AXIS`` names the data axis
and ``MESH.NUM_DEVICES`` (0: every launched rank) must match torchrun's
world size. ``DTYPE.COMPUTE`` and
``TRAIN.MOMENT_DTYPE`` are read through ``device.compute_dtype`` and
``device.moment_dtype``, which take float32 or bfloat16 and raise on
anything else.
"""

from __future__ import annotations

import copy
import io
from typing import Any, Mapping

import yaml


class AttrDict(dict):
    """dict with attribute access, recursive over nested mappings."""

    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if isinstance(v, Mapping) and not isinstance(v, AttrDict):
                self[k] = AttrDict(v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if isinstance(value, Mapping) and not isinstance(value, AttrDict):
            value = AttrDict(value)
        self[name] = value

    def __deepcopy__(self, memo: dict) -> "AttrDict":
        return AttrDict(
            {k: copy.deepcopy(v, memo) for k, v in self.items()}
        )


def default_cfg() -> AttrDict:
    """The full default config tree (StackGAN-v2-lineage key names)."""
    return AttrDict(
        {
            "CONFIG_NAME": "default",
            "DATASET_NAME": "birds",
            "DATA_DIR": "data/birds",
            "OUTPUT_DIR": "output",
            "GPU_ID": "0",
            "WORKERS": 4,
            "SEED": 0,
            "CUDA": False,
            "TREE": {
                # BRANCH_NUM: number of G stages / D scales (1..3).
                "BRANCH_NUM": 3,
                "BASE_SIZE": 64,
            },
            "TRAIN": {
                "FLAG": True,
                "BATCH_SIZE": 24,
                "MAX_EPOCH": 600,
                "SNAPSHOT_INTERVAL": 2000,
                "DISCRIMINATOR_LR": 2.0e-4,
                "GENERATOR_LR": 2.0e-4,
                "OPTIMIZER": "adam",
                "ADAM_BETA1": 0.5,
                "ADAM_BETA2": 0.999,
                "MOMENT_DTYPE": "float32",
                "MOMENT_DTYPE_MIN_SIZE": 262144,
                "NET_G": "",
                "NET_D": "",
                "NET_E": "",
                "B_NET_D": True,
                "COEFF": {
                    "KL": 2.0,
                    "UNCOND_LOSS": 1.0,
                    "COLOR_LOSS": 0.0,
                    "DISTILL": 0.0,
                },
                "WRONG_PAIR": "roll",
                # Joint mode: the GAN state carries the fine-tuned encoder.
                "JOINT_FT": False,
                "DEBUG_NANS": False,
                "PROFILE_DIR": "",
                "TENSORBOARD": False,
                "EMA_G": 0.999,
                "EMA_WARMUP": 0,
            },
            "GAN": {
                "DF_DIM": 64,
                "GF_DIM": 64,
                "Z_DIM": 100,
                "EMBEDDING_DIM": 128,  # CA-net condition dim
                "R_NUM": 2,  # residual blocks per next-stage
                "REMAT": False,
                "REMAT_POLICY": "none",
                # naive: nearest-2x, then the 3x3 conv; every other mode sums
                # the taps into phase kernels first (models/layers.py).
                "UPSAMPLE_MODE": "transpose",
                "D_TRUNK_BATCH": "auto",
                "S2D": "auto",
                "S2D_MID": False,
                "NETWORK_TYPE": "default",
                "B_CONDITION": True,
            },
            "DATA": {
                "PIPELINE": "native",
                "GRAIN_WORKERS": 0,
                "IMAGE_DTYPE": "uint8",
                "SHIP_SCALES": "top",
                "FAST_DECODE": False,
            },
            "TEXT": {
                # Teacher embedding dim == speech-encoder output dim.
                "DIMENSION": 1024,
                "CAPTIONS_PER_IMAGE": 10,
                "EMBEDDING_FILE": "char-CNN-RNN-embeddings.pickle",
            },
            "AUDIO": {
                "SAMPLE_RATE": 16000,
                "WIN_MS": 25.0,
                "HOP_MS": 10.0,
                "N_FFT": 512,
                "N_MELS": 40,
                "FMIN": 0.0,
                "FMAX": 8000.0,
                "HTK_MEL": False,  # False = Slaney-style mel (librosa default)
                "MEL_NORM": "slaney",  # 'slaney' area-norm or 'none'
                "LOG_OFFSET": 1.0e-6,
                "MAX_FRAMES": 1024,  # fixed-length crop/pad target
                "NORMALIZE": "utterance",  # 'utterance' mean-var | 'none'
                "FEATURE": "logmel",  # 'logmel' | 'mfcc'
                "N_MFCC": 40,
                "PREEMPHASIS": 0.0,  # 0 disables
                "CENTER": False,  # frame from sample 0 (no reflect padding)
            },
            "ENCODER": {
                # CNN + bi-GRU + pool + FC.
                "CONV_CHANNELS": [64, 128, 256],
                "CONV_KERNEL": 5,
                "CONV_STRIDE": 2,
                # "SAME" (XLA's asymmetric split) | "torch" (symmetric k//2)
                "CONV_PADDING": "SAME",
                "RNN_HIDDEN": 512,
                "RNN_LAYERS": 1,
                "BIDIRECTIONAL": True,
                "POOL": "mean_max",  # 'mean' | 'max' | 'mean_max'
                "CLS_HEAD": True,  # auxiliary class head (distillation)
                "N_CLASSES": 200,  # CUB-200; 102 for flowers
                "LR": 1.0e-3,
                "BATCH_SIZE": 64,
                "EPOCHS": 100,
                "LOG_EVERY": 50,
                "SNAPSHOT_INTERVAL": 1000,
                "CE_COEFF": 0.1,
                "NORM_OUT": False,  # L2-normalize the embedding
            },
            "EVAL": {
                "NUM_SAMPLES_PER_EMB": 1,
                "IS_SPLITS": 10,
                "FID_BATCH": 64,
                "INCEPTION_WEIGHTS": "",
                "EMA_BN_RECALC": 0,
            },
            "MESH": {
                "DATA_AXIS": "data",
                "NUM_DEVICES": 0,
            },
            "DTYPE": {
                # What the models compute in (float32 or bfloat16); the
                # parameters stay float32 (device.compute_dtype).
                "COMPUTE": "bfloat16",
                "PARAMS": "float32",
            },
        }
    )


def _merge_into(base: AttrDict, other: Mapping) -> None:
    """Recursively merge ``other`` into ``base`` (reference-style merge_cfg).

    Unknown keys are allowed (the reference's easydict also accepted them) but
    type mismatches on known scalar keys raise, to catch YAML typos early.
    """
    for k, v in other.items():
        if k in base and isinstance(base[k], dict) and isinstance(v, Mapping):
            _merge_into(base[k], v)
        else:
            if k in base and not _types_compatible(base[k], v):
                raise TypeError(
                    f"config key {k}: expected {type(base[k]).__name__}, "
                    f"got {type(v).__name__} ({v!r})"
                )
            base[k] = AttrDict(v) if isinstance(v, Mapping) else v


def _types_compatible(old: Any, new: Any) -> bool:
    if old is None or new is None or isinstance(old, dict):
        return True
    # tri-state levers: "auto" default, bool override (and back)
    if "auto" in (old, new) and all(
        isinstance(x, (bool, str)) for x in (old, new)
    ):
        return True
    if isinstance(old, bool) or isinstance(new, bool):
        return isinstance(old, bool) and isinstance(new, bool)
    if type(old) is type(new):
        return True
    # int→float promotion is fine
    return isinstance(old, float) and isinstance(new, int)


def cfg_from_file(path: str, base: AttrDict | None = None) -> AttrDict:
    """Load a YAML file and merge it over the defaults (or ``base``)."""
    out = copy.deepcopy(base) if base is not None else default_cfg()
    with open(path, "r") as f:
        loaded = yaml.safe_load(f)
    if loaded:
        _merge_into(out, loaded)
    return out


def cfg_from_string(text: str, base: AttrDict | None = None) -> AttrDict:
    out = copy.deepcopy(base) if base is not None else default_cfg()
    loaded = yaml.safe_load(io.StringIO(text))
    if loaded:
        _merge_into(out, loaded)
    return out


def apply_overrides(cfg_tree: AttrDict, overrides: list[str]) -> AttrDict:
    """Apply ``KEY.SUBKEY=value`` overrides (values parsed as YAML)."""
    for item in overrides:
        key, _, raw = item.partition("=")
        if not _:
            raise ValueError(f"override {item!r} is not KEY=VALUE")
        node = cfg_tree
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node[p]
        leaf = parts[-1]
        val = yaml.safe_load(raw)
        # same typo guard as the YAML merge path (_merge_into)
        if leaf in node and not _types_compatible(node[leaf], val):
            raise TypeError(
                f"override {key.strip()}: expected "
                f"{type(node[leaf]).__name__}, got {type(val).__name__} "
                f"({val!r})"
            )
        node[leaf] = val
    return cfg_tree


def dump_cfg(cfg_tree: AttrDict, path) -> None:
    """Write the resolved config as YAML (a run dir's ``config.yml``), which
    :func:`cfg_from_file` reads back. ``path``: a filesystem path or an open
    text stream."""
    if hasattr(path, "write"):
        yaml.safe_dump(_to_plain(cfg_tree), path, sort_keys=False)
        return
    with open(path, "w") as f:
        yaml.safe_dump(_to_plain(cfg_tree), f, sort_keys=False)


def _to_plain(tree: Mapping) -> dict:
    return {k: _to_plain(v) if isinstance(v, Mapping) else v for k, v in tree.items()}
