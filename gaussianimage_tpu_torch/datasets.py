"""Dataset iteration (NumPy only; counterpart of gaussianimage_tpu/
datasets.py:16-81) — the reference's per-dataset path logic (train.py:356-389:
kodak 24 images, kodak_small 1, test 2, DIV2K_valid_LRX2 100 images with ids
801-900), the in-repo ``photos`` / ``photos_native`` photographs, and a
``synthetic`` dataset that needs no files on disk (deterministic procedural
images, utils/image_io.py).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Tuple

import numpy as np

from gaussianimage_tpu_torch.utils.image_io import image_path_to_array, synthetic_image

DATASET_SPECS = {
    "kodak": (24, 0),
    "kodak_small": (1, 0),
    "test": (2, 0),
    "DIV2K_valid_LRX2": (100, 800),
    "synthetic": (2, 0),
    "synthetic_large": (24, 0),
    # real photographs committed in-repo (sklearn's bundled china/flower
    # sample photos, 1.5:1 aspect like Kodak, bicubic-resized to 768x512) —
    # the kodim01 north-star proxy for this zero-egress environment
    "photos": (2, 0),
    "photos_native": (2, 0),  # same photos at their native 640x427
}

_PHOTO_NAMES = ("china", "flower")
_REPO_DATA = Path(__file__).resolve().parent.parent / "data"


def dataset_image_name(data_name: str, i: int) -> str:
    if data_name in ("kodak", "kodak_small"):
        return f"kodim{i + 1:02}"
    if data_name == "DIV2K_valid_LRX2":
        return f"{i + 1:04}x2"
    if data_name == "test":
        return f"test{i + 1:02}"
    if data_name.startswith("synthetic"):
        return f"synth{i + 1:02}"
    if data_name.startswith("photos"):
        return _PHOTO_NAMES[i]
    raise ValueError(f"unknown dataset {data_name}")


def iterate_dataset(
    data_name: str, dataset_dir: str, image_hw: Tuple[int, int] = (512, 768)
) -> Iterator[Tuple[str, np.ndarray]]:
    """Yields (image_name, [1, 3, H, W] float32 array)."""
    if data_name not in DATASET_SPECS:
        raise ValueError(
            f"unknown dataset {data_name}; options: {sorted(DATASET_SPECS)}")
    length, start = DATASET_SPECS[data_name]
    for i in range(start, start + length):
        name = dataset_image_name(data_name, i)
        if data_name.startswith("synthetic"):
            yield name, synthetic_image(*image_hw, seed=i)
            continue
        if data_name.startswith("photos"):
            size = "640x427" if data_name == "photos_native" else "768x512"
            yield name, image_path_to_array(
                _REPO_DATA / f"{_PHOTO_NAMES[i]}_{size}.png")
            continue
        if data_name in ("kodak", "kodak_small"):
            path = Path(dataset_dir) / f"kodim{i + 1:02}.png"
        elif data_name == "DIV2K_valid_LRX2":
            path = Path(dataset_dir) / f"{i + 1:04}x2.png"
        else:
            path = Path(dataset_dir) / f"test{i + 1:02}.png"
        yield name, image_path_to_array(path)
