"""Host-side image IO and deterministic synthetic test images (NumPy only;
a copy of gaussianimage_tpu/utils/image_io.py so the port imports nothing
of the JAX package).

``image_path_to_array`` mirrors the reference's PIL->tensor load
(train.py:272-276) and returns a [1, 3, H, W] float32 numpy array (NCHW,
values in [0, 1]); the trainer copies it to the device once.
``synthetic_image`` generates a photo-like deterministic test image so runs
need no dataset on disk.
"""

from __future__ import annotations

import numpy as np


def image_path_to_array(image_path) -> np.ndarray:
    from PIL import Image

    img = Image.open(image_path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    arr = np.asarray(img, dtype=np.float32) / 255.0  # [H, W, 3]
    return np.transpose(arr, (2, 0, 1))[None]  # [1, 3, H, W]


def save_image_array(arr: np.ndarray, path) -> None:
    """arr: [3, H, W] or [1, 3, H, W] float in [0, 1]."""
    from PIL import Image

    if arr.ndim == 4:
        arr = arr[0]
    img = np.clip(np.transpose(arr, (1, 2, 0)) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    Image.fromarray(img).save(str(path))


def synthetic_image(H: int = 512, W: int = 768, seed: int = 0) -> np.ndarray:
    """Deterministic natural-image-like test target, [1, 3, H, W] in [0, 1].

    Band-limited multi-scale noise plus smooth gradients and a few hard edges —
    enough structure (smooth regions, texture, edges) to exercise a fitter the
    way a Kodak photo does.
    """
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    ys, xs = ys / H, xs / W

    img = np.zeros((H, W, 3), np.float32)
    # smooth base gradients per channel
    for c in range(3):
        a, b, ph = rng.uniform(0.2, 0.8), rng.uniform(0.5, 2.5, 2), rng.uniform(0, 6.28, 2)
        img[..., c] = a + 0.25 * np.sin(2 * np.pi * b[0] * xs + ph[0]) \
                        + 0.25 * np.cos(2 * np.pi * b[1] * ys + ph[1])
    # multi-scale smoothed noise (1/f-ish texture)
    for scale, amp in [(8, 0.20), (32, 0.12), (128, 0.06)]:
        h, w = max(H // scale, 1), max(W // scale, 1)
        noise = rng.standard_normal((h, w, 3)).astype(np.float32)
        # bilinear upsample via np (crude but deterministic and dependency-free)
        yi = np.linspace(0, h - 1, H)
        xi = np.linspace(0, w - 1, W)
        y0 = np.floor(yi).astype(int); x0 = np.floor(xi).astype(int)
        y1 = np.minimum(y0 + 1, h - 1); x1 = np.minimum(x0 + 1, w - 1)
        fy = (yi - y0)[:, None, None]; fx = (xi - x0)[None, :, None]
        up = (noise[y0][:, x0] * (1 - fy) * (1 - fx) + noise[y0][:, x1] * (1 - fy) * fx
              + noise[y1][:, x0] * fy * (1 - fx) + noise[y1][:, x1] * fy * fx)
        img += amp * up
    # a few hard-edged boxes and a disk (edges stress the fitter)
    for _ in range(6):
        y0_, x0_ = rng.integers(0, H // 2), rng.integers(0, W // 2)
        hh, ww = rng.integers(H // 8, H // 3), rng.integers(W // 8, W // 3)
        img[y0_:y0_ + hh, x0_:x0_ + ww] += rng.uniform(-0.3, 0.3, 3).astype(np.float32)
    cy, cx, r = H * 0.6, W * 0.4, min(H, W) * 0.15
    mask = (ys * H - cy) ** 2 + (xs * W - cx) ** 2 < r * r
    img[mask] += np.asarray([0.15, -0.1, 0.2], np.float32)

    img = np.clip(img, 0.0, 1.0)
    return np.transpose(img, (2, 0, 1))[None]
