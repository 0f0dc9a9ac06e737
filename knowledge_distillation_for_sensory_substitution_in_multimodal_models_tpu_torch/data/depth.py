"""Depth -> 3-channel encodings in numpy (jax-free counterpart of the JAX
package's ``data/depth.py``, whose module imports jax at the top).

Bit-exact with the JAX package's ``depth_to_3ch_numpy`` (with and without
``imagenet_bake``) and ``depth_to_gray3_numpy``; the tests hold it so.  This
copy goes away once the reference module imports jax lazily.

Prewitt encoding: normalize raw depth to uint8 [0, 255], run 3x3 Prewitt
Gx/Gy with reflect padding, stack ``[depth_norm, |G| norm, atan2(Gy, Gx)
norm]`` as uint8.  ``imagenet_bake=True`` reproduces the reference eval
path's ImageNet normalization baked into the uint8 image.
"""

from __future__ import annotations

import numpy as np

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

_KX = np.array([[-1, 0, 1], [-1, 0, 1], [-1, 0, 1]], dtype=np.float32)
_KY = np.array([[-1, -1, -1], [0, 0, 0], [1, 1, 1]], dtype=np.float32)


def _safe_normalize(arr: np.ndarray) -> np.ndarray:
    a_min, a_max = arr.min(), arr.max()
    if a_max == a_min:
        a_max = a_min + 1e-6
    return 255.0 * (arr - a_min) / (a_max - a_min)


def _to_uint8_range(depth: np.ndarray) -> np.ndarray:
    d = depth.astype(np.float32)
    d_min, d_max = d.min(), d.max()
    if d_max == d_min:
        d_max = d_min + 1e-6
    return (255.0 * (d - d_min) / (d_max - d_min)).astype(np.uint8)


def _convolve_reflect(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """3x3 true convolution with scipy.ndimage's 'reflect' boundary
    (np.pad mode 'symmetric')."""
    k = kernel[::-1, ::-1]
    padded = np.pad(img, 1, mode="symmetric")
    out = np.zeros_like(img, dtype=np.float32)
    for dy in range(3):
        for dx in range(3):
            out += k[dy, dx] * padded[dy:dy + img.shape[0], dx:dx + img.shape[1]]
    return out


def depth_to_3ch_numpy(depth: np.ndarray, imagenet_bake: bool = False) -> np.ndarray:
    """Raw depth [H, W] -> uint8 [H, W, 3] (depth, gradient magnitude, direction)."""
    depth_norm = _to_uint8_range(depth)
    g = depth_norm.astype(np.float32)
    gx = _convolve_reflect(g, _KX)
    gy = _convolve_reflect(g, _KY)
    gm_norm = _safe_normalize(np.sqrt(gx**2 + gy**2)).astype(np.uint8)
    gtheta_norm = _safe_normalize(np.arctan2(gy, gx)).astype(np.uint8)
    out = np.dstack([depth_norm, gm_norm, gtheta_norm])
    if imagenet_bake:
        f = (out.astype(np.float32) / 255.0 - _IMAGENET_MEAN) / _IMAGENET_STD
        out = np.dstack([_safe_normalize(f[..., c]).astype(np.uint8) for c in range(3)])
    return out


def depth_to_gray3_numpy(depth: np.ndarray) -> np.ndarray:
    """1D-depth variant: normalized grayscale replicated x3."""
    return np.stack([_to_uint8_range(depth)] * 3, axis=-1)
