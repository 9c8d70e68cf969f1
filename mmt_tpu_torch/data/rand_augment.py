"""RandAugment for the training image pipeline.

The port's own copy of ``mmt_tpu/data/rand_augment.py`` (numpy + PIL,
PIL imported at first use).  Parity surface:
``official.vision.image_classification.augment.RandAugment`` as configured
by the reference (``src/data/data_utils.py:125-145``): ``num_layers=1``,
default magnitude 10, with Invert and Cutout removed from the op pool
(color inversion hurts retrieval; cutout can remove the described
object).

Host-side PIL implementation (the reference ran these as TF ops on the
input-pipeline CPU; same place here).  Magnitude semantics follow the
RandAugment paper / TFM implementation: level in [0, 10] scaled per-op.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

_MAX_LEVEL = 10.0


def _to_pil(im: np.ndarray):
    from PIL import Image

    return Image.fromarray(np.clip(im * 255.0, 0, 255).astype(np.uint8))


def _from_pil(img) -> np.ndarray:
    return np.asarray(img, dtype=np.float32) / 255.0


def _enhance(factor_fn):
    def apply(im, level, enhancer):
        img = _to_pil(im)
        return _from_pil(enhancer(img).enhance(factor_fn(level)))

    return apply


def _enhance_factor(level: float) -> float:
    return (level / _MAX_LEVEL) * 1.8 + 0.1


def _rotate(im, level, rng):
    from PIL import Image

    degrees = (level / _MAX_LEVEL) * 30.0
    if rng.random() < 0.5:
        degrees = -degrees
    return _from_pil(_to_pil(im).rotate(degrees, resample=Image.BILINEAR))


def _shear(im, level, rng, axis):
    from PIL import Image

    shear = (level / _MAX_LEVEL) * 0.3
    if rng.random() < 0.5:
        shear = -shear
    matrix = (1, shear, 0, 0, 1, 0) if axis == "x" else (1, 0, 0, shear, 1, 0)
    return _from_pil(
        _to_pil(im).transform(
            _to_pil(im).size, Image.AFFINE, matrix, resample=Image.BILINEAR
        )
    )


def _translate(im, level, rng, axis):
    from PIL import Image

    pixels = (level / _MAX_LEVEL) * 100.0
    if rng.random() < 0.5:
        pixels = -pixels
    matrix = (1, 0, pixels, 0, 1, 0) if axis == "x" else (1, 0, 0, 0, 1, pixels)
    return _from_pil(
        _to_pil(im).transform(
            _to_pil(im).size, Image.AFFINE, matrix, resample=Image.BILINEAR
        )
    )


def build_ops() -> Dict[str, Callable]:
    from PIL import ImageEnhance, ImageOps

    return {
        "AutoContrast": lambda im, lvl, rng: _from_pil(
            ImageOps.autocontrast(_to_pil(im))
        ),
        "Equalize": lambda im, lvl, rng: _from_pil(ImageOps.equalize(_to_pil(im))),
        "Rotate": _rotate,
        "Posterize": lambda im, lvl, rng: _from_pil(
            ImageOps.posterize(_to_pil(im), max(1, 8 - int((lvl / _MAX_LEVEL) * 4)))
        ),
        "Solarize": lambda im, lvl, rng: _from_pil(
            ImageOps.solarize(_to_pil(im), 256 - int((lvl / _MAX_LEVEL) * 256))
        ),
        "SolarizeAdd": lambda im, lvl, rng: _solarize_add(
            im, int((lvl / _MAX_LEVEL) * 110)
        ),
        "Color": lambda im, lvl, rng: _from_pil(
            ImageEnhance.Color(_to_pil(im)).enhance(_enhance_factor(lvl))
        ),
        "Contrast": lambda im, lvl, rng: _from_pil(
            ImageEnhance.Contrast(_to_pil(im)).enhance(_enhance_factor(lvl))
        ),
        "Brightness": lambda im, lvl, rng: _from_pil(
            ImageEnhance.Brightness(_to_pil(im)).enhance(_enhance_factor(lvl))
        ),
        "Sharpness": lambda im, lvl, rng: _from_pil(
            ImageEnhance.Sharpness(_to_pil(im)).enhance(_enhance_factor(lvl))
        ),
        "ShearX": lambda im, lvl, rng: _shear(im, lvl, rng, "x"),
        "ShearY": lambda im, lvl, rng: _shear(im, lvl, rng, "y"),
        "TranslateX": lambda im, lvl, rng: _translate(im, lvl, rng, "x"),
        "TranslateY": lambda im, lvl, rng: _translate(im, lvl, rng, "y"),
    }


def _solarize_add(im: np.ndarray, addition: int, threshold: int = 128) -> np.ndarray:
    arr = np.clip(im * 255.0, 0, 255).astype(np.int32)
    added = np.clip(arr + addition, 0, 255)
    return np.where(arr < threshold, added, arr).astype(np.float32) / 255.0


class RandAugment:
    """num_layers random ops at the given magnitude (reference: 1 layer)."""

    # Reference op pool: Invert and Cutout removed (data_utils.py:128-145).
    OPS: List[str] = [
        "AutoContrast", "Equalize", "Rotate", "Posterize", "Solarize",
        "Color", "Contrast", "Brightness", "Sharpness",
        "ShearX", "ShearY", "TranslateX", "TranslateY", "SolarizeAdd",
    ]

    def __init__(self, num_layers: int = 1, magnitude: float = 10.0):
        self.num_layers = num_layers
        self.magnitude = magnitude
        self._ops = build_ops()

    def __call__(self, im: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """im: <float32>[H, W, 3] in [0, 1] -> augmented, same shape."""
        for _ in range(self.num_layers):
            name = self.OPS[int(rng.integers(0, len(self.OPS)))]
            im = self._ops[name](im, self.magnitude, rng)
        return im
