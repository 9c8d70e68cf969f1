"""Image patch extraction and normalization, on the host or on the device.

Counterpart of ``mmt_tpu/features/patches.py`` (``normalize_image``,
``extract_patches``): pure functions that take a numpy array (the host
pipeline) or a torch tensor (the encoder's ``images`` input, on the
model's device) and return the same kind.  The masked-patch-prediction
label math of that module comes with the pretraining loader.
"""

from __future__ import annotations

import numpy as np
import torch

# The reference normalizes by the ImageNet MEAN for both centering and
# scaling (its STD constant is dead code); the default reproduces that
# for weight and activation parity, ``use_std=True`` is the textbook form.
IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)


def normalize_image(image, use_std: bool = False):
    """(im - MEAN) / MEAN (the reference's quirk).

    Args:
      image: <float32>[..., H, W, 3] in [0, 1], numpy or torch.
      use_std: divide by STD instead of MEAN.
    """
    denom_values = IMAGENET_DEFAULT_STD if use_std else IMAGENET_DEFAULT_MEAN
    if isinstance(image, torch.Tensor):
        mean = torch.tensor(IMAGENET_DEFAULT_MEAN, dtype=image.dtype, device=image.device)
        denom = torch.tensor(denom_values, dtype=image.dtype, device=image.device)
        return (image - mean) / denom
    mean = np.asarray(IMAGENET_DEFAULT_MEAN, dtype=image.dtype)
    denom = np.asarray(denom_values, dtype=image.dtype)
    out = np.subtract(image, mean)  # same float ops, no temporaries
    np.true_divide(out, denom, out=out)
    return out


def extract_patches(image, patch_size: int):
    """Non-overlapping patch extraction in raster-scan order: each patch is
    flattened row-major as [py, px, channel], patches ordered row-major
    over the grid.

    Args:
      image: <float>[H, W, C] or [B, H, W, C], numpy or torch; H and W
        must be multiples of ``patch_size``.

    Returns:
      <float>[num_patches, patch_size**2 * C] (or with leading batch dim).
    """
    batched = image.ndim == 4
    if not batched:
        image = image[None]
    b, h, w, c = image.shape
    p = patch_size
    gh, gw = h // p, w // p
    x = image.reshape(b, gh, p, gw, p, c)
    if isinstance(x, torch.Tensor):
        x = x.permute(0, 1, 3, 2, 4, 5)  # [B, gh, gw, p, p, C]
    else:
        x = np.transpose(x, (0, 1, 3, 2, 4, 5))
    x = x.reshape(b, gh * gw, p * p * c)
    return x if batched else x[0]
