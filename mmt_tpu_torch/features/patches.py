"""Image patch extraction and normalization, on the host or on the device.

Counterpart of ``mmt_tpu/features/patches.py`` (``normalize_image``,
``extract_patches``): pure functions that take a numpy array (the host
pipeline) or a torch tensor (the encoder's ``images`` input, on the
model's device) and return the same kind; and the masked-patch-prediction
labels (``make_mpp_label_ids``), on numpy (the pretraining loader) or torch.
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


def make_mpp_label_ids(patch_values, patch_size: int, channels: int = 3,
                       max_pixel_val: int = 256, output_channel_bits: int = 3):
    """Masked-patch-prediction class labels from raw (unnormalized) patches.

    As the reference (``src/data/data_utils.py:448-481``): scale [0, 1]
    pixels to [0, max_pixel_val - 1], mean-pool each patch per channel,
    bucketize into ``2**bits`` equal bins and combine the channels
    base-``2**bits``: ``label = sum_c bucket_c * (2**bits)**c``.  A value v
    falls in bucket i iff boundaries[i-1] <= v < boundaries[i] (lower
    inclusive, as ``tf.raw_ops.Bucketize``).

    Args:
      patch_values: <float>[..., N, patch_size**2 * channels] in [0, 1],
        numpy or torch.

    Returns:
      <int32>[..., N] class ids, of the input's kind.
    """
    bin_size = max_pixel_val // (2**output_channel_bits)
    x = patch_values * (max_pixel_val - 1)
    x = x.reshape(*patch_values.shape[:-1], patch_size**2, channels)
    if isinstance(x, torch.Tensor):
        avg = x.mean(dim=-2)  # [..., N, C]
        boundaries = torch.arange(bin_size, max_pixel_val, bin_size, dtype=avg.dtype,
                                  device=avg.device)
        bucket = (avg[..., None] >= boundaries).sum(-1).to(torch.int32)
        base = (2**output_channel_bits) ** torch.arange(channels, dtype=torch.int32,
                                                        device=avg.device)
        return (bucket * base).sum(-1).to(torch.int32)
    # The mean over the middle axis as a product with ones (the JAX
    # package's host path, ~14x its strided reduction; the same sums).
    ones = np.ones((patch_size**2,), dtype=x.dtype)
    avg = np.matmul(ones, x) / (patch_size**2)
    boundaries = np.arange(bin_size, max_pixel_val, bin_size, dtype=avg.dtype)
    # bucket(v) = the number of boundaries <= v.
    bucket = (avg[..., None] >= boundaries).sum(axis=-1).astype(np.int32)
    base = (2**output_channel_bits) ** np.arange(channels, dtype=np.int32)
    return (bucket * base).sum(axis=-1).astype(np.int32)
