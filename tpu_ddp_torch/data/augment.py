"""Train-time augmentation: RandomCrop(32, padding=4) + RandomHorizontalFlip
(reference part1/main.py:23-28), vectorized numpy over the whole batch.
The port's own copy of tpu_ddp/data/augment.py: the same draws from the
same ``numpy.random.Generator`` give bitwise the same crops.
"""

from __future__ import annotations

import numpy as np


def random_crop_flip(
    images_u8: np.ndarray,
    rng: np.random.Generator,
    padding: int = 4,
) -> np.ndarray:
    """Batched random 32x32 crop from zero-padded 40x40 + per-image hflip.

    ``images_u8``: (N, H, W, C) uint8. Returns same shape/dtype.
    """
    n, h, w, c = images_u8.shape
    padded = np.zeros((n, h + 2 * padding, w + 2 * padding, c),
                      dtype=images_u8.dtype)
    padded[:, padding:padding + h, padding:padding + w] = images_u8
    ys = rng.integers(0, 2 * padding + 1, size=n)
    xs = rng.integers(0, 2 * padding + 1, size=n)
    flips = rng.random(n) < 0.5
    rows = ys[:, None] + np.arange(h)[None, :]            # (N, H)
    cols = xs[:, None] + np.arange(w)[None, :]            # (N, W)
    out = padded[np.arange(n)[:, None, None], rows[:, :, None],
                 cols[:, None, :]]                        # (N, H, W, C)
    out[flips] = out[flips, :, ::-1]
    return out
