"""Host-side train-time transforms: a copy of
``deep_prob_feature_track_tpu/data/transforms.py``, drawing from the same
``np.random.RandomState`` stream.

The reference's train transform intends gamma/brightness/per-channel color
jitter in [0.9, 1.1] with p=0.5 (code/data/dataloader.py:135-161), but its
implementation rebinds the loop variable before mutating, so it is
effectively a no-op on the returned images.  This is the working version of
the intended augmentation, applied identically to both views of a pair.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class ColorAugment:
    def __init__(
        self,
        gamma=(0.9, 1.1),
        brightness=(0.9, 1.1),
        color=(0.9, 1.1),
        prob: float = 0.5,
        seed: Optional[int] = None,
    ):
        self.gamma = gamma
        self.brightness = brightness
        self.color = color
        self.prob = prob
        self.rng = np.random.RandomState(seed)

    def __call__(self, images: List[np.ndarray]) -> List[np.ndarray]:
        """:param images: list of [H,W,3] float arrays in [0,1] (one pair)"""
        if self.rng.uniform() > self.prob:  # augment with probability `prob`
            return images
        g = self.rng.uniform(*self.gamma)
        b = self.rng.uniform(*self.brightness)
        c = self.rng.uniform(*self.color, size=3).astype(np.float32)
        out = []
        for x in images:
            y = np.power(x, g) * b * c[None, None, :]
            out.append(np.clip(y, 0.0, 1.0).astype(np.float32))
        return out
