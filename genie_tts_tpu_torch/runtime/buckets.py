"""Length bucketing, the same ladders as the JAX package.

Every host->device boundary rounds sequence lengths up to a fixed bucket
ladder; masks inside the models make padded execution equal to
exact-length execution. The port pads to the same buckets as
``genie_tts_tpu``, so both packages see the same shapes and masks for a
given input, and the decode cache lengths stay few.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def pick_bucket(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= length; the largest bucket if none fit (callers
    must truncate — mirrors the reference's implicit max-length behavior)."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def pad_to(arr: np.ndarray, target: int, axis: int = 0, value=0) -> np.ndarray:
    """Right-pad (or truncate) ``arr`` along ``axis`` to ``target``."""
    cur = arr.shape[axis]
    if cur == target:
        return arr
    if cur > target:
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(0, target)
        return arr[tuple(sl)]
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, target - cur)
    return np.pad(arr, widths, constant_values=value)
