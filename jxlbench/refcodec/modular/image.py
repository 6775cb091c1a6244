"""Modular image: int32 multi-channel image with per-channel shifts.

Mirrors lib/jxl/modular/modular_image.h. Channels are NumPy int32 arrays;
hshift/vshift track downsampling from transforms (Squeeze) or chroma.
"""

from __future__ import annotations

import numpy as np


class Channel:
    __slots__ = ("data", "hshift", "vshift")

    def __init__(self, w: int, h: int, hshift: int = 0, vshift: int = 0,
                 data: np.ndarray = None):
        if data is not None:
            self.data = data
        else:
            self.data = np.zeros((h, w), dtype=np.int32)
        self.hshift = hshift
        self.vshift = vshift

    @property
    def w(self) -> int:
        return self.data.shape[1]

    @property
    def h(self) -> int:
        return self.data.shape[0]

    def copy(self) -> "Channel":
        return Channel(self.w, self.h, self.hshift, self.vshift,
                       self.data.copy())

    def __repr__(self):
        return f"Channel({self.w}x{self.h}, shift=({self.hshift},{self.vshift}))"


class ModularImage:
    """A stack of channels; first nb_meta_channels are metadata (e.g. palette).

    w, h are the nominal image size (modular_image.h Image)."""

    def __init__(self, w: int, h: int, bitdepth: int = 8, nb_channels: int = 0):
        self.w = w
        self.h = h
        self.bitdepth = bitdepth
        self.nb_meta_channels = 0
        self.channel = [Channel(w, h) for _ in range(nb_channels)]

    def __repr__(self):
        return (f"ModularImage({self.w}x{self.h}, bitdepth={self.bitdepth}, "
                f"meta={self.nb_meta_channels}, channels={self.channel})")
