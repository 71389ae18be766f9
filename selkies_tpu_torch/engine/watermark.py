"""Watermark burn-in on the device.

The counterpart of selkies_tpu/engine/watermark.py: a PNG (path in the
``watermark_path`` setting) loads once per session, through PIL, and is
blended into every frame before the encode step by K12
``watermark_blend`` (ops/frames.py), at one of seven anchors of the
visible frame (``watermark_location``).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .._device import resolve_device
from ..ops.frames import watermark_blend
from .readback import upload

logger = logging.getLogger("selkies_tpu_torch.engine.watermark")

# location enum (reference parity): 0 tl, 1 tr, 2 bl, 3 br, 4 center,
# 5 top-center, 6 bottom-right (default)
_MARGIN = 16


def _anchor(loc: int, fw: int, fh: int, ww: int, wh: int) -> tuple[int, int]:
    x_left, x_mid, x_right = _MARGIN, (fw - ww) // 2, fw - ww - _MARGIN
    y_top, y_mid, y_bot = _MARGIN, (fh - wh) // 2, fh - wh - _MARGIN
    table = {0: (y_top, x_left), 1: (y_top, x_right),
             2: (y_bot, x_left), 3: (y_bot, x_right),
             4: (y_mid, x_mid), 5: (y_top, x_mid), 6: (y_bot, x_right)}
    y0, x0 = table.get(loc, table[6])
    return max(0, y0), max(0, x0)


def _read_png(path: str, frame_w: int, frame_h: int) -> np.ndarray:
    """The PNG at ``path`` as (h, w, 4) uint8 RGBA, shrunk to fit a
    quarter of the frame at most."""
    from PIL import Image
    img = Image.open(path).convert("RGBA")
    max_w, max_h = max(frame_w // 4, 8), max(frame_h // 4, 8)
    if img.width > max_w or img.height > max_h:
        img.thumbnail((max_w, max_h))
    return np.asarray(img, np.uint8)


class Watermark:
    """Loaded watermark bound to a frame geometry; ``apply(frame)``.
    ``device`` None means the card (``cuda``; raises without one)."""

    def __init__(self, path: str, location: int, frame_w: int, frame_h: int,
                 device=None):
        self._bind(_read_png(path, frame_w, frame_h), location, frame_w,
                   frame_h, device)

    @classmethod
    def from_rgba(cls, rgba: np.ndarray, location: int, frame_w: int,
                  frame_h: int, device=None) -> "Watermark":
        """A watermark from a decoded (h, w, 4) uint8 RGBA array, taken as
        it is (no resize): what the constructor does after PIL."""
        wm = cls.__new__(cls)
        wm._bind(np.asarray(rgba, np.uint8), location, frame_w, frame_h,
                 device)
        return wm

    def _bind(self, rgba: np.ndarray, location: int, frame_w: int,
              frame_h: int, device) -> None:
        if rgba.ndim != 3 or rgba.shape[2] != 4:
            raise ValueError(f"watermark must be (h, w, 4), got "
                             f"{rgba.shape}")
        self.wh, self.ww = rgba.shape[0], rgba.shape[1]
        device = resolve_device(device)
        # formed in float32 on the host exactly as the reference forms
        # them: float32(A) / 255 rounds once, in float32
        self._rgb = upload(np.ascontiguousarray(
            rgba[..., :3].astype(np.float32)), device)
        self._a = upload(np.ascontiguousarray(
            rgba[..., 3:4].astype(np.float32) / 255.0), device)
        self._y0, self._x0 = _anchor(location, frame_w, frame_h,
                                     self.ww, self.wh)

    def apply(self, frame: torch.Tensor, owned: bool = False
              ) -> torch.Tensor:
        """The stamped frame. ``owned`` means the caller hands ``frame``
        over and it is blended in place; otherwise (a source's cached
        buffer, a caller's array) a copy is stamped and ``frame`` is left
        as it is."""
        return watermark_blend(frame if owned else frame.clone(), self._rgb,
                               self._a, self._y0, self._x0)


def maybe_load(settings, frame_w: int, frame_h: int, device=None):
    """-> Watermark or None. A PNG that is missing or cannot be decoded
    degrades to no watermark with a log; an error putting it on the
    device is raised."""
    path = getattr(settings, "watermark_path", "")
    if not path:
        return None
    try:
        rgba = _read_png(path, frame_w, frame_h)
    except (OSError, ValueError, ImportError) as e:
        logger.warning("watermark %s unusable: %s", path, e)
        return None
    return Watermark.from_rgba(
        rgba, int(getattr(settings, "watermark_location", 6)), frame_w,
        frame_h, device)
