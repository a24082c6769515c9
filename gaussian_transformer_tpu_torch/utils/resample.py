"""Pillow's ``Image.resize(size)`` in numpy, bit for bit.

The JAX package scales a view with ``pil_image.resize(resolution)``: the
BICUBIC filter (a = -0.5) of Pillow's ``ImagingResample`` in 8-bit fixed
point, with no ``reducing_gap``. This module computes the same bytes
without Pillow, in the same steps:

* per axis, a window of taps around ``center = (x + 0.5) * scale`` with
  ``support = 2 * max(scale, 1)``, its bounds rounded as Pillow rounds them
  (``int(center -/+ support + 0.5)``, clipped to the image);
* the filter's weights summed tap by tap in float64, normalised to sum 1,
  then turned into fixed point with 22 fraction bits, rounded half away
  from zero;
* a horizontal pass into a clipped uint8 image, then a vertical pass; each
  accumulates from ``1 << 21`` and shifts right by 22 with an 8-bit clip.

RGBA (and LA) is resized through premultiplied alpha, as Pillow resizes
it through ``RGBa``/``La`` and converts back. Every step is integer
arithmetic on numpy arrays, one loop over the taps.

The other modes a PNG opens in, as Pillow 12.1.0 resizes them:
* ``I;16`` (16-bit gray, uint16 here): the same taps with the float64
  weights (no fixed point), each output rounded half away from zero, its
  low and high bytes each clipped to 0..255 (``ImagingResample`` on
  ``I;16``: an overshoot above 65535 keeps its low byte), per pass;
* ``1`` and ``P``, for which ``resize`` switches to NEAREST
  (``resize_nearest``): ``ImagingScaleAffine``'s source index
  ``int(x0)`` with ``x0 = scale / 2`` advanced by ``scale`` one output
  column at a time, in float64 as Pillow accumulates it.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2
_A = -0.5  # Pillow's bicubic a


def _bicubic(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    near = ((_A + 2.0) * x - (_A + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * _A
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _weights(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` for one axis: (first tap [out], taps
    used [out], float64 weights [out, ksize] normalised to sum 1)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    ss = 1.0 / filterscale
    w = np.zeros((out_size, ksize))
    ww = np.zeros(out_size)
    for x in range(ksize):  # summed in tap order, as Pillow sums them
        w[:, x] = np.where(x < xmax, _bicubic((x + xmin - center + 0.5) * ss), 0.0)
        ww = ww + w[:, x]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    return xmin, xmax, w


def coefficients(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for one
    axis: (first tap [out], taps used [out], fixed-point weights [out, ksize])."""
    xmin, xmax, w = _weights(in_size, out_size)
    scaled = w * (1 << PRECISION_BITS)
    fixed = np.trunc(np.where(w < 0, -0.5 + scaled, 0.5 + scaled)).astype(np.int64)
    return xmin, xmax, fixed


def _pass(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One 8-bit pass along ``axis`` (0 rows, 1 columns) of uint8 [H, W, C]."""
    in_size = img.shape[axis]
    xmin, xmax, k = coefficients(in_size, out_size)
    shape = [1, 1, 1]
    shape[axis] = out_size
    # int32, as Pillow's: |sum of weights| < 2 ** 23, so 255 times it fits.
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:], 1 << (PRECISION_BITS - 1), np.int32)
    src = img.astype(np.int32)
    k = k.astype(np.int32)
    for x in range(k.shape[1]):
        idx = np.minimum(xmin + x, in_size - 1)  # a tap past xmax has weight 0
        acc += np.take(src, idx, axis=axis) * k[:, x].reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _pass16(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One ``I;16`` pass along ``axis`` of uint16 [H, W, 1]."""
    in_size = img.shape[axis]
    xmin, _, k = _weights(in_size, out_size)
    shape = [1, 1, 1]
    shape[axis] = out_size
    acc = np.zeros(img.shape[:axis] + (out_size,) + img.shape[axis + 1:])
    src = img.astype(np.float64)
    for x in range(k.shape[1]):  # summed in tap order, as Pillow sums them
        idx = np.minimum(xmin + x, in_size - 1)
        acc += np.take(src, idx, axis=axis) * k[:, x].reshape(shape)
    v = np.trunc(np.where(acc >= 0, acc + 0.5, acc - 0.5)).astype(np.int64)
    lo = np.clip(np.fmod(v, 256), 0, 255)  # C's %: negative for a negative sum, then clipped
    hi = np.clip(v >> 8, 0, 255)
    return (lo + (hi << 8)).astype(np.uint16)


def nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """``ImagingScaleAffine``'s source index of each output column or row."""
    scale = in_size / out_size
    pos = scale * 0.5
    idx = np.empty(out_size, np.int64)
    for x in range(out_size):  # accumulated, as Pillow accumulates it
        idx[x] = int(pos)
        pos += scale
    return np.minimum(idx, in_size - 1)


def resize_nearest(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """[H, W, ...] of any dtype -> [h, w, ...] at ``size`` = (w, h), as
    ``Image.resize`` returns a "1" or "P" image (NEAREST)."""
    w, h = size
    if w <= 0 or h <= 0:
        raise ValueError(f"bad size {size}")
    img = np.asarray(image)
    return np.ascontiguousarray(img[nearest_index(img.shape[0], h)][:, nearest_index(img.shape[1], w)])


def _premultiply(img: np.ndarray) -> np.ndarray:
    """Pillow's RGBA -> RGBa (``MULDIV255`` on the colour channels)."""
    out = img.copy()
    tmp = img[..., :-1].astype(np.int64) * img[..., -1:] + 128
    out[..., :-1] = ((tmp >> 8) + tmp) >> 8
    return out


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    """Pillow's RGBa -> RGBA: colour * 255 // alpha, clipped, where alpha is
    neither 0 nor 255."""
    a = img[..., -1:].astype(np.int64)
    colour = img[..., :-1].astype(np.int64)
    keep = (a == 0) | (a == 255)
    div = np.clip(255 * colour // np.where(keep, 1, a), 0, 255)
    out = img.copy()
    out[..., :-1] = np.where(keep, colour, div)
    return out


def resize(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 [H, W, C] (C = 1 L, 2 LA, 3 RGB, 4 RGBA) or uint16 [H, W, 1]
    (I;16) -> the same at ``size`` = (w, h), as ``Image.resize(size)``
    returns it (BICUBIC)."""
    img = np.ascontiguousarray(image)
    i16 = img.dtype == np.uint16 and img.ndim == 3 and img.shape[2] == 1
    if not i16 and (img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (1, 2, 3, 4)):
        raise ValueError(f"resize takes uint8 [H, W, C] with C in 1..4 or uint16 [H, W, 1], "
                         f"got {img.dtype} {img.shape}")
    w, h = size
    if w <= 0 or h <= 0:
        raise ValueError(f"bad size {size}")
    if (h, w) == img.shape[:2]:
        return img.copy()
    if i16:
        if w != img.shape[1]:
            img = _pass16(img, 1, w)
        if h != img.shape[0]:
            img = _pass16(img, 0, h)
        return img
    alpha = img.shape[2] in (2, 4)
    if alpha:
        img = _premultiply(img)
    if w != img.shape[1]:
        img = _pass(img, 1, w)
    if h != img.shape[0]:
        img = _pass(img, 0, h)
    return _unpremultiply(img) if alpha else img
