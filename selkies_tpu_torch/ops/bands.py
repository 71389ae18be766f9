"""Dirty-band geometry: make per-frame encode cost scale with damage.

A copy of selkies_tpu/ops/bands.py (numpy only; the planning runs on the
host every frame). Every MB row is an independent slice, so a P frame's
bitstream decomposes into per-row segments built by different producers
and stitched at byte-aligned slice seams: rows that meet the damage are
encoded by the band step over just those rows, clean rows of delivered
stripes become host-built all-skip slices
(codecs/h264.py:p_skip_slice_rbsp), and stripes with no damage are not
sent.

Band sizes are bucketed to power-of-two row counts. With motion search
on, bands are whole stripes: a motion window must equal the decoder's
picture (the stripe) for the encoder's window clamp to match the
decoder's picture-edge clamp. Zero-MV replenishment has no windows, so
its bands are MB-row granular.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["band_buckets", "plan_band", "dirty_fraction"]


def band_buckets(n_rows: int, granularity: int = 1) -> tuple:
    """Reachable band sizes for a frame of ``n_rows`` MB rows: power-of-
    two multiples of ``granularity`` (1 for zero-MV bands, rows-per-
    stripe for motion bands), plus the full frame. Ascending, deduped.

    >>> band_buckets(9)
    (1, 2, 4, 8, 9)
    >>> band_buckets(8, granularity=2)
    (2, 4, 8)
    """
    if n_rows <= 0:
        raise ValueError("n_rows must be positive")
    g = max(1, int(granularity))
    out = []
    b = g
    while b < n_rows:
        out.append(b)
        b *= 2
    out.append(n_rows)
    return tuple(out)


def plan_band(rows_needed: np.ndarray, *, granularity: int = 1,
              floor_rows: int = 1) -> Optional[tuple]:
    """Smallest bucketed band covering every needed MB row.

    ``rows_needed``: (R,) bool — rows that must be encoded on the device
    this frame (dirty rows plus every row of a paint-over stripe).
    ``granularity``: band alignment and quantum in MB rows.
    ``floor_rows``: content-profile floor on the bucket.

    -> ``(row0, band_rows)`` with ``row0 % granularity == 0`` and
    ``band_rows`` from :func:`band_buckets`, or None when no row needs
    encoding (the idle frame).
    """
    rows_needed = np.asarray(rows_needed, bool)
    R = int(rows_needed.shape[0])
    nz = np.nonzero(rows_needed)[0]
    if nz.size == 0:
        return None
    g = max(1, int(granularity))
    lo = (int(nz[0]) // g) * g
    hi = -(-(int(nz[-1]) + 1) // g) * g          # exclusive, g-aligned
    span = hi - lo
    want = max(span, min(max(1, int(floor_rows)), R))
    for b in band_buckets(R, g):
        if b >= want:
            band_rows = b
            break
    # place the bucket over the span, clipped so it stays in the frame
    # and g-aligned (band_rows is a multiple of g or the full frame)
    row0 = min(lo, R - band_rows)
    row0 = max(0, (row0 // g) * g)
    return row0, band_rows


def dirty_fraction(dirty_rows: np.ndarray) -> float:
    """Fraction of MB rows dirty this frame."""
    d = np.asarray(dirty_rows, bool)
    return float(d.sum()) / float(max(1, d.shape[0]))
