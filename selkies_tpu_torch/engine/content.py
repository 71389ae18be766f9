"""Content classification: map damage-plane signals onto rate-control
profiles.

A copy of selkies_tpu/engine/content.py (the port imports nothing of
the JAX package).

The damage tracker and the row probe already compute everything needed
to tell a static desktop from a scrolling pane from full-motion video —
per-frame dirty fraction and its dynamics. This module turns those
free signals into a per-session content class and a tuned profile, the
quality/latency/energy ladder the NVENC longitudinal study charts
(PAPERS.md): a static desktop wants sharp text and near-zero device
work; video wants steady rate and no partial-encode churn.

Classes and the heuristics (EWMAs over per-frame damage):

- ``static``  — damage is rare or tiny (typing, cursor). Partial encode
  at row granularity, slight qp sharpening, long IDR cadence.
- ``scroll``  — persistent mid-sized contiguous damage. Partial encode
  with a floored band bucket (a scroll band flapping between buckets
  would churn compiled programs), stock qp.
- ``video``   — persistent large damage with STEADY area (a player
  repaints the same rect every frame). Full-frame encode (bands win
  nothing), mild qp relaxation toward rate.
- ``gaming``  — persistent large damage with VOLATILE area. Full-frame
  encode, stronger qp relaxation, short IDR cadence for fast recovery.

Hysteresis: a class switch requires the new candidate to win ``dwell``
consecutive updates — flapping between profiles would thrash the band
bucket floor and the qp bias for no QoE gain.

Stdlib-only and clock-free (frame-indexed), like the other pure control
modules (ladder, scheduler): the capture loop feeds it once per frame;
tests drive synthetic damage traces.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ContentProfile", "ContentClassifier", "CONTENT_PROFILES",
           "CONTENT_CLASSES"]

#: stable class -> gauge value mapping (selkies_session_content_class)
CONTENT_CLASSES = ("static", "scroll", "video", "gaming")


@dataclasses.dataclass(frozen=True)
class ContentProfile:
    """Tuned per-class rate-control profile. ``qp_bias`` shifts the
    session base qp (negative sharpens); ``band_floor_rows`` floors the
    partial-encode bucket (ops/bands.plan_band); ``partial_encode``
    gates the band path (video/gaming damage covers the raster anyway —
    the probe sync would buy nothing); ``idr_cadence_s`` overrides the
    keyframe interval (None keeps the configured one)."""

    name: str
    qp_bias: int = 0
    band_floor_rows: int = 1
    partial_encode: bool = True
    idr_cadence_s: Optional[float] = None


CONTENT_PROFILES: dict = {
    "static": ContentProfile("static", qp_bias=-2, band_floor_rows=1,
                             partial_encode=True, idr_cadence_s=None),
    "scroll": ContentProfile("scroll", qp_bias=0, band_floor_rows=4,
                             partial_encode=True, idr_cadence_s=None),
    "video": ContentProfile("video", qp_bias=2, band_floor_rows=8,
                            partial_encode=False, idr_cadence_s=None),
    "gaming": ContentProfile("gaming", qp_bias=4, band_floor_rows=8,
                             partial_encode=False, idr_cadence_s=5.0),
}

#: downshift rungs each content class makes pointless for the ladder
#: (resilience/ladder.set_content_profile): a static desktop's frames
#: are already idle-skipped by the partial encoder, so halving its
#: target fps sheds ~nothing while still costing smoothness the moment
#: the user types.
CONTENT_LADDER_SKIPS: dict = {
    "static": ("fps",),
    "scroll": (),
    "video": (),
    "gaming": (),
}

#: default EWMA smoothing (per frame) and switch dwell (frames)
_ALPHA = 0.08
_DWELL = 30


class ContentClassifier:
    """Per-session damage-signal classifier.

    ``update(dirty_fraction)`` once per frame -> the (hysteresis-stable)
    class name. ``profile`` is the matching :class:`ContentProfile`;
    ``snapshot()`` is the /api/sessions block.
    """

    def __init__(self, alpha: float = _ALPHA, dwell: int = _DWELL):
        self.alpha = float(alpha)
        self.dwell = max(1, int(dwell))
        #: EWMA of per-frame dirty fraction (damage area)
        self.area = 0.0
        #: EWMA of the damage indicator (damage persistence)
        self.persistence = 0.0
        #: EWMA of |area jump| frame-to-frame (area volatility —
        #: separates a steady player rect from game-render chaos)
        self.volatility = 0.0
        self._last_fraction = 0.0
        self.current = "static"
        self._candidate = "static"
        self._candidate_streak = 0
        self.transitions = 0
        self.frames = 0

    # -- classification ------------------------------------------------------
    def _classify(self) -> str:
        if self.persistence < 0.3 or self.area < 0.05:
            return "static"
        if self.area < 0.6:
            return "scroll"
        if self.volatility >= 0.08:
            return "gaming"
        return "video"

    def update(self, dirty_fraction: float) -> str:
        f = min(1.0, max(0.0, float(dirty_fraction)))
        a = self.alpha
        self.area += a * (f - self.area)
        self.persistence += a * ((1.0 if f > 0.0 else 0.0)
                                 - self.persistence)
        self.volatility += a * (abs(f - self._last_fraction)
                                - self.volatility)
        self._last_fraction = f
        self.frames += 1
        cand = self._classify()
        if cand == self.current:
            self._candidate = cand
            self._candidate_streak = 0
            return self.current
        if cand == self._candidate:
            self._candidate_streak += 1
        else:
            self._candidate = cand
            self._candidate_streak = 1
        if self._candidate_streak >= self.dwell:
            self.current = cand
            self._candidate_streak = 0
            self.transitions += 1
        return self.current

    # -- export --------------------------------------------------------------
    @property
    def profile(self) -> ContentProfile:
        return CONTENT_PROFILES[self.current]

    @property
    def class_index(self) -> int:
        """Stable numeric encoding for the Prometheus gauge
        (0=static 1=scroll 2=video 3=gaming)."""
        return CONTENT_CLASSES.index(self.current)

    def snapshot(self) -> dict:
        return {
            "class": self.current,
            "area_ewma": round(self.area, 4),
            "persistence_ewma": round(self.persistence, 4),
            "volatility_ewma": round(self.volatility, 4),
            "transitions": self.transitions,
            "frames": self.frames,
            "profile": {
                "qp_bias": self.profile.qp_bias,
                "band_floor_rows": self.profile.band_floor_rows,
                "partial_encode": self.profile.partial_encode,
                "idr_cadence_s": self.profile.idr_cadence_s,
            },
        }
