"""Multi-seat encoding on one card (selkies_tpu/parallel's counterpart).

The reference shards N seats over a device mesh, one encode dispatch a
tick driving every seat. On one H100 a seat is a batch index of the
same kernels: each tick launches each kernel once for all seats
(:class:`MultiSeatEncoder`, :class:`MultiSeatH264Encoder`), and
:class:`~.capture.MultiSeatCapture` is the ScreenCapture-compatible loop
over them. A device list whose entries are all one device holds every
seat there. Split-frame H.264 (:mod:`.stripes`) takes one frame's MB rows
as shards on the same pattern. Meshes of distinct devices raise
(ROADMAP A11c).
"""

from .capture import MultiSeatCapture
from .h264_seats import MultiSeatH264Encoder
from .seats import MultiSeatEncoder, seat_mesh, synthetic_seat_frames

__all__ = ["MultiSeatCapture", "MultiSeatEncoder", "MultiSeatH264Encoder",
           "seat_mesh", "synthetic_seat_frames"]
