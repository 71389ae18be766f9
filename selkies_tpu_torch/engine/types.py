"""Engine data types: capture settings and encoded output chunks.

A copy of selkies_tpu/engine/types.py (the port never imports the JAX
package). ``CaptureSettings`` keeps the reference's defaults, so a caller
that wants the stock H.264 slice the port runs sets
``h264_motion_vrange=0`` and ``h264_partial_encode=False`` explicitly.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class CaptureSettings:
    # geometry
    capture_width: int = 1920
    capture_height: int = 1080
    capture_x: int = 0
    capture_y: int = 0
    target_fps: float = 60.0
    # output mode: "jpeg" or "h264"
    output_mode: str = "jpeg"
    # rate control
    video_bitrate_kbps: int = 8000
    video_crf: int = 25
    use_cbr: bool = False
    video_min_qp: int = 10
    video_max_qp: int = 35
    keyframe_interval_s: float = 10.0
    # quality / color
    jpeg_quality: int = 60
    fullcolor: bool = False          # 4:4:4 instead of 4:2:0
    # damage gating + paint-over (reference settings.py:560-585)
    use_damage_gating: bool = True
    use_paint_over: bool = True
    paint_over_quality: int = 90
    paint_over_delay_frames: int = 15
    # striping (reference striped encoding, SURVEY.md §2.5)
    stripe_height: int = 64
    # split-frame device parallelism (ROADMAP 2): shard ONE frame's
    # stripes across this many devices (sequence-parallel analog of
    # tpu_seats). 1 = single-device session; >1 builds the
    # shard_map-wrapped step (StripeShardedH264Session). The mesh
    # silently-but-loudly degrades to the largest dividing count
    # (parallel/stripes.stripe_mesh logs + gauges the chosen value).
    stripe_devices: int = 1
    # deep pipeline (ROADMAP 2): frames in flight between dispatch and
    # delivery. 1 = frame-serial (the pre-pipeline engine); >=2 runs a
    # finalizer thread so frame N+1 dispatches while N reads back. The
    # relay backpressure clamp and the degradation ladder's rung-0
    # "pipeline" action can force 1 at runtime without a session rebuild.
    pipeline_depth: int = 2
    # ship each stripe's bytes as its readback lands (per-stripe fetch,
    # engine/readback.py) instead of waiting on the frame barrier —
    # client first-stripe receive decouples from frame-complete
    stripe_streaming: bool = True
    # h264 inter motion search (scroll/pan candidates; 0 vrange disables).
    # Dense vertical offsets up to vrange px; power-of-two horizontal pans
    # up to hrange px. The encoders behind the reference's design
    # (x264/NVENC, reference docs/design.md:33) all motion-search; this is
    # the TPU equivalent tuned for desktop content.
    h264_motion_vrange: int = 24
    h264_motion_hrange: int = 8
    # damage-proportional encoding (ROADMAP 4): P frames dispatch the
    # device step only over the MB-row band intersecting the damage
    # map; clean rows of delivered stripes ship as host-precomputed
    # all-skip slices and idle frames skip the device entirely.
    # Requires use_damage_gating; a 100%-dirty frame is byte-identical
    # to the stock P step (tests/test_h264_bands.py).
    h264_partial_encode: bool = True
    # content classifier (engine/content.py): damage-signal EWMAs map
    # each session to static/scroll/video/gaming and apply the class
    # profile (qp bias, band bucket floor, IDR cadence)
    h264_content_adaptive: bool = True
    # ROI QP: per-macroblock QP plane derived from the damage map
    # (freshly-damaged MBs sharpen by h264_roi_qp_bias below the row
    # base, coded as real mb_qp_delta syntax). 4:2:0 P frames only.
    h264_roi_qp: bool = False
    h264_roi_qp_bias: int = 4
    # h264-tpu (non-striped): one stream spanning the whole display;
    # the grid planner derives stripe_height from the CURRENT height so
    # live resizes keep the one-stream contract
    single_stream: bool = False
    # device placement
    seat_index: int = 0
    #: LOGICAL display label stamped on chunks ("primary", "display2",
    #: "seat0"...). NOT the X server address — see x_display.
    display_id: str = ":0"
    #: real X/Wayland display to open for capture (":0",
    #: "wayland-0"...); empty falls back to display_id for callers
    #: whose logical id IS the server address (tests, single display)
    x_display: str = ""
    # misc parity knobs
    watermark_path: str = ""
    watermark_location: int = 6
    debug_logging: bool = False


@dataclasses.dataclass(frozen=True)
class EncodedChunk:
    """One encoded stripe ready for wire framing.

    ``payload`` is the codec bitstream (JFIF bytes for jpeg, Annex-B for
    h264); the server layer adds the 0x03/0x04 header
    (protocol.pack_*_stripe). Mirrors the chunk contract of the reference's
    pixelflux callback (SURVEY.md §2.3 binary framing).

    ``width``/``height`` are the ENCODED (block-padded) stripe dimensions —
    what the client decoder needs. The visible desktop size travels in the
    ``server_settings`` payload; the client canvas crops any padding
    overhang on the right/bottom edges.
    """
    payload: bytes
    frame_id: int
    stripe_y: int
    width: int
    height: int
    is_idr: bool            # h264: IDR; jpeg: always True (intra)
    output_mode: str        # "jpeg" | "h264"
    seat_index: int = 0
    display_id: str = ":0"
