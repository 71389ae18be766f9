"""JPEG stripe-encoder session on PyTorch/CUDA (the server's default).

The counterpart of selkies_tpu/engine/encoder.py for one seat, 4:2:0
and 4:4:4 (``fullcolor``):

- a per-frame device step that splits the frame into ``stripe_h``-row
  stripes, diffs them against the previous frame (damage gating),
  advances the paint-over age, picks the motion or the paint-over
  quantisation tables per stripe, runs CSC + DCT + quantisation + Huffman
  events + bit packing, and byte-packs every stripe's scan into ONE
  fixed-capacity buffer. All stripes are encoded every frame; only the
  damaged and the repainted ones are sent;
- a host tail that slices the buffer, 0xFF-stuffs each scan, wraps the
  JFIF headers with the tables that were live at dispatch, and emits
  :class:`EncodedChunk`s;
- ``watermark_path``: a PNG blended into every frame before the step
  (engine/watermark.py, K12), anchored to the visible size.

One frame is K6 ``row_damage_probe`` at stripe granularity, K7
``jpeg_forward`` (which also writes ``prev <- frame``), K8 ``jpeg_events``
and K9 ``jpeg_pack`` (ops/jpeg_pipeline.py), plus (S,)-sized torch ops
for age, paint-over and send. Where the reference donates ``prev`` and
``age`` to its jitted step, the port updates them in place. Nothing in
:meth:`JpegEncoderSession.encode` waits for the device; the control
arrays are copied back without blocking and
:meth:`~JpegEncoderSession._sync_control` is the one sync point.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any

import numpy as np
import torch

from .._device import resolve_device
from ..codecs import jpeg as jtab
from ..ops.jpeg_entropy import scan_layout, scan_maps
from ..ops.jpeg_pipeline import KERNEL_OPS, JpegOps
from ..resilience import faults as _faults
from ..trace import tracer as _tracer
from . import state as _state
from .readback import HostCopy, fetch_stream_bytes, fetch_stripe_bytes, upload
from .types import CaptureSettings, EncodedChunk
from .watermark import maybe_load

logger = logging.getLogger("selkies_tpu_torch.engine.encoder")


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


@dataclasses.dataclass
class _Grid:
    width: int              # padded width
    height: int             # padded height
    stripe_h: int
    n_stripes: int
    out_w: int              # visible (unpadded) width
    out_h: int


def plan_grid(s: CaptureSettings) -> _Grid:
    block = 8 if s.fullcolor else 16
    stripe_h = max(block, _round_up(s.stripe_height, block))
    w = _round_up(s.capture_width, block)
    h = _round_up(s.capture_height, stripe_h)
    return _Grid(width=w, height=h, stripe_h=stripe_h,
                 n_stripes=h // stripe_h,
                 out_w=s.capture_width, out_h=s.capture_height)


def jpeg_buffer_caps(g: _Grid, fullcolor: bool) -> tuple[int, int, int]:
    """(e_cap, w_cap, out_cap) for a grid: the reference's sizing. e_cap
    is the true worst case (one event per coefficient slot), so only the
    word and byte buffers can overflow, and those grow."""
    stripe_px = g.stripe_h * g.width
    e_cap = stripe_px * (3 if fullcolor else 2)
    w_cap = stripe_px // 2
    out_cap = max(256 * 1024, stripe_px * g.n_stripes // 8)
    return e_cap, w_cap, out_cap


def build_step_fn(width: int, stripe_h: int, n_stripes: int, subsampling: str,
                  e_cap: int, w_cap: int, out_cap: int, paint_delay: int,
                  damage_gating: bool, paint_over: bool, scan: torch.Tensor,
                  ops: JpegOps = KERNEL_OPS):
    """The per-frame encode step. ``scan`` is the (3, M) scan maps of one
    stripe (ops/jpeg_entropy.scan_maps).

    step(frame u8 (H,W,3), prev u8 (H,W,3), age i32 (S,),
         qtables f32 (4, 64) [luma motion, chroma motion, luma paint,
         chroma paint])
    -> (data u8 (out_cap,), byte_lens i32 (S,), send bool (S,),
        is_paint bool (S,), overflow bool ())
    ``prev`` becomes ``frame`` and ``age`` advances, in place (the
    reference returns them as new arrays). With a seat set of ``ops``
    (parallel/seats.py) data is (n_seats, out_cap) and overflow
    (n_seats,)."""
    s = n_stripes

    def step(frame, prev, age, qtables):
        if damage_gating:
            damage = ops.row_damage_probe(frame, prev, s) != 0
        else:
            damage = torch.ones((s,), dtype=torch.bool, device=frame.device)
        age.copy_(torch.where(damage, 0, age + 1))
        if paint_over and paint_delay > 0:
            is_paint = age == paint_delay
        else:
            is_paint = torch.zeros_like(damage)
        send = damage | is_paint
        # K7 reads the frame after K6 has compared it with prev
        planes = ops.jpeg_forward(frame, prev, is_paint.to(torch.int32),
                                  qtables, subsampling)
        payload, nbits = ops.jpeg_events(*planes, scan, s)
        st = ops.jpeg_pack(payload, nbits, e_cap, w_cap, out_cap)
        # one overflow flag a frame; one a seat with the seat ops
        return st.data, st.byte_lens, send, is_paint, st.flags.any(-1)

    step.__name__ = "jpeg_step"
    return step


class JpegEncoderSession:
    """Per-display JPEG encoder session (the reference's lifecycle:
    ``encode`` dispatches, ``finalize``/``finalize_stream`` read back).

    ``device`` None means ``cuda`` (raises when CUDA is absent); pass
    ``"cpu"`` for the plain versions."""

    STATE_KEYS = _state.JPEG_STATE

    def __init__(self, settings: CaptureSettings, device=None):
        self.device = resolve_device(device)
        self.settings = settings
        self.grid = plan_grid(settings)
        self.subsampling = "444" if settings.fullcolor else "420"
        self._ops = KERNEL_OPS
        g = self.grid
        self._e_cap, self._w_cap, self._out_cap = jpeg_buffer_caps(
            g, settings.fullcolor)
        self._scan = scan_maps(scan_layout(g.stripe_h // 8, g.width // 8,
                                           self.subsampling), self.device)
        self._rebuild_steps()
        self.frame_id = 0
        self._age = torch.zeros((g.n_stripes,), dtype=torch.int32,
                                device=self.device)
        self._prev = torch.zeros((g.height, g.width, 3), dtype=torch.uint8,
                                 device=self.device)
        # set after a dropped (overflowed) frame: the client never saw it,
        # so damage diffs against it would leave stale stripes on glass
        self._force_after_drop = False
        self._cap_gen = 0   # buffer-growth generation
        # anchored against the VISIBLE size: padded rows and columns are
        # cropped client-side, so a bottom/right anchor must not land there
        self._watermark = maybe_load(settings, g.out_w, g.out_h, self.device)
        # readback runs here while the next frame's kernels are queued on
        # the dispatching stream (engine/readback.py)
        self._copy_stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self.update_quality(settings.jpeg_quality,
                            settings.paint_over_quality)

    def _rebuild_steps(self) -> None:
        """(Re)build the step for the current caps and ops."""
        g, s = self.grid, self.settings
        self._step = build_step_fn(g.width, g.stripe_h, g.n_stripes,
                                   self.subsampling, self._e_cap,
                                   self._w_cap, self._out_cap,
                                   s.paint_over_delay_frames,
                                   s.use_damage_gating, s.use_paint_over,
                                   self._scan, ops=self._ops)

    @property
    def visible_size(self) -> tuple[int, int]:
        """(width, height) the client should display; encode dims are
        block-padded beyond this and cropped client-side."""
        return self.grid.out_w, self.grid.out_h

    # -- live tunables ------------------------------------------------------
    def update_quality(self, motion_q: int, paint_q: int | None = None):
        """New quality tiers: the host tables (for the DQT) and ONE upload
        of the device tables; frames already dispatched keep the tensor
        they were given."""
        self.settings.jpeg_quality = int(motion_q)
        if paint_q is not None:
            self.settings.paint_over_quality = int(paint_q)
        self._qtabs_np = tuple(
            jtab.scale_qtable(base, q)
            for q in (self.settings.jpeg_quality,
                      self.settings.paint_over_quality)
            for base in (jtab.STD_LUMA_QUANT, jtab.STD_CHROMA_QUANT))
        self._qtab = upload(np.stack(self._qtabs_np).astype(np.float32),
                            self.device)

    # -- device step --------------------------------------------------------
    def encode(self, frame, force: bool = False, owned: bool = False
               ) -> dict[str, Any]:
        """Dispatch one encode step on a (grid.height, grid.width, 3)
        uint8 frame (numpy or torch); does not wait for the device.
        ``force`` is a finalize-time decision for JPEG (every stripe is
        always in the buffer); accepted for parity with the H.264
        session. ``owned``: the caller hands ``frame`` over, so the
        watermark is blended into it in place instead of a copy."""
        del force
        # fault point: device_error raises, slow stalls the dispatch
        _faults.registry.perturb("encoder.dispatch")
        cap_gen = self._cap_gen
        frame = upload(frame, self.device).contiguous()
        if self._watermark is not None:
            frame = self._watermark.apply(frame, owned)
        with _tracer.span("encode.dispatch"):
            data, lens, send, is_paint, overflow = self._step(
                frame, self._prev, self._age, self._qtab)
            fid = self.frame_id
            self.frame_id = (self.frame_id + 1) & 0xFFFF
            control = HostCopy([lens, send, is_paint, overflow])
        # the host tables live at DISPATCH: a quality change before
        # finalize must not make the DQT disagree with the device's
        return {"data": data, "control": control, "frame_id": fid,
                "cap_gen": cap_gen, "qtabs": self._qtabs_np}

    # -- host tail ----------------------------------------------------------
    def finalize(self, out: dict[str, Any], force_all: bool = False
                 ) -> list[EncodedChunk]:
        """Waits for the control arrays and produces wire-ready chunks.
        Reads only what :meth:`encode` put in ``out``."""
        g = self.grid
        # ONE readback span per frame: the control sync and the stream
        # fetch; a pipelined slot's readback starts at its submit instant
        tl = _tracer.lookup(self.settings.display_id, out["frame_id"])
        lane = f"slot{out['slot']}" if "slot" in out else None
        rb_t0 = out.get("submitted_ns") or time.perf_counter_ns()
        overflowed, idle, force_all, lens, send, is_paint = \
            self._sync_control(out, force_all)
        data = starts = None
        if not overflowed and not idle:
            starts = np.concatenate([[0], np.cumsum(lens)])
            # every stripe is in the buffer: fetch through the last
            # DELIVERED one, never the capacity padding
            deliver = np.arange(g.n_stripes) if force_all \
                else np.nonzero(send)[0]
            last = int(deliver[-1])
            data = fetch_stream_bytes(out["data"],
                                      int(starts[last] + lens[last]),
                                      self._copy_stream,
                                      out["control"].done)
        _tracer.record_span(tl, "encode.readback", rb_t0, lane=lane)
        if overflowed:
            self._handle_overflow(out)
            return []
        if idle:
            return []                 # idle frame: fetched nothing at all
        with _tracer.span("packetize", tl, lane=lane):
            return [self._chunk(out, i, data[starts[i]:starts[i] + lens[i]],
                                bool(is_paint[i]))
                    for i in range(g.n_stripes) if force_all or send[i]]

    def finalize_stream(self, out: dict[str, Any], force_all: bool = False):
        """Stripe-granular finalize: yields each stripe's chunk with its
        own fetch. Byte-identical to :meth:`finalize`."""
        g = self.grid
        tl = _tracer.lookup(self.settings.display_id, out["frame_id"])
        lane = f"slot{out['slot']}" if "slot" in out else None
        rb_t0 = out.get("submitted_ns") or time.perf_counter_ns()
        overflowed, idle, force_all, lens, send, is_paint = \
            self._sync_control(out, force_all)
        _tracer.record_span(tl, "encode.readback", rb_t0, lane=lane)
        if overflowed:
            self._handle_overflow(out)
            return
        if idle:
            return
        starts = np.concatenate([[0], np.cumsum(lens)])
        for i in range(g.n_stripes):
            if force_all or send[i]:
                with _tracer.span("encode.readback", tl, lane=lane):
                    raw = fetch_stripe_bytes(out["data"], int(starts[i]),
                                             int(lens[i]), self._copy_stream,
                                             out["control"].done)
                with _tracer.span("packetize", tl, lane=lane):
                    chunk = self._chunk(out, i, raw, bool(is_paint[i]))
                yield chunk

    def _sync_control(self, out: dict[str, Any], force_all: bool):
        """The one device-sync point of a dispatched frame, and the
        force-after-drop promotion. -> (overflowed, idle, force_all,
        lens, send, is_paint)."""
        lens, send, is_paint, overflow = out["control"].wait()
        if bool(overflow):
            return True, True, force_all, None, None, None
        if self._force_after_drop:
            self._force_after_drop = False
            force_all = True
        idle = not (force_all or send.any())
        return False, idle, force_all, lens, send, is_paint

    def _chunk(self, out: dict[str, Any], i: int, raw: np.ndarray,
               paint: bool) -> EncodedChunk:
        g = self.grid
        qy_m, qc_m, qy_p, qc_p = out["qtabs"]
        qy, qc = (qy_p, qc_p) if paint else (qy_m, qc_m)
        payload = jtab.assemble_jfif(g.stripe_h, g.width,
                                     jtab.stuff_ff_bytes(np.asarray(raw)),
                                     qy, qc, self.subsampling)
        return EncodedChunk(
            payload=payload, frame_id=out["frame_id"],
            stripe_y=i * g.stripe_h, width=g.width, height=g.stripe_h,
            is_idr=True, output_mode="jpeg",
            seat_index=self.settings.seat_index,
            display_id=self.settings.display_id)

    def _handle_overflow(self, out: dict[str, Any]) -> None:
        """A word or byte buffer overflowed (events cannot: e_cap is the
        worst case): the frame is dropped, the growable buffers double
        ONCE per episode (pipelined frames encoded with the old caps also
        overflow but must not re-double), and the next delivered frame
        resends every stripe, since ``prev`` already moved past the frame
        the client never saw."""
        if out["cap_gen"] == self._cap_gen:
            logger.warning("jpeg overflow at frame %d; raising capacity",
                           out["frame_id"])
            self._w_cap *= 2
            self._out_cap *= 2
            self._rebuild_steps()
            self._cap_gen += 1
        self._force_after_drop = True
