"""H.264 stripe-encoder session on PyTorch/CUDA: 4:2:0 and 4:4:4.

The counterpart of selkies_tpu/engine/h264_encoder.py for one device, at
4:2:0 and at 4:4:4 (``fullcolor``: High 4:4:4 Predictive, full-resolution
chroma planes and reference), in its default configuration (scroll
motion search, the damage-proportional band path) and in the stock one
(``h264_motion_vrange=0``, ``h264_partial_encode=False``):

- every wire stripe is an INDEPENDENT H.264 stream of ``stripe_h`` rows;
  each MB row inside a stripe is one slice;
- damage gating: unchanged stripes are skipped; paint-over re-sends a
  settled stripe once at ``paint_over_qp``;
- adaptive I/P: the first frame and every forced refresh are IDR access
  units; all other frames are P frames (P_Skip for unchanged macroblocks,
  P_L0_16x16 with a scroll motion vector and residual for changed ones);
- the band path (``h264_partial_encode`` with damage gating): a row
  probe's host-visible damage decides send, paint-over and the band; P
  frames encode only the band of MB rows covering the damage and stitch
  host-built all-skip slices for the clean rows of sent stripes; idle
  frames launch nothing;
- ``watermark_path``: a PNG blended into every frame before the step
  (engine/watermark.py, K12), anchored to the visible size;
- ``h264_roi_qp`` (ROI QP, 4:2:0 band path only): the macroblocks of a
  band that differ from the previous frame are coded
  ``h264_roi_qp_bias`` below their row's QP (clipped to [8, 48]), the
  per-MB QPs reaching the wire as mb_qp_delta syntax.

One stock frame is K1 ``csc420_damage``, K5 ``motion_select`` (when
motion is on), K2 ``mb_encode_i``/``mb_encode_p``, K3 ``cavlc_events``
and K4 ``pack_stream`` (ops/h264_planes.py, ops/h264_encode.py), plus
(S,)-sized torch ops for age, paint-over, send, ``sent``/``fnum``,
per-row qp and ``idr_pic_id``. A band frame is K6 ``row_damage_probe``
on the whole frame, then K1, K5, K2, K3 and K4 on the band rows; with
ROI QP K17 ``roi_qp_plane`` runs before K1 and K18 ``mb_qp_delta``
after K2. At 4:4:4 K13 ``csc444_damage``, K5's ``motion_select444``, K14
``mb_encode_i444``/K15 ``mb_encode_p444`` and K16 ``cavlc_events444``
(ops/h264_planes444.py) take the places of K1, K5, K2 and K3; K4 and K6
are shared. ``h264_roi_qp`` is ignored at 4:4:4 and by the stock step,
as in the reference.
Only the byte buffer prefix, the row lengths and the flags leave the
device.

:class:`StripeShardedH264Session` is the split-frame session
(``stripe_devices``): the frame's stripes as shards on one device, the
stock step launched once a frame over all of them with K4's seat entry
``pack_stream_seats`` giving each shard its own byte buffer.

Where the reference donates its state buffers to the jitted step, the
port updates preallocated state tensors in place: ``prev`` (by K1), the
reference planes (by K2, for sent rows only), ``age``, ``sent`` and
``fnum``. The stock path never waits for the device inside
:meth:`H264EncoderSession.encode`; the band path waits once, for the
probe's (R,) flags, which decide what to launch. Otherwise
:meth:`~H264EncoderSession._sync_control` is the one sync point.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..codecs import h264 as hcodec
from ..ops.bands import dirty_fraction as _dirty_fraction
from ..ops.bands import plan_band
from ..ops.h264_encode import P_SLOTS_MB, SLOTS_MB, scroll_candidates
from ..ops.h264_planes import KERNEL_OPS, SEAT_KERNEL_OPS, StepOps, p_rows
from ..ops.h264_planes444 import (KERNEL_OPS_444, P_SLOTS_MB_444,
                                  SEAT_KERNEL_OPS_444, SLOTS_MB_444)
from ..resilience import faults as _faults
from ..trace import tracer as _tracer
from . import state as _state
from .readback import (HostCopy, fetch_stream_bytes, fetch_stripe_bytes,
                       upload)
from .types import CaptureSettings, EncodedChunk
from .watermark import maybe_load

logger = logging.getLogger("selkies_tpu_torch.engine.h264")


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


@dataclasses.dataclass
class _Grid:
    width: int
    height: int
    stripe_h: int
    n_stripes: int
    rows_per_stripe: int
    mb_w: int
    out_w: int
    out_h: int


def h264_buffer_caps(g: _Grid, fullcolor: bool = False
                     ) -> tuple[int, int, int]:
    """(e_cap, w_cap, out_cap) for a grid: the reference's sizing policy.
    out_cap is the one array that crosses to the host every frame, sized
    for realistic intra frames (~1.5 bits/px); overflow grows it (and
    forces a clean refresh). 4:4:4 carries three luma-style components
    (~1.5x the slot and bit budget of 4:2:0)."""
    if fullcolor:
        e_cap = 9 + g.mb_w * max(SLOTS_MB_444, P_SLOTS_MB_444) + 2
        w_cap = max(3072, g.mb_w * 1152 // 4)
        out_cap = max(288 * 1024, g.width * g.height // 4)
    else:
        e_cap = 9 + g.mb_w * max(SLOTS_MB, P_SLOTS_MB) + 2
        w_cap = max(2048, g.mb_w * 768 // 4)
        out_cap = max(192 * 1024, g.width * g.height // 6)
    return e_cap, w_cap, out_cap


def h264_stripe_payload(intra: bool, rows: list[bytes],
                        sps_pps: bytes) -> bytes:
    """Wire payload for one stripe: IDR access unit (headers + IDR
    slices) or non-IDR reference P slices."""
    if intra:
        return sps_pps + hcodec.assemble_annexb(rows)
    return b"".join(hcodec.nal(1, rb, ref_idc=2) for rb in rows)


def plan_h264_grid(s: CaptureSettings) -> _Grid:
    if s.single_stream:
        stripe_h = _round_up(max(16, s.capture_height), 16)
    else:
        stripe_h = max(16, _round_up(s.stripe_height, 16))
    w = _round_up(s.capture_width, 16)
    h = _round_up(s.capture_height, stripe_h)
    return _Grid(width=w, height=h, stripe_h=stripe_h,
                 n_stripes=h // stripe_h, rows_per_stripe=stripe_h // 16,
                 mb_w=w // 16, out_w=s.capture_width, out_h=s.capture_height)


def _motion_candidates(s: CaptureSettings) -> tuple:
    vr = max(0, int(s.h264_motion_vrange))
    hr = max(0, int(s.h264_motion_hrange))
    return scroll_candidates(vr, hr) if vr else ((0, 0),)


def build_h264_step_fn(mode: str, width: int, stripe_h: int, n_stripes: int,
                       e_cap: int, w_cap: int, out_cap: int,
                       paint_delay: int, damage_gating: bool,
                       paint_over: bool, candidates: tuple = ((0, 0),),
                       ops: StepOps = KERNEL_OPS, scratch=None):
    """Per-frame step for ``mode`` in {"i", "p"}; P frames search
    ``candidates`` (motion inside each stripe) when there is more than
    the zero vector. ``scratch`` = (pred_y, pred_u, pred_v, mv), full
    frame, is where the motion search writes its prediction. ``ops``
    fix the chroma format: ``KERNEL_OPS_444`` (ops/h264_planes444.py)
    write and read full-resolution chroma planes.

    step(frame, prev, age, sent, fnum, ref_y, ref_u, ref_v, qp_motion,
         qp_paint, force, hdr_pay, hdr_nb)
    -> (data u8 (out_cap,), row_lens i32 (R,), send (S,), is_paint (S,),
        overflow ())
    ``prev``, ``age``, ``sent``, ``fnum`` and the reference planes are
    updated in place (the reference returns them as new arrays). With a
    seat set of ``ops`` (parallel/h264_seats.py) data is (n_seats,
    out_cap) and overflow (n_seats,)."""
    rps = stripe_h // 16
    intra = mode == "i"
    motion = not intra and len(candidates) > 1

    def step(frame, prev, age, sent, fnum, ref_y, ref_u, ref_v,
             qp_motion: int, qp_paint: int, force: bool, hdr_pay, hdr_nb):
        y, u, v, damage = ops.csc_damage(frame, prev, n_stripes)
        if damage_gating:
            damage = damage != 0
        else:
            damage = torch.ones_like(damage, dtype=torch.bool)
        age.copy_(torch.where(damage, 0, age + 1))
        if paint_over and paint_delay > 0:
            is_paint = age == paint_delay
        else:
            is_paint = torch.zeros_like(damage)
        send = damage | is_paint | bool(force)
        qp_rows = torch.where(is_paint, qp_paint, qp_motion).to(
            torch.int32).repeat_interleave(rps)
        send_i = send.to(torch.int32)
        if intra:
            # consecutive IDRs of one stripe stream must differ in
            # idr_pic_id (§7.4.3): a 4-bit cycle of the sent counter
            row_id = (sent & 0xF).repeat_interleave(rps)
            sent += send_i
            fnum.copy_(torch.where(send, 1, fnum))
            # the reference planes advance only for DELIVERED stripes
            lv, cbp, mb_pay, mb_nb = ops.mb_encode_i(
                y, u, v, qp_rows, send_i, rps, ref_y, ref_u, ref_v)
        else:
            row_id = fnum.repeat_interleave(rps)
            sent += send_i
            fnum.copy_(torch.where(send, fnum + 1, fnum))
            lv, cbp, mb_pay, mb_nb = p_rows(
                ops, y, u, v, qp_rows, send_i.repeat_interleave(rps),
                (ref_y, ref_u, ref_v), candidates if motion else None,
                stripe_h, scratch)
        ev_pay, ev_nb = ops.cavlc_events(lv, cbp, intra)
        st = ops.pack_stream(mb_pay, mb_nb, ev_pay, ev_nb, hdr_pay, hdr_nb,
                             row_id, qp_rows, intra, e_cap, w_cap, out_cap)
        # one overflow flag a frame; one a seat with the seat ops
        return st.data, st.byte_lens, send, is_paint, st.flags.any(-1)

    step.__name__ = f"h264_{mode}_step"
    return step


def build_h264_band_step_fn(width: int, stripe_h: int, n_stripes: int,
                            band_rows: int, e_cap: int, w_cap: int,
                            out_cap: int, candidates: tuple = ((0, 0),),
                            ops: StepOps = KERNEL_OPS, scratch=None,
                            roi_qp: int = 0):
    """Band P step: the stock P encode over a ``band_rows``-row band of
    the frame and the reference planes, as views (``narrow`` on whole
    rows; the chroma rows in the ratio of the planes handed over: halved
    at 4:2:0, whole at 4:4:4); the start row is an argument, so one step
    serves every band position. Every per-row input (slice-header
    events, frame_num, qp) is a slice of the full-frame arrays the stock
    step takes, so a full-frame band is byte-identical to the stock P
    step.

    Motion candidates require ``band_rows`` to cover whole stripes: the
    encoder's search-window clamp must equal the decoder's picture-edge
    clamp, and the picture of a stripe stream is the stripe.

    ``roi_qp`` (ROI QP, 4:2:0; 0 is off): K17 derives the band's per-MB
    QP plane from the frame against ``prev`` before K1 rewrites ``prev``,
    K2-P codes at it and K18 writes the mb_qp_delta chain; K5 and the
    slice headers keep the row QPs. No state crosses frames.

    step(frame, prev, sent, fnum, ref_y, ref_u, ref_v, qp_rows, send,
         send_rows, row0, hdr_pay, hdr_nb), with ``qp_rows`` and
         ``send_rows`` (band_rows,) and ``send`` (S,) int32
    -> (data u8 (out_cap,), row_lens i32 (band_rows,), fnum_used (S,),
        overflow ()); ``prev``, ``sent``, ``fnum`` and the band rows of
        the reference planes are updated in place."""
    rps = stripe_h // 16
    motion = len(candidates) > 1
    if motion and band_rows % rps:
        raise ValueError("motion bands must cover whole stripes "
                         f"({band_rows} rows vs {rps}/stripe)")

    def step(frame, prev, sent, fnum, ref_y, ref_u, ref_v, qp_rows, send,
             send_rows, row0: int, hdr_pay, hdr_nb):
        y0, bh = 16 * row0, 16 * band_rows

        def rows(t, top, n):
            return t.narrow(0, top, n)

        def planes(py, pu, pv):          # the band rows of Y, U and V
            cdiv = py.shape[0] // pu.shape[0]
            return (rows(py, y0, bh), rows(pu, y0 // cdiv, bh // cdiv),
                    rows(pv, y0 // cdiv, bh // cdiv))

        qp_mb = None
        if roi_qp:
            # dirty MBs against the previous frame: before K1 updates prev
            qp_mb = ops.roi_qp_plane(rows(frame, y0, bh), rows(prev, y0, bh),
                                     qp_rows, roi_qp)
        # the reference's prev_out is the whole frame; rows outside the
        # band are clean by construction (the band covers every row the
        # probe found dirty, so frame == prev there), so K1 updating prev
        # over the band rows alone leaves prev equal to the frame
        y, u, v, _ = ops.csc_damage(rows(frame, y0, bh), rows(prev, y0, bh),
                                    1)
        ref = planes(ref_y, ref_u, ref_v)
        out = None
        if motion and scratch is not None:
            out = (*planes(*scratch[:3]), rows(scratch[3], row0, band_rows))
        lv, cbp, mb_pay, mb_nb = p_rows(
            ops, y, u, v, qp_rows, send_rows, ref,
            candidates if motion else None, stripe_h, out, qp_mb)
        ev_pay, ev_nb = ops.cavlc_events(lv, cbp, False)
        fn_band = rows(fnum.repeat_interleave(rps), row0, band_rows)
        st = ops.pack_stream(mb_pay, mb_nb, ev_pay, ev_nb,
                             rows(hdr_pay, row0, band_rows),
                             rows(hdr_nb, row0, band_rows), fn_band,
                             qp_rows, False, e_cap, w_cap, out_cap)
        fnum_used = fnum.clone()                   # pre-increment
        sent += send
        fnum.copy_(torch.where(send != 0, fnum + 1, fnum))
        return st.data, st.byte_lens, fnum_used, st.flags.any()

    step.__name__ = f"h264_band{band_rows}_p_step"
    return step


class H264EncoderSession:
    """Per-display H.264 encoder session (the reference's lifecycle:
    ``encode`` dispatches, ``finalize``/``finalize_stream`` read back).

    ``device`` None means ``cuda`` (raises when CUDA is absent); pass
    ``"cpu"`` for the plain versions."""

    STATE_KEYS = _state.H264_STATE

    def __init__(self, settings: CaptureSettings, device=None):
        self.device = resolve_device(device)
        self.settings = settings
        self.fullcolor = bool(settings.fullcolor)
        self._ops = self._step_ops()
        self.grid = plan_h264_grid(settings)
        g = self.grid
        self.n_rows = g.n_stripes * g.rows_per_stripe
        self._e_cap, self._w_cap, self._out_cap = h264_buffer_caps(
            g, self.fullcolor)
        self._candidates = _motion_candidates(settings)
        dev = self.device

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)
        self._age = zeros(g.n_stripes)
        self._sent = zeros(g.n_stripes)
        self._fnum = zeros(g.n_stripes)
        self._prev = zeros(g.height, g.width, 3, dtype=torch.uint8)
        cdiv = 1 if self.fullcolor else 2
        ch, cw = g.height // cdiv, g.width // cdiv
        self._ref_y = zeros(g.height, g.width, dtype=torch.uint8)
        self._ref_u = zeros(ch, cw, dtype=torch.uint8)
        self._ref_v = zeros(ch, cw, dtype=torch.uint8)
        # where the motion search writes its prediction (never the
        # reference planes, which the P coder rewrites in place)
        self._scratch = None
        if len(self._candidates) > 1:
            self._scratch = (
                zeros(g.height, g.width, dtype=torch.uint8),
                zeros(ch, cw, dtype=torch.uint8),
                zeros(ch, cw, dtype=torch.uint8),
                zeros(self.n_rows, g.mb_w, 2))
        self._i_step = self._build_step("i")
        self._p_step = self._build_step("p")
        self.frame_id = 0
        self._force_after_drop = False
        # encode() tests-and-clears the flag while finalize sets it on
        # overflow: the lock keeps a concurrent set from being lost
        self._drop_lock = threading.Lock()
        self._cap_gen = 0   # buffer-growth generation
        self._sps_pps = hcodec.write_sps(
            g.width, g.stripe_h, chroma_format=3 if self.fullcolor else 1) \
            + hcodec.write_pps()

        def events(fn):
            pay, nb = fn(g.mb_w, g.rows_per_stripe)
            return (torch.as_tensor(np.tile(pay.astype(np.int32),
                                            (g.n_stripes, 1)), device=dev),
                    torch.as_tensor(np.tile(nb, (g.n_stripes, 1)),
                                    device=dev))
        self._hdr_pay, self._hdr_nb = events(hcodec.slice_header_events)
        self._p_hdr_pay, self._p_hdr_nb = events(
            hcodec.p_slice_header_events)
        # anchored against the VISIBLE size (padding is cropped
        # client-side)
        self._watermark = maybe_load(settings, g.out_w, g.out_h, dev)
        # readback runs here while the next frame's kernels are queued on
        # the dispatching stream (engine/readback.py)
        self._copy_stream = torch.cuda.Stream(dev) \
            if dev.type == "cuda" else None
        self.qp = int(np.clip(settings.video_crf, 8, 48))
        self.paint_qp = int(np.clip(settings.video_min_qp, 8, self.qp))
        # damage-proportional path: damage, age and paint-over move to the
        # host (fed by the row probe); the device age is re-seeded from
        # the host mirror before stock I dispatches
        self._partial = bool(settings.h264_partial_encode) \
            and bool(settings.use_damage_gating)
        self._host_age = np.zeros((g.n_stripes,), np.int64)
        #: band quantum: whole stripes under motion search (window ==
        #: picture), MB rows for zero-MV replenishment
        self._band_granularity = g.rows_per_stripe \
            if len(self._candidates) > 1 else 1
        #: content-profile floor on the band (set_content_profile)
        self._band_floor = 1
        #: ROI QP's bias below the row QP (0: off); the band step's only,
        #: and off at 4:4:4, as in the reference
        self._roi_qp_bias = int(settings.h264_roi_qp_bias) \
            if settings.h264_roi_qp and not self.fullcolor else 0
        #: last-frame observability
        self.dirty_fraction = 1.0
        self.last_band_rows = self.n_rows

    def _step_ops(self) -> StepOps:
        """The kernel set of the session's chroma format."""
        return KERNEL_OPS_444 if self.fullcolor else KERNEL_OPS

    def _build_step(self, mode: str):
        g, s = self.grid, self.settings
        return build_h264_step_fn(mode, g.width, g.stripe_h, g.n_stripes,
                                  self._e_cap, self._w_cap, self._out_cap,
                                  s.paint_over_delay_frames,
                                  s.use_damage_gating, s.use_paint_over,
                                  candidates=self._candidates,
                                  ops=self._ops, scratch=self._scratch)

    def _rebuild_steps(self) -> None:
        self._i_step = self._build_step("i")
        self._p_step = self._build_step("p")

    def _band_step(self, band_rows: int):
        g = self.grid
        return build_h264_band_step_fn(
            g.width, g.stripe_h, g.n_stripes, band_rows, self._e_cap,
            self._w_cap, self._out_cap, self._candidates, ops=self._ops,
            scratch=self._scratch, roi_qp=self._roi_qp_bias)

    @property
    def visible_size(self) -> tuple[int, int]:
        return self.grid.out_w, self.grid.out_h

    # -- live tunables ------------------------------------------------------
    def update_quality(self, motion_q: int, paint_q: int | None = None):
        """JPEG-session-compatible knob: quality 1-100 maps inversely onto
        qp 48-8."""
        self.qp = int(np.clip(48 - (motion_q * 40) // 100, 8, 48))
        if paint_q is not None:
            self.paint_qp = int(np.clip(48 - (paint_q * 40) // 100, 8, 48))

    def set_qp(self, qp: int, paint_qp: int | None = None):
        self.qp = int(np.clip(qp, 8, 48))
        if paint_qp is not None:
            self.paint_qp = int(np.clip(paint_qp, 8, 48))

    def set_content_profile(self, profile) -> None:
        """Apply a content profile (the reference's engine/content.py) to
        the band planner. A ``partial_encode=False`` profile floors the
        band at the full frame instead of switching back to the stock
        step: the path stays uniform, the probe keeps the dirty-fraction
        signal live, and a full-frame band is byte-identical to the stock
        step anyway."""
        floor = max(1, int(getattr(profile, "band_floor_rows", 1)))
        if not getattr(profile, "partial_encode", True):
            floor = self.n_rows
        self._band_floor = floor

    # -- device step --------------------------------------------------------
    def encode(self, frame, force: bool = False, owned: bool = False
               ) -> dict[str, Any]:
        """One adaptive I/P step on a (height, width, 3) uint8 frame
        (numpy or torch). ``force`` and the very first frame produce IDRs;
        every other frame is a P frame. ``owned``: the caller hands
        ``frame`` over, so the watermark is blended into it in place
        instead of a copy."""
        # fault point: device_error raises, slow stalls the dispatch
        _faults.registry.perturb("encoder.dispatch")
        cap_gen = self._cap_gen
        with self._drop_lock:
            if self._force_after_drop:
                self._force_after_drop = False
                force = True
        if self.frame_id == 0:
            # every stripe stream must OPEN with an IDR
            force = True
        frame = upload(frame, self.device).contiguous()
        if self._watermark is not None:
            frame = self._watermark.apply(frame, owned)
        with _tracer.span("encode.dispatch"):
            if self._partial:
                return self._dispatch_partial(frame, bool(force), cap_gen)
            return self._dispatch_stock(frame, bool(force), cap_gen)

    def _dispatch_stock(self, frame, intra: bool, cap_gen: int
                        ) -> dict[str, Any]:
        """The full-frame step (always for I frames; for P frames when the
        band path is off)."""
        step = self._i_step if intra else self._p_step
        hdr_pay = self._hdr_pay if intra else self._p_hdr_pay
        hdr_nb = self._hdr_nb if intra else self._p_hdr_nb
        data, row_lens, send, is_paint, overflow = step(
            frame, self._prev, self._age, self._sent, self._fnum,
            self._ref_y, self._ref_u, self._ref_v, self.qp, self.paint_qp,
            intra, hdr_pay, hdr_nb)
        fid = self.frame_id
        self.frame_id = (self.frame_id + 1) & 0xFFFF
        # start the copies of the SMALL control arrays now; the stream
        # buffer is fetched at finalize once the row lengths are known
        control = HostCopy([row_lens, send, is_paint, overflow])
        return {"data": data, "control": control, "frame_id": fid,
                "intra": intra, "cap_gen": cap_gen}

    def _dispatch_partial(self, frame, intra: bool, cap_gen: int
                          ) -> dict[str, Any]:
        """Damage-proportional dispatch: the row probe's host-visible
        damage decides what the stock step decides on the device. Idle
        frames launch nothing more; P frames run the band step over the
        smallest bucketed band covering the damage (paint-over stripes
        join it at ``paint_qp``); I frames fall through to the stock I
        step with the device age re-seeded from the host mirror."""
        g, s = self.grid, self.settings
        rps, S = g.rows_per_stripe, g.n_stripes
        # the one host sync of the band path: (R,) flags
        dirty_rows = self._ops.row_damage_probe(frame, self._prev) \
            .cpu().numpy() != 0
        stripe_dirty = dirty_rows.reshape(S, rps).any(axis=1)
        self.dirty_fraction = _dirty_fraction(dirty_rows)
        age_pre = self._host_age
        self._host_age = np.where(stripe_dirty, 0, age_pre + 1)
        if intra:
            # the stock I step applies the same where(damage, 0, age + 1)
            # to the age it is handed, so seeding the PRE-update host age
            # keeps both mirrors equal
            self._age.copy_(upload(
                np.minimum(age_pre, 2**31 - 1).astype(np.int32),
                self.device))
            return self._dispatch_stock(frame, True, cap_gen)
        paint = np.zeros_like(stripe_dirty)
        if s.use_paint_over and s.paint_over_delay_frames > 0:
            paint = self._host_age == s.paint_over_delay_frames
        send = stripe_dirty | paint
        fid = self.frame_id
        self.frame_id = (self.frame_id + 1) & 0xFFFF
        if not send.any():
            # idle frame: no launch, no readback; prev already equals
            # this frame (no row changed)
            self.last_band_rows = 0
            return {"idle": True, "frame_id": fid, "intra": False,
                    "cap_gen": cap_gen}
        rows_needed = dirty_rows | np.repeat(paint, rps)
        row0, band_rows = plan_band(rows_needed,
                                    granularity=self._band_granularity,
                                    floor_rows=self._band_floor)
        self.last_band_rows = band_rows
        band = slice(row0, row0 + band_rows)
        qp_rows = np.where(np.repeat(paint, rps), self.paint_qp, self.qp)
        # one upload for the step's host inputs: qp and send per band row,
        # send per stripe
        ctl = upload(np.concatenate(
            [qp_rows[band], np.repeat(send, rps)[band], send]).astype(
                np.int32), self.device)
        data, row_lens, fnum_used, overflow = self._band_step(band_rows)(
            frame, self._prev, self._sent, self._fnum, self._ref_y,
            self._ref_u, self._ref_v, ctl[:band_rows], ctl[2 * band_rows:],
            ctl[band_rows:2 * band_rows], row0, self._p_hdr_pay,
            self._p_hdr_nb)
        return {"data": data,
                "control": HostCopy([row_lens, fnum_used, overflow]),
                "send": send, "is_paint": paint, "frame_id": fid,
                "intra": False, "cap_gen": cap_gen,
                "band": (int(row0), int(band_rows)), "qp": int(self.qp),
                "dirty_fraction": self.dirty_fraction}

    # -- host tail ----------------------------------------------------------
    def finalize(self, out: dict[str, Any], force_all: bool = False
                 ) -> list[EncodedChunk]:
        """``force_all`` is ignored — forced refreshes are an encode()-time
        decision for this codec. Reads only what :meth:`encode` put in
        ``out``: with frames in flight, the next dispatch has already
        moved the session's state on."""
        del force_all
        g = self.grid
        # ONE readback span per frame: the control sync and the stream
        # fetch; a pipelined slot's readback starts at its submit instant
        tl = _tracer.lookup(self.settings.display_id, out["frame_id"])
        lane = f"slot{out['slot']}" if "slot" in out else None
        rb_t0 = out.get("submitted_ns") or time.perf_counter_ns()
        overflowed, idle, lens, send, intra = self._sync_control(out)
        data = starts = None
        if not overflowed and not idle:
            starts = self._row_starts(out, lens)
            band = out.get("band")
            # fetch through the last DELIVERED stripe's rows only; band
            # frames through the last band row of a sent stripe (clean
            # rows never existed on the device)
            if band is None:
                last_row = (int(np.nonzero(send)[0][-1]) + 1) \
                    * g.rows_per_stripe - 1
            else:
                last_row = self._band_last_row(send, band)
            if last_row is not None:
                data = self._fetch(out, int(starts[last_row]
                                            + lens[last_row]))
        _tracer.record_span(tl, "encode.readback", rb_t0, lane=lane)
        if overflowed:
            self._handle_overflow(out)
            return []
        if idle:
            return []
        with _tracer.span("packetize", tl, lane=lane):
            return [self._chunk(out, i, self._stripe_row_bytes(
                        out, i, data, starts, lens), intra)
                    for i in range(g.n_stripes) if send[i]]

    def finalize_stream(self, out: dict[str, Any], force_all: bool = False):
        """Stripe-granular finalize: yields each stripe's access unit with
        a per-stripe fetch (band frames: one fetch of the band, then
        per-stripe stitching). Byte-identical to :meth:`finalize`."""
        del force_all
        g = self.grid
        tl = _tracer.lookup(self.settings.display_id, out["frame_id"])
        lane = f"slot{out['slot']}" if "slot" in out else None
        rb_t0 = out.get("submitted_ns") or time.perf_counter_ns()
        overflowed, idle, lens, send, intra = self._sync_control(out)
        _tracer.record_span(tl, "encode.readback", rb_t0, lane=lane)
        if overflowed:
            self._handle_overflow(out)
            return
        if idle:
            return
        starts = self._row_starts(out, lens)
        rps = g.rows_per_stripe
        band = out.get("band")
        if band is not None:
            lb = self._band_last_row(send, band)
            data = None
            if lb is not None:
                with _tracer.span("encode.readback", tl, lane=lane):
                    data = self._fetch(out, int(starts[lb] + lens[lb]))
            for i in range(g.n_stripes):
                if not send[i]:
                    continue
                with _tracer.span("packetize", tl, lane=lane):
                    chunk = self._chunk(out, i, self._stripe_row_bytes(
                        out, i, data, starts, lens), intra)
                yield chunk
            return
        for i in range(g.n_stripes):
            if not send[i]:
                continue
            r0, r1 = i * rps, (i + 1) * rps
            with _tracer.span("encode.readback", tl, lane=lane):
                raw = fetch_stripe_bytes(
                    out["data"], int(starts[r0]),
                    int(starts[r1 - 1] + lens[r1 - 1] - starts[r0]),
                    self._copy_stream, out["control"].done)
            with _tracer.span("packetize", tl, lane=lane):
                base = int(starts[r0])
                rows = [bytes(raw[starts[r] - base:
                                  starts[r] - base + lens[r]])
                        for r in range(r0, r1)]
                chunk = self._chunk(out, i, rows, intra)
            yield chunk

    def _fetch(self, out: dict[str, Any], total: int) -> np.ndarray:
        """The first ``total`` bytes of the frame's stream buffer, on the
        session's copy stream once the frame's kernels are done."""
        return fetch_stream_bytes(out["data"], total, self._copy_stream,
                                  out["control"].done)

    def _band_last_row(self, send, band) -> Optional[int]:
        """The last BAND-LOCAL row belonging to a delivered stripe (None
        when no band row does)."""
        row0, brows = band
        rps = self.grid.rows_per_stripe
        in_band = np.nonzero(np.repeat(send, rps)[row0:row0 + brows])[0]
        return int(in_band[-1]) if in_band.size else None

    def _stripe_row_bytes(self, out: dict[str, Any], i: int, data, starts,
                          lens) -> list:
        """Stripe ``i``'s per-row slice RBSPs. Stock frames slice the
        device buffer; band frames stitch device-encoded band rows
        against host-built all-skip slices at the (byte-aligned) slice
        seams, with the frame_num and qp the device wrote into the band
        rows of the same stripe."""
        g = self.grid
        rps = g.rows_per_stripe
        band = out.get("band")
        if band is None:
            return [bytes(data[starts[r]:starts[r] + lens[r]])
                    for r in range(i * rps, (i + 1) * rps)]
        row0, brows = band
        fnum_used = out["control"].wait()[1]
        rows = []
        for r in range(i * rps, (i + 1) * rps):
            if row0 <= r < row0 + brows:
                b = r - row0
                rows.append(bytes(data[starts[b]:starts[b] + lens[b]]))
            else:
                rows.append(hcodec.p_skip_slice_rbsp(
                    (r % rps) * g.mb_w, g.mb_w, out["qp"],
                    int(fnum_used[i])))
        return rows

    def _row_starts(self, out: dict[str, Any], lens: np.ndarray
                    ) -> np.ndarray:
        """Byte offset of each MB row inside ``out['data']``: the rows back
        to back (:class:`StripeShardedH264Session` has a region a shard)."""
        del out
        return np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)

    def _sync_control(self, out: dict[str, Any]):
        """The one device-sync point of a dispatched frame. ->
        (overflowed, idle, lens, send, intra)."""
        if out.get("idle"):
            # band-path idle frame: nothing was dispatched at all
            return False, True, None, None, False
        if "band" in out:
            lens, _, overflow = out["control"].wait()
            send = out["send"]
        else:
            lens, send, _, overflow = out["control"].wait()
        if bool(overflow):
            return True, True, None, None, True
        return False, not send.any(), lens, send, out.get("intra", True)

    def _chunk(self, out: dict[str, Any], i: int, rows: list,
               intra: bool) -> EncodedChunk:
        g = self.grid
        return EncodedChunk(
            payload=h264_stripe_payload(intra, rows, self._sps_pps),
            frame_id=out["frame_id"], stripe_y=i * g.stripe_h,
            width=g.width, height=g.stripe_h, is_idr=intra,
            output_mode="h264", seat_index=self.settings.seat_index,
            display_id=self.settings.display_id)

    def _handle_overflow(self, out: dict[str, Any]) -> None:
        # grow once per episode: frames encoded with the old caps also
        # report overflow but must not re-double
        if out["cap_gen"] == self._cap_gen:
            logger.warning("h264 overflow at frame %d; growing buffers",
                           out["frame_id"])
            self._w_cap *= 2
            self._out_cap *= 2
            self._rebuild_steps()
            self._cap_gen += 1
        with self._drop_lock:
            self._force_after_drop = True


class StripeShardedH264Session(H264EncoderSession):
    """H.264 session with one frame's stripes split into
    ``settings.stripe_devices`` shards (the reference's split-frame
    session), with the lifecycle and the byte-identical chunks of
    :class:`H264EncoderSession`.

    The mesh is resolved over the grid's stripes
    (parallel/stripes.py:stripe_mesh, which logs and gauges the chosen
    count); ``devices`` None means ``[device]`` when a ``device`` is
    given, else every card. At a resolved count of 1 this IS
    :class:`H264EncoderSession`, band path and ROI QP included. Above 1
    the band path is off, as in the reference, and the stock step runs
    over the whole frame on the mesh's one device with K4's seat entry
    in place of K4: each shard's rows get their own byte buffer of
    ``_out_cap_local`` bytes and their own overflow flags (the
    reference's ``shard_map`` over whole stripes). Each kernel launches
    once a frame; ``out['data']`` is the shards' buffers back to back,
    and a frame overflows when any shard does. A mesh of distinct
    devices raises (ROADMAP A11c)."""

    def __init__(self, settings: CaptureSettings, device=None, devices=None):
        # parallel/ imports this module: resolved at construction
        from ..parallel.stripes import one_device, stripe_mesh
        if devices is None and device is not None:
            devices = [device]
        g = plan_h264_grid(settings)
        self.mesh = stripe_mesh(g.n_stripes, devices=devices,
                                requested=max(1, int(settings.stripe_devices)))
        #: the CHOSEN shard count (may be below the request: logged and
        #: gauged by stripe_mesh)
        self.stripe_devices = int(self.mesh.devices.size)
        super().__init__(settings, one_device(self.mesh.devices))
        if self.stripe_devices > 1:
            self._partial = False

    def _step_ops(self) -> StepOps:
        """The sets with K4's seat entry above one shard."""
        if self.stripe_devices <= 1:
            return super()._step_ops()
        return SEAT_KERNEL_OPS_444 if self.fullcolor else SEAT_KERNEL_OPS

    @property
    def _out_cap_local(self) -> int:
        """A shard's byte-buffer capacity (grows with ``_out_cap``; ceil,
        so the shards hold at least ``_out_cap``)."""
        return -(-self._out_cap // self.stripe_devices)

    def _build_step(self, mode: str):
        n = self.stripe_devices
        if n <= 1:
            return super()._build_step(mode)
        g, s = self.grid, self.settings
        ops = self._ops._replace(pack_stream=functools.partial(
            self._ops.pack_stream, n_seats=n))
        step = build_h264_step_fn(mode, g.width, g.stripe_h, g.n_stripes,
                                  self._e_cap, self._w_cap,
                                  self._out_cap_local,
                                  s.paint_over_delay_frames,
                                  s.use_damage_gating, s.use_paint_over,
                                  candidates=self._candidates, ops=ops,
                                  scratch=self._scratch)

        def sharded_step(*args, **kw):
            data, lens, send, is_paint, overflow = step(*args, **kw)
            return data.view(-1), lens, send, is_paint, overflow.any()

        sharded_step.__name__ = f"h264_stripes{n}_{mode}_step"
        return sharded_step

    def _row_starts(self, out: dict[str, Any], lens: np.ndarray
                    ) -> np.ndarray:
        """Shard d's rows start at ``d * local_cap``; the local cap is read
        off ``out['data']`` (frames in flight may predate a growth)."""
        n = self.stripe_devices
        if n <= 1:
            return super()._row_starts(out, lens)
        local_cap = int(out["data"].shape[0]) // n
        rl = lens.shape[0] // n
        seg = lens.reshape(n, rl).astype(np.int64)
        starts = np.cumsum(seg, 1) - seg
        return (starts + local_cap * np.arange(n)[:, None]).reshape(-1)
