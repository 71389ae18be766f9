"""Frame sources: where pixels come from.

The counterpart of selkies_tpu/engine/sources.py. A source is anything
that yields ``(H, W, 3) uint8`` frames on the session's device:

- :class:`SyntheticSource` — an animated test pattern generated on the
  device by K10 ``synthetic_frame`` (ops/frames.py; no host->device
  upload at all); drives tests, the capture loop's smoke run and the
  benchmark.
- :class:`ArraySource` — host numpy frames (screenshots, video files,
  shared-memory screen grabs), uploaded once through pinned memory.
- :class:`X11Source` — live X11 capture through libX11/XShm (ctypes; no
  X server in CI, so it degrades to unavailable).

The reference's ``WaylandSource`` (a client of its own Wayland protocol
package) is not ported yet (ROADMAP A5b):
``make_source("wayland")`` raises, and so does ``"auto"`` when X11 is
unavailable and ``WAYLAND_DISPLAY`` names a compositor, rather than
stream the test pattern in place of that desktop.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import logging
import os
from typing import Protocol

import numpy as np
import torch

from .._device import resolve_device
from ..ops.frames import synthetic_frame
from .readback import upload

logger = logging.getLogger("selkies_tpu_torch.engine.sources")

#: what the unported Wayland source raises
WAYLAND_TODO = ("WaylandSource (the Wayland capture source, ROADMAP A5b) "
                "is not ported yet")


class FrameSource(Protocol):
    width: int
    height: int

    def get_frame(self, tick: int) -> torch.Tensor:
        """Return the current frame as an (H, W, 3) uint8 tensor on the
        source's device."""
        ...

    def close(self) -> None:
        ...


class SyntheticSource:
    """Device-generated animated pattern (K10); ``static_after`` freezes
    motion to exercise damage gating / paint-over."""

    def __init__(self, width: int, height: int,
                 static_after: int | None = None, device=None):
        self.width, self.height = width, height
        self.static_after = static_after
        self.device = resolve_device(device)

    def get_frame(self, tick: int) -> torch.Tensor:
        if self.static_after is not None:
            tick = min(tick, self.static_after)
        return synthetic_frame(self.height, self.width, tick, self.device)

    def close(self) -> None:
        pass


class ArraySource:
    """Wraps host frames; replays a list cyclically."""

    def __init__(self, frames: list[np.ndarray], device=None):
        if not frames:
            raise ValueError("need at least one frame")
        self.height, self.width = frames[0].shape[:2]
        self.device = resolve_device(device)
        self._frames = [upload(np.ascontiguousarray(f), self.device)
                        for f in frames]

    def get_frame(self, tick: int) -> torch.Tensor:
        return self._frames[tick % len(self._frames)]

    def close(self) -> None:
        self._frames.clear()


class _XImage(ctypes.Structure):
    _fields_ = [("width", ctypes.c_int), ("height", ctypes.c_int),
                ("xoffset", ctypes.c_int), ("format", ctypes.c_int),
                ("data", ctypes.POINTER(ctypes.c_char)),
                ("byte_order", ctypes.c_int),
                ("bitmap_unit", ctypes.c_int),
                ("bitmap_bit_order", ctypes.c_int),
                ("bitmap_pad", ctypes.c_int),
                ("depth", ctypes.c_int),
                ("bytes_per_line", ctypes.c_int),
                ("bits_per_pixel", ctypes.c_int)]


class _XShmSegmentInfo(ctypes.Structure):
    _fields_ = [("shmseg", ctypes.c_ulong), ("shmid", ctypes.c_int),
                ("shmaddr", ctypes.c_void_p), ("readOnly", ctypes.c_int)]


class _XFixesCursorImage(ctypes.Structure):
    _fields_ = [("x", ctypes.c_short), ("y", ctypes.c_short),
                ("width", ctypes.c_ushort), ("height", ctypes.c_ushort),
                ("xhot", ctypes.c_ushort), ("yhot", ctypes.c_ushort),
                ("cursor_serial", ctypes.c_ulong),
                ("pixels", ctypes.POINTER(ctypes.c_ulong)),
                ("atom", ctypes.c_ulong),
                ("name", ctypes.c_char_p)]


class X11Source:
    """Live X11 screen capture (ctypes libX11), upgraded with:

    - **XSHM**: the server blits straight into a shared-memory segment
      (XShmGetImage) — no protocol round-trip copy per frame; falls back
      to XGetImage when the SHM extension is unavailable (remote X).
    - **XDamage**: when the damage extension reports no changes since the
      last frame, the previous DEVICE tensor is returned untouched — no
      grab and no host->device upload at all for static desktops.
    - **XFixes cursor**: ``poll_cursor()`` returns the cursor image as
      RGBA whenever its serial changes (reference streams these as
      ``cursor,{json}`` messages, display_utils.py:1683-1789).

    Raises ``RuntimeError`` when no display is reachable; callers degrade
    like the reference does when pixelflux is missing (selkies.py:177-189).
    """

    def __init__(self, display: str = ":0", width: int | None = None,
                 height: int | None = None, x: int = 0, y: int = 0,
                 device=None):
        self.device = resolve_device(device)
        lib = ctypes.util.find_library("X11")
        if lib is None:
            raise RuntimeError("libX11 not found")
        self._x = ctypes.CDLL(lib)
        self._x.XOpenDisplay.restype = ctypes.c_void_p
        self._x.XGetImage.restype = ctypes.c_void_p
        self._dpy = self._x.XOpenDisplay(display.encode())
        if not self._dpy:
            raise RuntimeError(f"cannot open X display {display}")
        self._x.XDefaultRootWindow.restype = ctypes.c_ulong
        self._root = self._x.XDefaultRootWindow(ctypes.c_void_p(self._dpy))
        scr = self._x.XDefaultScreen(ctypes.c_void_p(self._dpy))
        self.width = width or self._x.XDisplayWidth(
            ctypes.c_void_p(self._dpy), scr)
        self.height = height or self._x.XDisplayHeight(
            ctypes.c_void_p(self._dpy), scr)
        self._ox, self._oy = x, y
        self._depth = self._x.XDefaultDepth(ctypes.c_void_p(self._dpy), scr)
        self._cached: torch.Tensor | None = None
        self._display_name = display
        self._install_error_handler()
        self._init_shm(lib)
        self._init_damage()
        self._init_cursor()

    _err_handler_ref = None   # keep the CFUNCTYPE alive process-wide

    def _install_error_handler(self) -> None:
        """Xlib's DEFAULT error handler calls exit() on any async protocol
        error (e.g. a BadAccess from XShmAttach against a remote display)
        — fatal for a long-lived server. Replace it with a logger."""
        if X11Source._err_handler_ref is not None:
            return
        handler_t = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p)

        def _on_x_error(_dpy, _ev):
            logger.warning("X protocol error (ignored)")
            return 0

        X11Source._err_handler_ref = handler_t(_on_x_error)
        self._x.XSetErrorHandler(X11Source._err_handler_ref)

    # ------------------------------------------------------------------ xshm
    def _init_shm(self, x11_lib: str) -> None:
        self._shm = None
        # MIT-SHM only works when client and server share a kernel: a
        # display name with a host part (ssh -X, tcp) must use XGetImage
        if not self._display_name.startswith(":"):
            logger.info("remote display %s: XSHM skipped", self._display_name)
            return
        ext = ctypes.util.find_library("Xext")
        if ext is None:
            return
        shmid = -1
        addr = None
        libc = None
        IPC_CREAT, IPC_RMID = 0o1000, 0
        try:
            xext = ctypes.CDLL(ext)
            if not xext.XShmQueryExtension(ctypes.c_void_p(self._dpy)):
                return
            libc = ctypes.CDLL(None, use_errno=True)
            xext.XShmCreateImage.restype = ctypes.POINTER(_XImage)
            self._x.XDefaultVisual.restype = ctypes.c_void_p
            visual = self._x.XDefaultVisual(
                ctypes.c_void_p(self._dpy),
                self._x.XDefaultScreen(ctypes.c_void_p(self._dpy)))
            seg = _XShmSegmentInfo()
            img_p = xext.XShmCreateImage(
                ctypes.c_void_p(self._dpy), ctypes.c_void_p(visual),
                ctypes.c_uint(self._depth), 2,  # ZPixmap
                None, ctypes.byref(seg),
                ctypes.c_uint(self.width), ctypes.c_uint(self.height))
            if not img_p:
                return
            img = img_p.contents
            size = img.bytes_per_line * img.height
            shmid = libc.shmget(0, size, IPC_CREAT | 0o600)
            if shmid < 0:
                return
            libc.shmat.restype = ctypes.c_void_p
            addr = libc.shmat(shmid, None, 0)
            if addr is None or addr == ctypes.c_void_p(-1).value:
                addr = None
                return
            seg.shmid = shmid
            seg.shmaddr = addr
            seg.readOnly = 0
            img.data = ctypes.cast(addr, ctypes.POINTER(ctypes.c_char))
            if not xext.XShmAttach(ctypes.c_void_p(self._dpy),
                                   ctypes.byref(seg)):
                return
            self._x.XSync(ctypes.c_void_p(self._dpy), 0)
            stride = img.bytes_per_line
            self._shm = (xext, seg, img_p,
                         np.frombuffer(
                             (ctypes.c_ubyte * size).from_address(addr),
                             np.uint8).reshape(img.height, stride // 4, 4))
            logger.info("x11 capture using XSHM (%dx%d)",
                        self.width, self.height)
        except Exception as e:  # degrade to XGetImage
            logger.info("XSHM unavailable (%s); using XGetImage", e)
            self._shm = None
        finally:
            if shmid >= 0 and libc is not None:
                # mark for auto-removal once all attachments drop; also
                # frees the segment on every failure path above
                libc.shmctl(shmid, IPC_RMID, None)
            if self._shm is None and addr is not None and libc is not None:
                libc.shmdt(ctypes.c_void_p(addr))

    # ---------------------------------------------------------------- damage
    def _init_damage(self) -> None:
        self._damage = None
        lib = ctypes.util.find_library("Xdamage")
        if lib is None:
            return
        try:
            xdmg = ctypes.CDLL(lib)
            ev_base = ctypes.c_int(0)
            err_base = ctypes.c_int(0)
            if not xdmg.XDamageQueryExtension(
                    ctypes.c_void_p(self._dpy), ctypes.byref(ev_base),
                    ctypes.byref(err_base)):
                return
            # XDamageReportNonEmpty = 1: one event per damage episode
            dmg = xdmg.XDamageCreate(ctypes.c_void_p(self._dpy),
                                     ctypes.c_ulong(self._root), 1)
            self._damage = (xdmg, dmg, ev_base.value)
            logger.info("x11 capture damage-gated (XDamage)")
        except Exception as e:
            logger.info("XDamage unavailable (%s)", e)
            self._damage = None

    def _damage_pending(self) -> bool:
        """True when the root window changed since the last check (or when
        damage tracking is unavailable — always grab then)."""
        if self._damage is None:
            return True
        xdmg, dmg, ev_base = self._damage
        changed = False
        # drain the event queue; any XDamageNotify (ev_base+0) counts.
        # XEvent.type is a C int; bit 0x80 marks send_event copies.
        ev = (ctypes.c_long * 24)()   # >= sizeof(XEvent)
        ev_int = ctypes.cast(ev, ctypes.POINTER(ctypes.c_int))
        while self._x.XPending(ctypes.c_void_p(self._dpy)) > 0:
            self._x.XNextEvent(ctypes.c_void_p(self._dpy), ev)
            if (ev_int[0] & 0x7F) == ev_base:
                changed = True
        if changed:
            xdmg.XDamageSubtract(ctypes.c_void_p(self._dpy),
                                 ctypes.c_ulong(dmg), 0, 0)
        return changed

    # ---------------------------------------------------------------- cursor
    def _init_cursor(self) -> None:
        self._xfixes = None
        self._cursor_serial = 0
        lib = ctypes.util.find_library("Xfixes")
        if lib is None:
            return
        try:
            xf = ctypes.CDLL(lib)
            ev = ctypes.c_int(0)
            err = ctypes.c_int(0)
            if not xf.XFixesQueryExtension(ctypes.c_void_p(self._dpy),
                                           ctypes.byref(ev),
                                           ctypes.byref(err)):
                return
            xf.XFixesGetCursorImage.restype = \
                ctypes.POINTER(_XFixesCursorImage)
            self._xfixes = xf
        except Exception:
            self._xfixes = None

    def poll_cursor(self) -> dict | None:
        """-> {rgba (H,W,4) uint8, xhot, yhot, serial} when the cursor
        image changed since the last poll, else None."""
        if self._xfixes is None:
            return None
        img_p = self._xfixes.XFixesGetCursorImage(ctypes.c_void_p(self._dpy))
        if not img_p:
            return None
        ci = img_p.contents
        if ci.cursor_serial == self._cursor_serial:
            self._x.XFree(img_p)
            return None
        self._cursor_serial = ci.cursor_serial
        n = ci.width * ci.height
        # pixels are unsigned long (64-bit) holding 32-bit ARGB each
        raw = np.ctypeslib.as_array(ci.pixels, shape=(n,)).astype(np.uint32)
        argb = raw.reshape(ci.height, ci.width)
        a = (argb >> 24) & 0xFF
        r = (argb >> 16) & 0xFF
        g = (argb >> 8) & 0xFF
        b = argb & 0xFF
        # un-premultiply (X stores premultiplied alpha)
        af = np.maximum(a, 1).astype(np.float32)
        rgba = np.stack([
            np.clip(r * 255.0 / af, 0, 255),
            np.clip(g * 255.0 / af, 0, 255),
            np.clip(b * 255.0 / af, 0, 255),
            a], axis=-1).astype(np.uint8)
        out = {"rgba": rgba, "xhot": int(ci.xhot), "yhot": int(ci.yhot),
               "serial": int(ci.cursor_serial)}
        self._x.XFree(img_p)
        return out

    # ----------------------------------------------------------------- frame
    def get_frame(self, tick: int) -> torch.Tensor:
        if self._cached is not None and not self._damage_pending():
            return self._cached     # zero-copy, zero-upload static frame
        if self._shm is not None:
            xext, seg, img_p, view = self._shm
            if not xext.XShmGetImage(
                    ctypes.c_void_p(self._dpy), ctypes.c_ulong(self._root),
                    img_p, ctypes.c_int(self._ox), ctypes.c_int(self._oy),
                    ctypes.c_ulong(0xFFFFFFFF)):
                raise RuntimeError("XShmGetImage failed")
            rgb = view[:self.height, :self.width, [2, 1, 0]]  # BGRX->RGB
        else:
            ZPixmap = 2
            img_p = self._x.XGetImage(
                ctypes.c_void_p(self._dpy), ctypes.c_ulong(self._root),
                self._ox, self._oy, self.width, self.height,
                ctypes.c_ulong(0xFFFFFFFF), ZPixmap)
            if not img_p:
                raise RuntimeError("XGetImage failed")
            img = ctypes.cast(img_p, ctypes.POINTER(_XImage)).contents
            stride = img.bytes_per_line
            buf = ctypes.string_at(img.data, stride * img.height)
            arr = np.frombuffer(buf, np.uint8).reshape(
                img.height, stride // 4, 4)
            rgb = arr[:, :img.width, [2, 1, 0]]
            self._x.XDestroyImage(ctypes.c_void_p(img_p))
        self._cached = upload(np.ascontiguousarray(rgb), self.device)
        return self._cached

    def close(self) -> None:
        if self._dpy:
            if self._damage is not None:
                try:
                    self._damage[0].XDamageDestroy(
                        ctypes.c_void_p(self._dpy),
                        ctypes.c_ulong(self._damage[1]))
                except Exception:
                    pass
            if self._shm is not None:
                try:
                    xext, seg, img_p, _ = self._shm
                    xext.XShmDetach(ctypes.c_void_p(self._dpy),
                                    ctypes.byref(seg))
                    ctypes.CDLL(None).shmdt(
                        ctypes.c_void_p(seg.shmaddr))
                except Exception:
                    pass
            self._x.XCloseDisplay(ctypes.c_void_p(self._dpy))
            self._dpy = None


def make_source(kind: str, width: int, height: int, display: str = ":0",
                device=None) -> FrameSource:
    """Source factory used by ScreenCapture; 'auto' prefers a live X
    display, then the synthetic pattern. ``device`` None means the card
    (``cuda``; raises without one). The Wayland source is not ported
    (:data:`WAYLAND_TODO`): 'wayland' raises, and 'auto' raises where the
    reference would have opened the compositor ``WAYLAND_DISPLAY``
    names."""
    if kind == "synthetic":
        return SyntheticSource(width, height, device=device)
    if kind == "synthetic-static":
        # freezes after the first frame: exercises damage gating, paint-over
        # and the keyframe_interval refresh without X
        return SyntheticSource(width, height, static_after=0, device=device)
    if kind == "x11":
        return X11Source(display, width, height, device=device)
    if kind == "wayland":
        raise NotImplementedError(WAYLAND_TODO)
    if kind == "auto":
        # resolved first: a missing card must raise, not read as a
        # missing X display
        device = resolve_device(device)
        try:
            return X11Source(display, width, height, device=device)
        except (RuntimeError, OSError) as e:
            logger.info("X11 unavailable (%s)", e)
        if os.environ.get("WAYLAND_DISPLAY"):
            raise NotImplementedError(
                f"{WAYLAND_TODO}; WAYLAND_DISPLAY="
                f"{os.environ['WAYLAND_DISPLAY']} names a compositor the "
                "port cannot capture")
        logger.info("no Wayland compositor named; using synthetic source")
        return SyntheticSource(width, height, device=device)
    raise ValueError(f"unknown source kind {kind!r}")
