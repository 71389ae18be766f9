"""selkies_tpu_torch — the PyTorch/CUDA port of selkies_tpu's encode engine.

The JAX package ``selkies_tpu`` is the reference; this package keeps its
module names (``codecs/h264``, ``ops/h264_planes``, ``engine/encoder``
...) so every function has a findable counterpart, but it imports neither
``jax`` nor anything of ``selkies_tpu``: what it needs of the reference's
jax-free modules (CAVLC and JPEG tables, bitstream headers, settings) is
copied.

The slices ported so far run the engine loop and two sessions on one
device:

- ``engine.ScreenCapture``: a frame source (the synthetic desktop, host
  arrays, X11), padding to the encode grid, the watermark, and the
  depth-N pipeline ring that finalizes and delivers chunks in order on a
  second thread;
- the H.264 4:2:0 session in the reference's default configuration
  (scroll motion search, the damage-proportional band path) and in its
  stock one (zero-motion P frames): IDR and P frames, damage gating,
  paint-over, overflow growth;
- the JPEG stripe session (the server's default encoder), 4:2:0 and
  4:4:4: damage gating, paint-over tables, overflow growth.

Their device arithmetic runs in twelve hand-written CUDA kernels for
Hopper (``csrc/``, built on first use by ``ops/_cuda.py``); every kernel
has a plain PyTorch version beside its wrapper, which the wrapper uses
only for tensors that lie on the CPU.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
