"""The capture+encode engine on PyTorch/CUDA: :class:`ScreenCapture`
(the capture loop and its depth-N pipeline), the encoder sessions and
their host-side plumbing."""

from .types import CaptureSettings, EncodedChunk  # noqa: F401
from .capture import ScreenCapture  # noqa: F401
