"""H.264 4x4 transform tables (ITU-T H.264 §8.5) for the port.

The constants of selkies_tpu/ops/h264_transform.py that the plane-layout
encoder uses, as numpy arrays taken from the port's own table copy. The
arithmetic itself lives in ops/h264_planes.py (plain PyTorch) and in the
CUDA kernels (csrc/h264_common.cuh).
"""

from __future__ import annotations

from ..codecs import h264_tables as HT

#: position class within a 4x4 block: 0 for (0,0),(0,2),(2,0),(2,2);
#: 1 for (1,1),(1,3),(3,1),(3,3); 2 otherwise
_POS_CLS = HT.POS_CLS_NP
#: encoder quant multipliers, rows qp%6, columns position class (JM)
_MF = HT.MF_NP
#: decoder rescale multipliers (normAdjust4x4), same indexing
_V = HT.V_NP
#: chroma QP mapping (table 8-15, chroma_qp_index_offset = 0)
_QPC = HT.QPC_NP
#: zigzag scan for 4x4 blocks (§8.5.6): raster index per scan position
ZIGZAG4 = HT.ZIGZAG4_NP
