"""Build, load and launch the port's CUDA kernels.

Route: every ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``
into an object file, all compiles at once, and the objects are linked
into one shared library with a plain C interface, loaded through
``ctypes``. It is built at first use (never at import) into
``selkies_tpu_torch/_build/<hash>/``, keyed by a hash of every source
under ``csrc/`` and the flags, so a checkout builds once and a source
edit rebuilds.

Every C entry takes device pointers, sizes and the CUDA stream last, and
returns ``cudaGetLastError()`` after its launches; :func:`launch` raises
on a non-zero code and counts one launch per call in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("csc420_damage", "mb_encode", "cavlc_events", "pack_stream",
           "motion_select", "row_damage_probe", "jpeg_forward",
           "jpeg_events", "jpeg_pack", "synthetic_frame", "pad_frame",
           "watermark_blend", "csc444_damage", "mb_encode444",
           "roi_qp_plane", "mb_qp_delta", "halo_bands", "errors")
LIBRARY = "libselkies_cuda.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C entry -> argument types before the trailing stream
ENTRIES = {
    "csc420_damage": [_P] * 6 + [_I] * 3,
    "mb_encode_i": [_P] * 5 + [_I] + [_P] * 7 + [_I] * 2,
    "mb_encode_p": [_P] * 16 + [_I] * 2,
    "mb_encode_p_qp": [_P] * 17 + [_I] * 2,
    "cavlc_events": [_P] * 4 + [_I] * 3,
    "pack_stream": [_P] * 4 + [_I] + [_P] * 4 + [_I] * 6 + [_P] * 5,
    "pack_stream_seats": [_P] * 4 + [_I] + [_P] * 4 + [_I] * 7 + [_P] * 5,
    "motion_select": [_P] * 6 + [_I] * 4 + [_P] * 4,
    "row_damage_probe": [_P] * 3 + [_I] * 2,
    "jpeg_forward": [_P] * 7 + [_I] * 4,
    "jpeg_events": [_P] * 6 + [_I] * 4,
    "jpeg_pack": [_P] * 2 + [_I] * 5 + [_P] * 6,
    "jpeg_pack_seats": [_P] * 2 + [_I] * 6 + [_P] * 6,
    "synthetic_frame": [_P] + [_I] * 3,
    "synthetic_frames": [_P] + [_I] * 4,
    "pad_frame": [_P] * 2 + [_I] * 4,
    "watermark_blend": [_P] * 3 + [_I] * 6,
    "csc444_damage": [_P] * 6 + [_I] * 3,
    "mb_encode_i444": [_P] * 5 + [_I] + [_P] * 7 + [_I] * 2,
    "mb_encode_p444": [_P] * 16 + [_I] * 2,
    "cavlc_events444": [_P] * 4 + [_I] * 3,
    "motion_select444": [_P] * 6 + [_I] * 4 + [_P] * 4,
    "roi_qp_plane": [_P] * 4 + [_I] * 3,
    "mb_qp_delta": [_P] * 4 + [_I] * 2,
    "motion_select_halo": [_P] * 6 + [_I] * 7 + [_P] * 4,
    "motion_select_halo444": [_P] * 6 + [_I] * 7 + [_P] * 4,
    "halo_bands": [_P] + [_I] * 5 + [_P],
}

#: launches per C entry since the last :func:`reset_launches`
LAUNCHES = {name: 0 for name in ENTRIES}

_lock = threading.Lock()
_fns: dict = {}
_lib = None
#: how the library is loaded: ``ctypes.CDLL`` gives the interpreter lock
#: up around every call, ``ctypes.PyDLL`` keeps it
LOADER = ctypes.CDLL
_build_info: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "build on the machine with the card")
    return found


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> dict:
    """Compile every source to an object (all nvcc processes at once) and
    link them into one library, unless it exists.
    -> {"seconds", "dir", "ptxas": {source: compiler output}}."""
    with _lock:
        if _build_info:
            return _build_info
        t0 = time.perf_counter()
        out = build_dir()
        out.mkdir(parents=True, exist_ok=True)
        logs = {}
        if not (out / LIBRARY).exists():
            tmp = out / f"tmp.{os.getpid()}"
            tmp.mkdir(exist_ok=True)
            procs = {name: subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o",
                 str(tmp / f"{name}.o"), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for name in SOURCES}
            for name, proc in procs.items():
                logs[name], _ = proc.communicate()
            for name, proc in procs.items():
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed for {name}.cu:\n{logs[name]}")
            link = subprocess.run(
                [_nvcc(), *ARCH, "-shared", "-o", str(tmp / LIBRARY),
                 *(str(tmp / f"{name}.o") for name in SOURCES)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
            os.replace(tmp / LIBRARY, out / LIBRARY)
            shutil.rmtree(tmp, ignore_errors=True)
        _build_info.update(seconds=time.perf_counter() - t0, dir=str(out),
                           ptxas=logs)
        return _build_info


def _fn(entry: str):
    global _lib
    fn = _fns.get(entry)
    if fn is None:
        build()
        if _lib is None:
            _lib = LOADER(str(build_dir() / LIBRARY))
            _lib.sk_error_string.argtypes = [ctypes.c_int]
            _lib.sk_error_string.restype = ctypes.c_char_p
        fn = getattr(_lib, entry)
        fn.argtypes = ENTRIES[entry] + [_P]
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return fn


def launch(entry: str, *args) -> None:
    """Call C entry ``entry`` with tensors as pointers (None as a null
    pointer) and ints as C ints, on the current stream of the first
    tensor's device."""
    fn = _fn(entry)
    cargs, dev = [], None
    for a in args:
        if isinstance(a, torch.Tensor):
            dev = dev or a.device
            cargs.append(_P(a.data_ptr()))
        elif a is None:
            cargs.append(_P(None))
        else:
            cargs.append(_I(int(a)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(*cargs, _P(stream))
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc} "
                           f"({_lib.sk_error_string(rc).decode()})")
    LAUNCHES[entry] += 1


def render_tables_header() -> str:
    """The text of csrc/h264_tables.cuh, rendered from the port's numpy
    tables (the committed header must equal it; a CPU test checks)."""
    import numpy as np

    from ..codecs import h264_tables as HT
    from .colorspace import _CSC_601_FULL
    from .h264_encode import MV_LAMBDA_NP
    from .h264_planes import (_CDC_PACK, _CT_PACK, _RB_PACK, _SCAN_RASTER,
                              _TZ_PACK, _TZC_PACK)

    def arr(name, vals, ctype="int"):
        vals = [int(v) for v in np.asarray(vals).reshape(-1)]
        body = ",".join(str(v) for v in vals)
        return (f"static __constant__ {ctype} {name}[{len(vals)}] = "
                f"{{{body}}};\n")
    zz = HT.ZIGZAG4_NP
    lines = ["// Generated by selkies_tpu_torch/ops/_cuda.py:"
             "render_tables_header() from\n",
             "// selkies_tpu_torch/codecs/h264_tables.py; do not edit.\n",
             "#pragma once\n"]
    lines.append(arr("K_MF", HT.MF_NP))
    lines.append(arr("K_V", HT.V_NP))
    lines.append(arr("K_QPC", HT.QPC_NP))
    lines.append(arr("K_POS_CLS", HT.POS_CLS_NP))
    lines.append(arr("K_ZIGZAG", zz))
    lines.append(arr("K_INV_ZIGZAG", np.argsort(zz)))
    lines.append(arr("K_SCAN_RASTER", _SCAN_RASTER))
    lines.append(arr("K_CODING_OF_RASTER", np.argsort(_SCAN_RASTER)))
    lines.append(arr("K_CT", _CT_PACK))
    lines.append(arr("K_CDC", _CDC_PACK))
    lines.append(arr("K_TZ", _TZ_PACK))
    lines.append(arr("K_TZC", _TZC_PACK))
    lines.append(arr("K_RB", _RB_PACK))
    lines.append(arr("K_CBP2CODE", HT.CBP_INTER_CBP2CODE))
    lines.append(arr("K_CBP444", HT.CBP444_INTER_CBP2CODE))
    lines.append(arr("K_MV_LAMBDA", MV_LAMBDA_NP))
    m = ",".join(float(v).hex() + "f" for v in _CSC_601_FULL.reshape(-1))
    lines.append(f"static __constant__ float K_CSC[9] = {{{m}}};\n")
    return "".join(lines)


def render_jpeg_tables_header() -> str:
    """The text of csrc/jpeg_tables.cuh, rendered from the port's numpy
    tables (the committed header must equal it; a CPU test checks)."""
    import numpy as np

    from .dct import dct8_matrix, zigzag_order
    from .jpeg_entropy import _host_luts

    def ints(name, vals):
        vals = [int(v) for v in np.asarray(vals).reshape(-1)]
        return (f"static __constant__ int {name}[{len(vals)}] = "
                f"{{{','.join(str(v) for v in vals)}}};\n")
    luts = _host_luts()
    dc = (luts["dc_len"] << 16) | luts["dc_code"]            # (2, 256)
    ac = (luts["ac_len"] << 16) | luts["ac_code"]
    d = ",".join(float(v).hex() + "f" for v in dct8_matrix().reshape(-1))
    return "".join([
        "// Generated by selkies_tpu_torch/ops/_cuda.py:"
        "render_jpeg_tables_header() from\n",
        "// selkies_tpu_torch/ops/dct.py and codecs/jpeg.py; do not edit.\n",
        "#pragma once\n",
        f"static __constant__ float K_DCT8[64] = {{{d}}};\n",
        ints("K_ZIGZAG8", zigzag_order()),
        "// Huffman codes, len << 16 | code: [luma, chroma] x symbol\n",
        ints("K_JPEG_DC", dc[:, :16]),
        ints("K_JPEG_AC", ac)])
