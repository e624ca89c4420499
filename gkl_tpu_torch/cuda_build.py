"""Build and load the port's CUDA kernels.

Every ``gkl_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per source, all started together, and linked
into one shared library with a plain C interface, loaded with ctypes.  No
PyTorch header is included, so the build takes seconds.  The library is
cached in ``native_lib.build_dir()`` (``GKL_TPU_CACHE_DIR`` when it is
set, else ``build/gkl_tpu_torch/``) by a hash of the sources and flags; a
failed build raises :class:`native_lib.BuildError`.  It is always built
from ``csrc/``: ``GKL_TPU_LIBRARY_PATH`` serves only the host libraries.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import threading

from . import native_lib

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

# -ftz=true: f32 subnormals flush to zero, as on the TPU the scaled PairHMM
# kernel was tuned on (its liveness flag and 2^90 window assume a value
# that leaves the normal range is gone).  -fmad=false: no a*b+c
# contraction, so each product and sum rounds as in the plain version.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-ftz=true", "-fmad=false", "-Xptxas", "-v",
]

_lib: ctypes.CDLL | None = None
_path: str | None = None
_lock = threading.Lock()


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise native_lib.BuildError("nvcc not found (set CUDA_HOME)")


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    # the three PairHMM kernels take an indexed batch and the tables
    indexed = [
        vp, i32, i32,            # hap_u (H, nu_h)
        vp, i32, i32,            # readq_u (2, R, nu_r)
        vp, i32, i32, i32,       # quals_u (3, R, nu_r) or NULL; constant iq, dq, gcp
        vp, vp, vp, vp, i32,     # ridx, hidx, haplen, rslen; P
        vp, vp,                  # ph2pr (128,), match-to-match (8256,)
    ]
    lib.gkl_pairhmm_scaled.argtypes = indexed + [
        vp, vp, vp,              # M, X, Y (H, P) f32: the boundary row between bands
        vp,                      # out (3, P) i32: mantissa bits, exp2, flag
        vp,                      # cudaStream_t
    ]
    lib.gkl_pairhmm_rows.argtypes = indexed + [
        vp, vp, vp,              # M, X, Y (H, P) f32: the boundary row between bands
        vp,                      # out (P,) f32
        vp,                      # cudaStream_t
    ]
    lib.gkl_pairhmm_cols.argtypes = indexed + [
        vp, vp, vp,              # M, X, Y (H, P) f32: the boundary row between passes
        i32,                     # rows per thread: 4, 8 or 16
        vp,                      # out (P,) f32
        vp,                      # cudaStream_t
    ]
    lib.gkl_sw_forward.argtypes = [
        vp, i32,                 # ref (P, N) u8, lane-major; N
        vp, i32,                 # alt (P, M) u8, lane-major; M
        vp, vp, i32,             # reflen, altlen (P,) i32; P
        i32, i32, i32, i32,      # match, mismatch, open, extend
        i32,                     # indel boundary (0/1)
        vp, vp,                  # H, F (P, M) i32: the boundary row between passes
        vp, vp, vp,              # bt (P, N/2, M) u8, lastrow (M, P), lastcol (P, N) i32
        i32,                     # rows per thread: 2, 4 or 8
        vp,                      # cudaStream_t
    ]
    lib.gkl_sw_walk.argtypes = [
        vp, i32, i32,            # bt (P, N/2, M) u8; N, M
        vp, vp,                  # lastrow (M, P), lastcol (P, N) i32
        vp, vp, i32,             # reflen, altlen (P,) i32; P
        i32, i32,                # overhang strategy (9-12); run rows a lane
        vp,                      # out (2 + runs, P) i32: counts, offsets, runs
        vp,                      # cudaStream_t
    ]
    # gkl_pdhmm in f32, gkl_pdhmm_f64 in f64: tables, planes and out
    pdhmm = [
        vp, vp, i32, i32,        # hap_u, happd_u (H, nu_h) u8
        vp, i32, i32,            # readq_u (5, R, nu_r) u8
        vp, vp, vp, vp, i32,     # ridx, hidx, haplen, rslen; P
        vp, vp,                  # q2e (255,), match-to-match (32640,)
        vp,                      # M, I, D, BM, BI, BD (6, P, H): the boundary
                                 # row between passes (unused in one pass)
        i32,                     # rows per thread: 2, 4 or 8 (f64: 2 or 4)
    ]
    lib.gkl_pdhmm.argtypes = pdhmm + [
        vp,                      # out (P,)
        vp,                      # cudaStream_t
    ]
    lib.gkl_pdhmm_f64.argtypes = pdhmm + [
        i32,                     # warps a lane (its passes in relay), 1 to 32
        vp,                      # out (P,)
        vp,                      # cudaStream_t
    ]
    for fn in (lib.gkl_pairhmm_scaled, lib.gkl_pairhmm_rows, lib.gkl_pairhmm_cols,
               lib.gkl_sw_forward, lib.gkl_sw_walk, lib.gkl_pdhmm, lib.gkl_pdhmm_f64):
        fn.restype = i32


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    global _lib, _path
    with _lock:
        if _lib is None:
            sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
            headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
            key = "".join(open(h).read() for h in headers)
            _path = native_lib.build_shared_library(
                "gkl_tpu_torch_kernels", sources, [nvcc_path(), *NVCC_FLAGS],
                link=["-shared"], key_extra=key, compile_each=True)
            lib = ctypes.CDLL(_path)
            _declare(lib)
            _lib = lib
        return _lib


def build_log() -> str:
    """The compiler's messages from the build of the loaded library
    (register and shared-memory use per kernel, from ``-Xptxas -v``)."""
    load()
    with open(_path + ".log") as f:
        return f.read()
