"""Host C++ runtime loader — counterpart of ``gkl_tpu/native_lib.py``.

The port keeps its own byte-identical copy of the JAX package's C++ runtime
sources in ``gkl_tpu_torch/native/`` (the originals are in
``gkl_tpu/native/``; the port reads nothing there) and compiles them with
g++ on first use, keyed by a hash of the sources, flags and host CPU, into
:func:`build_dir`.  It reads the JAX package's two settings:

* ``GKL_TPU_CACHE_DIR`` — build here (the host libraries and the CUDA
  kernel library) instead of ``build/gkl_tpu_torch/`` under the repository
  root; file names carry the host key, so hosts may share the directory;
* ``GKL_TPU_LIBRARY_PATH`` — load the prebuilt host libraries
  (``lib<name>.so``) from this directory instead of compiling.  The CUDA
  kernel library is never taken from it: ``cuda_build`` always builds the
  kernels from ``csrc/``.

Unlike the JAX package, a failed build or a library missing under
``GKL_TPU_LIBRARY_PATH`` raises: the port has no pure-Python fallbacks for
these libraries, and no ``GKL_TPU_NATIVE=0``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_BUILD_DIR = os.path.join(REPO_ROOT, "build", "gkl_tpu_torch")
NATIVE_SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")

_SRC = {
    "gkl_codec": ["codec.cc", "deflate_fast.cc", "inflate_fast.cc"],
    "gkl_bam": ["bam_scan.cc"],
    "gkl_pairhmm_oracle": ["pairhmm_oracle.cc"],
    "gkl_sw_runtime": ["sw_runtime.cc", "sw_cigar.cc"],
    "gkl_pdhmm_oracle": ["pdhmm_oracle.cc"],
}
_LINK = {"gkl_codec": ["-lz"], "gkl_bam": [], "gkl_pairhmm_oracle": [],
         "gkl_sw_runtime": [], "gkl_pdhmm_oracle": []}

_cache: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class BuildError(RuntimeError):
    """A native or CUDA library failed to compile, or is not where
    ``GKL_TPU_LIBRARY_PATH`` says."""


def build_dir() -> str:
    """Where libraries are built: ``GKL_TPU_CACHE_DIR`` when it is set,
    else ``build/gkl_tpu_torch/`` under the repository root."""
    return os.environ.get("GKL_TPU_CACHE_DIR") or DEFAULT_BUILD_DIR


def _host_tag() -> str:
    """Platform and CPU feature flags: ``-march=native`` binaries run only
    on hosts with the same ISA extensions."""
    bits = [platform.machine(), platform.system()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    bits.append(" ".join(sorted(line.split(":", 1)[1].split())))
                    break
    except OSError:
        pass
    return "|".join(bits)


def build_shared_library(name: str, sources: list[str], command: list[str],
                         link: list[str] = (), key_extra: str = "",
                         compile_each: bool = False) -> str:
    """Compile ``sources`` with ``command -o out sources link`` into
    :func:`build_dir` unless a library built from the same sources and
    command is already there; returns its path.  With ``compile_each`` every source
    is first compiled alone (``command -c``), all at once, and the objects
    are linked.  The compiler's messages are kept beside the library in
    ``<path>.log``.  A file lock serialises concurrent builds by several
    processes; the output is renamed into place whole."""
    h = hashlib.sha256()
    h.update(" ".join([*command, *link]).encode())
    h.update(key_extra.encode())
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    out_dir = build_dir()
    so_path = os.path.join(out_dir, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{name}.lock"), "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if os.path.exists(so_path):
            return so_path
        tmp = f"{so_path}.{os.getpid()}.tmp"
        inputs, log = sources, ""
        if compile_each:
            inputs = [f"{tmp}.{i}.o" for i in range(len(sources))]
            procs = [subprocess.Popen([*command, "-c", "-o", o, s], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for o, s in zip(inputs, sources)]
            outs = [p.communicate()[0] for p in procs]
            log = "".join(outs)
            for p, out in zip(procs, outs):
                if p.returncode != 0:
                    raise BuildError(f"build of {name} failed:\n{' '.join(p.args)}\n{out}")
        proc = subprocess.run([*command, "-o", tmp, *inputs, *link],
                              capture_output=True, text=True)
        if compile_each:
            for o in inputs:
                os.remove(o)
        if proc.returncode != 0:
            raise BuildError(f"build of {name} failed:\n{' '.join(proc.args)}\n"
                             f"{proc.stdout}{proc.stderr}")
        with open(so_path + ".log", "w") as f:
            f.write(log + proc.stdout + proc.stderr)
        os.replace(tmp, so_path)
    return so_path


def load(name: str) -> ctypes.CDLL:
    """Load a host runtime library by name: prebuilt from
    ``GKL_TPU_LIBRARY_PATH`` when it is set, else built if needed."""
    if name not in _SRC:
        raise ValueError(f"unknown native library: {name!r}")
    with _lock:
        lib = _cache.get(name)
        if lib is None:
            prebuilt = os.environ.get("GKL_TPU_LIBRARY_PATH")
            if prebuilt:
                path = os.path.join(prebuilt, f"lib{name}.so")
                if not os.path.exists(path):
                    raise BuildError(f"GKL_TPU_LIBRARY_PATH={prebuilt} holds no lib{name}.so")
            else:
                sources = [os.path.join(NATIVE_SRC_DIR, s) for s in _SRC[name]]
                # -march=native is safe: libraries compile on the host that
                # runs them, and the cache key carries that host's CPU flags
                cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
                path = build_shared_library(name, sources, cmd, _LINK[name],
                                            key_extra=_host_tag())
            lib = _cache[name] = ctypes.CDLL(path)
        return lib
