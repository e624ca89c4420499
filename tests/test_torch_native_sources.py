"""The port builds its host C++ and its kernels from its own sources.

Every source that ``native_lib`` and ``cuda_build`` compile lies under
``gkl_tpu_torch/``.  The port's copies of the JAX package's runtime sources
(``gkl_tpu_torch/native/``) are byte-identical to their originals in
``gkl_tpu/native/``, so the f64 oracles that the port's rescues run are the
reference's; beside them the port has one source of its own
(``sw_cigar.cc``).  The build settings the port shares with the JAX package are
honoured: ``GKL_TPU_CACHE_DIR`` (where every library builds) and
``GKL_TPU_LIBRARY_PATH`` (prebuilt host libraries; never the kernels).
Nothing here compiles a kernel: the build calls are recorded and stopped
before the compiler runs, save two g++ builds, of the PairHMM oracle from a
copy of the package alone and of the BAM scanner into a cache directory."""

import os
import shutil
import subprocess
import sys

import pytest

from gkl_tpu_torch import cuda_build, native_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "gkl_tpu_torch")
ORIGINALS = os.path.join(ROOT, "gkl_tpu", "native")
# the port's own host source (the CIGAR strings of a device-walked chunk),
# which has no original; every other source is a copy
PORT_SOURCES = ["sw_cigar.cc"]
SOURCES = sorted({s for sources in native_lib._SRC.values() for s in sources}
                 - set(PORT_SOURCES))


class _Stop(Exception):
    """Raised in place of a build, once its sources are recorded."""


def _in_port(path: str) -> bool:
    real = os.path.realpath(path)
    return os.path.commonpath([real, os.path.realpath(PORT)]) == os.path.realpath(PORT)


def _record_builds(monkeypatch):
    """Replace ``build_shared_library`` with a stand-in that records its
    sources and stops."""
    seen = []

    def build(name, sources, command, link=(), key_extra="", compile_each=False):
        seen.append((name, list(sources)))
        raise _Stop(name)

    monkeypatch.setattr(native_lib, "build_shared_library", build)
    return seen


def test_source_dirs_are_the_ports():
    assert os.path.realpath(native_lib.NATIVE_SRC_DIR) == os.path.realpath(
        os.path.join(PORT, "native"))
    assert os.path.realpath(cuda_build.CSRC_DIR) == os.path.realpath(os.path.join(PORT, "csrc"))


def test_copies_are_the_runtime_sources():
    """The port's copy holds the seven sources its libraries build, and
    the JAX package has no runtime source that the port lacks; beside them
    the port has only its own ``PORT_SOURCES``, which a library builds."""
    assert len(SOURCES) == 7
    copied = sorted(f for f in os.listdir(native_lib.NATIVE_SRC_DIR) if f.endswith(".cc"))
    original = sorted(f for f in os.listdir(ORIGINALS) if f.endswith(".cc"))
    assert sorted(set(copied) - set(PORT_SOURCES)) == original == SOURCES
    assert set(PORT_SOURCES) <= set(copied) and not set(PORT_SOURCES) & set(original)
    assert all(any(s in srcs for srcs in native_lib._SRC.values()) for s in PORT_SOURCES)


@pytest.mark.parametrize("name", SOURCES)
def test_copy_is_byte_identical(name):
    with open(os.path.join(native_lib.NATIVE_SRC_DIR, name), "rb") as f:
        copy = f.read()
    with open(os.path.join(ORIGINALS, name), "rb") as f:
        assert copy == f.read()


@pytest.mark.parametrize("lib", sorted(native_lib._SRC))
def test_native_build_reads_only_the_port(monkeypatch, lib):
    seen = _record_builds(monkeypatch)
    monkeypatch.setattr(native_lib, "_cache", {})
    with pytest.raises(_Stop):
        native_lib.load(lib)
    [(name, sources)] = seen
    assert name == lib
    assert [os.path.basename(s) for s in sources] == native_lib._SRC[lib]
    assert all(_in_port(s) for s in sources), sources


def test_cuda_build_reads_only_the_port(monkeypatch):
    """The kernel library compiles every ``csrc/*.cu`` of the port and
    nothing else."""
    seen = _record_builds(monkeypatch)
    monkeypatch.setattr(cuda_build, "_lib", None)
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: "nvcc")
    with pytest.raises(_Stop):
        cuda_build.load()
    [(name, sources)] = seen
    assert name == "gkl_tpu_torch_kernels"
    assert sorted(os.path.basename(s) for s in sources) == [
        "pairhmm_cols.cu", "pairhmm_scaled.cu", "pdhmm.cu", "sw_forward.cu", "sw_walk.cu"]
    assert all(_in_port(s) for s in sources), sources


@pytest.fixture
def fresh_loaders(monkeypatch):
    """The loaders' module caches emptied and the build settings unset, all
    restored after the test."""
    monkeypatch.setattr(native_lib, "_cache", {})
    monkeypatch.setattr(cuda_build, "_lib", None)
    monkeypatch.setattr(cuda_build, "_path", None)
    monkeypatch.delenv("GKL_TPU_CACHE_DIR", raising=False)
    monkeypatch.delenv("GKL_TPU_LIBRARY_PATH", raising=False)
    return monkeypatch


@pytest.fixture(scope="module")
def built_bam_library(tmp_path_factory):
    """``gkl_bam`` (the smallest host library) built once with
    ``GKL_TPU_CACHE_DIR`` pointing at a fresh directory: (directory, path)."""
    cache = tmp_path_factory.mktemp("cache")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native_lib, "_cache", {})
        mp.delenv("GKL_TPU_LIBRARY_PATH", raising=False)
        mp.setenv("GKL_TPU_CACHE_DIR", str(cache))
        path = native_lib.load("gkl_bam")._name
    return cache, path


def test_cache_dir_is_where_host_libraries_build(built_bam_library, fresh_loaders):
    cache, path = built_bam_library
    assert os.path.dirname(path) == str(cache)
    assert os.path.basename(path).startswith("libgkl_bam-") and os.path.exists(path)
    assert native_lib.build_dir() == native_lib.DEFAULT_BUILD_DIR
    fresh_loaders.setenv("GKL_TPU_CACHE_DIR", str(cache))
    assert native_lib.build_dir() == str(cache)


def test_library_path_loads_prebuilt_without_compiling(built_bam_library, fresh_loaders,
                                                       tmp_path):
    _, path = built_bam_library
    shutil.copy(path, tmp_path / "libgkl_bam.so")
    fresh_loaders.setenv("GKL_TPU_LIBRARY_PATH", str(tmp_path))
    seen = _record_builds(fresh_loaders)
    lib = native_lib.load("gkl_bam")
    assert lib._name == str(tmp_path / "libgkl_bam.so") and not seen
    assert native_lib.load("gkl_bam") is lib


def test_library_path_missing_library_raises(fresh_loaders, tmp_path):
    """A library missing under ``GKL_TPU_LIBRARY_PATH`` raises; the port
    neither compiles it instead nor returns None."""
    fresh_loaders.setenv("GKL_TPU_LIBRARY_PATH", str(tmp_path))
    seen = _record_builds(fresh_loaders)
    with pytest.raises(native_lib.BuildError, match="libgkl_sw_runtime.so"):
        native_lib.load("gkl_sw_runtime")
    assert not seen and "gkl_sw_runtime" not in native_lib._cache


def test_cuda_build_goes_to_cache_dir_from_csrc(fresh_loaders, tmp_path):
    """The kernel library compiles into ``GKL_TPU_CACHE_DIR``, from ``csrc/``,
    even with ``GKL_TPU_LIBRARY_PATH`` holding a library of its name: the
    compiler's first command is recorded and stopped (no nvcc runs)."""
    prebuilt = tmp_path / "prebuilt"
    prebuilt.mkdir()
    (prebuilt / "libgkl_tpu_torch_kernels.so").write_bytes(b"not a library")
    fresh_loaders.setenv("GKL_TPU_CACHE_DIR", str(tmp_path / "cache"))
    fresh_loaders.setenv("GKL_TPU_LIBRARY_PATH", str(prebuilt))
    fresh_loaders.setattr(cuda_build, "nvcc_path", lambda: "nvcc")
    commands = []

    def popen(args, **kw):
        commands.append(args)
        raise _Stop(args)

    fresh_loaders.setattr(native_lib.subprocess, "Popen", popen)
    with pytest.raises(_Stop):
        cuda_build.load()
    [args] = commands
    out = args[args.index("-o") + 1]
    assert os.path.dirname(out) == str(tmp_path / "cache")
    assert os.path.basename(out).startswith("libgkl_tpu_torch_kernels-")
    assert _in_port(args[-1]) and args[-1].endswith(".cu")


def test_parallel_imports_without_the_jax_package(tmp_path):
    """In a copy of ``gkl_tpu_torch/`` alone, importing its multi-device
    layer and building a CPU mesh loads neither ``jax`` nor ``gkl_tpu``."""
    shutil.copytree(PORT, tmp_path / "gkl_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; import gkl_tpu_torch.parallel as p; "
            "from gkl_tpu_torch.parallel import distributed, mesh; "
            "m = p.data_parallel_mesh(devices=['cpu'] * 2); assert m.size == 2, m; "
            "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'gkl_tpu')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert not (tmp_path / "gkl_tpu").exists()


def test_port_builds_without_the_jax_package(tmp_path):
    """A copy of ``gkl_tpu_torch/`` alone, with no ``gkl_tpu/`` beside it,
    builds and runs the PairHMM rescue's f64 oracle (into its own
    ``build/``)."""
    shutil.copytree(PORT, tmp_path / "gkl_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import numpy as np; from gkl_tpu_torch.ops import pairhmm_ref as r; "
            "b = np.frombuffer(b'ACGTACGT', np.uint8); q = np.full(8, 30, np.uint8); "
            "v = r.pairhmm_scalar_batch([b], [b], [(q, q, q, np.full(8, 10, np.uint8))]); "
            "assert v.shape == (1,) and np.isfinite(v).all() and v[0] < 0, v; "
            "import sys; bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'gkl_tpu')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert not (tmp_path / "gkl_tpu").exists()
    assert any(f.startswith("libgkl_pairhmm_oracle")
               for f in os.listdir(tmp_path / "build" / "gkl_tpu_torch"))
