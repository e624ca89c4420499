"""The port builds its host C++ and its kernels from its own sources.

Every source that ``native_lib`` and ``cuda_build`` compile lies under
``gkl_tpu_torch/``.  The port's copies of the JAX package's runtime sources
(``gkl_tpu_torch/native/``) are byte-identical to their originals in
``gkl_tpu/native/``, so the f64 oracles that the port's rescues run are the
reference's.  Nothing here compiles a kernel: the build calls are recorded
and stopped before the compiler runs, save one g++ build of the PairHMM
oracle from a copy of the package alone."""

import os
import shutil
import subprocess
import sys

import pytest

from gkl_tpu_torch import cuda_build, native_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "gkl_tpu_torch")
ORIGINALS = os.path.join(ROOT, "gkl_tpu", "native")
SOURCES = sorted({s for sources in native_lib._SRC.values() for s in sources})


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
    the JAX package has no runtime source that the port lacks."""
    assert len(SOURCES) == 7
    copied = sorted(f for f in os.listdir(native_lib.NATIVE_SRC_DIR) if f.endswith(".cc"))
    original = sorted(f for f in os.listdir(ORIGINALS) if f.endswith(".cc"))
    assert copied == original == SOURCES


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
        "pairhmm_cols.cu", "pairhmm_scaled.cu", "pdhmm.cu", "sw_forward.cu"]
    assert all(_in_port(s) for s in sources), sources


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
