"""Runtime validation — counterpart of ``gkl_tpu/debug.py``.

The reference's closest equivalents are ``-Xcheck:jni`` test flags and
hardening compile flags (SURVEY.md §5.2); the port's counterparts:

* :func:`debug_context` — a NaN-checked scope, the counterpart of
  ``jax.debug_nans``: inside it the APIs check each f32 engine's output
  over the real lanes where they take it, and raise
  ``FloatingPointError`` naming the kernel or twin that gave a NaN;
  ``disable_jit=True`` also synchronises after every kernel launch, so
  that a launch's fault is raised at that launch;
* :func:`check_batch` — host-side invariant checks on a packed batch.

``debug_enabled()`` reads ``GKL_TPU_DEBUG=1``; as in the JAX package, no
API consults it.  Outside the scope nothing is checked.
"""

from __future__ import annotations

import contextlib
import os
import threading

import numpy as np
import torch

# the scope of this thread: None outside debug_context, else its options
_scope = threading.local()


def debug_enabled() -> bool:
    return os.environ.get("GKL_TPU_DEBUG") == "1"


@contextlib.contextmanager
def debug_context(disable_jit: bool = False):
    """NaN-checked execution scope for this thread; ``disable_jit``
    synchronises after each kernel launch (PyTorch runs eagerly, so a
    launch's own fault is what an unjitted run would show)."""
    prev = getattr(_scope, "options", None)
    _scope.options = {"sync": bool(disable_jit)}
    try:
        yield
    finally:
        _scope.options = prev


def nan_checks() -> bool:
    """True inside :func:`debug_context` on this thread."""
    return getattr(_scope, "options", None) is not None


def after_launch(device: torch.device) -> None:
    """Called by each kernel wrapper after its launch: synchronises the
    launch's card inside ``debug_context(disable_jit=True)``."""
    options = getattr(_scope, "options", None)
    if options is not None and options["sync"]:
        torch.cuda.synchronize(device)


def engine_name(kernel: str, twin: str, devices) -> str:
    """``kernel`` when any of ``devices`` is a card (the CUDA kernel ran),
    else ``twin`` (the plain version ran on the CPU)."""
    return kernel if any(torch.device(d).type == "cuda" for d in devices) else twin


def check_nan(values, n_real: int, engine: str) -> None:
    """Inside :func:`debug_context`: raise ``FloatingPointError`` if any of
    the first ``n_real`` lanes of ``values`` (an f32 engine's (P,) output,
    a numpy array or a tensor) is NaN.  Padding lanes past ``n_real`` may
    hold anything."""
    if not nan_checks():
        return
    lanes = torch.nonzero(torch.isnan(torch.as_tensor(values)[:n_real])).flatten()
    if len(lanes):
        raise FloatingPointError(f"{engine} gave NaN in {len(lanes)} real lanes, first "
                                 f"{lanes[:10].tolist()}")


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def check_batch(packed) -> None:
    """Invariant checks on a ``batch.PackedPairs`` (numpy planes or
    tensors): the JAX package's assertions, raised as AssertionError
    whatever the interpreter's ``-O``."""
    hap, read = _host(packed.hap), _host(packed.read)
    q, iq, dq, gcp = (_host(getattr(packed, f)) for f in ("q", "iq", "dq", "gcp"))
    haplen, rslen = _host(packed.haplen), _host(packed.rslen)
    H, P = hap.shape
    R = read.shape[0]
    checks = (
        ("quals are (R, P)", q.shape == iq.shape == dq.shape == gcp.shape == (R, P)),
        ("lengths are (P,)", haplen.shape == rslen.shape == (P,)),
        ("bases are uint8", hap.dtype == np.uint8 and read.dtype == np.uint8),
        ("0 < n_real <= P", 0 < packed.n_real <= P),
        ("1 <= haplen <= H", bool(np.all(haplen >= 1) and np.all(haplen <= H))),
        ("1 <= rslen <= R", bool(np.all(rslen >= 1) and np.all(rslen <= R))),
    )
    for what, ok in checks:
        if not ok:
            raise AssertionError(f"check_batch: {what} does not hold")
