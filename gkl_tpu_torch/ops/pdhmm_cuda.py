"""PDHMM forward in f32: the CUDA kernel's wrapper and its plain twin on an
indexed batch.

Counterpart of ``gkl_tpu/ops/pdhmm_pallas.py`` (``pdhmm_raw_pallas``,
``pdhmm_raw_pallas_chunked`` and their prep) with the lane expansion of
``api_pdhmm._pdhmm_indexed_jit``.  :func:`pdhmm` takes a deduplicated
batch: on CUDA tensors it launches ``csrc/pdhmm.cu`` or raises; on CPU
tensors it runs :func:`pdhmm_indexed_reference`, the lane gather and
``ops.pdhmm.pdhmm_raw`` in plain PyTorch.
"""

from __future__ import annotations

import functools

import torch

from .. import context as ctx_mod
from .. import cuda_build
from . import pdhmm as pdhmm_ops
from .pairhmm_cuda import _check

# Launches of the CUDA kernel in this process.
LAUNCHES = 0


def expand_indexed(hap_u, happd_u, readq_u, ridx, hidx):
    """Per-lane dense planes of an indexed batch: (hap, hap_pd, states,
    read, q, iq, dq, gcp), with the column states computed once per unique
    haplotype."""
    hi = hidx.to(torch.int64)
    ri = ridx.to(torch.int64)
    states_u = torch.from_numpy(
        pdhmm_ops.column_states(happd_u.cpu().numpy())).to(happd_u.device)
    hap, hap_pd, states = (t.index_select(1, hi) for t in (hap_u, happd_u, states_u))
    read, q, iq, dq, gcp = (readq_u[k].index_select(1, ri) for k in range(5))
    return hap, hap_pd, states, read, q, iq, dq, gcp


def pdhmm_indexed_reference(hap_u, happd_u, readq_u, ridx, hidx, haplen, rslen):
    """The kernel's function in plain PyTorch, on the inputs' device."""
    planes = expand_indexed(hap_u, happd_u, readq_u, ridx, hidx)
    return pdhmm_ops.pdhmm_raw(*planes, haplen, rslen, dtype="float32")


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device):
    """The exact f32 PDHMM tables the kernel reads: q2e (255,) and the
    match-to-match cache (32640,)."""
    ctx = ctx_mod.pdhmm_context("float32")
    q2e = torch.as_tensor(ctx.qual_to_error_prob, dtype=torch.float32).to(device)
    m2m = torch.as_tensor(ctx.match_to_match, dtype=torch.float32).to(device)
    return q2e, m2m


def pdhmm(hap_u, happd_u, readq_u, ridx, hidx, haplen, rslen) -> torch.Tensor:
    """f32 PDHMM forward of an indexed batch.

    Args:
      hap_u/happd_u: (H, nu_h) uint8 unique haplotype bases and PD bytes.
      readq_u: (5, R, nu_r) uint8 unique [bases, q, iq, dq, gcp].
      ridx/hidx: (P,) int32 lane -> unique read / haplotype column.
      haplen/rslen: (P,) int32 per-lane lengths (1..H, 1..R).

    Returns the (P,) float32 forward probability before the log, scaled by
    2^120, on the inputs' device (a lane with out-of-range indices or
    lengths gets NaN from the kernel).
    """
    global LAUNCHES
    device = hap_u.device
    _check("hap_u", hap_u, torch.uint8, 2, device)
    _check("happd_u", happd_u, torch.uint8, 2, device)
    _check("readq_u", readq_u, torch.uint8, 3, device)
    for name, t in (("ridx", ridx), ("hidx", hidx), ("haplen", haplen), ("rslen", rslen)):
        _check(name, t, torch.int32, 1, device)
    H, nu_h = hap_u.shape
    _, R, nu_r = readq_u.shape
    P = ridx.shape[0]
    if happd_u.shape != hap_u.shape or readq_u.shape[0] != 5:
        raise ValueError("happd_u must match hap_u, and readq_u must be (5, R, nu_r)")
    if not hidx.shape[0] == haplen.shape[0] == rslen.shape[0] == P:
        raise ValueError("ridx, hidx, haplen and rslen must have one entry per lane")
    if device.type == "cpu":
        return pdhmm_indexed_reference(hap_u, happd_u, readq_u, ridx, hidx, haplen, rslen)
    if device.type != "cuda":
        raise ValueError(f"no PDHMM kernel for device {device}")

    lib = cuda_build.load()
    q2e, m2m = _device_tables(device)
    state = torch.empty((6, H, P), dtype=torch.float32, device=device)
    out = torch.empty(P, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.gkl_pdhmm(
        hap_u.data_ptr(), happd_u.data_ptr(), H, nu_h, readq_u.data_ptr(), R, nu_r,
        ridx.data_ptr(), hidx.data_ptr(), haplen.data_ptr(), rslen.data_ptr(), P,
        q2e.data_ptr(), m2m.data_ptr(), state.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"pdhmm kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
