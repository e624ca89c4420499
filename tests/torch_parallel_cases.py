"""Shared inputs of the multi-device tests: seeded dense planes, meshes of
both packages, the sharded engines of ``gkl_tpu_torch.parallel`` beside the
JAX package's engines of the same names and the port's unsharded calls, and
the comparisons (``test_torch_parallel*.py``)."""

import numpy as np
import torch

from gkl_tpu import batch as jbatch
from gkl_tpu import parallel as jpar
from gkl_tpu.api_sw import SWParameters as JSWParameters
from gkl_tpu.ops import pdhmm as jpdhmm_ops
from gkl_tpu_torch import batch as tbatch
from gkl_tpu_torch import parallel as tpar
from gkl_tpu_torch.api_sw import SWParameters
from gkl_tpu_torch.context import MIN_ACCEPTED
from gkl_tpu_torch.ops import pairhmm as tpairhmm_ops
from gkl_tpu_torch.ops import pairhmm_cols, pairhmm_cuda, pdhmm_cuda
from gkl_tpu_torch.ops import pdhmm as tpdhmm_ops
from gkl_tpu_torch.ops import sw as tsw_ops
from gkl_tpu_torch.ops import sw_cuda

BASES = np.frombuffer(b"ACGT", np.uint8)
GATK = (200, -150, -260, -11)
SHARDS = (1, 2, 4, 8)
P = 64  # 8 lanes a shard on 8 shards: the interpret kernels' lane block
TOL_LOG10 = 1e-5  # the port's twin-vs-Pallas tolerance in log10


def dense_planes(H=48, R=24, seed=5):
    """Ragged dense planes, reads mutated hap prefixes, every 8th lane a
    random read; PD deletion events on every other lane."""
    rng = np.random.default_rng(seed)
    hap = BASES[rng.integers(0, 4, (H, P))]
    read = hap[:R].copy()
    mut = rng.random((R, P)) < 0.1
    read[mut] = BASES[rng.integers(0, 4, int(mut.sum()))]
    read[:, ::8] = BASES[rng.integers(0, 4, (R, P // 8))]
    q = rng.integers(10, 40, (R, P)).astype(np.uint8)
    iq = rng.integers(30, 45, (R, P)).astype(np.uint8)
    dq = rng.integers(30, 45, (R, P)).astype(np.uint8)
    gcp = np.full((R, P), 10, np.uint8)
    haplen = rng.integers(R, H + 1, P).astype(np.int32)
    rslen = rng.integers(8, R + 1, P).astype(np.int32)
    hap_pd = np.zeros((H, P), np.uint8)
    hap_pd[6, ::2] = 2  # DEL_START
    hap_pd[9, ::2] = 4  # DEL_END
    return hap, read, q, iq, dq, gcp, haplen, rslen, hap_pd


def meshes(n):
    return jpar.data_parallel_mesh(n), tpar.data_parallel_mesh(devices=["cpu"] * n)


def _dense_indexed(planes):
    """The dense planes as the port's kernels' indexed batch."""
    hap, read, q, iq, dq, gcp, haplen, rslen = (torch.from_numpy(a) for a in planes[:8])
    lanes = torch.arange(P, dtype=torch.int32)
    return dict(hap_u=hap, readq_u=torch.stack([read, q]), ridx=lanes, hidx=lanes,
                haplen=haplen, rslen=rslen, quals_u=torch.stack([iq, dq, gcp]))


def assert_raw_close(got, want):
    """Raw f32 forward results: the same lanes below MIN_ACCEPTED, the
    others within TOL_LOG10 in log10."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(got < MIN_ACCEPTED, want < MIN_ACCEPTED)
    ok = want >= MIN_ACCEPTED
    assert ok.any()
    np.testing.assert_allclose(np.log10(got[ok]), np.log10(want[ok]), rtol=0, atol=TOL_LOG10)


def assert_scaled_close(got, want):
    """(mantissa, exp2, flag) triples: the same flags, results within
    TOL_LOG10 in log10."""
    (gm, ge, gf), (wm, we, wf) = got, want
    np.testing.assert_array_equal(np.asarray(gf), np.asarray(wf).astype(np.int32))
    np.testing.assert_allclose(pairhmm_cuda.log10_of(gm, ge), pairhmm_cuda.log10_of(wm, we),
                               rtol=0, atol=TOL_LOG10)


def assert_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def unpacked(stacked):
    """The port's (3, P) int32 scaled layout as (mantissa, exp2, flag)."""
    stacked = np.asarray(stacked)
    return stacked[0].view(np.float32), stacked[1], stacked[2]


# Each engine: (JAX call, port call, the port's unsharded call, comparison
# with JAX).  A call takes (mesh, planes) and returns numpy.

def _jax_packed(planes):
    return jbatch.PackedPairs(*planes[:8], n_real=P)


def _port_packed(planes):
    return tbatch.PackedPairs(*planes[:8], n_real=P)


def _interp(fn, **kw):
    return lambda m, pl: fn(m, _jax_packed(pl), lane_block=8, interpret=True, **kw)


def _jax_pd(fn, **kw):
    def call(m, pl):
        states = jpdhmm_ops.column_states(pl[8])
        return fn(m, _jax_packed(pl), pl[8], states, lane_block=8, interpret=True, **kw)
    return call


def _jax_sw(fn, **kw):
    def call(m, pl):
        return fn(m, pl[0], pl[1], pl[6], pl[7], JSWParameters(*GATK), lane_block=8,
                  interpret=True, **kw)
    return call


def _port_sw(fn):
    return lambda m, pl: fn(m, pl[0], pl[1], pl[6], pl[7], SWParameters(*GATK))


def _twin_sw(pack_bt):
    def call(pl):
        t = [torch.from_numpy(a) for a in (pl[0], pl[1], pl[6], pl[7])]
        if pack_bt:
            return [x.numpy() for x in sw_cuda.sw_forward(*t, *GATK, indel_boundary=False)]
        return [x.numpy() for x in tsw_ops.sw_forward(*t, *GATK, indel_boundary=False)]
    return call


def _twin_pd(pl):
    t = _dense_indexed(pl)
    readq = torch.cat([t.pop("readq_u"), t.pop("quals_u")])
    return pdhmm_cuda.pdhmm(happd_u=torch.from_numpy(pl[8]), readq_u=readq, **t).numpy()


ENGINES = {
    "pairhmm_raw_pallas_sharded": (
        _interp(jpar.pairhmm_raw_pallas_sharded),
        lambda m, pl: tpar.pairhmm_raw_pallas_sharded(m, _port_packed(pl)),
        lambda pl: pairhmm_cuda.pairhmm_rows(**_dense_indexed(pl)).numpy(),
        assert_raw_close),
    "pairhmm_raw_pallas_scaled_sharded": (
        _interp(jpar.pairhmm_raw_pallas_scaled_sharded),
        lambda m, pl: tpar.pairhmm_raw_pallas_scaled_sharded(m, _port_packed(pl)),
        lambda pl: unpacked(pairhmm_cuda.pairhmm_scaled(**_dense_indexed(pl))),
        assert_scaled_close),
    "pairhmm_raw_pallas_cols_sharded": (
        _interp(jpar.pairhmm_raw_pallas_cols_sharded),
        lambda m, pl: tpar.pairhmm_raw_pallas_cols_sharded(m, _port_packed(pl)),
        lambda pl: pairhmm_cols.pairhmm_cols(**_dense_indexed(pl)).numpy(),
        assert_raw_close),
    "pairhmm_raw_pallas_cols_relay_sharded": (
        _interp(jpar.pairhmm_raw_pallas_cols_relay_sharded),
        lambda m, pl: tpar.pairhmm_raw_pallas_cols_relay_sharded(m, _port_packed(pl)),
        lambda pl: pairhmm_cols.pairhmm_cols(**_dense_indexed(pl)).numpy(),
        assert_raw_close),
    "pdhmm_raw_pallas_sharded": (
        _jax_pd(jpar.pdhmm_raw_pallas_sharded),
        lambda m, pl: tpar.pdhmm_raw_pallas_sharded(m, _port_packed(pl), pl[8]),
        _twin_pd, assert_raw_close),
    "pdhmm_raw_pallas_chunked_sharded": (
        _jax_pd(jpar.pdhmm_raw_pallas_chunked_sharded, r_chunk=8),
        lambda m, pl: tpar.pdhmm_raw_pallas_chunked_sharded(m, _port_packed(pl), pl[8]),
        _twin_pd, assert_raw_close),
    "sw_forward_pallas_sharded": (
        _jax_sw(jpar.sw_forward_pallas_sharded), _port_sw(tpar.sw_forward_pallas_sharded),
        _twin_sw(True), assert_equal),
    "sw_forward_pallas_relay_sharded": (
        _jax_sw(jpar.sw_forward_pallas_relay_sharded, seg=8),
        _port_sw(tpar.sw_forward_pallas_relay_sharded), _twin_sw(True), assert_equal),
    "pairhmm_raw_sharded": (
        lambda m, pl: jpar.pairhmm_raw_sharded(m, _jax_packed(pl)),
        lambda m, pl: tpar.pairhmm_raw_sharded(m, _port_packed(pl)),
        lambda pl: tpairhmm_ops.pairhmm_raw(*(torch.from_numpy(a) for a in pl[:8])).numpy(),
        assert_raw_close),
    "pdhmm_raw_sharded": (
        lambda m, pl: jpar.pdhmm_raw_sharded(m, _jax_packed(pl), pl[8],
                                             jpdhmm_ops.column_states(pl[8])),
        lambda m, pl: tpar.pdhmm_raw_sharded(m, _port_packed(pl), pl[8],
                                             tpdhmm_ops.column_states(pl[8])),
        lambda pl: tpdhmm_ops.pdhmm_raw(
            *(torch.from_numpy(a) for a in (pl[0], pl[8], tpdhmm_ops.column_states(pl[8]),
                                            *pl[1:8])), dtype="float32").numpy(),
        assert_raw_close),
    "sw_forward_sharded": (
        lambda m, pl: jpar.sw_forward_sharded(m, pl[0], pl[1], pl[6], pl[7],
                                              JSWParameters(*GATK)),
        _port_sw(tpar.sw_forward_sharded), _twin_sw(False), assert_equal),
}


def check_sharded_engine(engine, n):
    """On ``["cpu"] * n`` the port's engine equals its unsharded call bit
    for bit, and agrees with the JAX engine of the same name on an
    n-device mesh (raw results: the same lanes below MIN_ACCEPTED, the
    others within 1e-5 in log10; scaled: the same flags; SW: bit for bit)."""
    jax_call, port_call, whole_call, close = ENGINES[engine]
    planes = dense_planes()
    jmesh, tm = meshes(n)
    got = port_call(tm, planes)
    whole = whole_call(planes)
    assert_equal(got if isinstance(got, tuple) else (got,),
                 whole if isinstance(whole, (tuple, list)) else (whole,))
    with jmesh:
        want = jax_call(jmesh, planes)
    if isinstance(want, tuple):
        want = tuple(np.asarray(w) for w in want)
    else:
        want = np.asarray(want)
    close(got, want)
