"""The kernel fuzz of ``tests/test_kernel_fuzz.py`` for the port: its seeded
draws (``torch_fuzz_cases``) through the port's plain twins, the scan twins
and the twins in each CUDA kernel's order, against the JAX package's jnp
engines at that file's tolerances; and on the card (``gpu``), each CUDA
kernel bit for bit against its kernel-order twin on the same draws, as
``chip_smoke.py`` phase 16e runs them.  The JAX package is imported by the
CPU tests' fixture only, so the card's test also runs where JAX is absent:
``python -m pytest --noconftest -m gpu tests/test_torch_kernel_fuzz.py``."""

import types

import numpy as np
import pytest
import torch

import torch_fuzz_cases as fz
from gkl_tpu_torch.ops import pairhmm as tpairhmm_ops
from gkl_tpu_torch.ops import pairhmm_cols, pairhmm_cuda, pdhmm_cuda
from gkl_tpu_torch.ops import pdhmm as tpdhmm_ops
from gkl_tpu_torch.ops import sw as tsw_ops

FLOOR = 1e-28  # below MIN_ACCEPTED the APIs rescue in f64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_ops():
    """The JAX package's jnp engines."""
    from gkl_tpu.ops import pairhmm, pdhmm, sw

    return types.SimpleNamespace(pairhmm=pairhmm, pdhmm=pdhmm, sw=sw)


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _recon(mant, exp2):
    return mant.numpy().astype(np.float64) * np.exp2(exp2.numpy().astype(np.float64))


# the port's PairHMM twins: what each wrapper runs on CPU tensors, and the
# twins in the CUDA kernels' order
PAIRHMM_TWINS = {
    "pairhmm_raw": lambda *p: tpairhmm_ops.pairhmm_raw(*p, dtype="float32").numpy(),
    "rows_kernel_order": lambda *p: pairhmm_cuda.pairhmm_raw_scaled_kernel_order(
        *p, scaled=False).numpy(),
    "cols": lambda *p: pairhmm_cols.pairhmm_raw_cols(*p).numpy(),
    "scaled_reference": lambda *p: _recon(*pairhmm_cuda.pairhmm_raw_scaled_reference(*p)[:2]),
    "scaled_kernel_order": lambda *p: _recon(
        *pairhmm_cuda.pairhmm_raw_scaled_kernel_order(*p)[:2]),
}


def _jax_pairhmm(j, planes, dtype="float32"):
    return np.asarray(j.pairhmm.pairhmm_raw(*planes, dtype=dtype))


@pytest.mark.parametrize("twin", list(PAIRHMM_TWINS))
@pytest.mark.parametrize("seed,R,H", fz.PAIRHMM_DRAWS)
def test_pairhmm_twins_agree(seed, R, H, twin, jax_ops):
    """Every PairHMM twin against the jnp engine on the fuzz's ragged
    draws ('N' bases, quals 1-59), above MIN_ACCEPTED, at 3e-5."""
    planes = fz.pairhmm_draw(seed, R, H)
    ref = _jax_pairhmm(jax_ops, planes)
    got = PAIRHMM_TWINS[twin](*_t(planes))
    ok = ref > FLOOR
    assert ok.any()
    np.testing.assert_allclose(got[ok], ref[ok], rtol=3e-5)


@pytest.mark.parametrize("twin", ["cols_relay", "rows_kernel_order"])
@pytest.mark.parametrize("seed,R,H,r_chunk", fz.COLS_RELAY_DRAWS)
def test_pairhmm_cols_relay_fuzz(seed, R, H, r_chunk, twin, jax_ops):
    """The cols twin in read chunks (the relay's passes) and the rows
    kernel-order twin on the relay fuzz's edge lanes (1-row reads, a
    1-column haplotype, reads at and one past a chunk) against jnp."""
    planes = fz.cols_relay_draw(seed, R, H, r_chunk)
    ref = _jax_pairhmm(jax_ops, planes)
    if twin == "cols_relay":
        got = pairhmm_cols.pairhmm_raw_cols(*_t(planes), r_chunk=r_chunk).numpy()
    else:
        got = PAIRHMM_TWINS["rows_kernel_order"](*_t(planes))
    ok = ref > FLOOR
    assert ok.any()
    np.testing.assert_allclose(got[ok], ref[ok], rtol=3e-5)


@pytest.mark.parametrize("twin", ["scaled_reference", "scaled_kernel_order"])
def test_scaled_twins_short_haplen_long_read(twin, jax_ops):
    """Regression: padded columns past haplen must not dominate the scaled
    rescale; the scaled twins against jnp above f32's floor at 5e-5."""
    planes = fz.short_haplen_long_read()
    ref = _jax_pairhmm(jax_ops, planes)
    got = PAIRHMM_TWINS[twin](*_t(planes))
    ok = ref > 1e-30
    assert ok.any()
    np.testing.assert_allclose(got[ok], ref[ok], rtol=5e-5)


def test_scan_coefficient_underflow(jax_ops):
    """Regression: the Y scan's span coefficients underflow f32 while their
    contributions dominate.  The port's f32 twins against the jnp f32
    engine (5e-5), that against f64, the scaled twins against f64 (2e-3);
    PDHMM's scan twin and kernel-order twin likewise."""
    planes = fz.scan_coefficient_underflow()
    ref64 = _jax_pairhmm(jax_ops, planes, "float64") * (2.0 ** -900)
    ref = _jax_pairhmm(jax_ops, planes)
    ok = ref > FLOOR
    np.testing.assert_allclose(ref[ok], ref64[ok], rtol=5e-5)
    np.testing.assert_allclose(tpairhmm_ops.pairhmm_raw(*_t(planes), dtype="float64").numpy()
                               * (2.0 ** -900), ref64, rtol=1e-12)
    for name in ("pairhmm_raw", "rows_kernel_order", "cols"):
        got = PAIRHMM_TWINS[name](*_t(planes))
        np.testing.assert_array_equal(got > FLOOR, ok)  # these lanes leave plain f32's range
        np.testing.assert_allclose(got[ok], ref[ok], rtol=5e-5)
    ok64 = ref64 > 1e-200
    assert ok64.any()
    for name in ("scaled_reference", "scaled_kernel_order"):
        np.testing.assert_allclose(PAIRHMM_TWINS[name](*_t(planes))[ok64], ref64[ok64],
                                   rtol=2e-3)

    hap_pd = np.zeros_like(planes[0])
    pref64 = _jax_pdhmm(jax_ops, planes, hap_pd, "float64") * (2.0 ** -900)
    pref = _jax_pdhmm(jax_ops, planes, hap_pd)
    ok2 = pref > FLOOR
    np.testing.assert_allclose(pref[ok2], pref64[ok2], rtol=5e-5)
    for got in _pdhmm_twins(planes, hap_pd).values():
        np.testing.assert_array_equal(got > FLOOR, ok2)
        np.testing.assert_allclose(got[ok2], pref[ok2], rtol=5e-5)


@pytest.mark.parametrize("twin", ["scaled_reference", "scaled_kernel_order"])
def test_scaled_twins_growing_pad_tail(twin, jax_ops):
    """Regression: 120 rows past rslen grow the state hundreds of binades
    above the result; the accumulator fold compares value exponents, so
    the scaled twins keep it (1e-6 against jnp)."""
    planes = fz.growing_pad_tail()
    ref = _jax_pairhmm(jax_ops, planes)
    assert np.all(ref > 0)
    np.testing.assert_allclose(PAIRHMM_TWINS[twin](*_t(planes)), ref, rtol=1e-6)


def _pdhmm_twins(planes, hap_pd):
    """The port's PDHMM scan twin (``ops.pdhmm.pdhmm_raw``, the wrapper's
    CPU path) and the kernel-order twin on one dense draw."""
    hap, read, q, iq, dq, gcp, haplen, rslen = _t(planes)
    pd = torch.from_numpy(hap_pd)
    states = torch.from_numpy(tpdhmm_ops.column_states(hap_pd))
    lanes = torch.arange(hap.shape[1], dtype=torch.int32)
    return {
        "pdhmm_raw": tpdhmm_ops.pdhmm_raw(hap, pd, states, read, q, iq, dq, gcp, haplen, rslen,
                                          dtype="float32").numpy(),
        "kernel_order": pdhmm_cuda.pdhmm_kernel_order(
            hap, pd, torch.stack([read, q, iq, dq, gcp]), lanes, lanes, haplen,
            rslen).numpy()}


def _jax_pdhmm(j, planes, hap_pd, dtype="float32"):
    hap, read, q, iq, dq, gcp, haplen, rslen = planes
    states = j.pdhmm.column_states(hap_pd)
    return np.asarray(j.pdhmm.pdhmm_raw(hap, hap_pd, states, read, q, iq, dq, gcp,
                                        haplen, rslen, dtype=dtype))


@pytest.mark.parametrize("twin", ["pdhmm_raw", "kernel_order"])
@pytest.mark.parametrize("draws,base", [(fz.PDHMM_DRAWS, 100),
                                        ([d[:3] for d in fz.PDHMM_CHUNKED_DRAWS], 300)],
                         ids=["kernel", "chunked"])
def test_pdhmm_twins_agree(draws, base, twin, jax_ops):
    """The PDHMM twins against the jnp engine on the kernel fuzz's and the
    chunked fuzz's draws (random PD events, 'N' bases), above
    MIN_ACCEPTED, at 3e-5."""
    for seed, R, H in draws:
        planes, hap_pd = fz.pdhmm_draw(seed, R, H, base=base)
        ref = _jax_pdhmm(jax_ops, planes, hap_pd)
        got = _pdhmm_twins(planes, hap_pd)[twin]
        ok = ref > FLOOR
        assert ok.any()
        np.testing.assert_allclose(got[ok], ref[ok], rtol=3e-5, err_msg=f"seed {seed}")


@pytest.mark.parametrize("case", range(len(fz.SW_DRAWS) + len(fz.SW_RELAY_DRAWS)))
def test_sw_twin_agrees(case, jax_ops):
    """The SW twin (the kernel's comparison: its integer DP has one answer
    in any order) against jnp ``sw_forward``, bit for bit, on the kernel
    fuzz's and the relay fuzz's draws."""
    _, (ref, alt, reflen, altlen), ib = fz.sw_cases()[case]
    want = jax_ops.sw.sw_forward(ref, alt, reflen, altlen, *fz.SW_SCORES, indel_boundary=ib,
                              pack_bt=True)
    got = tsw_ops.sw_forward(*_t((ref, alt, reflen, altlen)), *fz.SW_SCORES,
                             indel_boundary=ib, pack_bt=True)
    for x, y in zip(want, got):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


@pytest.mark.gpu
def test_kernels_bit_equal_to_kernel_order_twins_on_card():
    """Each CUDA kernel against its kernel-order twin on every draw, on the
    card: no lane differs in any bit (SW: no in-range cell)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    differ = fz.kernel_lanes_differ(torch.device("cuda"))
    assert differ and not any(differ.values()), {k: v for k, v in differ.items() if v}
