"""GATK's ``--native-pair-hmm-use-double-precision`` as a configuration key
(``native_pair_hmm_use_double_precision``): the engines the harness builds,
the check's numbers of the port's double mode and of the control a
precision below it, and the rooflines at the float64 peak; without the key,
every one of them as before."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from bench_port import run
from bench_port.harness import check, drive, roofline, session, spec
from bench_port.tests.conftest import tiny_cell

SEED = 2 ** 31 + 7
KEY = "native_pair_hmm_use_double_precision"


def _cell(double: bool | None):
    """``hc_wgs30x.region`` over four small regions of 150-base reads (a
    float32 likelihood's error grows with the read), with the key set to
    ``double`` (None: absent)."""
    run.pin_environment()
    cell = tiny_cell("hc_wgs30x.region")
    cell.config.update(min_assembly_region_size=50, max_assembly_region_size=100,
                       assembly_region_padding=100, read_length=150, min_read_length=30,
                       indel_length=[1, 10])
    cell.mix.update(pool_regions=4, strata=4, check_regions=None)
    if double is not None:
        cell.config[KEY] = double
    return cell


def _run_every_region(s: session.Session) -> list:
    done = []
    for g in range(len(s.pool)):
        t0 = time.perf_counter()
        out = s.call(g)
        done.append(drive.Done(g, t0, time.perf_counter(), s.reads_of[g], out))
    return done


@pytest.mark.parametrize("double", [None, False, True])
def test_engines_follow_the_key(double):
    from gkl_tpu_torch import PairHMMNativeArguments, PDHMMNativeArguments, SmithWaterman

    config = spec.load_cell("hc_wgs30x.region").config
    if double is not None:
        config[KEY] = double
    hmm, sw, pdhmm = session.engines("cpu", config)
    # without the key, field for field the arguments the harness always built
    want_hmm = PairHMMNativeArguments()
    want_pd = PDHMMNativeArguments(max_number_of_threads=config["native_threads"])
    if double:
        want_hmm.use_double_precision = want_pd.use_double_precision = True
    assert hmm.args == want_hmm and pdhmm.args == want_pd
    assert type(sw) is SmithWaterman
    assert spec.double_precision(config) is bool(double)


def test_key_must_be_a_bool():
    with pytest.raises(ValueError):
        spec.double_precision({KEY: "false"})


def test_double_mode_meets_the_float64_reference_and_reads_the_f64_peak():
    s = session.Session(_cell(True), SEED, "cpu")
    s.spans = drive.Spans(annotate=True)
    try:
        numbers, counts = s.check(_run_every_region(s))
        spans = list(s.spans.items)
        regions = s.regions
    finally:
        s.close()
    assert counts["regions"] == 4 and counts["reads"] > 0
    assert numbers["pairhmm_err"] < 1e-10 and numbers["pdhmm_err"] < 1e-10, numbers
    assert numbers["best_gap"] == 0.0 and numbers["sw_mismatches"] == 0, numbers
    # each call's least time counted at the float64 peak
    pairhmm = [sp for sp in spans if sp.name == "pairhmm"]
    pdhmm = [sp for sp in spans if sp.name == "pdhmm"]
    assert len(pairhmm) == len(pdhmm) == len(regions)
    for sp, r in zip(pairhmm, regions):
        rl, hl = drive._lengths(r.reads), [len(h.haplotype_bases) for h in r.haps]
        assert sp.least_s == roofline.pairhmm_s(rl, hl, double=True)
    for sp, r in zip(pdhmm, regions):
        rl, hl = drive._lengths(r.reads), [len(h.haplotype_bases) for h in r.pd_haps]
        assert sp.least_s == roofline.pdhmm_s(rl, hl, double=True)


def _control(cell):
    pool = cell.generator().pool(cell.config, cell.mix, SEED)
    plan = check.plan(range(len(pool)), pool, cell.mix, SEED)
    return pool, plan, check.control_calls(pool, plan, cell.config)


def test_float32_control_fails_a_double_precision_deployment():
    cell = _cell(True)
    pool, plan, calls = _control(cell)
    numbers, _ = check.compare(calls, pool, plan, cell.config)
    assert numbers["pairhmm_err"] > 1e-7 and numbers["pdhmm_err"] > 1e-7, numbers
    # float32 with the float64 rescue: GATK's default mode, far from bfloat16
    assert numbers["pairhmm_err"] < 1e-4 and numbers["pdhmm_err"] < 1e-4, numbers


@pytest.mark.parametrize("double", [None, False])
def test_control_without_the_key_is_bfloat16(double):
    cell = _cell(double)
    pool, plan, calls = _control(cell)
    low = check.likelihoods(pool, plan, cell.config, dtype=torch.bfloat16,
                            rescue_below=cell.config["rescue_below"])
    best = {g: np.argmax(low[g][0], axis=1) for g in plan}
    sw = check.alignments(pool, [(g, int(plan[g][a]), int(b)) for g in plan
                                 for a, b in enumerate(best[g])], cell.config,
                          dtype=torch.int16)
    assert [g for g, _, _ in calls] == list(plan)
    for g, out, whole in calls:
        assert whole is None
        np.testing.assert_array_equal(out.lik, low[g][0])
        np.testing.assert_array_equal(out.pd, low[g][1])
        np.testing.assert_array_equal(out.best, best[g])
        al = [sw[(g, int(i), int(b))] for i, b in zip(plan[g], best[g])]
        assert out.cigars == [c for c, _ in al]
        np.testing.assert_array_equal(out.offsets, [o for _, o in al])
    numbers, _ = check.compare(calls, pool, plan, cell.config)
    assert numbers["pairhmm_err"] > 1e-3, numbers


LENGTHS = {"operations": ([150] * 96, [320] * 16), "bytes": ([150] * 64, [1])}


def _parent(ops, nbytes):
    return max(ops / 67e12, nbytes / 3.35e12)


@pytest.mark.parametrize("bound", sorted(LENGTHS))
def test_rooflines_by_precision(bound):
    rl, hl = LENGTHS[bound]
    ph_ops = 11 * sum(rl) * sum(hl) + 2 * len(rl) * sum(hl)
    ph_bytes = 5 * sum(rl) + sum(hl) + 8 * len(rl) * len(hl) + 33536
    pd_ops = 12 * sum(rl) * sum(hl)
    pd_bytes = 5 * sum(rl) + 2 * sum(hl) + 8 * len(rl) * len(hl) + 131584
    # without the precision: the float32 arithmetic, exactly
    assert roofline.pairhmm_s(rl, hl) == _parent(ph_ops, ph_bytes)
    assert roofline.pdhmm_s(rl, hl) == _parent(pd_ops, pd_bytes)
    assert roofline.pairhmm_s(rl, hl, double=False) == roofline.pairhmm_s(rl, hl)
    if bound == "operations":
        assert ph_ops / 67e12 > ph_bytes / 3.35e12
        assert roofline.pairhmm_s(rl, hl, double=True) == pytest.approx(
            roofline.pairhmm_s(rl, hl) * 67 / 34, rel=1e-12)
        assert roofline.pdhmm_s(rl, hl, double=True) == pytest.approx(
            roofline.pdhmm_s(rl, hl) * 67 / 34, rel=1e-12)
    else:
        # bound by bytes in either precision: the same least time
        assert roofline.pairhmm_s(rl, hl, double=True) == roofline.pairhmm_s(rl, hl)
        assert roofline.pdhmm_s(rl, hl, double=True) == roofline.pdhmm_s(rl, hl)
