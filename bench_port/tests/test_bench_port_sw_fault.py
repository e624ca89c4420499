"""Planted Smith-Waterman faults on the port's main path: ``SmithWaterman``
off a mesh walks its CIGARs on the device (``_align_walked``) and writes
the strings with ``api_sw.format_cigars``; an altered offset or CIGAR
there has to make the check refuse the run."""

from __future__ import annotations

import time

import pytest

from bench_port import run
from bench_port.tests.conftest import tiny_cell

SEED = 2 ** 31 + 4099


def _alter_offset(monkeypatch, planted):
    from gkl_tpu_torch import api_sw

    real = api_sw.SmithWaterman._align_walked

    def walked(self, *args):
        res = real(self, *args)
        for k, r in enumerate(res):
            planted.append(1)
            if len(planted) % 7 == 3:
                res[k] = api_sw.SWAlignerResult(r.cigar, r.alignment_offset + 1)
        return res
    monkeypatch.setattr(api_sw.SmithWaterman, "_align_walked", walked)


def _alter_cigar(monkeypatch, planted):
    from gkl_tpu_torch import api_sw

    real = api_sw.format_cigars

    def formatted(runs, counts):
        out = real(runs, counts)
        for k, cigar in enumerate(out):
            planted.append(1)
            if len(planted) % 7 == 3:
                out[k] = "1S" + cigar
        return out
    monkeypatch.setattr(api_sw, "format_cigars", formatted)


FAULTS = {"sw_offset_altered": _alter_offset, "sw_cigar_altered": _alter_cigar}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ["hc_wgs30x.region", "hc_deep_panel.bam_stream"])
def test_sw_fault_on_the_walked_path_fails_the_check(monkeypatch, fault, name):
    planted: list[int] = []
    FAULTS[fault](monkeypatch, planted)
    run.pin_environment()
    result, lines = run.run_cell(tiny_cell(name), SEED, 3.0, False, "cpu", time.perf_counter())
    assert len(planted) >= 3, "the fault was never planted: the walked path did not run"
    assert not result["correct"], lines
    assert result["checks"]["sw_mismatches"]["value"] > 0
