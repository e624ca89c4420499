"""The stage spans inside the port's three calls and ``region_stream``
(``profiling.span``) and the launch counts in ``profiling.METRICS``: with
``GKL_TPU_METRICS`` unset a call records nothing and marks nothing; with it
set every stage records with its calls and items, the whole-call counters
keep their items, the stages of a call and its counter each take no
longer than the call, and under ``torch.profiler`` each stage is a
``gkl.<stage>`` mark inside the call; the modules' ``LAUNCHES`` names read
the one launch count."""

import json
import os
import time

import numpy as np
import pytest
import torch

import chip_smoke
from gkl_tpu_torch import (PDHMM, HaplotypeData, PairHMM, PDHaplotypeData, ReadData,
                           SmithWaterman, SWParameters, api, api_pdhmm, api_sw, bam, batch,
                           pipeline, profiling)
from gkl_tpu_torch.api_sw import OverhangStrategy
from gkl_tpu_torch.ops import pairhmm_cols, pairhmm_cuda, pdhmm_cuda, sw_cuda

BAM = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "HiSeq.1mb.1RG.2k_lines.bam")
BASES = np.frombuffer(b"ACGT", np.uint8)
SW_READ_TO_HAP = SWParameters(10, -15, -30, -5)

# each call's stages that do not nest in another stage
STAGES = {
    "pairhmm": ("pairhmm_pack", "pairhmm_dispatch", "pairhmm_wait", "pairhmm_finalize"),
    "smithwaterman": ("sw_pack", "sw_dispatch", "sw_wait", "sw_bt_copy", "sw_host_walk",
                      "sw_scalar"),
    "pdhmm": ("pdhmm_plan", "pdhmm_pack", "pdhmm_wait", "pdhmm_finalize"),
}


@pytest.fixture(autouse=True)
def _clean_metrics(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.delenv("GKL_TPU_METRICS", raising=False)
    profiling.METRICS.reset()
    yield
    profiling.METRICS.reset()
    torch.set_num_threads(n)


def _reads_and_haps(seed=5):
    """9 reads of 24 and 40 bases (two read buckets), 3 haplotypes of 56
    and 90 bases (two haplotype buckets): four groups."""
    rng = np.random.default_rng(seed)
    haps = [BASES[rng.integers(0, 4, n)] for n in (56, 56, 90)]
    reads = []
    for i in range(9):
        n = 24 if i % 2 else 40
        start = int(rng.integers(0, 56 - n))
        read = haps[0][start:start + n].copy()
        read[rng.integers(0, n, 2)] = BASES[rng.integers(0, 4, 2)]
        q = rng.integers(20, 40, n).astype(np.uint8)
        reads.append(ReadData(read, q, np.full(n, 45, np.uint8), np.full(n, 45, np.uint8),
                              np.full(n, 10, np.uint8)))
    return reads, [HaplotypeData(h) for h in haps]


def _pd_haps(haps):
    pds = []
    for k, h in enumerate(haps):
        pd = np.zeros(len(h.haplotype_bases), np.uint8)
        if k:
            pd[10 + k] = 1 << (k % 2)
        pds.append(PDHaplotypeData(h.haplotype_bases, haplotype_pdbases=pd))
    return pds


def _sw_pairs():
    """Six pairs of two shapes on the device and one too large for the
    backtrack budget set by ``_small_bt_budget``."""
    reads, haps = _reads_and_haps()
    refs = [haps[k % 3].haplotype_bases for k in range(6)] + [np.tile(BASES, 80)]
    alts = [reads[k].read_bases for k in range(6)] + [np.tile(BASES, 20)]
    return refs, alts


def _small_bt_budget(monkeypatch):
    """A budget that holds the pairs of _sw_pairs at 8 lanes but not the
    320-base reference."""
    monkeypatch.setattr(api_sw, "SW_BT_BUDGET", 8 * (96 // 2) * 48)


def _call_pairhmm(monkeypatch):
    reads, haps = _reads_and_haps()
    return PairHMM(device="cpu").compute_likelihoods(reads, haps)


def _call_sw(monkeypatch):
    _small_bt_budget(monkeypatch)
    refs, alts = _sw_pairs()
    return SmithWaterman(device="cpu").align_batch(refs, alts, SW_READ_TO_HAP,
                                                   OverhangStrategy.SOFTCLIP)


def _call_pdhmm(monkeypatch):
    reads, haps = _reads_and_haps()
    return PDHMM(device="cpu").compute_likelihoods(reads, _pd_haps(haps))


def _region():
    _, records = bam.read_bam(BAM, limit=8)
    return chip_smoke.region_haplotypes(records)


def _call_region_stream(monkeypatch):
    haps, pd_haps = _region()
    return list(pipeline.region_stream(
        BAM, haps, pd_haplotypes=pd_haps, limit=20, chunk_reads=8, hmm=PairHMM(device="cpu"),
        sw=SmithWaterman(device="cpu"), pdhmm=PDHMM(device="cpu")))


CALLS = {"pairhmm": _call_pairhmm, "sw": _call_sw, "pdhmm": _call_pdhmm,
         "region_stream": _call_region_stream}


@pytest.mark.parametrize("call", list(CALLS))
def test_switch_off_records_and_marks_nothing(monkeypatch, tmp_path, call):
    """Unset, a call records no counter, enters no ``record_function`` of
    its own (the profiler's switch alone opens none), and leaves no
    ``gkl.*`` mark in a running profiler's trace."""
    marks = []
    real = torch.profiler.record_function

    def spy(name, *args, **kw):
        marks.append(name)
        return real(name, *args, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    CALLS[call](monkeypatch)
    assert profiling.METRICS.snapshot() == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        CALLS[call](monkeypatch)
    assert marks == [] and profiling.METRICS.snapshot() == {}
    assert not [e for e in _trace(prof, tmp_path) if e.get("name", "").startswith("gkl.")]


@pytest.mark.parametrize("call", ["pairhmm", "sw", "pdhmm", "region_stream"])
def test_switch_on_without_a_profiler_marks_nothing(monkeypatch, call):
    """Set, a call records its stages, and still enters no
    ``record_function`` while no profiler runs."""
    monkeypatch.setenv("GKL_TPU_METRICS", "1")
    marks = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a, **k: marks.append(a))
    CALLS[call](monkeypatch)
    assert marks == [] and profiling.METRICS.snapshot()


def _counts(snap):
    return {k: (v["calls"], v["items"]) for k, v in snap.items()}


def _force_rescue(monkeypatch, module):
    """Every lane below MIN_ACCEPTED, so every lane takes the f64 rescue
    (GKL_TPU_EXACT_RESCUE: for PairHMM, every lane out of range)."""
    monkeypatch.setattr(module, "MIN_ACCEPTED", np.inf)
    monkeypatch.setenv("GKL_TPU_EXACT_RESCUE", "1")


def test_pairhmm_stages(monkeypatch):
    """Four groups: one packing of the call and one a group, one dispatch,
    wait and finalize a group, the rescue inside the finalize; ``pairhmm``
    keeps its items and cells; the stages sum to no more than the call."""
    monkeypatch.setenv("GKL_TPU_METRICS", "1")
    _force_rescue(monkeypatch, api)
    reads, haps = _reads_and_haps()
    t0 = time.perf_counter()
    PairHMM(device="cpu").compute_likelihoods(reads, haps)
    wall = time.perf_counter() - t0
    snap = profiling.METRICS.snapshot()
    pairs = len(reads) * len(haps)
    assert _counts(snap) == {
        "pairhmm": (1, pairs), "pairhmm_pack": (5, pairs), "pairhmm_dispatch": (4, pairs),
        "pairhmm_wait": (4, pairs), "pairhmm_finalize": (4, pairs),
        "pairhmm_rescue": (4, pairs)}
    assert snap["pairhmm"]["cells"] == (sum(len(r.read_bases) for r in reads)
                                        * sum(len(h.haplotype_bases) for h in haps))
    _stages_within_call(snap, "pairhmm", wall)
    rescue = snap["pairhmm_rescue"]["seconds"]
    assert 0 < rescue <= snap["pairhmm_finalize"]["seconds"]


def test_pairhmm_lazy_groups_dispatch_from_result(monkeypatch):
    """Past the in-flight budget the later groups dispatch from
    ``result()``, each still one ``pairhmm_dispatch``."""
    monkeypatch.setenv("GKL_TPU_METRICS", "1")
    monkeypatch.setattr(PairHMM, "_ASYNC_INFLIGHT_BYTES", 1)
    reads, haps = _reads_and_haps()
    hmm = PairHMM(device="cpu")
    t0 = time.perf_counter()
    pending = hmm.compute_likelihoods_async(reads, haps)
    assert profiling.METRICS.snapshot()["pairhmm_dispatch"]["calls"] == 1
    pending.result()
    wall = time.perf_counter() - t0
    snap = profiling.METRICS.snapshot()
    assert snap["pairhmm_dispatch"]["calls"] == 4
    assert snap["pairhmm_dispatch"]["items"] == len(reads) * len(haps)
    _stages_within_call(snap, "pairhmm", wall)


def test_sw_stages(monkeypatch):
    """Four shapes, one lane chunk each, and one pair on the scalar
    aligner: one packing of the call and one a chunk; ``smithwaterman``,
    ``sw_bt_copy`` and ``sw_host_walk`` keep their items (alignments,
    bytes of the walk's counts, offsets and runs brought to the host, lanes
    written out), and ``sw_card_walk`` counts the lanes the device walked
    (the backtrack stays there)."""
    monkeypatch.setenv("GKL_TPU_METRICS", "1")
    refs, alts = _sw_pairs()
    t0 = time.perf_counter()
    _call_sw(monkeypatch)
    wall = time.perf_counter() - t0
    snap = profiling.METRICS.snapshot()
    shapes = {}
    for k, (r, a) in enumerate(zip(refs[:6], alts[:6])):
        shapes.setdefault((batch.bucket_length(len(r)), batch.bucket_length(len(a))), []).append(k)
    merged = api_sw.merge_shape_groups(shapes)
    n = len(merged)
    assert n == 4
    # every CIGAR here fits the first copy's run rows
    copied = sum(batch.bucket_lanes(len(idxs)) * (2 + api_sw.SW_RUNS_FIRST_COPY) * 4
                 for _, idxs in merged)
    assert _counts(snap) == {
        "smithwaterman": (1, 7), "sw_pack": (n + 1, 6), "sw_dispatch": (n, 6),
        "sw_wait": (n, 6), "sw_card_walk": (n, 6), "sw_bt_copy": (n, copied),
        "sw_host_walk": (n, 6), "sw_scalar": (1, 1)}
    assert snap["smithwaterman"]["cells"] == sum(len(r) * len(a) for r, a in zip(refs, alts))
    _stages_within_call(snap, "smithwaterman", wall)


def test_pdhmm_stages(monkeypatch):
    """The object path: the cross product and the lane order are two
    plans, one slice packed and waited for, its finalize with the rescue
    inside it, and the un-permute; ``pdhmm`` and ``pdhmm_rescue`` keep
    their items, and ``pdhmm_card_rescue`` counts the rescue's lanes;
    ``pdhmm_unique`` counts the slice's unique read and haplotype
    planes."""
    monkeypatch.setenv("GKL_TPU_METRICS", "1")
    _force_rescue(monkeypatch, api_pdhmm)
    reads, haps = _reads_and_haps()
    pd_haps = _pd_haps(haps)
    t0 = time.perf_counter()
    PDHMM(device="cpu").compute_likelihoods(reads, pd_haps)
    wall = time.perf_counter() - t0
    snap = profiling.METRICS.snapshot()
    n = len(reads) * len(haps)
    assert _counts(snap) == {
        "pdhmm": (1, n), "pdhmm_plan": (2, 2 * n), "pdhmm_pack": (1, n), "pdhmm_wait": (1, n),
        "pdhmm_finalize": (2, n), "pdhmm_rescue": (1, n), "pdhmm_card_rescue": (1, n),
        "pdhmm_unique": (1, len(reads) + len(haps))}
    assert snap["pdhmm"]["cells"] == (sum(len(r.read_bases) for r in reads)
                                      * sum(len(h.haplotype_bases) for h in haps))
    _stages_within_call(snap, "pdhmm", wall)
    assert snap["pdhmm_rescue"]["seconds"] <= snap["pdhmm_finalize"]["seconds"]


def test_pdhmm_flat_path_stages(monkeypatch):
    """``compute_pdhmm``: one plan (no cross product) and the same
    ``pdhmm`` items and cells as before."""
    monkeypatch.setenv("GKL_TPU_METRICS", "1")
    reads, haps = _reads_and_haps()
    pds = _pd_haps(haps)
    width_h, width_r = 90, 40
    hap2 = np.zeros((len(pds), width_h), np.uint8)
    pd2 = np.zeros_like(hap2)
    read2 = np.zeros((len(pds), width_r), np.uint8)
    q2 = np.zeros_like(read2)
    for k, (h, r) in enumerate(zip(pds, reads)):
        hap2[k, :len(h.haplotype_bases)] = h.haplotype_bases
        pd2[k, :len(h.haplotype_bases)] = h.haplotype_pdbases
        read2[k, :len(r.read_bases)] = r.read_bases
        q2[k, :len(r.read_bases)] = r.read_quals
    hl = [len(h.haplotype_bases) for h in pds]
    rl = [len(r.read_bases) for r in reads[:len(pds)]]
    t0 = time.perf_counter()
    PDHMM(device="cpu").compute_pdhmm(hap2, pd2, read2, q2, np.full_like(q2, 45),
                                      np.full_like(q2, 45), np.full_like(q2, 10), hl, rl)
    wall = time.perf_counter() - t0
    snap = profiling.METRICS.snapshot()
    assert _counts(snap)["pdhmm"] == (1, 3) and _counts(snap)["pdhmm_plan"] == (1, 3)
    assert snap["pdhmm"]["cells"] == sum(h * r for h, r in zip(hl, rl))
    _stages_within_call(snap, "pdhmm", wall)


def test_region_stream_stages(monkeypatch):
    """The first 20 records in chunks of 8: the producer's inflate and
    decode (items = decompressed bytes, records decoded), the caller's
    waits (one a chunk and the end) and dispatches (items = reads), every
    call's stages, and no ``pipeline_resolve``, ``pipeline_sw`` or
    ``pipeline_pdhmm``."""
    monkeypatch.setenv("GKL_TPU_METRICS", "1")
    t0 = time.perf_counter()
    chunks = _call_region_stream(monkeypatch)
    wall = time.perf_counter() - t0
    snap = profiling.METRICS.snapshot()
    _, records = bam.read_bam(BAM, limit=20)
    kept = [r for r in records if not pipeline._is_filtered(r) and len(r.seq)]
    sizes = [len(c.read_names) for c in chunks]
    assert sum(sizes) == len(kept) and sizes[:-1] == [8] * (len(sizes) - 1)
    assert _counts(snap)["pipeline_wait"] == (len(chunks) + 1, len(chunks) + 1)
    assert _counts(snap)["pipeline_dispatch"] == (len(chunks), len(kept))
    assert snap["pipeline_inflate"]["calls"] >= 1 and snap["pipeline_inflate"]["items"] > 0
    assert snap["pipeline_decode"]["calls"] >= 1 and snap["pipeline_decode"]["items"] == 20
    for whole in STAGES:
        assert snap[whole]["calls"] == len(chunks)
        _stages_within_call(snap, whole, wall, counter=whole != "pairhmm")
    assert {"pairhmm_pack", "sw_pack", "pdhmm_plan"} <= set(snap)
    assert not {"pipeline_resolve", "pipeline_sw", "pipeline_pdhmm"} & set(snap)


def test_pipeline_decode_is_what_read_bam_streaming_reads(monkeypatch):
    """The producer's own decoding (``bam.RecordDecoder``) yields the
    records ``read_bam_streaming`` does, at a limit and without one."""
    haps, _ = _region()
    for limit in (5, None):
        got = [n for c in pipeline.pairhmm_stream(BAM, haps, limit=limit, chunk_reads=64,
                                                  hmm=PairHMM(device="cpu"))
               for n in c.read_names][:40]
        _, records = bam.read_bam_streaming(BAM, limit=limit)
        want = [r.name for r in records if not pipeline._is_filtered(r) and len(r.seq)][:40]
        assert got == want


def _stages_within_call(snap, whole, wall, counter=True):
    """The call's stages, which nest in none of its other stages, sum to no
    more than the call's wall time; so does the call's own counter (it
    starts after the validation that the first stage holds), unless calls
    overlap, as a pipeline's PairHMM results do."""
    stages = sum(snap[s]["seconds"] for s in STAGES[whole] if s in snap)
    assert 0 < stages <= wall
    assert 0 < snap[whole]["seconds"] and (snap[whole]["seconds"] <= wall or not counter)


def _trace(prof, tmp_path):
    path = str(tmp_path / "spans.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)
    return events["traceEvents"] if isinstance(events, dict) else events


@pytest.mark.parametrize("call,marker", [("pairhmm", "pairhmm"), ("sw", "sw"),
                                         ("pdhmm", "pdhmm")])
def test_profiler_trace_holds_the_stages_inside_the_call(monkeypatch, tmp_path, call, marker):
    """Under ``torch.profiler`` (CPU) each stage is a ``gkl.<stage>``
    ``user_annotation`` lying inside the caller's own mark of the call,
    and no program mark takes a call's name."""
    monkeypatch.setenv("GKL_TPU_METRICS", "1")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(marker):
            CALLS[call](monkeypatch)
    marks = [e for e in _trace(prof, tmp_path)
             if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    outer = [e for e in marks if e["name"] == marker]
    ours = [e for e in marks if e["name"] != marker]
    assert len(outer) == 1 and ours
    assert all(e["name"].startswith("gkl.") for e in ours)
    # the benchmark keys its call spans and its slice on these names
    assert not {"pairhmm", "sw", "pdhmm", "bench.slice"} & {e["name"] for e in ours}
    whole = {"pairhmm": "pairhmm", "sw": "smithwaterman", "pdhmm": "pdhmm"}[call]
    assert {"gkl." + s for s in STAGES[whole]} - {"gkl.sw_scalar"} <= {e["name"] for e in ours}
    t0, t1 = outer[0]["ts"], outer[0]["ts"] + outer[0]["dur"]
    for e in ours:
        assert t0 <= e["ts"] and e["ts"] + e["dur"] <= t1 + 1, e["name"]


def test_profiler_trace_of_region_stream(monkeypatch, tmp_path):
    """``region_stream``'s own stages mark the caller's thread: its waits
    and dispatches, with PairHMM's packing inside a dispatch."""
    monkeypatch.setenv("GKL_TPU_METRICS", "1")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _call_region_stream(monkeypatch)
    marks = [e for e in _trace(prof, tmp_path) if e.get("cat") == "user_annotation"]
    names = {e["name"] for e in marks}
    assert {"gkl.pipeline_wait", "gkl.pipeline_dispatch", "gkl.pairhmm_pack",
            "gkl.sw_host_walk", "gkl.pdhmm_plan"} <= names
    dispatch = [e for e in marks if e["name"] == "gkl.pipeline_dispatch"]
    pack = [e for e in marks if e["name"] == "gkl.pairhmm_pack"]
    assert all(any(d["ts"] <= p["ts"] and p["ts"] + p["dur"] <= d["ts"] + d["dur"] + 1
                   for d in dispatch) for p in pack)


MODULE_COUNTERS = [(pairhmm_cuda, "LAUNCHES", "pairhmm_scaled"),
                   (pairhmm_cuda, "ROWS_LAUNCHES", "pairhmm_rows"),
                   (pairhmm_cols, "LAUNCHES", "pairhmm_cols"),
                   (sw_cuda, "LAUNCHES", "sw_forward"),
                   (pdhmm_cuda, "LAUNCHES", "pdhmm"),
                   (pdhmm_cuda, "F64_LAUNCHES", "pdhmm_f64")]


@pytest.mark.parametrize("module,attr,kernel", MODULE_COUNTERS)
def test_module_launch_names_read_the_one_count(module, attr, kernel):
    """A module's launch name reads ``METRICS``'s count of its kernel,
    which the snapshot shows as ``launch.<kernel>``, whatever the switch;
    the other kernels' counts stay, and ``METRICS.reset()`` clears it."""
    others = [getattr(m, a) for m, a, k in MODULE_COUNTERS if k != kernel]
    before = getattr(module, attr)
    profiling.METRICS.launch(kernel)
    profiling.METRICS.launch(kernel)
    assert getattr(module, attr) == before + 2
    assert profiling.METRICS.snapshot()[f"launch.{kernel}"]["calls"] == before + 2
    assert others == [getattr(m, a) for m, a, k in MODULE_COUNTERS if k != kernel]
    profiling.METRICS.reset()
    assert getattr(module, attr) == 0 and f"launch.{kernel}" not in profiling.METRICS.snapshot()
    with pytest.raises(AttributeError, match="LAUNCHED"):
        getattr(module, "LAUNCHED")


def test_cpu_calls_count_no_launch(monkeypatch):
    for call in ("pairhmm", "sw", "pdhmm"):
        CALLS[call](monkeypatch)
    assert [getattr(m, a) for m, a, _ in MODULE_COUNTERS] == [0] * len(MODULE_COUNTERS)
    assert not [k for k in profiling.METRICS.snapshot() if k.startswith("launch.")]


def test_span_off_is_one_shared_object():
    """Off, a span is the same do-nothing object whatever its name, and
    what a block sets on it records nothing."""
    with profiling.span("pairhmm_pack", False) as s:
        s.items = 5
    assert profiling.span("sw_pack", False) is s
    assert profiling.METRICS.snapshot() == {}


def test_span_records_on_error():
    """A stage that raises still records its time."""
    with pytest.raises(ValueError):
        with profiling.span("sw_pack", True, items=3):
            raise ValueError("x")
    assert _counts(profiling.METRICS.snapshot()) == {"sw_pack": (1, 3)}
