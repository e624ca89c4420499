"""The least time the card needs for a call's work, counted from the call's
inputs and outputs, whatever kernels implement it.

Peaks of one H100 SXM at its 700 W limit: 3.35 TB/s of memory, 67 TFLOP/s
of float32 and 34 TFLOP/s of float64 outside the tensor cores (NVIDIA's
data sheet; a DP recurrence's dependent products and sums cannot use the
tensor cores); int32, derived: the Hopper white paper's 64 INT32 units per
SM x 132 SMs x the 1.98 GHz boost clock.  Operations a DP cell: PairHMM 11
float32 products and sums, plus 2 a column of the read's last row for the
likelihood's sum; PDHMM 12; Smith-Waterman 13 int32 sums, maximums,
comparisons and ORs.  Bytes: each input byte once (a read base brings its
base, quality, insertion, deletion and continuation bytes; a PD haplotype
base its PD byte), each output byte once (a float64 likelihood; an offset
and a CIGAR), and the quality tables (PairHMM: 128 + 8,256 float32; PDHMM:
255 + 32,640 float32 and their padding).  A PairHMM or PDHMM call that the
deployment runs in float64 (``double``: GATK's
``--native-pair-hmm-use-double-precision``) counts the same operations and
bytes, read at the float64 peak.  The least time is the larger of
operations over the peak and bytes over the memory rate.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_F64_PER_S = 34e12
PEAK_INT32_PER_S = 64 * 132 * 1.98e9
PAIRHMM_OPS_PER_CELL = 11
PAIRHMM_OPS_PER_RESULT_COLUMN = 2
PDHMM_OPS_PER_CELL = 12
SW_OPS_PER_CELL = 13
PAIRHMM_TABLE_BYTES = 33536
PDHMM_TABLE_BYTES = 131584
READ_BYTES_PER_BASE = 5
LIKELIHOOD_BYTES = 8
OFFSET_BYTES = 4


def _least(ops: float, peak: float, nbytes: float) -> float:
    return max(ops / peak, nbytes / PEAK_BYTES_PER_S)


def _peak(double: bool) -> float:
    return PEAK_F64_PER_S if double else PEAK_F32_PER_S


def pairhmm_s(read_lengths, hap_lengths, *, double: bool = False) -> float:
    rl, hl = sum(read_lengths), sum(hap_lengths)
    nr, nh = len(read_lengths), len(hap_lengths)
    ops = PAIRHMM_OPS_PER_CELL * rl * hl + PAIRHMM_OPS_PER_RESULT_COLUMN * nr * hl
    nbytes = READ_BYTES_PER_BASE * rl + hl + LIKELIHOOD_BYTES * nr * nh + PAIRHMM_TABLE_BYTES
    return _least(ops, _peak(double), nbytes)


def pdhmm_s(read_lengths, hap_lengths, *, double: bool = False) -> float:
    rl, hl = sum(read_lengths), sum(hap_lengths)
    nr, nh = len(read_lengths), len(hap_lengths)
    nbytes = READ_BYTES_PER_BASE * rl + 2 * hl + LIKELIHOOD_BYTES * nr * nh + PDHMM_TABLE_BYTES
    return _least(PDHMM_OPS_PER_CELL * rl * hl, _peak(double), nbytes)


def sw_s(ref_lengths, alt_lengths, cigar_lengths) -> float:
    cells = sum(n * m for n, m in zip(ref_lengths, alt_lengths))
    nbytes = (sum(ref_lengths) + sum(alt_lengths) + sum(cigar_lengths)
              + OFFSET_BYTES * len(cigar_lengths))
    return _least(SW_OPS_PER_CELL * cells, PEAK_INT32_PER_S, nbytes)
