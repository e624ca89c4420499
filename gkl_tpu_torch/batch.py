"""Batch planning: padding/bucketing variable-length pairs into fixed shapes.

Counterpart of ``gkl_tpu/batch.py``.  Lengths pad to a small
ladder of buckets so one kernel launch serves a whole shape class.  The
arrays are (length, lane), the JAX package's layout; the PairHMM kernels
gather each lane's columns from them by index, and the Smith-Waterman
wrapper transposes its two small planes to (lane, length) on the device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np

# Length ladder: dense at small sizes, multiplicative afterwards.  Every
# rung is a multiple of 8, the scaled kernel's renormalisation period.
_LEN_LADDER = [8, 16, 24, 32, 48, 64, 96, 128, 160, 192, 224, 256, 320, 384, 448, 512, 640, 768, 1024]

# Lanes pad to a multiple of this.  The CUDA kernel masks ragged lane
# counts itself; 8 keeps padding waste small.
LANE_MULTIPLE = 8


def bucket_length(n: int) -> int:
    """Smallest ladder value >= n (beyond the ladder: next multiple of 256)."""
    for b in _LEN_LADDER:
        if n <= b:
            return b
    return ((n + 255) // 256) * 256


def bucket_lanes(n: int, lane_multiple: int = LANE_MULTIPLE) -> int:
    """Pad a lane count to a multiple of ``lane_multiple`` (at least one)."""
    return max(lane_multiple, ((n + lane_multiple - 1) // lane_multiple) * lane_multiple)


def resolve_lane_multiple(lane_multiple: int | None, shards: int = 1) -> int:
    """The lane padding multiple of an engine whose batches split over
    ``shards`` lane slabs (a mesh's size; 1 without one): the caller's
    ``lane_multiple``, or ``LANE_MULTIPLE * shards`` when it is None.  A
    value below 1, or one that does not split evenly over the shards,
    raises ``ValueError``.  Any other value runs: the kernels mask ragged
    lane counts, so nothing here needs the JAX package's 128-lane block."""
    if lane_multiple is None:
        return LANE_MULTIPLE * shards
    if lane_multiple < 1:
        raise ValueError(f"lane_multiple must be >= 1, got {lane_multiple}")
    if lane_multiple % shards:
        raise ValueError(f"lane_multiple {lane_multiple} does not split evenly over "
                         f"{shards} shards")
    return int(lane_multiple)


@dataclasses.dataclass
class PackedPairs:
    """Column-major (length, lane) padded arrays for one shape bucket."""

    hap: np.ndarray  # (H, P) uint8
    read: np.ndarray  # (R, P) uint8
    q: np.ndarray  # (R, P) uint8
    iq: np.ndarray  # (R, P) uint8
    dq: np.ndarray  # (R, P) uint8
    gcp: np.ndarray  # (R, P) uint8
    haplen: np.ndarray  # (P,) int32
    rslen: np.ndarray  # (P,) int32
    n_real: int  # lanes [0, n_real) are real pairs

    def device_bytes(self) -> int:
        """The dense batch's footprint while it is in flight, counted as
        ``gkl_tpu/batch.py`` counts it: the (H + 5R, P) uint8 input planes
        plus a (3, P) 4-byte result stack."""
        P = self.hap.shape[1]
        return (self.hap.shape[0] + 5 * self.read.shape[0]) * P + 12 * P


def _pad_columns(seqs: Sequence[np.ndarray], length: int, lanes: int, fill: int) -> np.ndarray:
    out = np.full((length, lanes), fill, dtype=np.uint8)
    n = len(seqs)
    if n and all(len(s) == len(seqs[0]) for s in seqs):
        # uniform lengths (fixed-length reads): one vectorized stack
        out[: len(seqs[0]), :n] = np.stack(seqs, axis=1)
        return out
    for k, s in enumerate(seqs):
        out[: len(s), k] = s
    return out


def pack_pairs(
    haps: Sequence[np.ndarray],
    reads: Sequence[np.ndarray],
    quals: Sequence[Sequence[np.ndarray]],
    lane_multiple: int = LANE_MULTIPLE,
    qual_fill: int = 40,
) -> PackedPairs:
    """Pack equal-bucket pairs into padded (len, lane) arrays.

    ``quals`` is a sequence of (q, iq, dq, gcp) per pair.  Padding quals use
    ``qual_fill`` (a benign mid-range phred); padded rows and columns never
    reach a result because per-lane lengths mask them.
    """
    n = len(haps)
    P = bucket_lanes(n, lane_multiple)
    H = bucket_length(max(len(h) for h in haps))
    R = bucket_length(max(len(r) for r in reads))

    hap = _pad_columns(haps, H, P, 0)
    read = _pad_columns(reads, R, P, 0)
    q = _pad_columns([qs[0] for qs in quals], R, P, qual_fill)
    iq = _pad_columns([qs[1] for qs in quals], R, P, qual_fill)
    dq = _pad_columns([qs[2] for qs in quals], R, P, qual_fill)
    gcp = _pad_columns([qs[3] for qs in quals], R, P, qual_fill)

    haplen = np.ones(P, np.int32)
    rslen = np.ones(P, np.int32)
    haplen[:n] = [len(h) for h in haps]
    rslen[:n] = [len(r) for r in reads]
    return PackedPairs(hap, read, q, iq, dq, gcp, haplen, rslen, n)


@dataclasses.dataclass
class PackedPairsIndexed:
    """Cross-product batch with deduplicated planes + per-pair indices.

    The reference marshals each read and each haplotype once and loops the
    cross product in the native kernel (``pairhmm/JavaData.h:84-106``).
    Here the unique (len, lane) planes go to the device once with two int32
    index vectors, and the kernel gathers each lane's columns itself.  When
    every read shares constant insertion/deletion GOP and GCP planes (the
    GATK default-GOP flow), those planes are not sent at all.
    """

    hap_u: np.ndarray  # (H, nu_h) uint8 — unique haplotype columns
    readq_u: np.ndarray  # (2, R, nu_r) uint8 — [bases, quals] per unique read
    quals_u: np.ndarray | None  # (3, R, nu_r) uint8 [iq, dq, gcp]; None = const
    const_quals: tuple[int, int, int] | None  # (iq, dq, gcp) when constant
    ridx: np.ndarray  # (P,) int32 — pair lane -> unique read column
    hidx: np.ndarray  # (P,) int32 — pair lane -> unique hap column
    haplen: np.ndarray  # (P,) int32
    rslen: np.ndarray  # (P,) int32
    n_real: int
    # full-pattern layout: ridx == arange(P)//nh and hidx == arange(P)%nh
    # for every lane, pads included, and the read planes pad to P//nh
    # columns, so that a dp mesh cuts unique reads and pair lanes at the
    # same places (each shard's pairs reference only its own read slab).
    # None = the compact single-device layout.
    pattern_nh: int | None = None

    def device_bytes(self) -> int:
        """Device bytes of this batch while its launch is in flight: the
        unique planes and the four (P,) int32 index and length vectors as
        uploaded, the three (H, P) f32 boundary planes that the scaled, row
        and column kernels hand from band to band or pass to pass, and the
        output, counted as the scaled kernel's (3, P) int32 (the column
        kernel's (P,) f32 is smaller).  ``gkl_tpu/batch.py``'s count
        differs: it charges the per-pair planes that its ``jnp.take``
        expands on the device, ``(H + 5R) * P``, which the port never
        builds (its kernels gather by index), and no boundary planes."""
        P = self.ridx.shape[0]
        H = self.hap_u.shape[0]
        planes = self.hap_u.nbytes + self.readq_u.nbytes
        if self.quals_u is not None:
            planes += self.quals_u.nbytes
        return planes + 4 * 4 * P + 3 * 4 * H * P + 12 * P

    def materialize(self) -> PackedPairs:
        """Expand to the dense per-pair representation (host-side)."""
        hap = np.take(self.hap_u, self.hidx, axis=1)
        read = np.take(self.readq_u[0], self.ridx, axis=1)
        q = np.take(self.readq_u[1], self.ridx, axis=1)
        if self.const_quals is not None:
            iq = np.full_like(read, self.const_quals[0])
            dq = np.full_like(read, self.const_quals[1])
            gcp = np.full_like(read, self.const_quals[2])
        else:
            iq = np.take(self.quals_u[0], self.ridx, axis=1)
            dq = np.take(self.quals_u[1], self.ridx, axis=1)
            gcp = np.take(self.quals_u[2], self.ridx, axis=1)
        return PackedPairs(hap, read, q, iq, dq, gcp, self.haplen,
                           self.rslen, self.n_real)


def pack_pairs_indexed(
    haps: Sequence[np.ndarray],
    reads: Sequence[np.ndarray],
    read_quals: Sequence[tuple],
    *,
    lane_multiple: int = LANE_MULTIPLE,
    qual_fill: int = 40,
    const_quals: tuple[int, int, int] | None = None,
    full_pattern: bool = False,
) -> PackedPairsIndexed:
    """Pack the full ``reads`` x ``haps`` cross product (read-major) with
    deduplicated planes.  ``read_quals`` holds (q, iq, dq, gcp) per read;
    iq/dq/gcp are ignored when ``const_quals`` is given.  ``full_pattern``
    pads the read planes to P//nh columns so that every lane, pads
    included, follows ridx = lane//nh, hidx = lane%nh (see
    PackedPairsIndexed.pattern_nh)."""
    nr, nh = len(reads), len(haps)
    H = bucket_length(max(len(h) for h in haps))
    R = bucket_length(max(len(r) for r in reads))
    nu_r = bucket_lanes(nr, 8)
    nu_h = bucket_lanes(nh, 8)
    P = bucket_lanes(nr * nh, lane_multiple)
    if full_pattern:
        if P % nh:
            raise ValueError("full_pattern needs nh | padded lane count")
        nu_r = P // nh

    readq_u = np.stack([
        _pad_columns(reads, R, nu_r, 0),
        _pad_columns([qs[0] for qs in read_quals], R, nu_r, qual_fill),
    ])
    quals_u = None
    if const_quals is None:
        quals_u = np.stack([
            _pad_columns([qs[1] for qs in read_quals], R, nu_r, qual_fill),
            _pad_columns([qs[2] for qs in read_quals], R, nu_r, qual_fill),
            _pad_columns([qs[3] for qs in read_quals], R, nu_r, qual_fill),
        ])
    hap_u = _pad_columns(haps, H, nu_h, 0)

    n = nr * nh
    if full_pattern:
        ridx = np.arange(P, dtype=np.int32) // nh
        hidx = np.arange(P, dtype=np.int32) % nh
    else:
        ridx = np.zeros(P, np.int32)
        hidx = np.zeros(P, np.int32)
        ridx[:n] = np.repeat(np.arange(nr, dtype=np.int32), nh)
        hidx[:n] = np.tile(np.arange(nh, dtype=np.int32), nr)
    rlen = np.array([len(r) for r in reads], np.int32)
    hlen = np.array([len(h) for h in haps], np.int32)
    haplen = np.ones(P, np.int32)
    rslen = np.ones(P, np.int32)
    haplen[:n] = hlen[hidx[:n]]
    rslen[:n] = rlen[ridx[:n]]
    return PackedPairsIndexed(hap_u, readq_u, quals_u, const_quals,
                              ridx, hidx, haplen, rslen, n,
                              pattern_nh=nh if full_pattern else None)


@dataclasses.dataclass
class PackedPDHMMIndexed:
    """PDHMM batch with deduplicated planes + per-pair indices.

    The object path (``api_pdhmm.PDHMM.compute_likelihoods``) shares one
    array per read and per haplotype across the cross product, so unique
    haplotype planes (bases, PD bytes) and unique read planes (bases and 4
    quality planes) go to the device once and the kernel gathers each
    lane's columns: ``2H*nu_h + 5R*nu_r`` bytes instead of ``(2H + 5R)*n``.
    """

    hap_u: np.ndarray  # (H, nu_h) uint8
    happd_u: np.ndarray  # (H, nu_h) uint8 — PD bytes
    readq_u: np.ndarray  # (5, R, nu_r) uint8 [bases, q, iq, dq, gcp]
    ridx: np.ndarray  # (P,) int32
    hidx: np.ndarray  # (P,) int32
    haplen: np.ndarray  # (P,) int32
    rslen: np.ndarray  # (P,) int32
    n_real: int

    @functools.cached_property
    def states_u(self) -> np.ndarray:
        """(H, nu_h) uint8 ``ops.pdhmm.column_states(happd_u)``, computed
        on first access: the kernel and its twin derive the jump states
        from the PD bytes themselves, so no launch reads this."""
        from .ops.pdhmm import column_states

        return column_states(self.happd_u)


def _pad_planes(planes: Sequence[Sequence[np.ndarray]], length: int, lanes: int,
                fills: Sequence[int]) -> np.ndarray:
    """(len(planes), length, lanes) uint8: column c of plane k holds
    ``planes[k][c]`` and plane k pads with ``fills[k]``.  One masked
    scatter of the concatenated columns, whatever their lengths (PDHMM's
    reads, clipped to a window, have many)."""
    flat = [s for seqs in planes for s in seqs]
    k, n = len(planes), len(planes[0])
    lens = np.fromiter(map(len, flat), np.int32, count=len(flat)).reshape(k, n)
    out = np.empty((k, lanes, length), np.uint8)
    out[...] = np.asarray(fills, np.uint8)[:, None, None]
    out[:, :n][np.arange(length, dtype=np.int32) < lens[:, :, None]] = np.concatenate(flat)
    return np.ascontiguousarray(out.transpose(0, 2, 1))


def pack_pdhmm_indexed(
    uhaps: Sequence[np.ndarray],
    uhap_pds: Sequence[np.ndarray],
    ureads: Sequence[np.ndarray],
    uread_quals: Sequence[tuple],
    ridx: Sequence[int],
    hidx: Sequence[int],
    *,
    lane_multiple: int = LANE_MULTIPLE,
    qual_fill: int = 40,
) -> PackedPDHMMIndexed:
    """Pack unique haplotype/read planes plus per-pair index vectors.

    ``ridx``/``hidx`` map each real pair lane to its unique read /
    haplotype column (deduplication is the caller's)."""
    hlen = np.fromiter(map(len, uhaps), np.int32, count=len(uhaps))
    rlen = np.fromiter(map(len, ureads), np.int32, count=len(ureads))
    H = bucket_length(int(hlen.max()))
    R = bucket_length(int(rlen.max()))
    hap_u, happd_u = _pad_planes((uhaps, uhap_pds), H, bucket_lanes(len(uhaps), 8), (0, 0))
    readq_u = _pad_planes([ureads, *zip(*uread_quals)], R, bucket_lanes(len(ureads), 8),
                          (0,) + (qual_fill,) * 4)
    n = len(ridx)
    P = bucket_lanes(n, lane_multiple)
    ridx_p = np.zeros(P, np.int32)
    hidx_p = np.zeros(P, np.int32)
    ridx_p[:n] = ridx
    hidx_p[:n] = hidx
    haplen = np.ones(P, np.int32)
    rslen = np.ones(P, np.int32)
    haplen[:n] = hlen[hidx_p[:n]]
    rslen[:n] = rlen[ridx_p[:n]]
    return PackedPDHMMIndexed(hap_u, happd_u, readq_u, ridx_p, hidx_p, haplen, rslen, n)


def _first_appearance(idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The distinct values of ``idx`` in the order of their first
    appearance, and each entry's position among them."""
    values, first, inverse = np.unique(idx, return_index=True, return_inverse=True)
    order = np.argsort(first)
    position = np.empty(len(values), np.int32)
    position[order] = np.arange(len(values), dtype=np.int32)
    return values[order], position[inverse.reshape(-1)]


def pack_pdhmm_lanes(
    haps: Sequence[np.ndarray],
    hap_pds: Sequence[np.ndarray],
    reads: Sequence[np.ndarray],
    read_quals: Sequence[tuple],
    ridx: np.ndarray,
    hidx: np.ndarray,
    *,
    lane_multiple: int = LANE_MULTIPLE,
) -> tuple[PackedPDHMMIndexed, int]:
    """Pack the lanes ``ridx``/``hidx``, indices into a call's unique reads
    (``reads``, ``read_quals``) and haplotypes (``haps``, ``hap_pds``):
    :func:`pack_pdhmm_indexed` of the columns those lanes use, in the
    order of their first lane.  Returns the batch and the number of unique
    planes it packs (reads plus haplotypes)."""
    ru, rloc = _first_appearance(ridx)
    hu, hloc = _first_appearance(hidx)
    ru, hu = ru.tolist(), hu.tolist()
    pk = pack_pdhmm_indexed([haps[k] for k in hu], [hap_pds[k] for k in hu],
                            [reads[k] for k in ru], [read_quals[k] for k in ru],
                            rloc, hloc, lane_multiple=lane_multiple)
    return pk, len(ru) + len(hu)


def group_by_bucket(haps: Sequence[np.ndarray], reads: Sequence[np.ndarray]):
    """Group pair indices by (R-bucket, H-bucket) shape class."""
    groups: dict[tuple[int, int], list[int]] = {}
    for k, (h, r) in enumerate(zip(haps, reads)):
        key = (bucket_length(len(r)), bucket_length(len(h)))
        groups.setdefault(key, []).append(k)
    return groups


def from_reference(packed) -> PackedPairs | PackedPairsIndexed | PackedPDHMMIndexed:
    """The port's dataclass for a batch packed by another implementation
    (the JAX package's ``PackedPairs``, ``PackedPairsIndexed`` and
    ``PackedPDHMMIndexed``), read by its numpy fields, so that both engines
    can run one identical batch."""
    if hasattr(packed, "happd_u"):
        return PackedPDHMMIndexed(
            *(np.asarray(getattr(packed, f), np.uint8) for f in ("hap_u", "happd_u", "readq_u")),
            *(np.asarray(getattr(packed, f), np.int32)
              for f in ("ridx", "hidx", "haplen", "rslen")),
            n_real=int(packed.n_real))
    if hasattr(packed, "ridx"):
        return PackedPairsIndexed(
            hap_u=np.asarray(packed.hap_u, np.uint8),
            readq_u=np.asarray(packed.readq_u, np.uint8),
            quals_u=(None if packed.quals_u is None
                     else np.asarray(packed.quals_u, np.uint8)),
            const_quals=(None if packed.const_quals is None
                         else tuple(int(v) for v in packed.const_quals)),
            ridx=np.asarray(packed.ridx, np.int32),
            hidx=np.asarray(packed.hidx, np.int32),
            haplen=np.asarray(packed.haplen, np.int32),
            rslen=np.asarray(packed.rslen, np.int32),
            n_real=int(packed.n_real),
            pattern_nh=getattr(packed, "pattern_nh", None),
        )
    return PackedPairs(*(np.asarray(getattr(packed, f), np.uint8)
                         for f in ("hap", "read", "q", "iq", "dq", "gcp")),
                       haplen=np.asarray(packed.haplen, np.int32),
                       rslen=np.asarray(packed.rslen, np.int32),
                       n_real=int(packed.n_real))
