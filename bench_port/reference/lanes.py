"""Lane packing shared by the reference's forward DPs.

A lane is one (read, haplotype) pair.  Lanes are sorted by read plus
haplotype length and cut into blocks, so that each block's anti-diagonal
loop runs about as long as its longest lane needs; every tensor of a block
is padded to the block's longest read and haplotype."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

N_BASE = ord("N")


@dataclasses.dataclass
class Block:
    lanes: np.ndarray     # positions of this block's lanes in the caller's order
    rl: torch.Tensor      # (L,) read lengths, int64
    hl: torch.Tensor      # (L,) haplotype lengths, int64
    read: torch.Tensor    # (L, R) uint8 read bases
    rows: torch.Tensor    # (L, R, 8) per-row probabilities in the DP's type
    hap: torch.Tensor     # (L, H) uint8 haplotype bases
    hap_idx: np.ndarray   # (L,) unique haplotype of each lane


def pad_rows(seqs, width: int, fill=0, dtype=np.uint8) -> np.ndarray:
    out = np.full((len(seqs), width), fill, dtype)
    for k, s in enumerate(seqs):
        out[k, :len(s)] = s
    return out


def blocks(read_bases, read_rows, hap_bases, lanes, block: int, dtype, device):
    """Yield :class:`Block` s over ``lanes`` ((n, 2) read index, haplotype
    index) of the unique reads (bases, (R, 8) float64 rows) and haplotypes."""
    lanes = np.asarray(lanes, np.int64).reshape(-1, 2)
    rlen = np.array([len(r) for r in read_bases], np.int64)
    hlen = np.array([len(h) for h in hap_bases], np.int64)
    span = rlen[lanes[:, 0]] + hlen[lanes[:, 1]]
    order = np.argsort(span, kind="stable")
    for s0 in range(0, len(order), block):
        pos = order[s0:s0 + block]
        ri, hi = lanes[pos, 0], lanes[pos, 1]
        R, H = int(rlen[ri].max()), int(hlen[hi].max())
        rows = np.zeros((len(pos), R, 8), np.float64)
        for k, r in enumerate(ri):
            rows[k, :rlen[r]] = read_rows[r]
        yield Block(
            lanes=pos,
            rl=torch.from_numpy(rlen[ri]).to(device),
            hl=torch.from_numpy(hlen[hi]).to(device),
            read=torch.from_numpy(pad_rows([read_bases[r] for r in ri], R)).to(device),
            rows=torch.from_numpy(rows).to(device=device, dtype=dtype),
            hap=torch.from_numpy(pad_rows([hap_bases[h] for h in hi], H)).to(device),
            hap_idx=hi)


def log10_total(total: torch.Tensor, exp2: int) -> np.ndarray:
    """log10 of the DP's sums with its initial constant 2^exp2 taken off."""
    with np.errstate(divide="ignore"):
        return np.log10(total.to(torch.float64).cpu().numpy()) - np.log10(np.ldexp(1.0, exp2))


def below(total: torch.Tensor, threshold: float | None) -> np.ndarray:
    """Which of the DP's sums (its initial constant still in) lie below
    ``threshold`` or are not finite: the lanes a float kernel hands to its
    float64 rescue.  None: no lane."""
    t = total.to(torch.float64).cpu().numpy()
    if threshold is None:
        return np.zeros(len(t), bool)
    return ~(t >= threshold)
