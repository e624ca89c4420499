#!/usr/bin/env python3
"""Hold the PairHMM row kernels of two checkouts of the PyTorch port against
each other, bit for bit, on the inputs of ``chip_smoke.py`` phase 2.

    python3 scripts/torch_row_kernel_bits.py OLD_ROOT [NEW_ROOT]

runs, in one process per checkout (NEW_ROOT defaults to this script's
checkout), that checkout's ``gkl_tpu_torch`` kernels on one CUDA card: the
scaled instance at R=128, H=224, P=2,048 with the gap quals as planes and
as the GATK constants, and on phase 2's deep-lane batch; the plain
(``pairhmm_rows``) instance at R=128, H=224, P=2,048.  The inputs come from
this checkout's ``chip_smoke.py``.  It prints one JSON line per input: the
lanes whose outputs differ in any bit (mantissa, exp2 or flag; the plain
instance's f32) and each side's SHA-256.  It exits nonzero if any lane
differs.  ``--dump ROOT OUT`` is the per-checkout step: it writes ROOT's
outputs to the ``.npz`` file OUT.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs():
    """This checkout's ``chip_smoke.py`` (the functions that make its
    batches), loaded under a private name so that the kernels come from the
    checkout on sys.path."""
    spec = importlib.util.spec_from_file_location("_smoke_inputs",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dump(root: str, out: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from gkl_tpu_torch import ReadData
    from gkl_tpu_torch import batch as batch_mod
    from gkl_tpu_torch.ops import pairhmm_cuda as pc

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smoke = _inputs()
    dev = torch.device("cuda")
    hap, read, q, iq, dq, gcp, haplen, rslen = (
        torch.from_numpy(a).to(dev) for a in smoke.gatk_like_batch(128, 224, 2048))
    lanes = torch.arange(hap.shape[1], dtype=torch.int32, device=dev)
    readq = torch.stack([read, q]).contiguous()
    quals_u = torch.stack([iq, dq, gcp]).contiguous()
    res = {
        "scaled_quals_u": pc.pairhmm_scaled(hap, readq, lanes, lanes, haplen, rslen,
                                            quals_u=quals_u),
        "scaled_const_quals": pc.pairhmm_scaled(hap, readq, lanes, lanes, haplen, rslen,
                                                const_quals=smoke.GATK_GAP_QUALS),
        "rows_quals_u": pc.pairhmm_rows(hap, readq, lanes, lanes, haplen, rslen,
                                        quals_u=quals_u).view(torch.int32),
    }
    # phase 2's deep lanes: the active region's deep reads against every
    # haplotype, plus random reads at Q50
    haps, reads, deep, _ = smoke.active_region(n_reads=64 * 32)
    rd = smoke.to_read_data([reads[i] for i in np.nonzero(deep)[0]])
    rng = np.random.default_rng(1)
    q50 = np.full(256, 50, np.uint8)
    rd += [ReadData(smoke.BASES[rng.integers(0, 4, 256)], q50, q50, q50,
                    np.full(256, 10, np.uint8)) for _ in range(8)]
    pk = batch_mod.pack_pairs_indexed(
        haps, [r.read_bases for r in rd],
        [(r.read_quals, r.insertion_gop, r.deletion_gop, r.overall_gcp) for r in rd])
    res["scaled_deep"] = pc.pairhmm_scaled(**smoke.device_batch(pk, dev))
    np.savez(out, **{k: v.cpu().numpy() for k, v in res.items()})


def main(argv) -> int:
    if argv[:1] == ["--dump"] and len(argv) == 3:
        dump(argv[1], argv[2])
        return 0
    if len(argv) not in (1, 2) or argv[0].startswith("-"):
        raise SystemExit(__doc__)
    roots = [argv[0], argv[1] if len(argv) == 2 else HERE]
    with tempfile.TemporaryDirectory() as tmp:
        outs = []
        for i, root in enumerate(roots):
            out = os.path.join(tmp, f"{i}.npz")
            subprocess.run([sys.executable, os.path.abspath(__file__), "--dump", root, out],
                           check=True, timeout=900)
            outs.append(dict(np.load(out)))
    bad = 0
    for name in outs[0]:
        a, b = outs[0][name], outs[1][name]
        differ = int((a != b).reshape(-1, a.shape[-1]).any(axis=0).sum())
        bad += differ
        print(json.dumps({"input": name, "lanes": a.shape[-1], "lanes_differing": differ,
                          "sha256_old": hashlib.sha256(a.tobytes()).hexdigest(),
                          "sha256_new": hashlib.sha256(b.tobytes()).hexdigest()}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
