#!/usr/bin/env python3
"""Hold the PDHMM kernels of two checkouts of the PyTorch port against each
other and against the twin in the kernel's order, bit for bit.

    python3 scripts/torch_pdhmm_kernel_bits.py OLD_ROOT [NEW_ROOT]

runs, in one process per checkout (NEW_ROOT defaults to this script's
checkout), that checkout's ``gkl_tpu_torch/csrc/pdhmm.cu`` on one CUDA card
at ``chip_smoke.py``'s 8a shape (R=256, H=448, P=8,192), its 8b shape
(R=1,024, H=512, P=512) and on the inputs of phase 11's PDHMM launch (the
corpus's 40,960 lanes through ``PDHMM.compute_likelihoods``).  The inputs
come from this checkout's ``chip_smoke.py``.  A checkout that has
``ops/pdhmm_cuda.pdhmm_kernel_order`` also runs it on the same inputs.  It
prints the card's name and power limit, then one JSON line per input: the
lanes whose f32 results differ in any bit between the two kernels and
between each kernel and the twin, each side's SHA-256, and each kernel's
ms (CUDA events, mean of 5 calls after a warm-up).  It exits nonzero if
any lane differs.  ``--dump ROOT OUT`` is the per-checkout step: it writes
ROOT's results to the ``.npz`` file OUT.
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

    from gkl_tpu_torch import PDHMM
    from gkl_tpu_torch.ops import pdhmm_cuda

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smoke = _inputs()
    batches = {"8a": smoke.pdhmm_batch(256, 448, 8192, seed=11),
               "8b": smoke.pdhmm_batch(1024, 512, 512, seed=11)}
    # phase 11's launch: the corpus's PD haplotypes through the public call
    calls = []
    real = pdhmm_cuda.pdhmm
    pdhmm_cuda.pdhmm = lambda **t: calls.append(t) or real(**t)
    try:
        c = smoke.region_corpus()
        PDHMM().compute_likelihoods(c["rd"], c["pdd"])
    finally:
        pdhmm_cuda.pdhmm = real
    if len(calls) != 1:
        raise AssertionError(f"phase 11's corpus took {len(calls)} PDHMM launches, not 1")
    batches["11"] = calls[0]
    twin = getattr(pdhmm_cuda, "pdhmm_kernel_order", None)
    res = {}
    for name, t in batches.items():
        res[f"kernel_{name}"] = pdhmm_cuda.pdhmm(**t).view(torch.int32)
        res[f"ms_{name}"] = torch.tensor(smoke.cuda_ms(lambda i: pdhmm_cuda.pdhmm(**t), 5))
        if twin is not None:
            res[f"twin_{name}"] = twin(**t).view(torch.int32)
    np.savez(out, **{k: v.cpu().numpy() for k, v in res.items()})


def main(argv) -> int:
    if argv[:1] == ["--dump"] and len(argv) == 3:
        dump(argv[1], argv[2])
        return 0
    if len(argv) not in (1, 2) or argv[0].startswith("-"):
        raise SystemExit(__doc__)
    roots = [argv[0], argv[1] if len(argv) == 2 else HERE]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        outs = []
        for i, root in enumerate(roots):
            out = os.path.join(tmp, f"{i}.npz")
            subprocess.run([sys.executable, os.path.abspath(__file__), "--dump", root, out],
                           check=True, timeout=900)
            outs.append(dict(np.load(out)))
    old, new = outs
    bad = 0
    for name in ("8a", "8b", "11"):
        a, b = old[f"kernel_{name}"], new[f"kernel_{name}"]
        line = {"input": name, "lanes": int(a.shape[0]),
                "lanes_differing_old_new": int((a != b).sum()),
                "sha256_old": hashlib.sha256(a.tobytes()).hexdigest(),
                "sha256_new": hashlib.sha256(b.tobytes()).hexdigest(),
                "kernel_ms_old": float(old[f"ms_{name}"]),
                "kernel_ms_new": float(new[f"ms_{name}"])}
        bad += line["lanes_differing_old_new"]
        twin = new.get(f"twin_{name}", old.get(f"twin_{name}"))
        if twin is not None:
            line["lanes_differing_old_twin"] = int((a != twin).sum())
            line["lanes_differing_new_twin"] = int((b != twin).sum())
            bad += line["lanes_differing_old_twin"] + line["lanes_differing_new_twin"]
        print(json.dumps(line), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
