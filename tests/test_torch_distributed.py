"""Two real processes on the CPU through ``torch.distributed`` (gloo on
127.0.0.1), the port's counterpart of ``tests/test_distributed2.py``: each
process feeds only its lanes (``host_local_slice``) through the
``*_global`` entries, the indexed engine and the three APIs on the global
mesh, and must get back the single-process results for its lanes bit for
bit (``tests/torch_distributed_worker.py``, the CPU twins)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from torch_distributed_worker import LEGS

HERE = os.path.dirname(__file__)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(kind: str, timeout: int):
    """Start the two workers, wait at most ``timeout`` seconds for each
    (killing both on a timeout), and return their (rc, stdout, stderr)."""
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_distributed_worker.py"), coordinator, "2",
         str(rank), kind], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("a distributed worker timed out")
    return outs


def parse_lanes(out: str):
    got = ref = None
    for line in out.splitlines():
        if line.startswith("RESULT "):
            got = np.array(json.loads(line[7:]), np.float32)
        elif line.startswith("REF "):
            ref = np.array(json.loads(line[4:]), np.float32)
    return got, ref


def test_two_process_global_entries():
    outs = run_workers("cpu", timeout=300)
    for rc, out, err in outs:
        assert rc == 0, err[-3000:]
    lanes = []
    for rc, out, err in outs:
        got, ref = parse_lanes(out)
        assert got is not None and ref is not None, out
        np.testing.assert_array_equal(got, ref)
        lanes.append(len(got))
        for leg in LEGS:
            assert f"{leg} ok" in out, (leg, out)
    assert lanes == [16, 16]
