"""The CPU Box-Muller gives the same bits in every process.

With an MKL build of torch, a process's first multi-threaded
``log``/``exp``/``cos``/``sin`` call can give wrong values on one
intra-op thread's share of the tensor (about 1 fresh process in 15);
importing ``repro_torch`` settles that first call on one element.  Here
``FRESH`` fresh Python processes start at once, and each one's first act
after the import is ``gaussian_from_u32`` on ``DRAWS`` CPU draws with
``THREADS`` intra-op threads: every process must give the same bits as
its own second call, as a single-threaded call, and as every other
process.  About 10 s of wall time.
"""

import os
import subprocess
import sys
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[1] / "src")
FRESH, DRAWS, THREADS = 10, 1_000_003, 4

_PROCESS = f"""
import hashlib
import numpy as np
import torch
from repro_torch.core.hashrng import gaussian_from_u32

torch.set_num_threads({THREADS})
rng = np.random.RandomState(0)
ua, ub = (torch.from_numpy(rng.randint(0, 2**32, {DRAWS}, dtype=np.uint64)
                           .astype(np.int64)) for _ in range(2))
first = gaussian_from_u32(ua, ub)
second = gaussian_from_u32(ua, ub)
torch.set_num_threads(1)
single = gaussian_from_u32(ua, ub)
print(hashlib.sha256(first.numpy().tobytes()).hexdigest(),
      torch.equal(first.view(torch.int32), second.view(torch.int32)),
      torch.equal(first.view(torch.int32), single.view(torch.int32)))
"""


def test_first_call_bits_in_fresh_processes():
    env = {**os.environ, "PYTHONPATH": SRC + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, "-c", _PROCESS], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(FRESH)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
        outs.append(out.split())
    assert all(o[1:] == ["True", "True"] for o in outs), outs
    assert len({o[0] for o in outs}) == 1, outs
