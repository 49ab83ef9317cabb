"""Build the port's CUDA sources into shared libraries, at first use.

Each library is one ``.cu`` file (plus the headers it includes) under
``csrc/``, compiled by ``nvcc`` for ``sm_90a`` into ``build/repro_torch/``
of the checkout as a shared library with a plain C interface, and loaded
with ``ctypes``.  The library's file name carries a digest of its
sources, so an edited source builds anew.  ``build_all`` starts one
``nvcc`` per library at once and waits for all of them.

Nothing here runs at import: the CPU tests import every module, and
this machine's CPU-only installs have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SMEM_MAX = 232_448  # shared memory a CTA may have on sm_90
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    path = home / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the port's kernels build on a "
                           "machine with the CUDA toolkit")
    return str(path)


class KernelLibrary:
    """One ``.cu`` source built into one ctypes library.

    ``bind(lib)`` declares ``argtypes``/``restype`` of its C functions.
    ``log`` holds what nvcc and ptxas printed for the last build in
    this process ("" when the library was already on disk).
    """

    def __init__(self, source: str, headers: Sequence[str],
                 bind: Callable[[ctypes.CDLL], None]):
        self.source = source
        self.headers = tuple(headers)
        self.bind = bind
        self.log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._proc: Optional[subprocess.Popen] = None
        self._tmp: Optional[Path] = None

    def _out(self) -> Path:
        digest = hashlib.sha256()
        for name in (self.source, *self.headers):
            digest.update((CSRC / name).read_bytes())
        stem = Path(self.source).stem
        return BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"

    def start(self) -> None:
        """Start nvcc in the background if the library is not built."""
        if self._lib is not None or self._proc is not None:
            return
        out = self._out()
        if out.exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self._tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(self._tmp),
               str(CSRC / self.source)]
        self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)

    def load(self) -> ctypes.CDLL:
        """Wait for a started build, then load and bind the library."""
        if self._lib is not None:
            return self._lib
        self.start()
        out = self._out()
        if self._proc is not None:
            proc, self._proc = self._proc, None
            text, _ = proc.communicate()
            self.log = (text or "").strip()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source} "
                                   f"({proc.returncode}):\n{self.log}")
            os.replace(self._tmp, out)
        lib = ctypes.CDLL(str(out))
        self.bind(lib)
        self._lib = lib
        return lib


def build_all(libraries: Sequence[KernelLibrary]) -> None:
    """Build every library, one nvcc each, all started together."""
    for lib in libraries:
        lib.start()
    for lib in libraries:
        lib.load()


def raise_on(rc: int, what: str) -> None:
    """Raise if a launch returned a cudaError_t other than 0."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def source_constant(source: str, name: str) -> int:
    """The value of ``constexpr int <name> = <value>;`` in a ``csrc/``
    source: the kernel's compile-time constants stay in one place, and
    the launch geometry reads them from there."""
    text = (CSRC / source).read_text()
    found = re.findall(rf"constexpr\s+int\s+{name}\s*=\s*(\d+)\s*;", text)
    if len(found) != 1:
        raise RuntimeError(f"{source} defines {name} {len(found)} times")
    return int(found[0])


def magic_div(d: int) -> Tuple[int, int, int]:
    """(m, s1, s2) such that, with t = (n * m) >> 32, floor(n / d) ==
    (t + ((n - t) >> s1)) >> s2 for every 32-bit n (Granlund and
    Montgomery 1994, fig. 4.1); ``qz::Div`` of ``csrc/qz_common.cuh``
    takes them."""
    if not 1 <= d < 1 << 32:
        raise ValueError(f"divisor {d} outside [1, 2^32)")
    ell = (d - 1).bit_length()  # ceil(log2 d)
    m = ((1 << 32) * ((1 << ell) - d)) // d + 1
    return m, min(ell, 1), max(ell - 1, 0)
