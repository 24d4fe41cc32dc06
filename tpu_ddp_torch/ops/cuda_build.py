"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each source under ``tpu_ddp_torch/ops/csrc/`` exposes a plain C entry
point (device pointers, sizes and a stream), so it compiles in seconds
without PyTorch's headers. The shared library goes into
``tpu_ddp_torch/_build/`` under a name keyed on a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags: an edit to any triggers a
rebuild at first use, and an unchanged source is loaded from the earlier
build. A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


class KernelError(RuntimeError):
    """A kernel of the port that did not build or did not launch. Never
    caught: serving's failover re-raises it (fleet/resilience.py
    ``device_fault``)."""

# sm_90a, not sm_90: the Hopper-only instructions (wgmma, setmaxnreg)
# exist only for the "a" target.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    the toolkit's default location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH);"
                       " the port's CUDA kernels are built from source at "
                       "first use")


def library_path(source: str) -> Path:
    """Where the build of ``csrc/<source>`` lands for the current text of
    the source and of every header in ``csrc/``, and the flags."""
    text = b"".join(p.read_bytes() for p in
                    [CSRC / source, *sorted(CSRC.glob("*.cuh"))])
    key = hashlib.sha256(text + "\0".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{key[:16]}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` into a shared library unless a build of
    this exact source and flag set exists. The compiler's report
    (registers, spills: ``-Xptxas -v``) is kept beside it as ``.log``."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / source)],
            capture_output=True, text=True, check=False)
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise KernelError(f"nvcc failed on {source} (exit "
                              f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a reader never sees a half file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``; one handle per
    process."""
    return ctypes.CDLL(str(build(source)))
