"""Build a CUDA source of ``csrc/`` with nvcc and load it with ctypes.

Each source has a plain C interface that returns ``cudaError_t``; nothing
includes PyTorch's headers, so a build takes seconds. The shared library
goes to ``build/`` at the repository root, named by a hash of the source and
the flags, and is rebuilt only when that hash changes. Nothing here runs at
import time: the first launch builds, or ``build_all`` builds every stale
source at once, one nvcc process each. What ptxas reports of a build
(registers, stack, spills) is kept beside its library; a library without
that report counts as stale.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Sequence

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
SOURCES = ("dropout.cu", "focal.cu")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from PATH, else from CUDA_HOME or /usr/local/cuda; raises when
    there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(source: str) -> str:
    """Where the library for `source` (a file name under csrc/) lives."""
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{os.path.splitext(source)[0]}-{digest}.so")


def build_all(sources: Sequence[str]) -> Dict[str, str]:
    """Compile every source of `sources` whose library is not current, one
    nvcc process each, all started together; returns the ptxas report
    (registers, stack, spills) of each source built, keyed by source."""
    jobs = {}
    for source in sources:
        out = library_path(source)
        if os.path.isfile(out) and os.path.isfile(out + ".ptxas"):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs[source] = (proc, tmp, out, cmd)
    reports, errors = {}, []
    for source, (proc, tmp, out, cmd) in jobs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{stderr}")
        else:
            reports[source] = stdout + stderr
            with open(out + ".ptxas", "w") as f:
                f.write(reports[source])
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return reports


def ptxas_report(source: str) -> str:
    """What ptxas reported when csrc/`source`'s current library was built;
    builds it first if it is not current."""
    build_all([source])
    with open(library_path(source) + ".ptxas") as f:
        return f.read()


def build(source: str) -> str:
    """Compile csrc/`source` unless its library is current; returns the path."""
    build_all([source])
    return library_path(source)


def load(source: str) -> ctypes.CDLL:
    """Build if needed and load csrc/`source` once per process."""
    with _LOCK:
        if source not in _LOADED:
            _LOADED[source] = ctypes.CDLL(build(source))
        return _LOADED[source]
