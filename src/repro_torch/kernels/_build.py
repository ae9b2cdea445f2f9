"""Build the port's hand-written CUDA kernels and load them with ctypes.

Each kernel is one ``.cu`` file with a plain C interface.  It is compiled at
first use with ``nvcc`` for ``sm_90a`` into a shared library whose name
carries a hash of the source and the flags, inside ``kernels/_build/`` (a
git-ignored directory), then loaded with :mod:`ctypes`.  A later call, in
this process or another, finds the library by its hash and skips the build.
Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Sequence

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built only on a "
                       "machine with the CUDA toolkit")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def build(sources: Sequence[Path]) -> List[Path]:
    """Compile every source whose library is missing, one ``nvcc`` process
    per source, all started together.  The compiler's output (register and
    shared-memory counts from ``-Xptxas=-v``) is kept beside each library as
    ``<name>.log``.  Raises with the compiler's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources:
        so = library_path(src)
        if so.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((src, so, tmp, proc))
    failed = []
    for src, so, tmp, proc in jobs:
        log, _ = proc.communicate()
        so.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{src.name}:\n{log}")
        else:
            os.replace(tmp, so)        # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return [library_path(src) for src in sources]


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, building it first if needed."""
    key = str(source)
    if key not in _loaded:
        (so,) = build([source])
        _loaded[key] = ctypes.CDLL(str(so))
    return _loaded[key]
