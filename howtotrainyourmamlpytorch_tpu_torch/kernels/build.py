"""Build the CUDA kernels at first use and bind them with ``ctypes``.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds). All sources compile in parallel, one ``nvcc`` each,
into ``howtotrainyourmamlpytorch_tpu_torch/_build/<hash>/``, where the hash
covers every file in ``csrc/`` and the compiler flags: an edited source
builds anew, an unchanged one is reused. Each build's compiler output
(``-Xptxas -v``: registers, shared memory, spills) is kept beside its
library as ``<name>.log``.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "are built from kernels/csrc at first use and need the CUDA toolkit"
    )


def sources() -> Sequence[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    """``_build/<hash of csrc/* and the flags>``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every source not yet built (in parallel); returns
    ``{stem: library path}``. Raises with the compiler's output on
    failure."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: out / f"lib{src.stem}.so" for src in sources()}
    pending = []
    for src in sources():
        lib = libs[src.stem]
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log = open(out / f"{src.stem}.log", "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(src)]
        pending.append((src, lib, tmp, log,
                        subprocess.Popen(cmd, stdout=log,
                                         stderr=subprocess.STDOUT)))
    failed = []
    for src, lib, tmp, log, proc in pending:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append((src, (out / f"{src.stem}.log").read_text()))
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError(
            "nvcc failed:\n" + "\n".join(f"--- {s.name}\n{text}"
                                         for s, text in failed)
        )
    return libs


def timed_build() -> float:
    """Build everything; returns the wall seconds it took."""
    start = time.perf_counter()
    build_all()
    return time.perf_counter() - start


def build_logs() -> Dict[str, str]:
    """The compiler output of each built source (ptxas resource usage)."""
    out = build_dir()
    return {
        src.stem: (out / f"{src.stem}.log").read_text()
        for src in sources() if (out / f"{src.stem}.log").exists()
    }


@functools.lru_cache(maxsize=None)
def library(stem: str) -> ctypes.CDLL:
    """The loaded shared library built from ``csrc/<stem>.cu``."""
    return ctypes.CDLL(str(build_all()[stem]))


@functools.lru_cache(maxsize=None)
def function(stem: str, name: str, argtypes: tuple):
    """A C entry point of ``csrc/<stem>.cu`` with its argument types
    declared; every entry point returns a CUDA error code (0 = success)."""
    fn = getattr(library(stem), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if code != 0:
        err = library("conv3x3_s2").maml_cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        raise RuntimeError(
            f"{what}: CUDA error {code} ({err(code).decode()})"
        )
