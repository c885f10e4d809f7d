"""Build and load the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` on its own into ``build/kernels/<name>-<hash>.so`` at the
repository root, then loaded with ``ctypes``. The hash covers the source,
the shared headers ``csrc/*.cuh`` and the flags, so an edited source is
rebuilt and a built one is reused.
``-Xptxas -v`` output (registers, shared memory, spills per kernel) is
kept beside each library in ``<name>-<hash>.log``.

PyTorch's own extension builder is not used: a source that includes
PyTorch's headers takes minutes to compile, a plain C one seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Tuple[Path, Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = f"{name}-{h.hexdigest()[:12]}"
    return src, BUILD_DIR / f"{stem}.so", BUILD_DIR / f"{stem}.log"


def _start(name: str):
    """Start nvcc for one source; ``None`` when it is already built."""
    src, lib, log = _target(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name and rename: concurrent builders (test
    # workers) never load a half-written library
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib, log


def _finish(name: str, job) -> None:
    proc, tmp, lib, log = job
    out, _ = proc.communicate()
    log.write_text(out)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, lib)


def build(names: Iterable[str]) -> None:
    """Compile the named sources, all nvcc processes started together."""
    jobs = [(n, _start(n)) for n in names]
    errors = []
    for name, job in jobs:
        if job is None:
            continue
        try:
            _finish(name, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def ptxas_log(name: str) -> str:
    """The ``-Xptxas -v`` report of the current build of ``name``."""
    return _target(name)[2].read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)[1]))
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` code returned by a
    launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
