"""Build and load the hand-written CUDA kernels of `csrc/`, and its host C++.

Each `csrc/<name>.cu` is compiled with `nvcc` for Hopper (`sm_90a`) into its
own shared library with a plain C interface and loaded with `ctypes`. The
host sources (`HOST_SOURCES`, `csrc/<name>.cpp`: the zstd decoder of the
orbax reader) are compiled the same way by the host C++ compiler, the one
`nvcc` drives, so they build on a machine without CUDA too. The library
name carries a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. Libraries land in
`<repo>/build/kernels/`, written under a temporary name and renamed into
place, so processes that build at once do not read a half-written file.
Nothing is downloaded and no prebuilt kernel is used; a failed build raises
and names the compiler.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("onepass_attention", "cross_attention", "flash_backward", "flash_forward")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)
HOST_SOURCES = ("zstd_decode",)
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from csrc/ on a "
            "machine with the CUDA toolkit"
        )
    return nvcc


def _cxx() -> str:
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("the host C++ compiler (c++ or g++) was not found: the zstd "
                           "decoder of the orbax reader is built from csrc/zstd_decode.cpp")
    return cxx


def _command(name: str, out: Path) -> list:
    if name in HOST_SOURCES:
        return [_cxx(), *CXX_FLAGS, "-o", str(out), str(CSRC / f"{name}.cpp")]
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def library_path(name: str) -> Path:
    """Where the library of `csrc/<name>.cu` (or `.cpp`) lives for the current
    sources."""
    host = name in HOST_SOURCES
    h = hashlib.sha256(" ".join(CXX_FLAGS if host else NVCC_FLAGS).encode())
    sources = [CSRC / f"{name}.cpp"] if host else sorted(CSRC.glob("*.cuh")) + [
        CSRC / f"{name}.cu"]
    for src in sources:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Sequence[str] = KERNELS) -> Dict[str, str]:
    """Compile every library in `names` not built yet, one compiler per
    source, all started together. Returns {name: compiler output}
    (`-Xptxas -v` register and shared-memory use) for the sources it
    compiled."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = _command(name, tmp)
        procs[name] = (out, tmp, cmd[0], subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {}
    failed = []
    for name, (out, tmp, compiler, proc) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{compiler} failed for {name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu` (or `.cpp`), built first if
    needed."""
    path = library_path(name)
    if not path.exists():
        build([name])
    return ctypes.CDLL(str(path))

