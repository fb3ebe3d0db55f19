"""Host build of the graph code (csrc/host/*.cpp).

The HNSW and NSG graphs are built and walked on the host, in C++, as in
faiss_tpu (models/hnsw.py, models/nsg.py). Each source is compiled with g++
at first use, with faiss_tpu's flags, into ``_build/host/<digest>/``: the
digest covers the source, the flags and the compiler, so an edit rebuilds.
The library is written to a file of the process's own and renamed into
place, so concurrent processes (pytest-xdist workers) never load a half
written file. A failed build raises; nothing falls back."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
HOST_CSRC = _PKG / "csrc" / "host"
BUILD_DIR = _PKG / "_build" / "host"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-fopenmp")


def _gxx() -> str:
    # g++ from PATH, as faiss_tpu builds its copy (a CXX of the environment
    # may name another toolchain)
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the graph indexes build their host "
                           "code with it at first use")
    return found


@functools.lru_cache(maxsize=None)
def build_host_lib(name: str) -> ctypes.CDLL:
    """Compile csrc/host/<name>.cpp (once per digest) and load it."""
    source = HOST_CSRC / f"{name}.cpp"
    gxx = _gxx()
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join((gxx, *GXX_FLAGS)).encode())
    out = BUILD_DIR / digest.hexdigest()[:16]
    lib_path = out / f"lib{name}.so"
    if not lib_path.exists():
        out.mkdir(parents=True, exist_ok=True)
        tmp = out / f"lib{name}.{os.getpid()}.so"
        proc = subprocess.run([gxx, *GXX_FLAGS, str(source), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {source}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path))
