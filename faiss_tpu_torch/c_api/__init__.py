"""The C API of the port (counterpart of faiss_tpu's c_api/): C callers
build, search, tune and store indexes of faiss_tpu_torch through
``faiss_tpu_torch_c.h``, whose library embeds Python and this package.

``build()`` compiles the library and ``example.c`` with gcc at first use,
against python3's own headers and libpython (sysconfig), into
``_build/c_api/<digest>/``: the digest covers the sources, the flags and the
compiler, so an edit rebuilds. Each file is written under a name of the
process's own and renamed into place, so concurrent processes never load a
half-written file. A missing gcc or a failed build raises; nothing falls
back. ``run_example(device)`` runs the example on ``device`` ("cuda" or
"cpu") and raises unless it prints its OK line."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_PKG_ROOT = _HERE.parent.parent  # the directory that holds faiss_tpu_torch
BUILD_DIR = _HERE.parent / "_build" / "c_api"
SOURCES = ("faiss_tpu_torch_c.h", "faiss_tpu_torch_c.c", "example.c")
CFLAGS = ("-O2", "-fPIC")


def _gcc() -> str:
    found = shutil.which("gcc")
    if not found:
        raise RuntimeError("gcc not found: the C API is built with it at first use")
    return found


def _python_flags():
    """(-I include, -L libdir, rpath, -lpython) of the running python3."""
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION")
    return [f"-I{inc}"], [f"-L{libdir}", f"-Wl,-rpath,{libdir}", f"-lpython{ver}"]


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr}")


def build() -> dict:
    """Compile the library and the example once per digest. Returns the
    paths {"lib": ..., "example": ..., "dir": ...}."""
    gcc = _gcc()
    inc, link = _python_flags()
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((_HERE / name).read_bytes())
    digest.update(" ".join((gcc, *CFLAGS, *inc, *link)).encode())
    out = BUILD_DIR / digest.hexdigest()[:16]
    lib, example = out / "libfaiss_tpu_torch_c.so", out / "example_c"
    pid = os.getpid()
    if not lib.exists():
        out.mkdir(parents=True, exist_ok=True)
        tmp = out / f"libfaiss_tpu_torch_c.{pid}.so"
        _run([gcc, *CFLAGS, "-shared", *inc, str(_HERE / "faiss_tpu_torch_c.c"),
              *link, "-o", str(tmp)])
        os.replace(tmp, lib)
    if not example.exists():
        tmp = out / f"example_c.{pid}"
        _run([gcc, *CFLAGS, f"-I{_HERE}", str(_HERE / "example.c"), f"-L{out}",
              f"-Wl,-rpath,{out}", "-lfaiss_tpu_torch_c", "-o", str(tmp)])
        os.replace(tmp, example)
    return {"lib": str(lib), "example": str(example), "dir": str(out)}


def run_example(device="cuda", timeout: float = 600) -> str:
    """Build if needed and run the example on ``device``; its index file
    lands beside the build. Returns its standard output; raises unless it
    exits 0 with its OK line."""
    paths = build()
    env = dict(os.environ)
    # the embedded interpreter sees this process's packages (a virtual
    # environment's site-packages are not on its default path)
    env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p and os.path.isdir(p))
    fname = Path(paths["dir"]) / f"example_index.{os.getpid()}.npz"
    try:
        proc = subprocess.run(
            [paths["example"], str(_PKG_ROOT), str(device), str(fname)],
            env=env, capture_output=True, text=True, timeout=timeout)
    finally:
        fname.unlink(missing_ok=True)
    if proc.returncode != 0 or "C API EXAMPLE: OK" not in proc.stdout:
        raise RuntimeError(f"the C API example failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return proc.stdout
