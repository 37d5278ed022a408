"""Build the port's CUDA sources into shared libraries on first use.

Every kernel package keeps its sources under ``<package>/csrc/``; each
``<name>.cu`` exposes a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/lib<name>-<hash>.so`` beside this
file, then loaded with `ctypes`. `SOURCES` names every source of the
port. The hash covers the source and the compiler flags, so an edit
rebuilds. ``build/`` is listed in ``.gitignore``; nothing is compiled
when a module is imported, only when a kernel is first launched (or
when `build` is called, as ``chip_smoke.py`` does).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

KERNELS = Path(__file__).resolve().parent
BUILD_DIR = KERNELS / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# kernel name -> its source, relative to this directory
SOURCES = {
    "drain": "gossip/csrc/drain.cu",
    "mix": "gossip/csrc/mix.cu",
    "enqueue": "gossip/csrc/enqueue.cu",
    "ssd_chunk": "ssd/csrc/ssd_chunk.cu",
}


def source_path(name: str) -> Path:
    """The ``.cu`` file of kernel `name`."""
    return KERNELS / SOURCES[name]


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` or the toolkit's
    default prefix; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME); the CUDA kernels of repro_torch "
        "are built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where kernel `name` builds to, keyed on source + flags."""
    h = hashlib.sha256(source_path(name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(nvcc: str, name: str, out: Path) -> list:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(source_path(name))]


def build(names: Sequence[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile every source of `names` that is not built yet, one
    ``nvcc`` per source, all started together; returns name -> library.

    Each compile writes a temporary file that is renamed into place, so
    concurrent builders never load a half-written library. The ptxas
    report (registers, shared memory, spills) goes to ``<lib>.log``.
    """
    paths = {name: library_path(name) for name in names}
    todo = [n for n, p in paths.items() if not p.exists()]
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            nvcc_command(nvcc, name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        paths[name].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{source_path(name).name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return paths


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of kernel `name` (built on first call)."""
    return ctypes.CDLL(str(build((name,))[name]))
