"""Build the port's CUDA sources into shared libraries on first use.

Every kernel package keeps its sources under ``<package>/csrc/``; each
``<name>.cu`` exposes a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/lib<name>-<hash>.so`` beside this
file, then loaded with `ctypes`. `SOURCES` names every source of the
port. Every ``csrc/`` directory is on the include path, so a source (or
a variant's text built elsewhere) finds the device headers (``*.cuh``)
beside it. The hash covers the source, every header and the compiler
flags, so an edit to any of them rebuilds. ``build/`` is listed in ``.gitignore``; nothing is compiled
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
from typing import Dict, Mapping, Optional, Sequence

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


def include_dirs() -> list:
    """The ``csrc/`` directory of every source, each once."""
    return sorted({source_path(name).parent for name in SOURCES})


def headers() -> list:
    """Every device header (``*.cuh``) on the include path."""
    return sorted(p for d in include_dirs() for p in d.glob("*.cuh"))


def _keyed(label: str, source: bytes) -> Path:
    h = hashlib.sha256(source)
    for header in headers():
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{label}-{h.hexdigest()[:16]}.so"


def library_path(name: str) -> Path:
    """Where kernel `name` builds to, keyed on source + headers + flags."""
    return _keyed(name, source_path(name).read_bytes())


def nvcc_command(nvcc: str, name: str, out: Path, source: Optional[Path] = None) -> list:
    includes = [f"-I{d}" for d in include_dirs()]
    return [nvcc, *NVCC_FLAGS, *includes, "-o", str(out), str(source or source_path(name))]


def build(names: Sequence[str] = tuple(SOURCES), *,
          texts: Optional[Mapping[str, str]] = None) -> Dict[str, Path]:
    """Compile every source of `names` that is not built yet, one
    ``nvcc`` per source, all started together; returns name -> library.

    `texts` maps further labels to CUDA source text (a variant of a
    kernel's source, say), written to ``build/<label>-<hash>.cu`` and
    built the same way, keyed on the text; the result has them under
    their labels. Each compile writes a temporary file that is renamed
    into place, so concurrent builders never load a half-written
    library. The ptxas report (registers, shared memory, spills) goes to
    ``<lib>.log``.
    """
    texts = dict(texts or {})
    jobs = {name: (source_path(name), library_path(name)) for name in names}
    for label, text in texts.items():
        lib = _keyed(label, text.encode())
        jobs[label] = (lib.with_name(f"{lib.stem[3:]}.cu"), lib)
    paths = {label: lib for label, (_, lib) in jobs.items()}
    todo = [label for label, lib in paths.items() if not lib.exists()]
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label in todo:
        source, lib = jobs[label]
        if label in texts:
            source.write_text(texts[label])
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[label] = (tmp, subprocess.Popen(
            nvcc_command(nvcc, label, tmp, source), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for label, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        paths[label].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{jobs[label][0].name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[label])
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return paths


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of kernel `name` (built on first call)."""
    return ctypes.CDLL(str(build((name,))[name]))
