"""nvcc builds of the port's hand-written CUDA sources.

Each source (``*/csrc/*.cu``, plain C interface) is compiled at first use
with ``nvcc`` for ``sm_90a`` into a shared library under ``build/`` next to
this file, named by a hash of the source, the headers beside it and the
flags, so an edit never reuses a stale build.  ``build_all`` starts one
``nvcc`` per source at once, and ``load`` opens one library with
``ctypes``.  Importing this module needs neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the "
                       "CUDA toolkit")


def library_path(source: Path) -> Path:
    """Where ``source`` is built: ``build/lib<stem>_<hash>.so``, the hash
    over the source, the headers beside it (``*.cuh``) and the flags."""
    text = source.read_bytes() + b"".join(h.read_bytes()
                                          for h in sorted(source.parent.glob("*.cuh")))
    tag = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{tag}.so"


def build_all(sources) -> list:
    """Compile every source not built yet, one ``nvcc`` each, all started
    together; returns the shared libraries' paths in ``sources``' order.
    ptxas' register and shared-memory report lands beside each as ``.log``."""
    libs = [library_path(src) for src in sources]
    running = []
    for src, lib in zip(sources, libs):
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((src, lib, tmp, proc))
    failed = []
    for src, lib, tmp, proc in running:  # wait for every nvcc, even after a failure
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {src.name}:\n{out}")
            continue
        lib.with_suffix(".log").write_text(out)
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load(source: Path) -> ctypes.CDLL:
    """``source``'s library, built first if it is not yet."""
    return ctypes.CDLL(str(build_all((source,))[0]))
