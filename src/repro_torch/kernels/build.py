"""Build the port's CUDA sources into shared libraries with ``nvcc`` and a
plain C interface (bound with ``ctypes``; no PyTorch headers, so a build
takes seconds).

Every library is built from the sources in this package at first use, into
``_build/`` beside this file (listed in ``.gitignore``). Its file name holds
a hash of the source and the flags, so a stale build is never loaded.
``build_all`` starts one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from typing import Dict

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (no nvcc on PATH, none under "
                           f"{home}): the CUDA kernels cannot be built")
    return path


def _target(name: str, src: str) -> str:
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{key.hexdigest()[:16]}.so")


def build_all(sources: Dict[str, str]) -> Dict[str, str]:
    """{name: .cu path} -> {name: built .so path}. Sources whose library is
    already built are skipped; the rest compile concurrently. The
    compiler's ``-Xptxas -v`` report is kept beside each library as
    ``<lib>.ptxas.txt``. Raises with the compiler output on any failure."""
    out = {name: _target(name, src) for name, src in sources.items()}
    todo = [name for name in sources if not os.path.exists(out[name])]
    if not todo:
        return out
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = f"{out[name]}.tmp.{os.getpid()}"
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, sources[name]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {sources[name]}:\n{log}")
            continue
        with open(f"{out[name]}.ptxas.txt", "w") as f:
            f.write(log)
        os.replace(tmp, out[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out
