"""Build the port's CUDA sources into shared libraries with ``nvcc`` and a
plain C interface (bound with ``ctypes``; no PyTorch headers, so a build
takes seconds).

Every library is built from the sources in this package at first use, into
``_build/`` beside this file (listed in ``.gitignore``). Its file name holds
a hash of the flags and of every file the source can reach: all files
under its ``csrc/`` directory and every header it includes with quotes,
wherever it lies. So a stale build is never loaded. ``build_all`` starts
one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from typing import Dict, List

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


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def source_files(src: str) -> List[str]:
    """The files a build of ``src`` reads: every file under its directory,
    and every header reached through quoted ``#include``s, followed
    recursively (relative to the including file; one that does not exist
    there is left to nvcc). Sorted absolute paths."""
    src = os.path.abspath(src)
    found = set()
    root = os.path.dirname(src)
    for dirpath, _, names in os.walk(root):
        found.update(os.path.join(dirpath, n) for n in names)
    todo = sorted(found | {src})
    seen = set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        with open(path, "rb") as f:
            text = f.read()
        for inc in _INCLUDE.findall(text):
            dep = os.path.normpath(os.path.join(os.path.dirname(path),
                                                inc.decode()))
            if os.path.isfile(dep) and dep not in seen:
                todo.append(dep)
    return sorted(seen)


def _target(name: str, src: str) -> str:
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(src):
        with open(path, "rb") as f:
            data = f.read()
        key.update(f"\0{os.path.relpath(path, os.path.dirname(src))}"
                   f"\0{len(data)}\0".encode())
        key.update(data)
    return os.path.join(BUILD_DIR, f"lib{name}-{key.hexdigest()[:16]}.so")


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_STACK = re.compile(r"(\d+) bytes stack frame")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(log: str) -> dict:
    """The ``-Xptxas -v`` log of one library -> {"kernels": [{"name",
    "registers", "stack_bytes", "spill_stores", "spill_loads"}, ...],
    "wgmma_serialized":
    the compiler's warnings that it serialised wgmma instructions}."""
    kernels, current = [], None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            current = {"name": m.group(1)}
            kernels.append(current)
        elif current is not None and _SPILL.search(line):
            stores, loads = _SPILL.search(line).groups()
            current.update(spill_stores=int(stores), spill_loads=int(loads))
            if _STACK.search(line):
                current["stack_bytes"] = int(_STACK.search(line).group(1))
        elif current is not None and _REGS.search(line):
            current["registers"] = int(_REGS.search(line).group(1))
    serialized = [ln.strip() for ln in log.splitlines()
                  if "wgmma" in ln and "serialized" in ln]
    return {"kernels": kernels, "wgmma_serialized": serialized}


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
