"""Several ranks of one program on this host, without torchrun: each rank is
a subprocess, and the group meets through a ``FileStore`` in a directory of
the caller's (no port to collide with another run).

    spawn_ranks(2, [sys.executable, "body.py"], workdir, timeout_s=120)

and in ``body.py``:

    rank, world = join_from_env()       # init_process_group(gloo, ...)

Every rank gets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the store's
path in ``REPRO_TORCH_STORE``. A rank that fails or outlives the deadline
fails the whole run: the others are killed, and the error carries each
rank's exit code and the end of its standard error.
"""
from __future__ import annotations

import datetime
import os
import subprocess
import time
from typing import Dict, List, Optional, Sequence

import torch.distributed as dist

STORE_ENV = "REPRO_TORCH_STORE"


def join_from_env(backend: str = "gloo", timeout_s: float = 120.0):
    """Join the group that ``spawn_ranks`` set up; -> (rank, world)."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(
        backend, store=dist.FileStore(os.environ[STORE_ENV], world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    return rank, world


def spawn_ranks(n: int, argv: Sequence[str], workdir: str,
                timeout_s: float, env: Optional[Dict[str, str]] = None
                ) -> List[str]:
    """Run ``argv`` as ranks 0..n-1 and wait for all of them, at most
    ``timeout_s`` seconds in all. Returns each rank's standard output."""
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "store")
    if os.path.exists(store):
        os.unlink(store)
    base = dict(os.environ if env is None else env)
    procs = []
    for r in range(n):
        renv = dict(base, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r))
        renv[STORE_ENV] = store
        out = open(os.path.join(workdir, f"rank{r}.out"), "w+")
        err = open(os.path.join(workdir, f"rank{r}.err"), "w+")
        procs.append((subprocess.Popen(list(argv), env=renv, stdout=out,
                                       stderr=err), out, err))
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p, _, _ in procs):
            failed = [p for p, _, _ in procs
                      if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p, _, _ in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs, report, ok = [], [], True
    for r, (p, out, err) in enumerate(procs):
        out.seek(0)
        err.seek(0)
        outs.append(out.read())
        tail = err.read()[-3000:]
        out.close()
        err.close()
        ok = ok and p.returncode == 0
        report.append(f"rank {r}: exit {p.returncode}\n{tail}")
    if not ok:
        raise RuntimeError(f"{n} ranks of {list(argv)} failed or timed out "
                           f"after {timeout_s} s:\n" + "\n".join(report))
    return outs
