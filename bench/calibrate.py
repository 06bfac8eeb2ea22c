"""Readings that set a cell's limits: what the system under test gives on
many seeds, and what the control (the reference in float8 in its place)
and planted faults give on the same seeds, all in one process.

    python3 bench/calibrate.py --workload <cell> --seeds 11,12,13 \\
        --seconds 8 --modes control[,half_batch] --out <file.jsonl>

One JSON line a seed: the checks (the program's numbers beside the
current limits), each mode's readings, the end-to-end numbers and the
memory peak. The benchmark's own runs never run this.
"""
import time

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--modes", default="control")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibration reads the card: no CUDA device", file=sys.stderr)
        return 2
    from bench.harness import run_cell
    modes = tuple(m for m in args.modes.split(",") if m)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out, ctx = run_cell(args.workload, seed, args.seconds, False, "cuda",
                            t, readings=modes)
        line = {"seed": seed, "correct": out["correct"],
                "checks": out["checks"], "readings": ctx.readings,
                "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                "memory_peak_bytes": out["memory_peak_bytes"],
                "seconds": time.perf_counter() - t,
                "card": torch.cuda.get_device_name(0)}
        print(json.dumps(line), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        del out, ctx
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
