"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with at least the cell's number
of CUDA devices. The run sets up (weights on the device from the seed,
stores, the replica's first pull, one warm-up of every shape), measures
for ``--seconds``, then checks what the timed path produced against the
plain references in ``bench/reference``. It prints the run's facts on an
earlier line, each number compared beside its limit as the last lines of
standard error, and as the last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and ``checks`` last.

Stores and every other file the run writes go under ``TMPDIR`` and are
removed at exit; the port's kernels build into its own directory inside
the checkout, once.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
os.environ.setdefault("USE_FLAX", "0")

BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules() -> list:
    """Loaded modules whose whole top-level name is banned."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def io_counts() -> dict:
    """This process's write counts: ``wchar`` (bytes handed to write
    calls, files and pipes) and ``write_bytes`` (bytes sent to storage,
    where the kernel accounts them)."""
    out = {}
    try:
        with open("/proc/self/io") as f:
            for line in f:
                key, _, value = line.partition(":")
                if key in ("wchar", "write_bytes"):
                    out[key] = int(value)
    except OSError:
        pass
    return out


def card_facts() -> dict:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return {"nvidia_smi": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench import spec
    decl = spec.declaration()
    cell = spec.cell(decl, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from bench.harness import failed_checks, run_cell
    io0 = io_counts()
    out, ctx = run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda", T_START, decl=decl)
    found = banned_modules()
    if found:
        print(f"the run loaded {found}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    facts = {"cell": args.workload, "why": cell["why"],
             "card": torch.cuda.get_device_name(0), **card_facts(),
             "torch": torch.__version__, "cuda": torch.version.cuda,
             "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
             "tf32_cudnn": torch.backends.cudnn.allow_tf32,
             "written": {k: v - io0.get(k, 0) for k, v in io_counts().items()},
             "setup_s": ctx.setup_s, "window_s": ctx.window.seconds,
             "check_s": ctx.check_s,
             "counters": dict(ctx.rec.counters), "notes": ctx.notes}
    print("facts " + json.dumps(facts), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": out.pop("memory_peak_bytes")}
    prof = out.pop("profile", None)
    if args.trace:
        device.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
    checks = out.pop("checks")
    line = {**out, "device": device, "checks": checks}
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    if failed_checks(checks):
        print(f"not correct: {failed_checks(checks)}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
