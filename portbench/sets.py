"""Run a cell several times in a row, one process at a time, and keep each
run's result line, exit code and wall time as JSON lines.

    python3 portbench/sets.py --workload <name> --seconds <s> \\
        --trace <0|1> --seeds <n> [<n> ...] --out <file.jsonl>

The bounds in ``BENCHMARK.json`` come from two such sets of six runs over
the same seeds.  The card's name and power limit are written first.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def card() -> str:
    res = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return res.stdout.strip() or res.stderr.strip()


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as out:
        out.write(json.dumps({"card": card(), "workload": args.workload,
                              "seconds": args.seconds,
                              "trace": args.trace}) + "\n")
        for seed in args.seeds:
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, os.path.join(HERE, "run.py"),
                 "--workload", args.workload, "--seed", str(seed),
                 "--seconds", str(args.seconds), "--trace", str(args.trace)],
                capture_output=True, text=True)
            lines = res.stdout.strip().splitlines()
            try:
                result = json.loads(lines[-1]) if lines else None
            except json.JSONDecodeError:
                result = None
            rec = {"seed": seed, "rc": res.returncode,
                   "wall_s": time.perf_counter() - t0, "result": result,
                   "stderr": res.stderr[-4000:]}
            out.write(json.dumps(rec) + "\n")
            out.flush()
            print(json.dumps({k: rec[k] for k in ("seed", "rc", "wall_s")}
                             | {"correct": result and result["correct"],
                                "metrics": result and {
                                    k: v["value"] for k, v in
                                    result["metrics"].items()},
                                "layers": result and result.get("layers"),
                                "host": result and result.get("host"),
                                "stage_s": result and result.get("stage_s"),
                                "checks": result and {
                                    k: v["value"] for k, v in
                                    result["checks"].items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
