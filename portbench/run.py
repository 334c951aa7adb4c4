"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and ``checks`` last: each number
the check compared, beside its limit); the compared numbers are also the
last lines of standard error.  With ``--trace 0`` the metrics are the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics.

The run exits non-zero and prints no result when no CUDA card (or fewer
than the cell asks for) is visible, and when JAX or the JAX package is
loaded in this process once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
# fixed cache directories inside the checkout, so only a cell's first run
# there builds (the port's own kernels build into flink_tpu_torch/_build/)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(REPO, ".portbench_cache", sub)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench.lib import harness
    cell = harness.load_cell(args.workload)

    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA card is visible", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device, T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: JAX or the JAX package is loaded: "
              f"{', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
