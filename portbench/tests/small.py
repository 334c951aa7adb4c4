"""Cells of ``BENCHMARK.json`` cut to sizes a test run holds, run on the
CPU with the program's plain kernel versions."""

import time

import torch

from portbench.lib import harness

#: what each driver's configuration and mix are cut to here
SMALL = {
    "window": ({"keys": 20000, "key_capacity": 1 << 15},
               {"batch_size": 4096, "pool_batches": 16,
                "check_windows": 8}),
    "graph": ({"scale": 10}, {}),
}


def small_cell(name: str, root=harness.REPO) -> harness.Cell:
    cell = harness.load_cell(name, root=root)
    config, traffic = SMALL[cell.config["driver"]]
    cell.config.update(config)
    cell.traffic.update(traffic)
    return cell


def run_small(cell: harness.Cell, seed: int = 2 ** 31 + 12345,
              seconds: float = 1.0, trace: bool = False) -> dict:
    return harness.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter())
