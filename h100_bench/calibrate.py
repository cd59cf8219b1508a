"""Readings that the limits of a cell's checks are set from: the numbers
that ``compare`` gives for the program on many seeds, and for the
configuration's control (its plain reference in the precision below the
stated one) in the program's place.

    python3 -m h100_bench.calibrate --workload <cell> --seeds 11 12 ... [--control] [--device cpu]

Each seed builds the cell as a run does, runs the units a run compares
(``check_units``; with ``--control`` none: the control stands in), frees
the program and prints one JSON line: the seed and the numbers of each unit
compared. The limits go into the workload file (see PERF.md); the
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from h100_bench import harness

harness.set_cache_dirs()


def readings(cell: str, seeds, control: bool, device=None):
    """Yield ``{"seed", "control", "numbers", "seconds"}`` for each seed."""
    import torch

    chips = {w["name"]: w["chips"] for w in harness.benchmark()["workloads"]}.get(cell, 1)
    traffic = harness.load_json("workloads", cell)
    config = harness.load_json("configs", traffic["config"])
    if device is None:
        harness.require_cards(chips)
        device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mod = harness.load_module("entries", traffic["entry"])
    k = int(traffic["check_units"])
    for seed in seeds:
        t0 = time.perf_counter()
        entry = mod.Entry(traffic, config, seed, device)
        if not control:
            entry.warm_up()
            for i in range(k):
                entry.unit(i)
        entry.free()
        _, _, per_unit = entry.check(control=control)
        del entry
        yield {"seed": seed, "control": control, "numbers": per_unit,
               "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    import torch

    device = None if args.device is None else torch.device(args.device)
    for row in readings(args.workload, args.seeds, args.control, device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
