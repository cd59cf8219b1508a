"""What every cell of the benchmark shares: where its files are, the
checkout's fixed cache directories, the card check, the closed loop that
times units, and the result line.

Everything that belongs to one configuration, traffic mix or metric lives in
a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the deployment, its source, ``reduced``,
  ``assumed`` and its precision; ``configs/<config>.py`` beside it: the
  plain reference (the simulator and a plain-PyTorch filter, importing no
  code of the program);
- ``workloads/<cell>.json``: the configuration's name, the entry kind that
  drives the program, the traffic parameters and the limits of the checks;
- ``entries/<entry>.py``: one module per entry kind;
- ``metrics/<metric>.py``: one reader per metric, ``read(ctx)`` returning a
  number, or None where it finds nothing to read.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
CHECKOUT = BENCH.parent
# Fixed cache directories inside the checkout: only a cell's first run in a
# checkout compiles. TRITON_CACHE_DIR has to be set before triton is imported.
CACHE_DIRS = {"TRITON_CACHE_DIR": CHECKOUT / "build" / "triton_cache"}


def set_cache_dirs() -> None:
    for var, path in CACHE_DIRS.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def load_json(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    mod_name = f"h100_bench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark(path: Path = CHECKOUT / "BENCHMARK.json") -> dict:
    return json.loads(path.read_text())


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: its end-to-end ones
    untraced, its per-layer ones traced (listed for the cell, or moving an
    end-to-end metric of the cell where the entry lists no cells)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def unit_seed(seed: int, *parts) -> int:
    """A generator seed for one stream of one unit, from the run's seed."""
    key = ":".join(str(p) for p in (seed, *parts)).encode()
    return int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(), "little") >> 1


def generator(device, seed: int, *parts):
    import torch

    return torch.Generator(device=device).manual_seed(unit_seed(seed, *parts))


def require_cards(count: int):
    """The card check: exit without a result where there are too few cards."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < count:
        print(f"this cell needs {count} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}.",
              file=sys.stderr)
        raise SystemExit(2)


def power_limit_w():
    """The card's power limit as ``nvidia-smi`` reads it (None if it cannot)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def closed_loop(unit, seconds: float):
    """Run ``unit(i)`` (which ends in a sync) back to back until ``seconds``
    have passed; the last unit started before then finishes. Returns each
    unit's wall seconds and the whole window's."""
    times = []
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        unit(len(times))
        t1 = time.perf_counter()
        times.append(t1 - t0)
        if t1 - start >= seconds:
            return times, t1 - start


def percentile(values, q: int) -> float:
    """The q-th percentile (inclusive method) of ``values``."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


class Context:
    """What a metric reader reads: the run's times and work, and for a traced
    run the trace, the program's counters and the shapes the work is counted
    from. Fields that a run does not have are None."""

    def __init__(self, **fields) -> None:
        self.setup_s = None
        self.unit_s = None
        self.window_s = None
        self.work = {}
        self.trace = None
        self.counts = {}
        self.shape = {}
        self.__dict__.update(fields)


def read_metrics(entries: list, ctx: Context) -> dict:
    """``{name: {"value", "unit"}}`` for every metric whose reader finds
    something to read."""
    out = {}
    for m in entries:
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown=None) -> str:
    """The run's last line: the contract's keys, ``checks`` (each number
    compared, beside its limit) last."""
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return json.dumps(line)


class Keep:
    """The units whose outputs a run keeps for its check: ``count`` of them,
    the last always among them, the others drawn from the seed uniformly
    among the rest as the units come (a reservoir), so that a run holds
    at most ``count`` units' outputs however many it runs."""

    def __init__(self, seed: int, count: int) -> None:
        import random

        self.rng = random.Random(unit_seed(seed, "sample"))
        self.size, self.offered, self.kept, self.last = max(count, 1) - 1, 0, {}, None

    def add(self, i: int, out) -> None:
        if self.last is not None:
            j, prev = self.last
            if self.offered < self.size:
                self.kept[j] = prev
            else:
                r = self.rng.randrange(self.offered + 1)
                if r < self.size:
                    del self.kept[sorted(self.kept)[r]]
                    self.kept[j] = prev
            self.offered += 1
        self.last = (i, out)

    def items(self) -> list:
        """``[(unit, output)]`` in the units' order."""
        out = dict(self.kept)
        if self.last is not None:
            out[self.last[0]] = self.last[1]
        return sorted(out.items())


def worst(per_unit: list, limits: dict):
    """``({name: (worst value, limit)}, units that fail a limit, per_unit)``
    for the numbers of each unit compared; a number that is not finite
    counts as infinite."""
    def clean(v):
        return v if math.isfinite(v) else math.inf

    out = {name: (max(clean(u[name]) for u in per_unit), lim) for name, lim in limits.items()}
    failed = sum(any(clean(u[name]) > lim for name, lim in limits.items()) for u in per_unit)
    return out, failed, per_unit
