"""Run one cell of the benchmark once and print its result line.

    python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's workload file names its
configuration and its entry kind; the entry sets up the program from the
seed and warms up the cell's shapes (the set-up, ``setup_s``, counted from
the process's start), then units run back to back for ``--seconds``
(``--trace 0``) or a fixed number of units runs under the profiler
(``--trace 1``). Once the window has closed, the peak memory read and the
program's state freed, the plain reference checks a sample of the units'
outputs; the numbers compared and their limits are the last lines on
standard error and the last key of the result line, the last line on
standard output.

Without enough CUDA devices the run exits with code 2 and prints no result.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402

from h100_bench import harness  # noqa: E402

harness.set_cache_dirs()


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(args, device=None, bench=None, start=START) -> dict:
    """One run: the result line's fields. ``device`` (a test hook) skips the
    card check and runs where it says."""
    bench = harness.benchmark() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        raise SystemExit(f"unknown workload {args.workload!r}; BENCHMARK.json has {sorted(cells)}.")
    cell = cells[args.workload]
    traffic = harness.load_json("workloads", cell["name"])
    config = harness.load_json("configs", cell["config"])

    import gc

    import torch

    torch.set_num_threads(1)  # one process, few threads: the host's work is one Python thread
    if device is None:
        harness.require_cards(cell["chips"])
        device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device.type == "cuda"

    t_import = time.perf_counter()
    entry = harness.load_module("entries", traffic["entry"]).Entry(traffic, config, args.seed,
                                                                   device)
    t_entry = time.perf_counter()
    entry.warm_up()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - start
    print(f"setup {setup_s:.3f} s: imports and the device {t_import - start:.3f}, data and "
          f"program {t_entry - t_import:.3f}, warm-up {start + setup_s - t_entry:.3f}",
          file=sys.stderr)

    gc.collect()  # the window starts without set-up's garbage
    ctx = harness.Context(setup_s=setup_s, shape=entry.shape)
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": cell["chips"]}
    breakdown = None
    if args.trace:
        from h100_bench import trace

        entry.reset_counts()
        tr, (times, window_s) = trace.capture(lambda: _units(entry, traffic["trace_units"]))
        ctx.trace, ctx.counts = tr, entry.counts(len(times))
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        times, window_s = harness.closed_loop(entry.unit, args.seconds)
    ctx.unit_s, ctx.window_s, ctx.work = times, window_s, entry.work(len(times))
    q = [harness.percentile([t * 1e3 for t in times], p) for p in (10, 50, 90)]
    half = len(times) // 2
    print(f"{len(times)} units in {window_s:.3f} s: ms p10 {q[0]:.3f}, p50 {q[1]:.3f}, "
          f"p90 {q[2]:.3f}; halves {sum(times[:half]):.3f} s, {sum(times[half:]):.3f} s",
          file=sys.stderr)
    metrics = harness.read_metrics(harness.cell_metrics(bench, cell["name"], args.trace), ctx)
    if cuda:
        device_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
        device_info["power_limit_w"] = harness.power_limit_w()

    entry.free()
    checks, failed, _ = entry.check()
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())
    return {"correct": correct, "attempted": len(times), "failed": failed,
            "metrics": metrics, "device": device_info, "breakdown": breakdown,
            "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}}


def _units(entry, count: int):
    """``count`` units back to back: their wall seconds and the window's."""
    times = []
    start = time.perf_counter()
    for i in range(count):
        t0 = time.perf_counter()
        entry.unit(i)
        times.append(time.perf_counter() - t0)
    return times, time.perf_counter() - start


def main(argv=None) -> int:
    res = run(parse(argv))
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(harness.result_line(res["correct"], res["attempted"], res["failed"], res["metrics"],
                              res["device"], res["checks"], res["breakdown"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
