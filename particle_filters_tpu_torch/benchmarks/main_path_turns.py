"""The main path of two trees of this package in turns, on one card.

    python -m particle_filters_tpu_torch.benchmarks.main_path_turns OTHER_ROOT [PAIRS]

``OTHER_ROOT`` is the root of another checkout of the repository (a
parent commit unpacked with ``git archive``); this tree is the one the
module comes from. Each run is a fresh process started in a tree's root, so
it imports that tree's package and builds its kernels; the runs go in
pairs, other-this then this-other, ``PAIRS`` (default 5) times. A run times
``chip_smoke.py``'s main path: the fused SV filter at N = 2²⁰, T = 200
(wall ms a step, the median of 5 runs after a warm-up, and the device busy
ms of one profiled run) and the general ``ParticleFilter`` on the same
data (median of 3); then the resample's run ends alone at N = 2²⁰
(``_child_run_ends_u``: kernel S in a tree that has it, else the torch
chain of the cdf scan and the ceil), median of 50 calls,
to a sync and to the call's return (the host's time to issue it). It
prints one JSON line a run and the medians by tree.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[2]

CHILD = r"""
import json, statistics, time
import torch
from particle_filters_tpu_torch.models import ParticleFilter
from particle_filters_tpu_torch.ops.fused_pf import FusedSIRFilter, SVModel
from particle_filters_tpu_torch.resampling.hard import _child_run_ends_u
from particle_filters_tpu_torch.simulators import simulate_sv_1d

N, T, ALPHA, SIGMA, BETA = 1 << 20, 200, 0.95, 0.2, 1.0
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
sv = simulate_sv_1d(T, ALPHA, SIGMA, BETA, seed=42, device=dev)
zs = sv.Y[:, None]
var0 = SIGMA**2 / (1 - ALPHA**2)
model = SVModel(ALPHA, BETA)
gen = torch.Generator(device=dev).manual_seed(0)


def wall_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


f = FusedSIRFilter(model, [[SIGMA**2]], Np=N, resample_thresh=0.5, device=dev)
st = f.initialize(gen, [0.0], [[var0]])
fused = wall_ms(lambda: f.run(gen, st, zs), 5)
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as prof:
    _, hist = f.run(gen, st, zs)
    torch.cuda.synchronize()
busy = sum(e.self_device_time_total for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
pf = ParticleFilter(lambda x, u: model.g(x), None, Q=[[SIGMA**2]], R=None, Np=N,
                    resample_thresh=0.5, obs_loglik=model.obs_loglik, device=dev)
gst = pf.initialize(gen, [0.0], [[var0]])
general = wall_ms(lambda: pf.run(gen, gst, zs), 3)
w = torch.rand(N, generator=gen, device=dev)
w = w / w.sum()
u = torch.rand((), generator=gen, device=dev)
ends_ms = wall_ms(lambda: _child_run_ends_u(w, N, u), 50)
torch.cuda.synchronize()
issue = []
for _ in range(50):
    t0 = time.perf_counter()
    _child_run_ends_u(w, N, u)
    issue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
print(json.dumps({"fused_ms_step": fused / T, "fused_busy_ms": busy,
                  "resample_steps": int(hist["resampled"].sum()),
                  "general_ms_step": general / T, "run_ends_ms": ends_ms,
                  "run_ends_issue_ms": statistics.median(issue)}))
"""


def run_one(root: pathlib.Path) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=root, capture_output=True,
                         text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv) -> int:
    other = pathlib.Path(argv[0]).resolve()
    pairs = int(argv[1]) if len(argv) > 1 else 5
    runs = {"other": [], "this": []}
    for i in range(pairs):
        for tag in (("other", "this") if i % 2 == 0 else ("this", "other")):
            r = run_one(other if tag == "other" else HERE)
            runs[tag].append(r)
            print(json.dumps({"pair": i, "tree": tag, **r}), flush=True)
    for tag, rs in runs.items():
        med = {k: statistics.median(r[k] for r in rs) for k in rs[0]}
        print(f"{tag} ({other if tag == 'other' else HERE}), medians of {len(rs)} runs: "
              + ", ".join(f"{k} {v:.6f}" for k, v in med.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
