"""Where kernel B2's time goes, phase by phase.

No profiler on the card sees inside a kernel (``ncu`` is not available),
so this builds copies of ``csrc/systematic_resample.cu`` that return after
each of its phases (keeping what the phase wrote alive) and times each on
the same inputs: N = 2^20, d = 1, lognormal weights at sigma = 2 and a
point mass, eight rotating input sets, CUDA-graph replay, in turns.

  empty        the launch alone
  search       + the two brackets (warps 0 and 1)
  window       + staging the starts, both splits, the marks cleared
  scatter      + the run marks
  scan         + the max-scan: every output's ancestor in shared memory
  no gather    the whole kernel with the ancestor's index stored for its value
  full         the kernel as shipped

Run on a GPU host::

    python -m particle_filters_tpu_torch.benchmarks.b2_phases
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from particle_filters_tpu_torch.ops import _nvcc
from particle_filters_tpu_torch.ops import resample as b2
from particle_filters_tpu_torch.resampling.hard import _systematic_starts
from particle_filters_tpu_torch.utils.timing import card_line

N = 1 << 20
_KEEP = "  if (d > 0) { if (threadIdx.x == 0 && d == -1) out[0] = %s; return; }\n"
# (phase, the line it ends before, what it leaves behind)
_CUTS = (
    ("empty", "  if (threadIdx.x < 64) {  // warp 0 the first diagonal", "0.f"),
    ("search", "  // Both brackets hold at most kBracket candidates", "bracket[1]"),
    ("window", "  // Scatter: the last start of each run marks its output.", "win[a0 - base]"),
    ("scatter", "  // Inclusive max-scan of the marks from a0 - 1", "anc[b0 & 7]"),
    ("scan", "  // Copy: elements [e0, e1) of out", "anc[b0 & 7]"),
)


def variants(src: str):
    """``{phase: source}``; raises if the kernel no longer has a cut's line."""
    out = {}
    for phase, line, kept in _CUTS:
        if src.count(line) != 1:
            raise RuntimeError(f"b2_phases: the kernel has no unique line {line!r}")
        out[phase] = src.replace(line, _KEEP % kept + line)
    gather = "__ldg(p + anc[padded(static_cast<int>(v%s - b0))])"
    no_gather = src
    for c in ("", " + 1", " + 2", " + 3"):
        if no_gather.count(gather % c) != 1:
            raise RuntimeError("b2_phases: the kernel's d = 1 gather changed")
        no_gather = no_gather.replace(
            gather % c, "static_cast<float>(anc[padded(static_cast<int>(v%s - b0))])" % c)
    out["no gather"] = no_gather
    out["full"] = src
    return out


def _build(tag: str, src: str):
    build = _nvcc.BUILD_DIR / "b2_phases"
    build.mkdir(parents=True, exist_ok=True)
    cu = build / f"{tag.replace(' ', '_')}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(src)
    res = subprocess.run([_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, "-o", str(so), str(cu)],
                         capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {tag}:\n{res.stderr}")
    fn = ctypes.CDLL(str(so)).pf_resample_by_starts
    fn.argtypes = [*b2._KERNEL.argtypes, ctypes.c_void_p]  # the stream last
    fn.restype = ctypes.c_int
    return fn


def _graph_us(fn, reps: int = 16, samples: int = 5) -> float:
    """Median over ``samples`` of the CUDA-event time of one replay of
    ``reps`` captured calls, per call, in µs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3 / reps)
    return statistics.median(times)


def run(device, card: str = "") -> dict:
    """``{(weights, phase): µs}`` for every phase, printed as it goes."""
    sources = variants((_nvcc.CSRC / "systematic_resample.cu").read_text())
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:  # one nvcc each
        fns = dict(zip(sources, pool.map(lambda kv: _build(*kv), sources.items())))
    gen = torch.Generator(device=device).manual_seed(5)
    mass = torch.zeros(N, device=device)
    mass[N // 3] = 1.0
    weights = {"sigma=2": torch.softmax(2.0 * torch.randn(N, generator=gen, device=device), 0),
               "point mass": mass}
    out = {}
    for label, w in weights.items():
        sets = [(torch.randn((N, 1), generator=gen, device=device), _systematic_starts(gen, w, N))
                for _ in range(8)]
        outs = [torch.empty_like(p) for p, _ in sets]
        calls = {}
        for phase, fn in fns.items():
            it = iter(range(10**9))

            def call(fn=fn, it=it, phase=phase):
                k = next(it) % len(sets)
                (p, starts), o = sets[k], outs[k]
                err = fn(p.data_ptr(), starts.data_ptr(), o.data_ptr(), N, N, 1, 0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"B2 {phase}: CUDA error {err}")
            calls[phase] = call
        fns["full"](sets[0][0].data_ptr(), sets[0][1].data_ptr(), outs[0].data_ptr(), N, N,
                    1, 0, torch.cuda.current_stream().cuda_stream)
        if not torch.equal(outs[0], b2.resample_by_starts_reference(*sets[0])):
            raise RuntimeError("b2_phases: the full kernel differs from its plain version")
        times = {phase: [] for phase in calls}
        for phase in list(calls) + list(calls)[::-1]:
            times[phase].append(_graph_us(calls[phase]))
        for phase, ts in times.items():
            out[label, phase] = sum(ts) / len(ts)
            print(f"B2 phases N={N} {label:10s} {phase:9s}: {out[label, phase]:7.3f} us"
                  f"  [{card}]", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("b2_phases needs a CUDA device.", file=sys.stderr)
        return 1
    run(torch.device("cuda"), card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
