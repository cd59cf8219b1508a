"""Blockwise Sinkhorn-OT resampling at large N — the port's twin of
``bench_ot_large`` in ``benchmarks/run_benchmarks.py``.

    python -m particle_filters_tpu_torch.benchmarks.ot_large

N = 4096, 16384 and 65536 particles in d = 2, ε = 0.1, 10 damped
iterations, block 512: at 65536 a call takes about 2·10 half-updates ×
N² = 8.6·10¹⁰ exponentials, and the dense N×N cost would be 17 GB, so the
blockwise path never forms it. The cloud is N(0, I) and the log-weights
0.5·N(0, 1) from a generator; the check is the JAX suite's: the barycentric
projection keeps the weighted mean, ‖mean(x') − Σ wᵢxᵢ‖ (``JAX_MEAN_ERR``:
the JAX package's on the CPU on its own draws, ``python
tests/test_torch_soft_ot.py``). Each N is timed to a sync after a warm-up
call, with the peak memory allocated during the timed call. Also the
dense path against the blockwise one on one cloud at N = 4096. Products run
with TF32 off (``main`` sets it; a caller sets its own).
"""

from __future__ import annotations

import sys
import time

import torch

from particle_filters_tpu_torch.benchmarks.snlg import print_profile
from particle_filters_tpu_torch.resampling.ot import sinkhorn_ot_resample
from particle_filters_tpu_torch.resampling.ot_blockwise import sinkhorn_ot_resample_blockwise
from particle_filters_tpu_torch.utils.timing import card_line, sync

SIZES = (4096, 16384, 65536)
EPSILON, N_ITERS, BLOCK = 0.1, 10, 512
DENSE_N = 4096
# The JAX package's mean error at each N on the CPU (its own draws; the
# error of the unconverged 10-iteration solve, a statistic, not a parity
# value). The port's, on its draws, is held to MEAN_ERR_FACTOR times it.
JAX_MEAN_ERR = {4096: 0.00912052858620882, 16384: 0.006179644260555506,
                65536: 0.00264511676505208}
MEAN_ERR_FACTOR = 3.0


def cloud(gen, n, device):
    p = torch.randn((n, 2), generator=gen, device=device)
    w = torch.softmax(0.5 * torch.randn((n,), generator=gen, device=device), dim=0)
    return p, w


def mean_err_bound(n) -> float:
    return MEAN_ERR_FACTOR * JAX_MEAN_ERR[n]


def mean_err(new_p, p, w) -> float:
    return float(torch.linalg.vector_norm(new_p.mean(0) - w @ p))


@torch.no_grad()
def run(device, sizes=SIZES, seed=0):
    """Seconds, peak MiB and the mean error at each N."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for n in sizes:
        p, w = cloud(gen, n, device)

        def call():
            return sinkhorn_ot_resample_blockwise(p, w, epsilon=EPSILON, n_iters=N_ITERS,
                                                  block=BLOCK)[0]
        call()
        sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
        t0 = time.perf_counter()
        new_p = call()
        sync(device)
        secs = time.perf_counter() - t0
        peak = ((torch.cuda.max_memory_allocated(device) - base) / 2**20
                if device.type == "cuda" else float("nan"))
        out[n] = {"s": secs, "peak_mib": peak, "mean_err": mean_err(new_p, p, w),
                  "finite": bool(torch.isfinite(new_p).all()),
                  "exps": 2 * N_ITERS * n * (n + (-n) % BLOCK) + n * (n + (-n) % BLOCK)}
    return out


@torch.no_grad()
def dense_vs_blockwise(device, n=DENSE_N, seed=1):
    """The dense and the blockwise path on one cloud: max |difference| and
    each one's seconds (after a warm-up)."""
    device = torch.device(device)
    p, w = cloud(torch.Generator(device=device).manual_seed(seed), n, device)
    kw = dict(epsilon=EPSILON, n_iters=N_ITERS)
    res = {}
    for tag, fn in (("dense", lambda: sinkhorn_ot_resample(p, w, damping=0.5, **kw)[0]),
                    ("blockwise", lambda: sinkhorn_ot_resample_blockwise(p, w, block=BLOCK,
                                                                         **kw)[0])):
        fn()
        sync(device)
        t0 = time.perf_counter()
        res[tag] = fn()
        sync(device)
        res[tag + "_s"] = time.perf_counter() - t0
    res["max_abs_diff"] = float((res["dense"] - res["blockwise"]).abs().max())
    res["n"] = n
    return res


def gates(res) -> dict:
    """``{gate: (value, held)}``: each N's output finite and, at the N
    where the JAX package has one, its mean error within ``mean_err_bound``."""
    out = {}
    for n, r in res.items():
        out[f"N={n} finite"] = (r["finite"], r["finite"])
        if n in JAX_MEAN_ERR:
            out[f"N={n} mean error <= {mean_err_bound(n)}"] = (
                r["mean_err"], r["mean_err"] <= mean_err_bound(n))
    return out


def print_rows(res, dense, card=""):
    for n, r in res.items():
        print(f"ot_large N={n}: {r['s']:.4f} s, peak {r['peak_mib']:.1f} MiB, mean error "
              f"{r['mean_err']:.6f} (JAX CPU {JAX_MEAN_ERR.get(n)}), {r['exps']:.3e} exps, "
              f"{r['exps'] / r['s']:.3e} exp/s  [{card}]")
    if dense:
        print(f"OT dense vs blockwise at N={dense['n']}: max |diff| {dense['max_abs_diff']:.3e}, "
              f"dense {dense['dense_s']:.4f} s, blockwise {dense['blockwise_s']:.4f} s  [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("ot_large: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print_rows(run("cuda"), dense_vs_blockwise("cuda"), card)
    p, w = cloud(torch.Generator(device="cuda").manual_seed(0), SIZES[-1], "cuda")
    print_profile(f"blockwise Sinkhorn N={SIZES[-1]}", lambda: sinkhorn_ot_resample_blockwise(
        p, w, epsilon=EPSILON, n_iters=N_ITERS, block=BLOCK), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
