"""Probe X1's variants, kernel only (port of ``benchmarks/exp_kernel_var.py``).

Feeds prebuilt windows (``make_inputs``) to the windowed compare-and-sum
(``ops/window_resample.py``) at N = 2^20 and times each variant by the
graph slope (``_slope.graph_slope``, m 16 → 112, best of 4: the JAX
script's lengths):

  v0  Q = 4, SG = 64, the select, (S, SG, 128) output
  v1  v0 counting only (no select)
  v2  v0 with the (S, 128, SG) output
  v3  Q = 3
  v4  SG = 128
  v5  Q = 3, SG = 128

The JAX script perturbed its carry with each output so that XLA could not
drop the kernel; eager PyTorch drops nothing, so the loop here launches the
kernel on the same windows m times and nothing else.

``make_inputs`` ranks each sub-group's first chunk as the JAX script does,
with its own ``⌈scf/128⌉`` scatter (``_a0_ceil``), not with
``ops.resample_blocked.rank_window``.

Run on a GPU host::

    python -m particle_filters_tpu_torch.benchmarks.exp_kernel_var
"""

from __future__ import annotations

import sys

import torch

from particle_filters_tpu_torch.benchmarks._slope import graph_slope
from particle_filters_tpu_torch.ops.resample_blocked import SUB, fine_chunks
from particle_filters_tpu_torch.ops.window_resample import window_compare_sum
from particle_filters_tpu_torch.resampling.hard import _systematic_starts

N = 1 << 20
M_LO, M_HI, REPS = 16, 112, 4  # the JAX script's
# (label, Q, SG, transpose, sum_only): exp_kernel_var.py:155-160
VARIANTS = (
    ("v0 current (Q=4, SG=64)", 4, 64, True, False),
    ("v1 sum-only (Q=4)", 4, 64, True, True),
    ("v2 no-transpose (Q=4)", 4, 64, False, False),
    ("v3 Q=3", 3, 64, True, False),
    ("v4 SG=128 (Q=4)", 4, 128, True, False),
    ("v5 Q=3, SG=128", 3, 128, True, False),
)


def _a0_ceil(scf: torch.Tensor, n_subs_pad: int) -> torch.Tensor:
    """a0[s] = #{m : ⌈scf[m]/128⌉ ≤ s} − 1, at least 0 (the JAX script's
    ranking, ``exp_kernel_var.py:58-61``)."""
    c_lo = (scf + SUB - 1) // SUB
    marks = torch.zeros(n_subs_pad + 1, dtype=torch.int32, device=scf.device)
    marks.index_add_(0, c_lo.long(), torch.ones_like(c_lo))
    return torch.clamp(torch.cumsum(marks, dim=0, dtype=torch.int32)[:-1] - 1, min=0)


def windows(starts: torch.Tensor, particles: torch.Tensor, q: int, sg: int):
    """``(s_win, d_win)``: each sub-group's q fine-chunk rows of starts
    (S, SG, q·128) and of particle differences (S, SG, 1, q·128), as
    ``make_inputs`` builds them; N a multiple of 128·sg, d = 1."""
    n = particles.shape[0]
    n_fc = n // SUB
    scf = torch.clamp(starts.view(n_fc, SUB)[:, 0], 0, n)
    a0 = _a0_ceil(scf, n_fc)
    starts_f, diffs, _ = fine_chunks(starts, particles, n_fc, q)
    rows = (a0.long()[:, None] + torch.arange(q, device=a0.device)).view(-1)
    num_super = n_fc // sg
    s_win = starts_f[rows].view(num_super, sg, q * SUB)
    d_win = diffs[rows].view(num_super, sg, 1, q * SUB)
    return s_win, d_win


def make_inputs(q, sg, *, n=N, device="cuda", seed=0):
    """Windows at N = ``n`` for log-weights N(0, 1) and particles N(0, 1)
    drawn from a generator seeded with ``seed``, starts by systematic
    resampling."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w0 = torch.softmax(torch.randn(n, generator=gen, device=device), 0)
    p = torch.randn((n, 1), generator=gen, device=device)
    starts = _systematic_starts(gen, w0, n)
    return windows(starts, p, q, sg)


def build_call(q, sg, transpose, sum_only, *, n=N, device="cuda"):
    """``build_loop`` of one variant: m launches on the same windows."""
    s_win, d_win = make_inputs(q, sg, n=n, device=device)

    def build(m):
        def run():
            for _ in range(m):
                o = window_compare_sum(s_win, d_win, sum_only=sum_only, transpose=transpose)
            return o
        return run
    return build


def run_all(device="cuda"):
    """Graph-slope seconds per launch of every variant: ``{label: s}``."""
    print(f"X1 variants at N = {N}, graph slope m {M_LO} -> {M_HI}, best of {REPS}:")
    return {label: graph_slope(label, build_call(q, sg, transpose, sum_only, device=device),
                               M_LO, M_HI, REPS)
            for label, q, sg, transpose, sum_only in VARIANTS}


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_kernel_var needs a CUDA device.", file=sys.stderr)
        return 1
    print(f"card: {torch.cuda.get_device_name(0)}")
    run_all()
    return 0


if __name__ == "__main__":
    sys.exit(main())
