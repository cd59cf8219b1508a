"""Profiling probes of the port, run as modules on a GPU host.

- ``profile_small_n``: the small-N step decomposition of the fused SIR path
  (with probe X3, ``ops/launch_probe.py``, as its launch floor);
- ``exp_kernel_var``: the windowed compare-and-sum variants (probe X1,
  ``ops/window_resample.py``);
- ``exp_resample_dma``: the span-staged resample (probe X2,
  ``ops/span_resample.py``) against kernel B2;
- ``b2_phases``: kernel B2's device time phase by phase, from copies of its
  source cut after each phase;
- ``snlg``: the SNLG d = 64 column (KF, UKF, EDH-200, LEDH-200, EDH-10000
  over 100 trials at once), the twin of ``bench_snlg`` in
  ``benchmarks/run_benchmarks.py``;
- ``skewt``: the skew-t d = 144 column (EKF, UKF, EDH-200, EDH-10000,
  LEDH-200 over 100 trials), the twin of ``bench_skewt``;
- ``mat``: the multi-target acoustic tracking column (EKF, UKF, and EDH and
  LEDH over 16 seeds), the twin of ``bench_mat_flows``;
- ``kpf``: the kernel particle filter on Lorenz-96 at nx = 1000, against
  the JAX package's posteriors;
- ``spf``: the stochastic particle flow's example 1 (the twin of
  ``bench_spf``) and example 2 (``examples/10_spf_example2.py``, with the
  SIR PF at N = 10⁴ through B2);
- ``dpf``: the differentiable PFs' ``dpf_linear`` and ``dpf_nonlinear``
  columns (soft, OT, RNN, the trained RNN) and the held-out check of the
  committed trained resampler;
- ``ot_large``: blockwise Sinkhorn-OT resampling at N = 4096, 16384, 65536;
- ``run_benchmarks``: the harness, the twin of ``benchmarks/run_benchmarks.py``:
  the nine columns above by the JAX package's names, merged into one record
  (the card's is ``results.json`` here).

``skewt``, ``mat``, ``kpf``, ``spf`` and ``dpf`` read the JAX package's data
from ``data/``.
The first three time by the slope protocol of ``_slope``, ``b2_phases`` by
CUDA-graph replay, the columns by wall clock to a sync. Importing runs
nothing.
"""
