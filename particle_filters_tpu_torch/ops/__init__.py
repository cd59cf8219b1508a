"""Hand-written Hopper kernels and the paths built on them.

- B1, ``fused_pf.fused_step``: the fused propagate-and-weight step (Triton),
  driven by ``fused_pf.FusedSIRFilter``.
- B2, ``resample.resample_by_starts``: systematic-resampled values (CUDA C++),
  driven by ``resampling.hard.systematic_resample_values`` and, for many
  clouds in one launch, ``systematic_resample_values_batched``.
- S, ``systematic_starts.systematic_starts`` and ``systematic_run_ends``: the
  systematic child-run starts and run ends from the weights (CUDA C++), driven
  by ``resampling.hard.batched_starts`` and ``_child_run_ends_u``.
- The Sinkhorn tile kernels, ``sinkhorn_tile.sinkhorn_tile`` and
  ``tile_projection``: the damped dual loop and the projection with the cost
  formed in registers, and ``sinkhorn_tile_vjp``, their vector-Jacobian
  product through every iteration (CUDA C++), driven by ``resampling.ot``.
- The profiling probes (CUDA C++), driven by ``benchmarks``: X1,
  ``window_resample.window_compare_sum``; X2,
  ``span_resample.span_compare_sum``, on the prep of ``resample_blocked``;
  X3, ``launch_probe.add_one``.

Each wrapper launches its kernel on a CUDA tensor, takes its plain version
on a CPU tensor, and counts launches in ``<wrapper>.launches``. The CUDA
C++ wrappers call their kernels through one seam, ``_nvcc.Kernel``, which
builds the library, sets the signature, enters the device, passes its
stream and raises on a CUDA error. This package
file imports nothing, so ``resampling.hard`` can import ``ops.resample``
and ``ops.systematic_starts`` while ``ops.fused_pf`` imports ``resampling.hard``.
"""
