"""The reference notebooks' experiments that no column of ``benchmarks``
reproduces, one module each (the port's twins of the JAX package's
``examples/NN_*.py`` scripts):

- ``ex01_kalman_lgssm``: the Kalman filter's NEES, RMSE and coverage over 10
  seeds of the README's 2-D LGSSM;
- ``ex07_train_dpf``: learning the SSM's transition coefficient by gradient
  descent through the soft-resampling DPF;
- ``ex08_dpf_ot_tuning``: the DPF-OT ε × damping × iterations sweep,
  vmapped over the grid and the seeds;
- ``ex11_spf_ledh_beta_schedule``: LEDH on the SPF's optimal β* schedule
  against the linear one (the notebook's negative finding);
- ``ex12_kernel_pf_experiments``: the perturbed-observation EnKF reference
  and the notebook's two tables beside the kernel PF's posteriors;
- ``ex14_sv_variance_stabilized``: the EKF, UKF and PF on the raw and the
  log-squared SV observations;
- ``ex15_pf_degeneracy_analysis``: the SIR PF's degeneracy panel and the
  notebook's four experiments.

Each takes sizes, a ``torch.Generator`` or seeds, and ``device`` (the card
unless ``"cpu"``), and its ``main()`` (``python -m
particle_filters_tpu_torch.examples.<name> [--device cpu]``) prints the JAX
script's tables, times beside the card's name and power limit. Importing
runs nothing, and no module imports matplotlib: the figures of the JAX
scripts are not made.
"""
