"""The multi-device layer on one card: the sharded paths at world size 1
over NCCL (every collective a real NCCL call), held against the one-device
port, and the shard-aware forms of kernels B1 and B2 held against their
plain versions.

    python -m particle_filters_tpu_torch.benchmarks.sharded

opens a one-card NCCL group (``parallel.launch.process_group``) and runs
every part; ``chip_smoke.py`` runs them in its parallel phase. The parts,
each on the default group (all of them need one):

- :func:`fused_runs`: ``FusedSIRFilter`` and the sharded fused filter in
  both modes on the SV model (α = 0.95, σ = 0.2, β = 1, N = 2²⁰, T = 200)
  from one seed, with ms/step (the second of two runs) and the launches of
  the sharded runs;
- :func:`b1_offset`: B1 over four blocks of N/4 with their global offsets
  against one launch over N (x′ and lw′ must be bit-equal), and the four
  launches' partials folded by ``fold_ranks`` against the one launch's row;
- :func:`b2_cases`: B2's M→n form at a pooled shape, the all-gather slice
  and the SPF's d = 9;
- :func:`exact_pool`: the pooled exact run ends at N = 2²⁵ against
  ``exact_child_run_ends_u`` on the card and on the CPU;
- :func:`general_pf`: the sharded ``ParticleFilter`` in neighbour mode at
  N = 2²⁰ beside the unsharded one;
- :func:`snlg_edh`: the sharded EDH on the SNLG d = 64 data at N = 10⁴
  without process noise beside the unsharded flow;
- :func:`dpf_step`: the sharded DPF train step at ``bench_dpf_nonlinear``'s
  sizes (SV, N = 100, T = 100, 8 sequences) beside the unsharded step.

Across S ranks, each on its own card (the cross-rank fold, the neighbour
exchange's point-to-point copies and the rescue, which one card cannot
reach):

    python -m particle_filters_tpu_torch.benchmarks.sharded --ranks 4

spawns S NCCL ranks (``parallel.launch.run_ranks``) that run
:func:`fused_runs` at N = 2²⁰, T = 200 and past 2²⁴ (N = 2²⁵, T = 50: the
exact run ends) and :func:`pooled_resample`, and holds them to
:func:`check_across`; ``--device cpu`` runs the same on gloo ranks (at a
smaller ``--n``, ``--n-big``). It exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from particle_filters_tpu_torch.benchmarks import snlg
from particle_filters_tpu_torch.core import comm
from particle_filters_tpu_torch.models.particle_filter import ParticleFilter
from particle_filters_tpu_torch.ops import resample as b2
from particle_filters_tpu_torch.ops.fused_pf import (
    FusedSIRFilter,
    StepWork,
    SVModel,
    fold_ranks,
    fused_step,
)
from particle_filters_tpu_torch.parallel import (
    make_mesh,
    make_sharded_dpf_train_step,
    make_sharded_fused_pf,
    make_sharded_pf_run,
)
from particle_filters_tpu_torch.parallel.distributed_resample import (
    neighbor_exchange_systematic_resample,
    neighbor_pool_starts,
)
from particle_filters_tpu_torch.parallel.launch import process_group, run_ranks
from particle_filters_tpu_torch.resampling.exact import exact_child_run_ends_u
from particle_filters_tpu_torch.resampling.hard import _child_run_ends_u, _systematic_starts
from particle_filters_tpu_torch.simulators import simulate_sv_1d
from particle_filters_tpu_torch.utils.timing import card_line, sync

N, T = 1 << 20, 200
ALPHA, SIGMA, BETA = 0.95, 0.2, 1.0
RADIUS = 2
EXACT_N = 1 << 25
# (label, ranks S, this rank r, d, n): B2's M→n shapes, M = S·n starts and
# n outputs from r·n. The middle rank of 5 with radius 2 pools all 5
# shards; the all-gather slice of rank 3 of 4 merges the gathered N = 4n;
# the pool again at the SPF's d = 9.
B2_SHAPES = (("pool, rank 2 of 5, radius 2", 5, 2, 1, 1 << 18),
             ("all-gather slice, rank 3 of 4", 4, 3, 1, 1 << 18),
             ("pool d=9, rank 2 of 5", 5, 2, 9, 2000))
# Neighbour mode against all-gather on one card: the pooled cdf is
# normalized by the shard totals, not by its last entry, so some f32 run
# ends move by one and the two runs are different draws from there. At
# N = 2^20, T = 200 they read max |Δmean| 9.234e-5, ESS 2.491e-5 relative,
# log evidence 1.221e-4, the same in each of four H100 runs (the run is
# deterministic); the bounds are those readings times 4.
NEIGHBOR_TOL = {"mean": 4e-4, "ess_rel": 1e-4, "log_evidence": 5e-4}
# S cards against one, and neighbour against all-gather on S cards: the
# ranks' partials are summed in another order, so log Z rounds otherwise by
# an ulp, and the f32 run ends turn that into another draw of the cloud (a
# 1-ulp nudge of the carried log Z alone leaves 0.00015 of 2^16 particles
# equal after 200 steps on the CPU, ``tests/test_torch_parallel_filters.py::
# test_one_ulp_of_log_z_is_another_draw``). Two draws differ by Monte Carlo noise:
# at every step |Δmean| ≤ SE_K·sqrt(2·var/ESS) and |Δlog Z| ≤
# SE_K·sqrt(2/ESS), var and ESS the reference run's (1/ESS bounds the
# relative variance of the step's likelihood estimate).
SE_K = 5.0
# The ranks' B1 partials folded by ``fold_ranks`` against one launch's own
# row: the same sums in another order and another code (f32 rounding).
FOLD_TOL = {"rtol": 1e-5, "atol": 1e-6}
EDH_T, EDH_N = 50, 10000
# The sharded EDH against the unsharded flow, to f32 rounding (every H100 run
# read 0.0: at world size 1 the sums are the same).
EDH_TOL = {"mean": 1e-5, "mse_rel": 1e-5}
DPF_B, DPF_N, DPF_T = 8, 100, 100
DPF_ALPHA, DPF_SIGMA, DPF_BETA = 0.95, 0.2, 0.6


def _world():
    return dist.group.WORLD


def sv_data(device, t=T):
    sv = simulate_sv_1d(t, ALPHA, SIGMA, BETA, seed=42, device=device)
    return sv, sv.Y[:, None]


def _run_fused(filt, zs, device, seed=0):
    """(final state, history, seconds) of ``filt`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    st = filt.initialize(gen, [0.0], [[SIGMA**2 / (1 - ALPHA**2)]])
    sync(device)
    t0 = time.perf_counter()
    final, hist = filt.run(gen, st, zs)
    sync(device)
    return final, hist, time.perf_counter() - t0


def fused_runs(device, n=N, t=T):
    """``{"single" | "all_gather" | "neighbor": (final, history, s/step)}``
    and the sharded runs' launches ``{"B1", "B2"}`` (each run twice: the
    second is timed and returned; the counts are the second runs')."""
    sv, zs = sv_data(device, t)
    model = SVModel(ALPHA, BETA)
    filters = {"single": FusedSIRFilter(model, [[SIGMA**2]], Np=n, device=device)}
    for mode in ("all_gather", "neighbor"):
        filters[mode] = make_sharded_fused_pf(model, [[SIGMA**2]], Np=n, mesh=_world(),
                                              distributed_resample=mode,
                                              neighbor_radius=RADIUS, device=device)
    out, counts = {}, {"B1": 0, "B2": 0}
    for name, filt in filters.items():
        _run_fused(filt, zs, device)  # warm-up
        if name != "single":
            fused_step.launches = b2.resample_by_starts.launches = 0
        final, hist, secs = _run_fused(filt, zs, device)
        if name != "single":
            counts["B1"] += fused_step.launches
            counts["B2"] += b2.resample_by_starts.launches
        out[name] = (final, hist, secs / t)
    return sv, out, counts


def b1_offset(gen, device, n=N, ranks=4):
    """B1 over ``ranks`` blocks of n/ranks (as rank r of ``ranks``) against
    one launch over n, for a carried and a uniform ``off_u``: ``(max
    |diff| of x′ and lw′, fold error)``. The first must be 0 (bit-equal).
    The second is the largest ``|fold − row| / (atol + rtol·|row|)`` at
    :data:`FOLD_TOL` (within it at ≤ 1) of the blocks' partials rows folded
    by ``fold_ranks``, the sharded filter's cross-rank step (over the
    default group when there is one), against the one launch's own row."""
    model = SVModel(ALPHA, BETA)
    f = FusedSIRFilter(model, [[SIGMA**2]], Np=n, device=device)
    x = torch.randn((1, n), generator=gen, device=device)
    lw = torch.randn(n, generator=gen, device=device) - math.log(n)
    z = torch.tensor([0.7], device=device)
    work, k = StepWork(1, device), n // ranks
    group = _world() if dist.is_initialized() else None
    err = fold_err = 0.0
    for off_u in ((0.3, 0.0), (0.0, 1.0)):
        off_u = torch.tensor(off_u, device=device)
        x1, lw1, row1 = (a.clone() for a in fused_step(x, lw, off_u, z, f.Lq, f.params, model,
                                                        seed=7, work=work))
        parts = []
        for r in range(ranks):
            cols = slice(r * k, (r + 1) * k)
            xr, lwr, _ = fused_step(x[:, cols].contiguous(), lw[cols].contiguous(), off_u, z,
                                    f.Lq, f.params, model, seed=7, work=work, shard=(r, ranks))
            parts.append(work.last_partials().clone())
            err = max(err, (xr - x1[:, cols]).abs().max().item(),
                      (lwr - lw1[cols]).abs().max().item())
        folded = fold_ranks(torch.cat(parts), 1, group)
        scale = FOLD_TOL["atol"] + FOLD_TOL["rtol"] * row1.abs()
        fold_err = max(fold_err, ((folded - row1).abs() / scale).max().item())
    return err, fold_err


def b2_cases(gen, device):
    """``[(label, values, starts, n_out, offset)]`` of :data:`B2_SHAPES`:
    lognormal (σ = 2) weights over the S·n particles and their systematic
    starts."""
    out = []
    for label, ranks, r, d, n in B2_SHAPES:
        w = torch.softmax(2.0 * torch.randn(ranks * n, generator=gen, device=device), 0)
        values = torch.randn((ranks * n, d), generator=gen, device=device)
        out.append((label, values, _systematic_starts(gen, w, ranks * n), n, r * n))
    return out


def b2_work(starts, n_out: int, offset: int, d: int):
    """What one M→n call must move and do on these starts: ``(bytes, ops,
    counts)``: the starts whose child runs meet the outputs or lie in them,
    the distinct ancestors' values read once, the n·d outputs written; a
    compare and a select per merge item; ``counts`` the ancestors' child
    counts in the window (``repeat_interleave``'s argument)."""
    rel = torch.clamp(starts.long() - offset, 0, n_out)
    ends = torch.cat([rel[1:], rel.new_full((1,), n_out)])
    counts = ends - rel
    seen = (rel < n_out) & ((ends > 0) | (rel > 0))
    a, k = int(seen.sum()), int((counts > 0).sum())
    return 4 * a + 4 * d * k + 4 * d * n_out, 2 * (a + n_out), counts


def exact_pool(gen, device, n=EXACT_N):
    """The pooled exact run ends at ``n`` on the card against
    ``exact_child_run_ends_u`` on the card and on the CPU, at lognormal
    σ = 2 weights and at a point mass: ``{label: (card pool == card,
    card pool == CPU)}``."""
    out = {}
    pm = torch.zeros(n, device=device)
    pm[n // 3] = 1.0
    for label, w in (("sigma=2", torch.softmax(2.0 * torch.randn(n, generator=gen,
                                                                 device=device), 0)),
                     ("point mass", pm)):
        u = torch.rand(1, generator=gen, device=device)
        t_pool, _, _ = neighbor_pool_starts(w, u, group=_world(), radius=RADIUS, exact=True)
        t_card = exact_child_run_ends_u(w, n, u[0])
        t_cpu = exact_child_run_ends_u(w.cpu(), n, u[0].cpu())
        out[label] = (torch.equal(t_pool, t_card), torch.equal(t_pool.cpu(), t_cpu))
    return out


def general_pf(device, n=N, t=T):
    """The unsharded ``ParticleFilter`` and the sharded one in neighbour
    mode on the SV data: ``(sv, hist, sharded hist, sharded B2 launches)``."""
    sv, zs = sv_data(device, t)
    model = SVModel(ALPHA, BETA)
    var0 = SIGMA**2 / (1 - ALPHA**2)

    def make(**kw):
        return ParticleFilter(lambda x, u: model.g(x), None, Q=[[SIGMA**2]], R=None, Np=n,
                              obs_loglik=model.obs_loglik, device=device, **kw)

    gen = torch.Generator(device=device).manual_seed(1)
    pf = make()
    _, hist = pf.run(gen, pf.initialize(gen, [0.0], [[var0]]), zs)
    pfs = make(group=_world(), distributed_resample="neighbor", neighbor_radius=RADIUS)
    gen = torch.Generator(device=device).manual_seed(1)
    st = pfs.initialize(gen, [0.0], [[var0]])
    b2.resample_by_starts.launches = 0
    _, hist_s = make_sharded_pf_run(pfs)(gen, st, zs)
    return sv, hist, hist_s, b2.resample_by_starts.launches


def snlg_edh(device, t=EDH_T, n=EDH_N):
    """The SNLG d = 64 data's first trial through EDH-``n`` without process
    noise, unsharded and sharded, from one seed, in turns (unsharded,
    sharded, sharded, unsharded): ``(X, hist, sharded hist, seconds
    unsharded, seconds sharded)``, each a mean of its two runs."""
    Sigma, (X, Z), _ = snlg.make_data(trials=1, steps=t)
    Sigma = torch.as_tensor(Sigma, device=device)
    Z = torch.as_tensor(Z[0], device=device)
    zeros = torch.zeros(Sigma.shape[0], device=device)
    filters = {g: snlg.make_flow("edh", n, Sigma, device, group=g)[0]
               for g in (None, _world())}
    hists, secs = {}, {g: [] for g in filters}
    for g in (None, _world(), _world(), None):
        filt = filters[g]
        gen = torch.Generator(device=device).manual_seed(5)
        st = filt.init_from_gaussian(gen, zeros, Sigma)
        ts = filt.tracker.init(zeros, Sigma)
        sync(device)
        t0 = time.perf_counter()
        _, _, hists[g] = filt.run(gen, st, ts, Z)
        sync(device)
        secs[g].append(time.perf_counter() - t0)
    return (X[0, 1:], hists[None], hists[_world()], float(np.mean(secs[None])),
            float(np.mean(secs[_world()])))


def collective_us(device, reps: int = 200):
    """Host µs a call (to a sync every call) of the collectives the layer
    uses, on the default group: ``{label: µs}``."""
    g = _world()
    x1 = torch.ones(1, device=device)
    xb = torch.ones(1 << 20, device=device)
    ops = {"all_reduce(MAX) of 1 float": lambda: dist.all_reduce(x1, dist.ReduceOp.MAX, g),
           "all_gather of 1 float (list)": lambda: dist.all_gather([torch.empty_like(x1)], x1,
                                                                   group=g),
           "all_gather of 4 MiB (list)": lambda: dist.all_gather([torch.empty_like(xb)], xb,
                                                                 group=g)}
    out = {}
    for label, fn in ops.items():
        fn()
        sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
            sync(device)
        out[label] = (time.perf_counter() - t0) / reps * 1e6
    return out


def _dpf_data(seed=42):
    """8 SV sequences of ``bench_dpf_nonlinear``'s model (α 0.95, σ 0.2,
    β 0.6, T 100) drawn by its recipe from one PCG64 stream."""
    rng = np.random.default_rng(seed)
    var0 = DPF_SIGMA**2 / (1 - DPF_ALPHA**2)
    X = np.empty((DPF_B, DPF_T))
    X[:, 0] = rng.normal(0.0, np.sqrt(var0), DPF_B)
    for t in range(1, DPF_T):
        X[:, t] = DPF_ALPHA * X[:, t - 1] + DPF_SIGMA * rng.standard_normal(DPF_B)
    Y = DPF_BETA * np.exp(0.5 * X) * rng.standard_normal((DPF_B, DPF_T))
    return X[..., None].astype(np.float32), Y[..., None].astype(np.float32)


def dpf_step(device):
    """One train step at ``bench_dpf_nonlinear``'s sizes on a (1, S) mesh
    and on one device without collectives, from one seed: ``{"sharded" |
    "unsharded": (loss, gradients, seconds)}``."""
    xs, ys = (torch.as_tensor(a, device=device) for a in _dpf_data())

    def transition_fn(params, eps, particles):
        return params["alpha"] * particles + torch.exp(params["log_sigma"]) * eps

    def obs_loglik_fn(params, particles, y):
        var = DPF_BETA**2 * torch.exp(particles[:, 0])
        return -0.5 * (y[0] ** 2 / var + torch.log(var))

    def init_fn(params, eps):
        return math.sqrt(DPF_SIGMA**2 / (1 - DPF_ALPHA**2)) * eps

    lr = 0.05
    out = {}
    dev = torch.device(device)
    for label, mesh in (("unsharded", None),
                        ("sharded", make_mesh(1, device_type=dev.type))):
        step = make_sharded_dpf_train_step(
            mesh, n_particles=DPF_N, dim=1, transition_fn=transition_fn,
            obs_loglik_fn=obs_loglik_fn, init_fn=init_fn,
            loss_fn=lambda m, x: torch.mean((m - x) ** 2), learning_rate=lr)
        params = {"alpha": torch.tensor(0.9, device=device),
                  "log_sigma": torch.tensor(math.log(0.3), device=device)}
        sync(device)
        t0 = time.perf_counter()
        loss, new = step(params, torch.Generator(device=device).manual_seed(0), ys, xs)
        sync(device)
        out[label] = (loss, {k: (params[k] - new[k]) / lr for k in params},
                      time.perf_counter() - t0)
    return out


# --- S ranks, each on its own card (or gloo ranks on the CPU) ------------------
HIST_KEYS = ("mean", "cov", "ess", "log_evidence", "resampled", "exchange_ok")
BIG_T = 50  # the run past 2^24 (EXACT_N), where the resample takes the exact run ends


def pooled_resample(device, n, radius=RADIUS, values=True):
    """One resample of a global cloud of n on this rank of the default
    group, for one replicated u, in three cases: lognormal σ = 2 weights at
    ``radius`` and at radius 1, and a point mass on rank 0 at ``radius``
    (with S > radius + 1 ranks the last ranks' pools miss it: the rescue).
    ``{label: {...}}``: ``ends_equal``, the ranks' pooled exact run ends
    gathered equal to ``exact_child_run_ends_u`` on the global weights;
    with ``values`` (the particles' global indices as two exact f32
    columns, i // 4096 and i % 4096), for the exact and the f32 mode the
    neighbour exchange's ``ok`` and ``differ``, the count of this rank's
    slots whose value differs from the one-device resample's (its plain
    version, on the same weights and starts: exact mode must give 0)."""
    group = _world()
    r, s = dist.get_rank(), dist.get_world_size()
    k = n // s
    gen = torch.Generator(device=device).manual_seed(11)
    lw_sigma = torch.log_softmax(2.0 * torch.randn(n, generator=gen, device=device), 0)
    lw_point = torch.full((n,), -math.inf, device=device)
    lw_point[k // 2] = 0.0
    u = torch.rand(1, generator=gen, device=device)
    idx = torch.arange(n, device=device)
    vals_all = torch.stack([idx // 4096, idx % 4096], 1).to(torch.float32)
    vals = vals_all[r * k:(r + 1) * k].contiguous()
    out = {}
    for label, lw_all, rad in ((f"sigma=2, radius {radius}", lw_sigma, radius),
                               ("sigma=2, radius 1", lw_sigma, 1),
                               (f"point mass on rank 0, radius {radius}", lw_point, radius)):
        w_all = torch.exp(lw_all)
        lw = lw_all[r * k:(r + 1) * k].contiguous()
        t_local, _, _ = neighbor_pool_starts(torch.exp(lw), u, group=group, radius=rad,
                                             exact=True)
        t_ref = exact_child_run_ends_u(w_all, n, u[0])
        res = {"ends_equal": torch.equal(comm.all_gather_cat(t_local, group), t_ref)}
        if values:
            for mode, exact in (("exact", True), ("f32", False)):
                t = t_ref if exact else _child_run_ends_u(w_all[None], n, u, exact=False)[0]
                ref = b2.resample_by_starts_reference(
                    vals_all, torch.cat([t.new_zeros(1), t[:-1]]), k, r * k)
                got, ok = neighbor_exchange_systematic_resample(None, vals, lw, group=group,
                                                                radius=rad, exact=exact, u=u)
                res[f"ok_{mode}"] = ok
                res[f"differ_{mode}"] = int((got != ref).any(1).sum())
        out[label] = res
    return out


def rank_run(n, t, n_big, t_big, device_type):
    """One rank of :func:`run_across`: :func:`fused_runs` at (n, t) and
    (n_big, t_big), and :func:`pooled_resample` at n (with values) and
    n_big (run ends only). Returns the histories' :data:`HIST_KEYS`, ms/step,
    the sharded runs' launches, and the share of this rank's final
    particles that equal the one-device run's in all-gather mode."""
    device = torch.device(device_type)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    r, s = dist.get_rank(), dist.get_world_size()
    res = {}
    for case, (nn, tt) in (("main", (n, t)), ("big", (n_big, t_big))):
        _, runs, counts = fused_runs(device, nn, tt)
        k = nn // s
        single = runs["single"][0][0].reshape(-1, nn)[:, r * k:(r + 1) * k]
        sharded = runs["all_gather"][0][0].reshape(-1, k)
        res[case] = {
            "hist": {m: {key: h[key] for key in HIST_KEYS} for m, (_, h, _) in runs.items()},
            "ms": {m: sec * 1e3 for m, (_, _, sec) in runs.items()},
            "counts": counts,
            "same_particles": (single == sharded).float().mean().item(),
        }
    res["pool"] = pooled_resample(device, n)
    res["pool_big"] = pooled_resample(device, n_big, values=False)
    return res


def draw_diffs(h, ref):
    """How far the history ``h`` lies from ``ref``'s, in the units of
    :data:`SE_K`: the largest ``|Δmean| / sqrt(2·var/ESS)`` and ``|Δlog Z| /
    sqrt(2/ESS)`` over the steps (var and ESS ``ref``'s), the largest
    differences themselves, the largest relative ESS difference, and the
    resample steps of each."""
    ess = np.asarray(ref["ess"], np.float64)
    var = np.asarray(ref["cov"], np.float64).reshape(len(ess), -1)[:, 0]
    d_mean = np.abs(np.asarray(h["mean"])[:, 0] - np.asarray(ref["mean"])[:, 0])
    d_ll = np.abs(np.asarray(h["log_evidence"], np.float64) - ref["log_evidence"])
    return {"mean_se": float((d_mean / np.sqrt(2 * var / ess)).max()),
            "log_z_se": float((d_ll / np.sqrt(2 / ess)).max()),
            "max_mean": float(d_mean.max()), "max_log_z": float(d_ll.max()),
            "ess_rel": float((np.abs(h["ess"] - ess) / ess).max()),
            "steps": (int(h["resampled"].sum()), int(ref["resampled"].sum()))}


def check_across(results, n, t, n_big, t_big, counted=True):
    """The S ranks' results held to what the sharded filter promises:
    ``[(label, held, detail)]``. Every rank's sharded histories are the
    same bits; all-gather mode's mean and log Z stay within :data:`SE_K`
    standard errors of the one-device run's at every step, and neighbour
    mode's of all-gather's (:func:`draw_diffs`), with ``exchange_ok``
    throughout; on a
    card (``counted``: the plain versions count nothing) B1 launches once a
    step a run and B2 once a resample step; the pooled exact run ends and values
    equal the one-device ones bit for bit, and the ranks agree on ``ok``,
    which is False exactly where the point mass lies past the pool."""
    s = len(results)
    out = []

    def check(label, held, detail=""):
        out.append((label, bool(held), detail))

    r0 = results[0]
    for case, (nn, tt) in (("main", (n, t)), ("big", (n_big, t_big))):
        h = r0[case]["hist"]
        check(f"{case}: every rank's sharded histories the same bits",
              all(np.array_equal(res[case]["hist"][m][key], h[m][key]) for res in results[1:]
                  for m in ("all_gather", "neighbor") for key in HIST_KEYS))
        for mode, ref in (("all_gather", "single"), ("neighbor", "all_gather")):
            d = draw_diffs(h[mode], h[ref])
            check(f"{case} N={nn} T={tt} on {s} ranks: {mode}'s mean and log Z within "
                  f"{SE_K:g} standard errors of {ref}'s", max(d["mean_se"], d["log_z_se"]) <= SE_K,
                  f"{d}")
        check(f"{case}: neighbour mode's exchange_ok throughout",
              bool(h["neighbor"]["exchange_ok"].all()))
        n_res = int(h["all_gather"]["resampled"].sum()) + int(h["neighbor"]["resampled"].sum())
        counts = [res[case]["counts"] for res in results]
        if counted:
            check(f"{case}: B1 launched {2 * tt}, B2 {n_res} times on every rank",
                  all(c == {"B1": 2 * tt, "B2": n_res} for c in counts), f"{counts}")
        ms = {m: [res[case]["ms"][m] for res in results] for m in h}
        same = [res[case]["same_particles"] for res in results]
        check(f"{case}: ms/step and the share of final particles equal to the one-device "
              f"run's (all-gather), by rank", True, f"{ms}; {same}")
    for key, nn in (("pool", n), ("pool_big", n_big)):
        for label in r0[key]:
            got = [res[key][label] for res in results]
            check(f"pooled exact run ends at N={nn} == exact_child_run_ends_u, {label}",
                  all(g["ends_equal"] for g in got))
            if "ok_exact" not in got[0]:
                continue
            oks = {(g["ok_exact"], g["ok_f32"]) for g in got}
            want = s - 1 <= RADIUS if label.startswith("point mass") else None
            check(f"neighbour exchange at N={nn}, {label}: the ranks agree on ok"
                  + ("" if want is None else f" (= {want})"),
                  len(oks) == 1 and (want is None or oks == {(want, want)}), f"{oks}")
            check(f"neighbour exchange at N={nn}, {label}: exact values bit-equal to the "
                  f"one-device resample's", all(g["differ_exact"] == 0 for g in got),
                  f"f32 slots that differ by rank: {[g['differ_f32'] for g in got]}")
    return out


def run_across(ranks: int, *, backend="nccl", device_type="cuda", n=N, t=T, n_big=EXACT_N,
               t_big=BIG_T, timeout_s=600.0):
    """:func:`rank_run` on ``ranks`` spawned ranks (with ``nccl`` each on its
    own card), checked by :func:`check_across`."""
    if device_type == "cuda":
        if torch.cuda.device_count() < ranks:
            raise RuntimeError(f"{ranks} ranks need {ranks} cards; "
                               f"{torch.cuda.device_count()} visible.")
        b2._KERNEL.entry()  # built here once, not by every rank at the same time
    results = run_ranks(rank_run, ranks, backend=backend, timeout_s=timeout_s,
                        args=(n, t, n_big, t_big, device_type))
    return check_across(results, n, t, n_big, t_big, counted=device_type == "cuda")


def main_across(argv) -> int:
    p = argparse.ArgumentParser(description="The sharded fused filter and the neighbour "
                                "exchange on S ranks against one device.")
    p.add_argument("--ranks", type=int, required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--n", type=int, default=N)
    p.add_argument("--t", type=int, default=T)
    p.add_argument("--n-big", type=int, default=EXACT_N)
    p.add_argument("--t-big", type=int, default=BIG_T)
    a = p.parse_args(argv)
    backend = "nccl" if a.device == "cuda" else "gloo"
    if a.device == "cuda" and not torch.cuda.is_available():
        print("sharded --device cuda needs a CUDA device.", file=sys.stderr)
        return 1
    card = card_line() if a.device == "cuda" else "CPU"
    t0 = time.perf_counter()
    checks = run_across(a.ranks, backend=backend, device_type=a.device, n=a.n, t=a.t,
                        n_big=a.n_big, t_big=a.t_big)
    for label, held, detail in checks:
        print(f"{'ok  ' if held else 'FAIL'} {label}{': ' + detail if detail else ''}")
    failed = [label for label, held, _ in checks if not held]
    print(f"{a.ranks} ranks over {backend}: {len(checks) - len(failed)} of {len(checks)} "
          f"checks held, {time.perf_counter() - t0:.1f} s  [{card}]")
    return 1 if failed else 0


def main() -> int:
    if len(sys.argv) > 1:
        return main_across(sys.argv[1:])
    if not torch.cuda.is_available():
        print("sharded needs a CUDA device.", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    with process_group("nccl"):
        _, runs, counts = fused_runs(device)
        for name, (_, hist, s) in runs.items():
            print(f"fused SV {name}: {s * 1e3:.4f} ms/step, resample steps "
                  f"{int(hist['resampled'].sum())}  [{card}]")
        print(f"sharded launches {counts}")
        gen = torch.Generator(device=device).manual_seed(3)
        err, fold_err = b1_offset(gen, device)
        print(f"B1 offset max |diff| {err}; fold within {fold_err} of {FOLD_TOL}")
        for label, values, starts, n, off in b2_cases(gen, device):
            out = b2.resample_by_starts(values, starts, n_out=n, offset=off)
            same = torch.equal(out, b2.resample_by_starts_reference(values, starts, n, off))
            print(f"B2 M->n {label}: M={values.shape[0]}, n={n}, d={values.shape[1]}: "
                  f"kernel == plain {same}")
        print(f"exact pool {exact_pool(gen, device)}")
        _, h, hs, launches = general_pf(device)
        print(f"general PF neighbor: resample steps {int(hs['resampled'].sum())}, "
              f"B2 {launches}, exchange_ok {bool(hs['exchange_ok'].all())}")
        print(f"collectives, host µs a call: {collective_us(device)}")
        X, h1, hs, s1, ss = snlg_edh(device)
        print(f"SNLG EDH-{EDH_N}: max |mean diff| "
              f"{(h1['mean'] - hs['mean']).abs().max().item():.3e}, {s1:.2f} s / {ss:.2f} s")
        for k, (loss, grads, s) in dpf_step(device).items():
            print(f"DPF {k}: loss {loss.item():.6f}, grads "
                  f"{ {n: g.item() for n, g in grads.items()} }, {s:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
