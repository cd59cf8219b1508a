"""Programs that the sharded tests run on spawned gloo ranks
(``particle_filters_tpu_torch.parallel.launch.run_ranks``).

They import torch and the port, never JAX, so a rank starts in about a
second; the tests make their inputs with numpy (and JAX) in the parent and
read their results back as numpy. Each program runs every case of its test
module, so a module spawns its ranks once per world size.
"""

import math

import numpy as np
import torch
import torch.distributed as dist

from particle_filters_tpu_torch.core import comm
from particle_filters_tpu_torch.core import linalg as tlin
from particle_filters_tpu_torch.core import weights as tw
from particle_filters_tpu_torch import entry
from particle_filters_tpu_torch.entry import DRY_ALPHA0 as ALPHA0
from particle_filters_tpu_torch.entry import DRY_SIGMA0 as SIGMA0
from particle_filters_tpu_torch.entry import dpf_parts, dryrun_rank
from particle_filters_tpu_torch.models import edh_particle_filter as tedh
from particle_filters_tpu_torch.models import extended_kalman_filter as tekf
from particle_filters_tpu_torch.models import ledh_particle_filter as tledh
from particle_filters_tpu_torch.models import trackers as ttr
from particle_filters_tpu_torch.ops.fused_pf import SVModel
from particle_filters_tpu_torch.parallel import (
    all_gather_systematic_resample,
    make_mesh,
    make_sharded_dpf_train_step,
    make_sharded_flow_run,
    make_sharded_fused_init,
    make_sharded_fused_pf,
    make_sharded_fused_run,
    make_sharded_fused_step,
    make_sharded_pf_run,
    neighbor_exchange_systematic_resample,
    shard_flow_state,
    shard_pf_state,
    sharded_soft_resample,
)
from particle_filters_tpu_torch.parallel.distributed_resample import neighbor_pool_starts

CPU = "cpu"


def _world():
    return dist.group.WORLD


def _rows(n_global, group=None):
    group = _world() if group is None else group
    k = n_global // comm.size(group)
    return slice(comm.rank(group) * k, (comm.rank(group) + 1) * k)


def _raises(fn, exc=ValueError) -> str:
    """The message of the ``exc`` that ``fn()`` raises ('' if none)."""
    try:
        fn()
    except exc as e:  # noqa: PERF203
        return str(e) or type(e).__name__
    return ""


# --- resampling, weights, mesh ---------------------------------------------
def resample_suite(cases, p_w, lw_w):
    """Each case ``(particles, logw, u, radius, exact)`` (global arrays): the
    rank's neighbour-exchange values and ``ok``, its all-gather values and
    the global starts, its pooled run ends and own ``ok``; the weight
    functions with the group on ``(p_w, lw_w)``; and ``make_mesh``."""
    g = _world()
    out = {"cases": []}
    for p, lw, u, radius, exact in cases:
        rows = _rows(p.shape[0])
        pt, lwt, ut = torch.from_numpy(p[rows]), torch.from_numpy(lw[rows]), torch.tensor([u])
        nb, ok = neighbor_exchange_systematic_resample(None, pt, lwt, group=g, radius=radius,
                                                       exact=exact, u=ut)
        ag, starts = all_gather_systematic_resample(None, pt, lwt, group=g, u=ut, exact=exact)
        t_local, t_before, ok_local = neighbor_pool_starts(torch.exp(lwt), ut, group=g,
                                                           radius=radius, exact=bool(exact))
        out["cases"].append({"neighbor": nb, "ok": ok, "all_gather": ag, "starts": starts,
                             "t_local": t_local, "t_before": t_before, "ok_local": ok_local})
    rows = _rows(lw_w.shape[0])
    p, lw = torch.from_numpy(p_w[rows]), torch.from_numpy(lw_w[rows])
    logw_n, log_z = tw.log_normalize(lw, g)
    mean, cov = tw.weighted_mean_cov(p, lw, g)
    out["weights"] = {"logw_n": logw_n, "log_z": log_z, "ess": tw.ess_from_logw(lw, g),
                      "mean": mean, "cov": cov, "wmean": tw.weighted_mean(p, lw, g),
                      "ess_uniform": tw.ess_from_logw(torch.zeros_like(lw), g)}
    m1, m2 = make_mesh(1, device_type=CPU), make_mesh(2, device_type=CPU)
    out["mesh"] = {
        "names": list(m1.mesh_dim_names), "shape1": tuple(m1.mesh.shape),
        "shape2": tuple(m2.mesh.shape),
        "particles_size2": comm.size(m2.get_group("particles")),
        "bad": [_raises(lambda: make_mesh(3, device_type=CPU)),
                _raises(lambda: make_mesh(4, 4, device_type=CPU)),
                _raises(lambda: make_mesh(1, 2, device_type=CPU))],
        "shift": [comm.shift(torch.tensor([float(comm.rank(g))]), g, o)
                  for o in (-2, -1, 1, 2)],
    }
    return out


def fail_on_rank(bad_rank):
    if comm.rank(_world()) == bad_rank:
        raise RuntimeError("rank program failed on purpose")
    dist.barrier()
    return comm.rank(_world())


def sleep_past(seconds):
    import time

    time.sleep(seconds)


# --- the general SIR filter ------------------------------------------------
def sv_pf(n, **kw):
    """``entry.sv_pf`` on the CPU."""
    return entry.sv_pf(n, CPU, **kw)


def general_pf(zs, n, seed):
    """The sharded ParticleFilter on the SV data in both modes; the ESS of
    a uniform cloud over three null observations; the checks it raises."""
    g = _world()
    out = {}
    for mode in ("all_gather", "neighbor"):
        pf = sv_pf(n, group=g, distributed_resample=mode, neighbor_radius=2)
        gen = torch.Generator().manual_seed(seed)
        st = pf.initialize(gen, [0.0], [[1.05]])
        _, hist = make_sharded_pf_run(pf)(gen, st, torch.from_numpy(zs))
        out[mode] = {"hist": hist, "gen_state": gen.get_state(),
                     "n_local": st.particles.shape[0]}
    pf = sv_pf(n, group=g)
    gen = torch.Generator().manual_seed(seed + 1)
    st = pf.initialize(gen, [0.0], [[1.0]])
    out["ess_uniform"] = make_sharded_pf_run(pf)(gen, st, torch.zeros((3, 1)))[1]["ess"]
    # A global state cut to this rank's slice, then run.
    full = sv_pf(n).initialize(torch.Generator().manual_seed(seed + 2), [0.0], [[1.05]])
    st = shard_pf_state(full, g)
    out["cut"] = st.particles
    out["raises"] = [
        _raises(lambda: pf.run(gen, st, torch.zeros((2, 1)), track_degeneracy=True)),
        _raises(lambda: sv_pf(n + 1, group=g)),
    ]
    return out


# --- the fused filter ------------------------------------------------------
def fused_runs(zs, n, seed_i, seed_r, neighbor_zs):
    """The sharded fused SV filter: all-gather twice from one seed (its
    final particles and history), neighbour mode resampling every step,
    one step, and a count that does not divide."""
    g = _world()
    zs = torch.from_numpy(zs)
    pf = make_sharded_fused_pf(SVModel(0.95, 1.0), [[0.04]], Np=n, mesh=g, device=CPU)
    init, run = make_sharded_fused_init(pf), make_sharded_fused_run(pf)
    out = {}
    for k in range(2):
        st = init(torch.Generator().manual_seed(seed_i), [0.0], [[0.41]])
        final, hist = run(torch.Generator().manual_seed(seed_r), st, zs)
        out[f"run{k}"] = {"x": final[0], "hist": hist}
    pfn = make_sharded_fused_pf(SVModel(0.95, 1.0), [[0.04]], Np=n, mesh=g,
                                resample_thresh=2.0, distributed_resample="neighbor",
                                device=CPU)
    gen = torch.Generator().manual_seed(seed_r)
    _, out["neighbor"] = make_sharded_fused_run(pfn)(gen, pfn.initialize(gen, [0.0], [[0.41]]),
                                                     torch.from_numpy(neighbor_zs))
    st = init(torch.Generator().manual_seed(seed_i), [0.0], [[0.41]])
    _, out["step"] = make_sharded_fused_step(pf)(torch.Generator().manual_seed(1), st,
                                                 torch.tensor([0.3]))
    out["bad_np"] = _raises(lambda: make_sharded_fused_pf(SVModel(0.95, 1.0), [[0.04]],
                                                         Np=n + 2, mesh=g, device=CPU))
    return out


# --- the flows ---------------------------------------------------------------
def flow_filter(kind, cfg_kw, sys, group=None, bend=0.0, mode="all_gather"):
    """EDH or LEDH on the 2-D system ``sys`` (A, C, Q, R as numpy) with
    h(x) = Cx + bend·sin x and an EKF tracker; the process-noise sampler of
    its Q."""
    A, C, Q, R = (torch.from_numpy(np.asarray(sys[k], np.float32)) for k in "ACQR")
    LQ = torch.linalg.cholesky(Q + 1e-10 * torch.eye(2))
    LR = torch.linalg.cholesky(R)
    h = lambda x: C @ x + bend * torch.sin(x)  # noqa: E731
    tracker = ttr.GaussianTracker(tekf.ExtendedKalmanFilter(lambda x, u: A @ x, h, Q, R,
                                                            device=CPU))
    args = (tracker, lambda x, u, v: A @ x + v, h,
            lambda x: C + bend * torch.diag(torch.cos(x)),
            lambda xn, xo: tlin.mvn_logpdf_chol(xn, A @ xo, LQ),
            lambda z, x: tlin.mvn_logpdf_chol(z, h(x), LR), R)
    kw = dict(device=CPU, group=group, distributed_resample=mode)
    if kind == "edh":
        f = tedh.EDHFlowPF(*args, tedh.EDHConfig(**cfg_kw), **kw)
    else:
        f = tledh.LEDHFlowPF(*args, tledh.LEDHConfig(**cfg_kw), **kw)
    return f, (lambda gen, n, nx: torch.randn((n, nx), generator=gen) @ LQ.T)


def flow_state(p0, n_lambda):
    """The FlowPFState of the global cloud ``p0`` with uniform weights."""
    p = torch.from_numpy(p0)
    logw = tw.uniform_logw(p.shape[0])
    mean, cov = tw.weighted_mean_cov(p, logw)
    return tedh.FlowPFState(particles=p, weights=torch.exp(logw), log_weights=logw,
                            mean=mean, cov=cov,
                            diagnostics={"condition_numbers": torch.zeros(n_lambda),
                                         "resampled": torch.zeros((), dtype=torch.bool)})


def flow_runs(cases, sys, zs, seed):
    """Each case ``(kind, cfg_kw, p0, noise, bend, mode)``: the sharded run from
    the global cloud ``p0`` (cut to this rank), its history and final
    particles, and the condition numbers of a one-device run of the rank's
    cloud alone (``local_conds``: its first particle's, without noise or
    resampling the same flow as on the rank)."""
    g = _world()
    out = []
    for kind, cfg_kw, p0, noise, bend, mode in cases:
        f, sampler = flow_filter(kind, cfg_kw, sys, group=g, bend=bend, mode=mode)
        st = shard_flow_state(flow_state(p0, cfg_kw["n_lambda_steps"]), g)
        ts = f.tracker.init(torch.zeros(2), torch.eye(2))
        run = make_sharded_flow_run(f, process_noise_sampler=sampler if noise else None)
        final, _, hist = run(torch.Generator().manual_seed(seed), st, ts, torch.from_numpy(zs))
        f1, _ = flow_filter(kind, cfg_kw, sys, bend=bend)
        _, _, h1 = f1.run(torch.Generator().manual_seed(seed),
                          flow_state(np.ascontiguousarray(p0[_rows(p0.shape[0])]),
                                     cfg_kw["n_lambda_steps"]),
                          ts, torch.from_numpy(zs))
        out.append({"hist": hist, "x": final.particles,
                    "local_conds": h1["condition_numbers"]})
    return out


# --- differentiable-PF training ------------------------------------------------
def dpf_train(n_batch, n_particles, xs, ys, seed):
    """One sharded train step on an (n_batch, S / n_batch) mesh: the loss,
    the new parameters and their gradients; ``sharded_soft_resample`` on a
    cloud of 64 (each rank's block); the divisibility check."""
    mesh = make_mesh(n_batch, device_type=CPU)
    tr, ll, init, loss_fn = dpf_parts()
    lr = 0.05
    step = make_sharded_dpf_train_step(mesh, n_particles=n_particles, dim=1, transition_fn=tr,
                                       obs_loglik_fn=ll, init_fn=init, loss_fn=loss_fn,
                                       learning_rate=lr)
    params = {"alpha": torch.tensor(ALPHA0), "log_sigma": torch.tensor(math.log(SIGMA0))}
    loss, new = step(params, torch.Generator().manual_seed(seed), torch.from_numpy(ys),
                     torch.from_numpy(xs))
    grads = {k: (params[k] - new[k]) / lr for k in params}
    g = mesh.get_group("particles")
    cloud = torch.from_numpy(np.random.default_rng(seed).standard_normal((64, 2))
                             .astype(np.float32))
    rows = _rows(64, g)
    soft, _ = sharded_soft_resample(torch.Generator().manual_seed(seed + 7), cloud[rows],
                                    torch.full((64 // comm.size(g),), -math.log(64.0)),
                                    n_particles=64, temperature=0.1, group=g)
    bad = _raises(lambda: make_sharded_dpf_train_step(
        mesh, n_particles=comm.size(g) * 8 + 1, dim=1, transition_fn=tr, obs_loglik_fn=ll,
        init_fn=init, loss_fn=loss_fn))
    return {"loss": loss, "new": new, "grads": grads, "soft": soft, "bad": bad}


# --- the whole slice: the dry run's four phases ----------------------------------
def dryrun(n_batch, seed, layout=(2, 2)):
    """``entry.dryrun_rank``: ``dryrun_multichip``'s four phases at the sizes
    of a ``layout`` (batch, particles) mesh, run on this world's
    (n_batch, S/n_batch) mesh."""
    return dryrun_rank(n_batch, seed, layout, CPU)


def filters_suite(pf_args, fused_args, flow_args):
    """The filters' programs in one start of the ranks."""
    return {"pf": general_pf(*pf_args), "fused": fused_runs(*fused_args),
            "flows": flow_runs(*flow_args)}


def dpf_suite(n_batch, n_particles, xs, ys, seed, dry_batch, dry_seed):
    """The DPF programs and the dry run in one start of the ranks."""
    return {"dpf": dpf_train(n_batch, n_particles, xs, ys, seed),
            "dry": dryrun(dry_batch, dry_seed)}
