"""Port parity: the sharded filters on 4 spawned gloo ranks (and a world
of one in this process), against the one-device port and the JAX
package's sharded runs on the same inputs.

- The general ``ParticleFilter`` with a group, in both resample modes, on
  the conftest's SV data (``tests/unit/test_sharding.py`` and
  ``test_distributed_resample.py:153-205``): it tracks (RMSE < 1.5), its
  RMSE within the JAX tests' bound of the one-device run's
  (0.25·max + 0.05), its summed log evidence within 3 of it, ESS global
  (above a rank's N, at most N); every rank holds the same history and the
  same replicated generator state; neighbour mode keeps ``exchange_ok``;
  the checks (non-systematic neighbour mode, track_degeneracy, a count
  that does not divide) raise.
- The fused filter: one rank in all-gather mode bit-equal to
  ``FusedSIRFilter``; four ranks bit-equal to the one-device plain run
  (the normals keyed on the global index, the fold combining the one-device
  blocks' partials), and two runs bit-equal; the fold against the JAX
  package's ``_combine_partials`` with ``axis_name`` on the same partials
  (rtol 1e-5); neighbour mode finite with ``exchange_ok``; one step;
  ``Np`` must divide; ``benchmarks/sharded.py``'s run across 2 and 4
  ranks holds all its checks; a one-ulp nudge of the carried log Z makes
  another draw of the cloud, within ``SE_K`` standard errors.
- EDH and LEDH without process noise (``tests/unit/test_flow_sharded.py``):
  four ranks equal to the one-device port to f32 rounding (rtol 1e-5,
  atol 1e-6; resampling on, the same u) and, resampling off, to the JAX
  package's sharded run within ``test_torch_flows.py``'s flow tolerance
  (2e-4) from the same cloud; LEDH's condition number the max over the
  ranks' first particles; EDH in neighbour mode with ``exchange_ok`` on
  every step and all-gather mode's moments (rtol 1e-5); with process noise
  EDH tracks the LGSSM.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import _torch_rank_programs as progs
from particle_filters_tpu.core.linalg import mvn_logpdf_chol as jmvn
from particle_filters_tpu.models import EDHConfig as JEDHConfig
from particle_filters_tpu.models import EDHFlowPF as JEDH
from particle_filters_tpu.models import ExtendedKalmanFilter as JEKF
from particle_filters_tpu.models import GaussianTracker as JTracker
from particle_filters_tpu.ops import fused_pf as jfused
from particle_filters_tpu.parallel import make_sharded_flow_run as jflow_run
from particle_filters_tpu.parallel import shard_flow_state as jshard_flow
from particle_filters_tpu_torch import interop
from particle_filters_tpu_torch.ops import fused_pf as tfused
from particle_filters_tpu_torch.parallel.launch import process_group, run_ranks, to_numpy

torch.set_num_threads(1)

S, N_PF, N_FUSED, N_FLOW = 4, 1024, 4096, 64
T_PF, T_FUSED, T_FLOW = 200, 40, 8
SEED = 5
FLOW_TOL = dict(rtol=2e-4, atol=2e-4)


def _fused_zs(T, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros(T)
    x[0] = rng.standard_normal() * np.sqrt(0.04 / (1 - 0.95**2))
    for t in range(1, T):
        x[t] = 0.95 * x[t - 1] + 0.2 * rng.standard_normal()
    return (np.exp(0.5 * x) * rng.standard_normal(T)).astype(np.float32)[:, None]


def _flow_cases(p0):
    """(kind, cfg, global cloud, process noise, bend, resample mode)."""
    edh = dict(n_particles=N_FLOW, n_lambda_steps=5, resample_ess_ratio=0.5)
    return [
        ("edh", edh, p0, False, 0.0, "all_gather"),
        ("edh", dict(edh, resample_ess_ratio=0.0), p0, False, 0.0, "all_gather"),
        ("ledh", dict(n_particles=N_FLOW, n_lambda_steps=4, resample_ess_ratio=0.5), p0, False,
         0.3, "all_gather"),
        ("edh", dict(n_particles=N_FLOW, n_lambda_steps=5), p0, True, 0.0, "all_gather"),
        ("edh", edh, p0, False, 0.0, "neighbor"),
    ]


@pytest.fixture(scope="module")
def data(sv_data, lgssm_data, small_system):
    p0 = np.random.default_rng(3).standard_normal((N_FLOW, 2)).astype(np.float32)
    sys = {k: np.asarray(small_system[k], np.float32) for k in "ACQR"}
    return {"sv_zs": np.asarray(sv_data.Y[:T_PF, None], np.float32),
            "sv_x": np.asarray(sv_data.X[:T_PF]),
            "fused_zs": _fused_zs(T_FUSED, 3), "neighbor_zs": _fused_zs(20, 9),
            "flow_zs": np.asarray(lgssm_data.Y[:T_FLOW], np.float32),
            "flow_x": np.asarray(lgssm_data.X[:T_FLOW], np.float32),
            "p0": p0, "sys": sys}


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    return run_ranks(progs.filters_suite, S, args=(
        (data["sv_zs"], N_PF, SEED),
        (data["fused_zs"], N_FUSED, 0, 1, data["neighbor_zs"]),
        (_flow_cases(data["p0"]), data["sys"], data["flow_zs"], SEED)),
        timeout_s=120.0, store_dir=str(tmp_path_factory.mktemp("store")))


# --- the general filter -------------------------------------------------------
def _rmse(mean, x):
    return float(np.sqrt(np.mean((np.asarray(mean)[:, 0] - x) ** 2)))


@pytest.fixture(scope="module")
def single_pf(data):
    pf = progs.sv_pf(N_PF)
    gen = torch.Generator().manual_seed(SEED)
    _, hist = pf.run(gen, pf.initialize(gen, [0.0], [[1.05]]), torch.from_numpy(data["sv_zs"]))
    return to_numpy(hist)


@pytest.mark.parametrize("mode", ["all_gather", "neighbor"])
def test_sharded_pf_tracks_and_matches_single_device(ranks, data, single_pf, mode):
    h = ranks[0]["pf"][mode]["hist"]
    assert ranks[0]["pf"][mode]["n_local"] == N_PF // S
    r_s, r_1 = _rmse(h["mean"], data["sv_x"]), _rmse(single_pf["mean"], data["sv_x"])
    assert r_s < 1.5
    assert abs(r_s - r_1) < 0.25 * max(r_s, r_1) + 0.05, (r_s, r_1)
    assert abs(h["log_evidence"].sum() - single_pf["log_evidence"].sum()) < 3.0
    assert np.all(np.isfinite(h["ess"])) and np.all(h["ess"] <= N_PF + 1)
    assert np.any(h["ess"] > N_PF // S) and h["resampled"].any()
    assert h["exchange_ok"].all()  # SV weights: radius 2 always suffices


@pytest.mark.parametrize("mode", ["all_gather", "neighbor"])
def test_sharded_pf_is_replicated(ranks, mode):
    first = ranks[0]["pf"][mode]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["pf"][mode]["gen_state"], first["gen_state"])
        for k, v in first["hist"].items():
            np.testing.assert_array_equal(r["pf"][mode]["hist"][k], v, err_msg=k)


def test_sharded_pf_ess_is_global(ranks):
    ess = ranks[0]["pf"]["ess_uniform"]
    assert np.all(ess <= N_PF + 1) and np.any(ess > N_PF // S)


def test_sharded_pf_checks(ranks):
    bad_degeneracy, bad_np = ranks[0]["pf"]["raises"]
    assert "track_degeneracy" in bad_degeneracy and "divide" in bad_np
    with pytest.raises(ValueError, match="systematic"):
        progs.sv_pf(64, distributed_resample="neighbor", resample_method="multinomial")
    with pytest.raises(ValueError, match="all_gather"):
        progs.sv_pf(64, distributed_resample="bogus")


def test_shard_pf_state_cuts_the_global_state(ranks):
    full = progs.sv_pf(N_PF).initialize(torch.Generator().manual_seed(SEED + 2), [0.0],
                                        [[1.05]])
    got = np.concatenate([r["pf"]["cut"] for r in ranks])
    np.testing.assert_array_equal(got, full.particles.numpy())


# --- the fused filter ------------------------------------------------------------
@pytest.fixture(scope="module")
def single_fused(data):
    f = tfused.FusedSIRFilter(tfused.SVModel(0.95, 1.0), [[0.04]], Np=N_FUSED, device="cpu")
    st = f.initialize(torch.Generator().manual_seed(0), [0.0], [[0.41]])
    final, hist = f.run(torch.Generator().manual_seed(1), st,
                        torch.from_numpy(data["fused_zs"]))
    return final[0].numpy(), to_numpy(hist)


def test_fused_one_rank_bit_equal(data, single_fused, tmp_path):
    with process_group("gloo", store_dir=str(tmp_path)):
        got = to_numpy(progs.fused_runs(data["fused_zs"], N_FUSED, 0, 1, data["neighbor_zs"]))
    x1, h1 = single_fused
    np.testing.assert_array_equal(got["run0"]["x"], x1)
    for k, v in h1.items():
        np.testing.assert_array_equal(got["run0"]["hist"][k], v, err_msg=k)


def test_fused_four_ranks_equal_single_device(ranks, single_fused):
    """A rank's 1024 particles are one block of the plain version, so the
    fold combines the one-device blocks: bit-equal."""
    x1, h1 = single_fused
    x = np.concatenate([r["fused"]["run0"]["x"] for r in ranks])
    np.testing.assert_array_equal(x, x1)
    h = ranks[0]["fused"]["run0"]["hist"]
    assert h1["resampled"].any()
    for k, v in h1.items():
        np.testing.assert_array_equal(h[k], v, err_msg=k)
    for r in ranks:  # deterministic, and the same on every rank
        for k, v in h.items():
            np.testing.assert_array_equal(r["fused"]["run1"]["hist"][k], v)
    np.testing.assert_array_equal(np.concatenate([r["fused"]["run1"]["x"] for r in ranks]), x)


def test_fused_rank_fold_matches_jax_combine():
    """The fold (``fold_ranks``: ``_combine_partials`` over every rank's
    partials, which the four-rank run above holds bit-equal to one device)
    against the JAX package's ``_combine_partials`` with ``axis_name`` on the
    same partials over a 4-device mesh, to f32 rounding (its pmax/psum sums
    in another order)."""
    rng = np.random.default_rng(4)
    mesh = Mesh(np.asarray(jax.devices()[:S]), ("particles",))
    for nx in (1, 2):
        x = rng.standard_normal((nx, 4096)).astype(np.float32)
        lw = (3.0 * rng.standard_normal(4096)).astype(np.float32)
        lw[:1024] -= 40.0  # one rank's weights far below the others'
        part = tfused._block_partials(torch.from_numpy(x), torch.from_numpy(lw))
        got = tfused._packed(part, nx).numpy()

        @partial(shard_map, mesh=mesh, in_specs=P("particles", None), out_specs=P(),
                 check_vma=False)
        def jcombine(p):
            lz, e, m, xx = jfused._combine_partials(p, nx, "particles")
            return jnp.concatenate([jnp.stack([lz, e]), m, xx])

        pad = np.zeros((part.shape[0], 128), np.float32)
        pad[:, :part.shape[1]] = part.numpy()
        np.testing.assert_allclose(got, np.asarray(jcombine(jnp.asarray(pad))), rtol=1e-5,
                                   atol=1e-7)


def test_fused_neighbor_step_and_checks(ranks):
    h = ranks[0]["fused"]["neighbor"]
    assert np.all(np.isfinite(h["mean"])) and h["resampled"].all() and h["exchange_ok"].all()
    info = ranks[0]["fused"]["step"]
    assert set(info) == {"mean", "cov", "ess", "resampled", "log_evidence", "exchange_ok"}
    assert np.isfinite(info["mean"]).all()
    assert "divide" in ranks[0]["fused"]["bad_np"]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_benchmark_across_ranks(world):
    """``benchmarks/sharded.py --ranks S`` on gloo ranks at a small size:
    every check holds (the ranks' histories the same bits, all-gather mode
    bit-equal to one device here, neighbour mode within ``SE_K`` standard
    errors, the
    exact pooled run ends and values bit-equal to the one-device ones, the
    rescue taken where the point mass lies past the pool)."""
    from particle_filters_tpu_torch.benchmarks import sharded

    checks = sharded.run_across(world, backend="gloo", device_type="cpu", n=4096, t=40,
                                n_big=8192, t_big=10, timeout_s=120.0)
    assert len(checks) == 22
    assert [c for c in checks if not c[1]] == []
    ok = [c for c in checks if "point mass" in c[0] and "agree" in c[0]]
    assert ok[0][0].endswith(f"(= {world - 1 <= sharded.RADIUS})")


@pytest.mark.parametrize("n", [1 << 14, 1 << 16])
def test_one_ulp_of_log_z_is_another_draw(n):
    """Why ``benchmarks/sharded.py`` holds S cards against one by standard
    errors (``SE_K``): a one-device fused SV run whose carried log Z is
    nudged by one ulp a step (as a fold of partials in another order
    rounds it) ends, after 200 steps, with hardly a particle equal to the
    plain run's, since the f32 run ends turn the ulp into another draw; its
    mean and log Z stay within ``SE_K`` standard errors at every step."""
    import math

    from particle_filters_tpu_torch.benchmarks import sharded
    from particle_filters_tpu_torch.simulators import simulate_sv_1d

    class Nudged(tfused.FusedSIRFilter):
        def _step_core(self, *args, **kw):
            out = super()._step_core(*args, **kw)
            self._work.carry[0] = torch.nextafter(self._work.carry[0],
                                                  torch.tensor(math.inf))
            return out

    zs = simulate_sv_1d(200, 0.95, 0.2, 1.0, seed=42, device="cpu").Y[:, None]
    runs = []
    for cls in (tfused.FusedSIRFilter, Nudged):
        f = cls(tfused.SVModel(0.95, 1.0), [[0.04]], Np=n, device="cpu")
        gen = torch.Generator().manual_seed(0)
        runs.append(f.run(gen, f.initialize(gen, [0.0], [[0.04 / (1 - 0.95**2)]]), zs))
    (fin_a, h_a), (fin_b, h_b) = runs
    share = (fin_a[0] == fin_b[0]).float().mean().item()
    d = sharded.draw_diffs(to_numpy(h_b), to_numpy(h_a))
    print(f"N={n}: share of final particles equal {share}, {d}")
    assert share < 0.05
    assert max(d["mean_se"], d["log_z_se"]) <= sharded.SE_K


# --- the flows -------------------------------------------------------------------
def _single_flow(data, case):
    kind, cfg, p0, noise, bend, _ = case
    f, sampler = progs.flow_filter(kind, cfg, data["sys"], bend=bend)
    ts = f.tracker.init(torch.zeros(2), torch.eye(2))
    final, _, hist = f.run(torch.Generator().manual_seed(SEED),
                           progs.flow_state(p0, cfg["n_lambda_steps"]), ts,
                           torch.from_numpy(data["flow_zs"]),
                           process_noise_sampler=sampler if noise else None)
    return final.particles.numpy(), to_numpy(hist)


@pytest.mark.parametrize("i", [0, 2], ids=["edh", "ledh"])
def test_sharded_flows_equal_single_device(ranks, data, i):
    case = _flow_cases(data["p0"])[i]
    x1, h1 = _single_flow(data, case)
    h = ranks[0]["flows"][i]["hist"]
    np.testing.assert_array_equal(h["resampled"], h1["resampled"])
    assert h1["resampled"].any()
    for k in ("mean", "cov", "ess"):
        np.testing.assert_allclose(h[k], h1[k], rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(np.concatenate([r["flows"][i]["x"] for r in ranks]), x1,
                               rtol=1e-5, atol=1e-6)


def test_sharded_edh_matches_jax_sharded(ranks, data):
    kind, cfg, p0, _, _, _ = _flow_cases(data["p0"])[1]
    s = {k: jnp.asarray(v) for k, v in data["sys"].items()}
    LQ = jnp.linalg.cholesky(s["Q"] + 1e-10 * jnp.eye(2))
    LR = jnp.linalg.cholesky(s["R"])
    tracker = JTracker(JEKF(lambda x, u: s["A"] @ x, lambda x: s["C"] @ x, s["Q"], s["R"]))
    f = JEDH(tracker, lambda x, u, v: s["A"] @ x + v, lambda x: s["C"] @ x, lambda x: s["C"],
             lambda xn, xo: jmvn(xn, s["A"] @ xo, LQ), lambda z, x: jmvn(z, s["C"] @ x, LR),
             s["R"], JEDHConfig(**cfg), axis_name="particles")
    from particle_filters_tpu.models.edh_particle_filter import FlowPFState
    from particle_filters_tpu.core import weights as jw

    logw = jw.uniform_logw(N_FLOW)
    mean, cov = jw.weighted_mean_cov(jnp.asarray(p0), logw)
    st = FlowPFState(particles=jnp.asarray(p0), weights=jnp.exp(logw), log_weights=logw,
                     mean=mean, cov=cov,
                     diagnostics={"condition_numbers": jnp.zeros(cfg["n_lambda_steps"]),
                                  "resampled": jnp.asarray(False)})
    mesh = Mesh(np.asarray(jax.devices()[:S]), ("particles",))
    _, _, jh = jflow_run(f, mesh)(jax.random.PRNGKey(0), jshard_flow(st, mesh),
                                  tracker.init(jnp.zeros(2), jnp.eye(2)),
                                  jnp.asarray(data["flow_zs"]))
    h = ranks[0]["flows"][1]["hist"]
    for k in ("mean", "cov", "ess"):
        np.testing.assert_allclose(h[k], np.asarray(jh[k]), **FLOW_TOL, err_msg=k)
    np.testing.assert_allclose(h["condition_numbers"], np.asarray(jh["condition_numbers"]),
                               rtol=1e-3)
    # The port's sharded state from the JAX package's, as the ranks took it.
    cut = interop.sharded_state_from_jax(st, 1, S, device="cpu")
    np.testing.assert_array_equal(cut.particles.numpy(), p0[N_FLOW // S:2 * N_FLOW // S])


def test_ledh_condition_number_is_max_over_ranks(ranks):
    conds = ranks[0]["flows"][2]["hist"]["condition_numbers"]
    local = np.max([r["flows"][2]["local_conds"] for r in ranks], axis=0)
    assert conds.shape == local.shape == (T_FLOW, 4)
    # Each step's flow starts from the resampled cloud, which a rank's
    # cloud alone does not reproduce: the first step's are the ones to hold.
    np.testing.assert_allclose(conds[0], local[0], rtol=1e-5)
    assert np.all(np.isfinite(conds)) and np.all(conds >= 1.0)
    for r in ranks:
        np.testing.assert_array_equal(r["flows"][2]["hist"]["condition_numbers"], conds)


def test_sharded_edh_neighbor_mode(ranks):
    """Neighbour mode, radius 2 of 4 ranks: every pool suffices, the same
    resample steps as all-gather mode (case 0) and its moments to f32
    rounding (rtol 1e-5, atol 1e-6: the pool's cdf is normalized by the
    ranks' totals; on these clouds no run end moves)."""
    h, h0 = ranks[0]["flows"][4]["hist"], ranks[0]["flows"][0]["hist"]
    assert h["exchange_ok"].all() and h0["exchange_ok"].all()
    np.testing.assert_array_equal(h["resampled"], h0["resampled"])
    for k in ("mean", "cov", "ess"):
        np.testing.assert_allclose(h[k], h0[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_sharded_edh_with_noise_tracks(ranks, data):
    h = ranks[0]["flows"][3]["hist"]
    rmse = float(np.sqrt(np.mean((h["mean"] - data["flow_x"]) ** 2)))
    assert np.all(np.isfinite(h["mean"])) and rmse < 1.5
    blocks = np.concatenate([r["flows"][3]["x"] for r in ranks]).reshape(S, -1, 2)
    assert not np.allclose(blocks[0], blocks[1])  # the ranks drew their own noise
