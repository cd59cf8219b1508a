"""Kernels B1, B2 and S, the Sinkhorn tile kernels and probes X1-X3
against their plain versions on an NVIDIA GPU.

The checks of ``chip_smoke.py`` (B2 bit-equal to its plain version at the
weight regimes of the TPU kernel's tiers and at point masses; B1 with
injected normals at rtol 1e-5 / atol 1e-6, its row at rtol 1e-4, its
counter back to 0 and its trigger and carry matching the row after a launch
and after CUDA-graph replays, and its Philox normals' mean and variance
within 5 standard errors; X3 bit-equal; X1's variants and X2 within 1e-5,
X2 also against B2, both on sorted windows and on shuffled ones, X1 also at
W = 128 and 6144 and on a NaN start; X2 launched past its span budget
writes NaN in exactly the over-budget super-groups) at a small N, plus the
launch counters; N = 3000 leaves
a ragged last block, and the probes, which take whole super-groups, run at
3·2^14 beside a power of two. The fused filter run twice from one seed
gives the same history bit for bit. B2 at the flows' d = 64 with
trial-offset starts (a point-mass trial among them) is bit-equal to plain,
and the exact run ends at N = 2^25 on the card equal the CPU's. Kernel S
(the systematic starts) against the plain chain at the SV cells' 2^24 and
2^20, a ragged 3000 and the flows' 100 x 200 and 100 x 10^4, on five
weight regimes, differing at no more than 1e-5 of the run ends
(``chip_smoke.check_starts``); its log-domain input against the chain fed
exp(logw − log_z) under the same share, its linear mode bit-equal to the
kernel before that input, and degenerate clouds as the normalized path
gives them. The Sinkhorn tile kernels against their
plain version from N = 1 to 20000 at d = 1 and 3, and ``DPF_OT.run_filter``
at N = 8192 resampling through them and its gradient through the VJP
kernels (``chip_smoke.check_sinkhorn_tile``, ``chip_smoke.run_dpf_ot_path``).
Run on a GPU host with

    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

SIZES = [1 << 14, 3000]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n", SIZES)
def test_b2_kernel_equals_plain(cuda_device, n):
    import chip_smoke

    from particle_filters_tpu_torch.ops.resample import resample_by_starts

    before = resample_by_starts.launches
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    assert chip_smoke.check_b2(gen, n, cuda_device) == 0.0
    torch.cuda.synchronize()
    assert resample_by_starts.launches == before + 14  # 7 regimes x d in {1, 3}


@pytest.mark.parametrize("rows,n", [(1, 1 << 24), (1, 1 << 20), (1, 3000), (100, 200),
                                    (100, 10_000)])
def test_starts_kernel_matches_plain(cuda_device, rows, n):
    """Kernel S: run ends within one of the plain chain's at no more than
    1e-5 of the positions (none below 10^5), a wrong u shown to move more,
    the starts their shift (sorted, first b·N, bounded), two calls
    bit-equal, one launch a pass counted (``chip_smoke.check_starts`` raises
    on any miss)."""
    import chip_smoke

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    assert chip_smoke.check_starts(gen, rows, n, cuda_device) <= 1


@pytest.mark.parametrize("rows,n", [(1, 1 << 24), (1, 1 << 20), (1, 3000), (100, 200),
                                    (100, 10_000)])
def test_starts_log_domain_matches_chain(cuda_device, rows, n):
    """Kernel S's log-domain input (log-weights and their log-normalizers):
    starts within one of the plain chain fed exp(logw − log_z) at no more
    than 1e-5 of the positions, two calls bit-equal, launches and log rows
    counted (``chip_smoke.check_starts_log`` raises on any miss)."""
    import chip_smoke

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    assert chip_smoke.check_starts_log(gen, rows, n, cuda_device) <= 1


@pytest.mark.parametrize("rows,n", [(1, 1 << 24), (1, 1 << 20), (1, 3000), (100, 200),
                                    (100, 10_000)])
def test_starts_linear_mode_as_before(cuda_device, rows, n):
    """Kernel S without log_z writes the bits it wrote before its
    log-domain input (``chip_smoke.check_starts_linear_pinned``)."""
    import chip_smoke

    chip_smoke.check_starts_linear_pinned(rows, n, cuda_device)


@pytest.mark.parametrize("label", ["all -inf", "all -inf, guarded log Z", "one finite weight",
                                   "+inf log Z"])
def test_starts_degenerate_as_before(cuda_device, label):
    """Degenerate clouds through the log-domain input give the normalized
    path's starts bit for bit (``chip_smoke.check_starts_degenerate``)."""
    import chip_smoke

    chip_smoke.check_starts_degenerate(label, cuda_device)


@pytest.mark.parametrize("n", SIZES)
def test_b1_kernel_matches_plain(cuda_device, n):
    import chip_smoke

    from particle_filters_tpu_torch.ops.fused_pf import fused_step

    before = fused_step.launches
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    err = chip_smoke.check_b1(gen, n, cuda_device)
    torch.cuda.synchronize()
    assert err < 1e-3
    # 2 models x (2 injected x (1 launch + graph warm-up + capture) + 1 drawn)
    assert fused_step.launches == before + 14


@pytest.mark.parametrize("n", SIZES)
def test_fused_run_is_deterministic(cuda_device, n):
    """The last program finishes the moments in a fixed order and resets
    the counter: two runs from one seed give the same history bit for bit."""
    import chip_smoke

    from particle_filters_tpu_torch.ops.fused_pf import FusedSIRFilter, SVModel
    from particle_filters_tpu_torch.simulators import simulate_sv_1d

    sv = simulate_sv_1d(60, chip_smoke.ALPHA, chip_smoke.SIGMA, chip_smoke.BETA, seed=3,
                        device=cuda_device)
    f = FusedSIRFilter(SVModel(chip_smoke.ALPHA, chip_smoke.BETA), [[chip_smoke.SIGMA**2]],
                       Np=n, device=cuda_device)
    hists = []
    for _ in range(2):
        gen = torch.Generator(device=cuda_device).manual_seed(11)
        state0 = f.initialize(gen, [0.0], [[0.4]])
        _, hist = f.run(gen, state0, sv.Y[:, None])
        hists.append(hist)
    torch.cuda.synchronize()
    assert int(f._work.counter.item()) == 0
    assert bool(hists[0]["resampled"].any())
    for k in hists[0]:
        assert torch.equal(hists[0][k], hists[1][k]), k


PROBE_SIZES = [1 << 16, 3 << 14]


def test_x3_kernel_equals_plain(cuda_device):
    import chip_smoke

    from particle_filters_tpu_torch.ops.launch_probe import add_one

    before = add_one.launches
    assert chip_smoke.check_x3(cuda_device) == 0.0
    torch.cuda.synchronize()
    assert add_one.launches == before + 1


def test_kernel_seam_on_the_card(cuda_device):
    """The kernels' one call seam (``ops/_nvcc.py::Kernel``): a launch in
    a side stream's scope runs there, and an error code from the C entry
    raises naming the kernel."""
    from particle_filters_tpu_torch.ops import launch_probe as x3

    x = torch.randn(x3.TILE, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = x3.add_one(x)
    side.synchronize()
    assert torch.equal(out, x + 1.0)
    with pytest.raises(RuntimeError, match=r"X3 launch probe launch failed: CUDA error 1\."):
        x3._KERNEL(cuda_device, x.data_ptr(), out.data_ptr(), 0)  # n = 0: invalid value


@pytest.mark.parametrize("n", PROBE_SIZES)
def test_x1_kernel_matches_plain(cuda_device, n):
    import chip_smoke

    from particle_filters_tpu_torch.ops.window_resample import window_compare_sum

    before = window_compare_sum.launches
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    assert chip_smoke.check_x1(gen, n, cuda_device) <= chip_smoke.PROBE_TOL
    torch.cuda.synchronize()
    # (six variants + v0-v2 at W = 128 and 6144) x (sorted, shuffled) + 2 on a NaN start
    assert window_compare_sum.launches == before + 26


@pytest.mark.parametrize("n", PROBE_SIZES)
def test_x2_kernel_matches_plain_and_b2(cuda_device, n):
    import chip_smoke

    from particle_filters_tpu_torch.ops.span_resample import span_compare_sum

    before = span_compare_sum.launches
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    assert chip_smoke.check_x2(gen, n, cuda_device) <= chip_smoke.PROBE_TOL
    torch.cuda.synchronize()
    # four regimes on its path, three times each (plain, B2, shuffled rows), and
    # the two refused regimes launched once each past the refusal
    assert span_compare_sum.launches == before + 14


def test_x1_misaligned_windows_equal_plain(cuda_device):
    """Contiguous windows that start 4 bytes past a 16-byte boundary take the
    kernel's word-by-word copies, with the same result: the kernel and the
    plain version each within PROBE_TOL of the windows' f64 sums."""
    import chip_smoke

    from particle_filters_tpu_torch.benchmarks import exp_kernel_var

    s_win, d_win = exp_kernel_var.make_inputs(4, 64, n=1 << 16, device=cuda_device)
    s_off = torch.empty(s_win.numel() + 1, device=cuda_device)[1:].view(s_win.shape)
    d_off = torch.empty(d_win.numel() + 1, device=cuda_device)[1:].view(d_win.shape)
    s_off.copy_(s_win)
    d_off.copy_(d_win)
    assert s_off.data_ptr() % 16 and s_off.is_contiguous()
    for transpose, sum_only in ((True, False), (False, False), (True, True)):
        _, err_kernel, err_plain = chip_smoke._check_x1("misaligned", s_off, d_off, transpose,
                                                        sum_only)
        assert max(err_kernel, err_plain) <= chip_smoke.PROBE_TOL


def test_x2_nan_for_exactly_the_over_budget_super_groups(cuda_device):
    """A weight desert spreads some super-groups over more than ROWS rows;
    launched anyway, the kernel writes NaN there and the plain values
    elsewhere."""
    import chip_smoke

    from particle_filters_tpu_torch.ops import span_resample as x2
    from particle_filters_tpu_torch.ops.resample_blocked import fine_chunks
    from particle_filters_tpu_torch.resampling.hard import _systematic_starts

    n = 1 << 16
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    desert = torch.where(torch.arange(n, device=cuda_device) < n // 2, 1e-3, 1.0)
    starts = _systematic_starts(gen, desert / desert.sum(), n)
    a0, _ = chip_smoke.exp_resample_dma.rank_a0(starts, n, n // x2.SUB)
    a0s = a0.view(-1, x2.SG)
    assert bool((a0s[:, -1] + x2.Q - a0s[:, 0] > x2.ROWS).any())
    p = torch.randn((n, 1), generator=gen, device=cuda_device)
    chunks = fine_chunks(starts, p, n // x2.SUB, x2.ROWS)
    assert chip_smoke._check_x2_budget("weight desert", chunks, a0) <= chip_smoke.PROBE_TOL


@pytest.mark.parametrize("trials,n", [(5, 300), (3, 4096)])
def test_b2_trial_offset_starts_d64_equal_plain(cuda_device, trials, n):
    import chip_smoke

    from particle_filters_tpu_torch.ops.resample import resample_by_starts

    before = resample_by_starts.launches
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    assert chip_smoke.check_b2_trials(gen, trials, n, 64, cuda_device) == 0.0
    torch.cuda.synchronize()
    assert resample_by_starts.launches == before + 1  # one launch for all trials


def test_exact_run_ends_card_equals_cpu_at_2_25(cuda_device):
    import chip_smoke

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    chip_smoke.check_exact(gen, cuda_device)


OT_TILE_CASES = [(1, 1), (1, 3), (100, 1), (100, 3), (8192, 1), (8192, 3), (8193, 1), (8193, 3),
                 (20000, 1), (20000, 3)]


@pytest.mark.parametrize("n,d", OT_TILE_CASES)
def test_sinkhorn_tile_matches_plain(cuda_device, n, d):
    """The Sinkhorn tile kernels (50 damped iterations, then the projection)
    against their plain version on a spread cloud and on a point mass with a
    particle 8 sigma out: potentials and dual changes within
    ``chip_smoke.OT_TILE_POT_TOL``, new particles within
    ``OT_TILE_PARTICLE_TOL`` of the input cloud's std, and the launches the plan
    states a call (``chip_smoke.check_sinkhorn_tile`` raises on any miss)."""
    import chip_smoke

    gen = torch.Generator(device=cuda_device).manual_seed(7)
    worst = chip_smoke.check_sinkhorn_tile(gen, n, d, cuda_device)
    assert worst["potentials"] <= chip_smoke.OT_TILE_POT_TOL
    assert worst["particles"] <= chip_smoke.OT_TILE_PARTICLE_TOL


def test_dpf_ot_resamples_through_the_tile_kernels(cuda_device):
    """``DPF_OT.run_filter`` at N = 8192: every step's resample launches the
    plan's 2·50 + 1 tile kernels; the gradient of its log-evidence every
    backward resample's 4·50 + 2 VJP launches (T − 1 of them)."""
    import chip_smoke

    from particle_filters_tpu_torch.ops.sinkhorn_tile import launches, vjp_launches

    forward, backward = chip_smoke.run_dpf_ot_path(cuda_device, "")
    assert forward == chip_smoke.DPF_OT_T * launches(50)
    assert backward == (chip_smoke.DPF_OT_T - 1) * vjp_launches(50)
