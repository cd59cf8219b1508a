"""The shard-aware forms of kernels B1 and B2, and the sharded fused filter
in a one-card NCCL group, on an NVIDIA GPU.

- B2's M→n form (``out[i] = values[max{j : starts[j] ≤ offset + i}]``)
  bit-equal to its plain version at a pooled shape (5 shards of n, the
  middle rank's n outputs) and the all-gather slice, d = 1 and 3, at
  n = 2^12 and 3000 (a ragged last block); the launches counted.
- B1 as rank r of 4 (its Philox counters offset to the particles' global
  indices, −log N of the whole cloud) bit-equal, in x′ and lw′, to the
  slices of one launch over the whole cloud.
- The sharded fused SV filter in a world of one over NCCL: all-gather mode
  bit-equal to ``FusedSIRFilter`` from one seed; neighbour mode keeps
  ``exchange_ok``.
- With two to four cards, ``benchmarks/sharded.py``'s run across them
  (one NCCL rank a card) holds all its checks.

Run on a GPU host with

    python -m pytest tests/test_torch_cuda_parallel.py -q --noconftest
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1 << 12, 3000])
@pytest.mark.parametrize("d", [1, 3])
def test_b2_m_to_n_equals_plain(cuda_device, n, d):
    from particle_filters_tpu_torch.ops import resample as b2
    from particle_filters_tpu_torch.resampling.hard import _systematic_starts

    gen = torch.Generator(device=cuda_device).manual_seed(n + d)
    before = b2.resample_by_starts.launches
    for ranks, r in ((5, 2), (4, 3)):
        w = torch.softmax(2.0 * torch.randn(ranks * n, generator=gen, device=cuda_device), 0)
        starts = _systematic_starts(gen, w, ranks * n)
        values = torch.randn((ranks * n, d), generator=gen, device=cuda_device)
        got = b2.resample_by_starts(values, starts, n_out=n, offset=r * n)
        torch.cuda.synchronize()
        assert torch.equal(got, b2.resample_by_starts_reference(values, starts, n, r * n))
    assert b2.resample_by_starts.launches == before + 2


def test_b1_global_offsets_equal_one_launch(cuda_device):
    from particle_filters_tpu_torch.benchmarks import sharded

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    err, fold_err = sharded.b1_offset(gen, cuda_device, n=1 << 14)
    assert err == 0.0 and fold_err <= 1.0


def test_sharded_fused_one_rank_equals_fused(cuda_device):
    from particle_filters_tpu_torch.benchmarks import sharded
    from particle_filters_tpu_torch.parallel.launch import process_group

    with process_group("nccl"):
        _, runs, counts = sharded.fused_runs(cuda_device, n=1 << 14, t=30)
    (f1, h1, _), (fa, ha, _), (_, hn, _) = (runs[k] for k in
                                             ("single", "all_gather", "neighbor"))
    assert torch.equal(f1[0], fa[0])
    for k in ("mean", "cov", "log_evidence", "resampled", "ess"):
        assert torch.equal(h1[k], ha[k]), k
    assert bool(hn["exchange_ok"].all()) and counts["B1"] == 60


def test_sharded_across_cards(cuda_device):
    """``benchmarks/sharded.py --ranks S`` over NCCL, one rank a card (2 to
    4 cards), at a small size: every check holds."""
    from particle_filters_tpu_torch.benchmarks import sharded

    world = min(4, torch.cuda.device_count())
    if world < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    checks = sharded.run_across(world, n=1 << 16, t=30, n_big=1 << 18, t_big=10,
                                timeout_s=300.0)
    assert [c for c in checks if not c[1]] == []
