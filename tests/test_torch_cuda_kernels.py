"""Kernels B1 and B2 against their plain versions on an NVIDIA GPU.

The checks of ``chip_smoke.py`` (B2 bit-equal to its plain version at the
weight regimes of the TPU kernel's tiers; B1 with injected normals at
rtol 1e-5 / atol 1e-6, its combined moments at rtol 1e-4, and its Philox
normals' mean and variance within 5 standard errors) at a small N, plus the
launch counters; N = 3000 leaves a ragged last block. Run on a GPU host with

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
    assert resample_by_starts.launches == before + 8  # 4 regimes x d in {1, 3}


@pytest.mark.parametrize("n", SIZES)
def test_b1_kernel_matches_plain(cuda_device, n):
    import chip_smoke

    from particle_filters_tpu_torch.ops.fused_pf import fused_step

    before = fused_step.launches
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    err = chip_smoke.check_b1(gen, n, cuda_device)
    torch.cuda.synchronize()
    assert err < 1e-3
    assert fused_step.launches == before + 6  # 2 models x (2 injected + 1 drawn)
