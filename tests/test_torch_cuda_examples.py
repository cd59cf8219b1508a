"""The examples' sampled accuracy on an NVIDIA GPU, over enough seeds for
Welch's test.

- ex14's PF in both forms, ``WELCH_SEEDS`` = 40 seeds of the first
  ``T_CUT`` = 500 steps (N = 1000, systematic resampling through kernel B2)
  against the JAX package's 32 committed keys over the same steps
  (``benchmarks/data/sv_vs_t2000.npz``): Welch's p ≥ 1e-3 in each form.
  ``chip_smoke.py`` runs 3 seeds a form, held by the spread of the JAX
  package's keys; this test resolves a shift of ~0.003 in the mean RMSE.

Run on a GPU host with

    python -m pytest tests/test_torch_cuda_examples.py -q -s --noconftest

or, for the same comparison on the CPU, followed by the JAX package over
128 keys it has not committed (about two minutes; needs JAX),

    python tests/test_torch_cuda_examples.py cpu
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


def ex14_pf_welch(device):
    """ex14's PF over ``WELCH_SEEDS`` seeds of ``T_CUT`` steps on ``device``
    against the JAX package's committed keys: ``pf_welch``'s rows, each
    printed beside the device."""
    from particle_filters_tpu_torch.benchmarks._stats import summary
    from particle_filters_tpu_torch.examples import ex14_sv_variance_stabilized as ex
    from particle_filters_tpu_torch.utils.timing import card_line

    data = ex.load_data(device)
    res = ex.run_all(device, data, seeds=ex.WELCH_SEEDS, t=ex.T_CUT)
    welch = ex.pf_welch(res, data)
    for form, (mean, sd, n, z, p) in welch.items():
        jm, jsd, jn = summary([float(v) for v in data[f"jax_pf_{form}_rmse_cut"]])
        print(f"ex14 PF {form}, first {ex.T_CUT} steps: port {mean:.6f} ± {sd:.6f} over {n} "
              f"seeds, JAX package {jm:.6f} ± {jsd:.6f} over {jn} keys; Welch z {z:.3f}, "
              f"p {p:.4f}  [{card_line(device)}]")
    return res, welch


def test_ex14_pf_agrees_with_the_jax_keys_over_40_seeds(cuda_device):
    from particle_filters_tpu_torch.benchmarks._stats import P_MIN
    from particle_filters_tpu_torch.ops import resample as b2

    b2.resample_by_starts.launches = 0
    _, welch = ex14_pf_welch(cuda_device)
    assert b2.resample_by_starts.launches > 0
    assert all(p >= P_MIN for *_, p in welch.values()), welch


if __name__ == "__main__":
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    device = torch.device(sys.argv[1] if len(sys.argv) > 1 else "cuda")
    res, _ = ex14_pf_welch(device)
    if device.type == "cpu":
        # The JAX package over 128 keys it has not committed (200 ...), to
        # tell a shift of the port from the noise of the committed 32.
        os.environ["JAX_PLATFORMS"] = "cpu"
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import test_torch_ex14 as t14

        from particle_filters_tpu_torch.benchmarks._stats import summary, welch_z
        from particle_filters_tpu_torch.examples import ex14_sv_variance_stabilized as ex

        X, Y = t14.jax_data()
        for form, rows in t14.jax_pf_rmses(X, Y, keys=range(200, 328), t=ex.T_CUT).items():
            z, p = welch_z([r["rmse"] for r in res["pf"][form]], *summary(rows))
            print(f"ex14 PF {form}, first {ex.T_CUT} steps: JAX package %.6f ± %.6f over %d "
                  "fresh keys; the port's Welch z %.3f, p %.4f" % (*summary(rows), z, p))
