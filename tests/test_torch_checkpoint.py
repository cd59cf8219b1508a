"""Port parity: checkpoints (``utils/checkpoint.py``) and
``ParticleFilter.run_chunked`` against the JAX package's semantics.

- A state (a ``PFState``, nested dicts, lists, tuples, numbers) saved and
  restored with a template comes back equal bit for bit, in the template's
  dataclasses; without one, as plain containers; a leaf of another shape or
  dtype than the template's raises. The ``step_XXXXXXXX`` layout is the JAX
  package's: its ``latest_step`` reads a directory the port wrote.
- ``run_chunked`` equals ``run`` bit for bit (37 steps in pieces of 10, a
  partial tail), and so does a run interrupted after 2 pieces and resumed
  with another generator object (the checkpoint carries the generator's
  state); resuming a finished run re-runs nothing; the degeneracy panel
  passes through. The JAX package's ``TestRunChunked`` cases, on the port.
"""

import dataclasses

import numpy as np
import pytest
import torch

from particle_filters_tpu.utils import checkpoint as jckpt
from particle_filters_tpu_torch.core.structs import PFState
from particle_filters_tpu_torch.models import ParticleFilter
from particle_filters_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

CPU = "cpu"
ALPHA, SIGMA, BETA = 0.91, 0.3, 0.7


def _pf(Np=256):
    def obs(x, z):
        return -0.5 * (z[0] ** 2 / (BETA**2 * torch.exp(x[0])) + x[0])

    return ParticleFilter(lambda x, u: ALPHA * x, None, [[SIGMA**2]], None, Np=Np,
                          obs_loglik=obs, device=CPU)


def _setup(T=37, seed=0):
    pf = _pf()
    st0 = pf.initialize(torch.Generator().manual_seed(seed), np.zeros(1), np.eye(1))
    zs = 0.3 * np.random.default_rng(seed).standard_normal((T, 1)).astype(np.float32)
    return pf, st0, torch.tensor(zs)


def _hist_equal(ha, hb):
    assert set(ha) == set(hb)
    for k in ha:
        assert torch.equal(ha[k], hb[k]), k


def _state_equal(a, b):
    for f in dataclasses.fields(PFState):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def test_save_restore_roundtrip(tmp_path):
    pf, st0, _ = _setup()
    tree = {"state": st0, "list": [torch.arange(3), (1.5, torch.ones(2, dtype=torch.bool))],
            "n": 7}
    path = tckpt.save_checkpoint(str(tmp_path / "c"), tree, step=3)
    assert path.endswith("step_00000003")
    back = tckpt.restore_checkpoint(str(tmp_path / "c"), template=tree, step=3)
    _state_equal(back["state"], st0)
    assert isinstance(back["state"], PFState) and isinstance(back["list"][1], tuple)
    assert torch.equal(back["list"][0], tree["list"][0]) and back["n"] == 7
    plain = tckpt.restore_checkpoint(str(tmp_path / "c"), step=3)
    assert isinstance(plain["state"], dict) and torch.equal(plain["state"]["particles"],
                                                            st0.particles)
    bad = dataclasses.replace(st0, particles=st0.particles[:10])
    with pytest.raises(ValueError, match="template"):
        tckpt.restore_checkpoint(str(tmp_path / "c"), template={**tree, "state": bad}, step=3)


def test_latest_step_and_layout_match_jax(tmp_path):
    root = str(tmp_path / "ckpt")
    assert tckpt.latest_step(root) is None and jckpt.latest_step(root) is None
    for step in (1, 12, 4):
        tckpt.save_checkpoint(root, {"x": torch.zeros(2)}, step=step)
    (tmp_path / "ckpt" / "step_junk").mkdir()
    assert tckpt.latest_step(root) == jckpt.latest_step(root) == 12
    # Saving again replaces the step's state.
    tckpt.save_checkpoint(root, {"x": torch.ones(2)}, step=12)
    assert torch.equal(tckpt.restore_checkpoint(root, step=12)["x"], torch.ones(2))


def test_run_chunked_matches_run():
    pf, st0, zs = _setup()
    fin_m, hist_m = pf.run(torch.Generator().manual_seed(2), st0, zs)
    fin_c, hist_c = pf.run_chunked(torch.Generator().manual_seed(2), st0, zs, chunk_size=10)
    _state_equal(fin_m, fin_c)
    _hist_equal(hist_m, hist_c)
    assert int(fin_c.t) == 37 and bool(hist_m["resampled"].any())


def test_interrupt_and_resume_bitexact(tmp_path):
    pf, st0, zs = _setup()
    ckpt = str(tmp_path / "ckpt")
    fin_u, hist_u = pf.run(torch.Generator().manual_seed(3), st0, zs)
    fin_p, hist_p = pf.run_chunked(torch.Generator().manual_seed(3), st0, zs, chunk_size=10,
                                   ckpt_dir=ckpt, stop_after_chunks=2)
    assert int(fin_p.t) == 20 and hist_p["mean"].shape[0] == 20
    # A new process would hold a new generator: the checkpoint restores it.
    fin_r, hist_r = pf.run_chunked(torch.Generator().manual_seed(99), st0, zs, chunk_size=10,
                                   ckpt_dir=ckpt, resume=True)
    _state_equal(fin_u, fin_r)
    _hist_equal(hist_u, hist_r)


def test_resume_skips_completed_chunks(tmp_path):
    pf, st0, zs = _setup(T=20)
    ckpt = str(tmp_path / "ckpt")
    fin_a, hist_a = pf.run_chunked(torch.Generator().manual_seed(4), st0, zs, chunk_size=10,
                                   ckpt_dir=ckpt)
    # zs of zeros would change the results if anything ran again.
    fin_b, hist_b = pf.run_chunked(torch.Generator().manual_seed(4), st0, torch.zeros_like(zs),
                                   chunk_size=10, ckpt_dir=ckpt, resume=True)
    _state_equal(fin_a, fin_b)
    _hist_equal(hist_a, hist_b)


def test_track_degeneracy_passthrough(tmp_path):
    pf, st0, zs = _setup(T=15)
    _, hist_m = pf.run(torch.Generator().manual_seed(5), st0, zs, track_degeneracy=True)
    _, hist_c = pf.run_chunked(torch.Generator().manual_seed(5), st0, zs, chunk_size=4,
                               ckpt_dir=str(tmp_path / "c"), track_degeneracy=True)
    assert {"entropy", "gini", "max_weight", "unique_frac"} <= set(hist_c)
    _hist_equal(hist_m, hist_c)


@pytest.mark.parametrize("kw,match", [
    (dict(chunk_size=0), "chunk_size"),
    (dict(chunk_size=5, stop_after_chunks=0), "stop_after_chunks"),
    (dict(chunk_size=5, resume=True), "ckpt_dir"),
])
def test_invalid_arguments_raise(kw, match):
    pf, st0, zs = _setup(T=5)
    with pytest.raises(ValueError, match=match):
        pf.run_chunked(torch.Generator(), st0, zs, **kw)
    with pytest.raises(ValueError, match="at least one"):
        pf.run_chunked(torch.Generator(), st0, zs[:0], chunk_size=5)
