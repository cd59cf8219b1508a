"""The fused SIR filter's run with the resample decided on the card
(``ops/fused_pf.py`` ``_CardRun``) and the gate of kernels S and B2.

On the CPU: the run's body, executed eagerly through the plain versions,
against the host's loop (``FusedSIRFilter.run`` on a CPU cloud) from the
same generator, bit for bit (both draw a run's seeds and uniforms alike); the plain S and B2 with a trigger (0 leaves
their outputs untouched, 1 gives the ungated result); the gate's pointer
through the kernels' wrappers on a stubbed library.

On the card (``cuda`` marker; no JAX, so they run on a GPU host with
``--noconftest``): the replay against the eager run of the same body, the
body against the host's loop bit for bit, two sequences on one captured
graph, the outputs' copies, the counters::

    python -m pytest tests/test_torch_fused_graph.py -q -m cuda --noconftest -p no:cacheprovider
"""

import contextlib

import numpy as np
import pytest
import torch

from particle_filters_tpu_torch.ops import _nvcc
from particle_filters_tpu_torch.ops import resample as b2
from particle_filters_tpu_torch.ops import systematic_starts as ss
from particle_filters_tpu_torch.ops.fused_pf import (
    FusedSIRFilter,
    LinearObsFirstModel,
    SVModel,
    _CardRun,
    fused_step,
)
from particle_filters_tpu_torch.resampling import hard

torch.set_num_threads(1)

ALPHA, SIGMA, BETA = 0.95, 0.2, 1.0
A2 = np.array([[0.9, 0.1], [0.0, 0.8]], np.float32)
Q2 = np.diag([0.05, 0.02]).astype(np.float32)


def _sv_data(T, seed):
    """An SV observation sequence (T, 1) from the model's own law."""
    g = torch.Generator().manual_seed(seed)
    x, ys = 0.0, []
    for _ in range(T):
        x = ALPHA * x + SIGMA * float(torch.randn((), generator=g))
        ys.append(BETA * np.exp(x / 2) * float(torch.randn((), generator=g)))
    return np.asarray(ys, np.float32)[:, None]


def _filter(nx, n, device, thresh=0.5):
    if nx == 1:
        return FusedSIRFilter(SVModel(ALPHA, BETA), [[SIGMA**2]], Np=n, resample_thresh=thresh,
                              device=device)
    return FusedSIRFilter(LinearObsFirstModel(A2, 0.1), Q2, Np=n, resample_thresh=thresh,
                          device=device)


# --- the run's body on the CPU --------------------------------------------------
@pytest.mark.parametrize("nx,thresh", [(1, 0.5), (1, 0.9), (2, 0.5)])
def test_card_body_equals_host_loop_bit_for_bit(nx, thresh):
    """SV at N = 2^12, T = 50 (and the nx = 2 linear model, whose B2 runs a
    launch a coordinate): the body that decides on the card, run eagerly
    through the plain versions, gives the host's loop's histories and final
    state bit for bit from the same generator, and the sequence has steps
    of both kinds."""
    n, T = 1 << 12, 50
    f = _filter(nx, n, "cpu", thresh)
    zs = _sv_data(T, 3) if nx == 1 else _sv_data(T, 4) / 4
    state0 = f.initialize(torch.Generator().manual_seed(1), np.zeros(nx), 0.3 * np.eye(nx))
    (p_h, lw_h, off_h), hist_h = f.run(torch.Generator().manual_seed(7), state0, zs)
    resampled = hist_h["resampled"]
    assert 0 < int(resampled.sum()) < T

    card = _CardRun(f, T, 1)
    card.load(torch.Generator().manual_seed(7), state0, torch.from_numpy(zs))
    card.steps()
    (p_c, lw_c, off_c), rows, trig = card.outputs()
    assert torch.equal(trig, resampled)
    assert torch.equal(rows[:, 0], hist_h["log_evidence"])
    assert torch.equal(rows[:, 1], hist_h["ess"])
    assert torch.equal(rows[:, 2:2 + nx], hist_h["mean"])
    assert torch.equal(p_c.view(p_h.shape), p_h)
    assert torch.equal(lw_c, lw_h)
    assert torch.equal(off_c, off_h)


@pytest.mark.parametrize("thresh", [0.0, 2.0])
def test_step_is_a_run_of_one(thresh):
    """``step`` draws as a run of length 1 does (a seed, then a uniform):
    from the same generator it gives that run's state and row, whether the
    step resamples (threshold 2) or not (0)."""
    n = 1 << 12
    f = _filter(1, n, "cpu", thresh)
    state0 = f.initialize(torch.Generator().manual_seed(3), [0.0], [[0.3]])
    z = torch.tensor([0.4])
    (p_s, lw_s, off_s), info = f.step(torch.Generator().manual_seed(8), state0, z)
    (p_r, lw_r, off_r), hist = f.run(torch.Generator().manual_seed(8), state0, z[None])
    assert bool(info["resampled"]) == (thresh > 1) == bool(hist["resampled"][0])
    for a, b in ((p_s, p_r), (lw_s, lw_r), (off_s, off_r),
                 (info["log_evidence"], hist["log_evidence"][0]), (info["ess"], hist["ess"][0])):
        assert torch.equal(a, b)


def test_card_body_reads_its_state_and_repeats():
    """The body leaves the caller's state alone, and a second load of the
    same inputs gives the same outputs (its buffers carry nothing over)."""
    n, T = 1 << 12, 30
    f = _filter(1, n, "cpu")
    zs = torch.from_numpy(_sv_data(T, 5))
    state0 = f.initialize(torch.Generator().manual_seed(2), [0.0], [[0.3]])
    copy0 = tuple(t.clone() for t in state0)
    card = _CardRun(f, T, 1)
    outs = []
    for _ in range(2):
        card.load(torch.Generator().manual_seed(9), state0, zs)
        card.steps()
        outs.append(card.outputs())
    for a, b in zip(state0, copy0):
        assert torch.equal(a, b)
    (sa, ra, ta), (sb, rb, tb) = outs
    assert bool(ta.any())
    for a, b in zip((*sa, ra, ta), (*sb, rb, tb)):
        assert torch.equal(a, b)


# --- the plain S and B2 with a trigger -------------------------------------------
def _weights(n, seed=0):
    z = torch.from_numpy(np.random.default_rng(seed).standard_normal(n).astype(np.float32))
    return torch.log_softmax(2.0 * z, 0)


@pytest.mark.parametrize("open_", [0, 1])
def test_plain_starts_gate(open_):
    """``systematic_starts`` with a trigger: 0 leaves ``out`` as it was, 1
    writes the ungated starts; the log rows are counted either way."""
    n = 5000
    logw, u = _weights(n)[None], torch.tensor([0.3])
    log_z = torch.logsumexp(logw, 1)
    want = ss.systematic_starts(logw, u, log_z=log_z)
    out = torch.full((n,), -7, dtype=torch.int32)
    rows = ss.systematic_starts.log_rows
    got = ss.systematic_starts(logw, u, log_z=log_z, out=out,
                               trigger=torch.tensor([open_], dtype=torch.int32))
    assert got is out
    assert ss.systematic_starts.log_rows == rows + 1
    assert torch.equal(out, want if open_ else torch.full((n,), -7, dtype=torch.int32))


@pytest.mark.parametrize("open_", [0, 1])
@pytest.mark.parametrize("d", [1, 3])
def test_plain_resample_gate(open_, d):
    """``resample_by_starts`` with a trigger: 0 leaves ``out`` as it was
    (the starts not read: garbage here), 1 writes the ungated values."""
    n = 3000
    p = torch.randn((n, d), generator=torch.Generator().manual_seed(d))
    starts = hard.batched_starts(torch.softmax(_weights(n, 1), 0)[None], torch.tensor([0.6]))
    want = b2.resample_by_starts(p, starts)
    out = torch.full((n, d), 9.0)
    trig = torch.tensor([open_], dtype=torch.int32)
    used = starts if open_ else torch.full((n,), 10**6, dtype=torch.int32)
    assert b2.resample_by_starts(p, used, out=out, trigger=trig) is out
    assert torch.equal(out, want if open_ else torch.full((n, d), 9.0))


def test_gate_arguments_are_checked():
    n = 100
    p, starts = torch.randn((n, 1)), torch.zeros(n, dtype=torch.int32)
    with pytest.raises(ValueError, match="out="):
        b2.resample_by_starts(p, starts, trigger=torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="trigger"):
        b2.resample_by_starts(p, starts, out=torch.empty((n, 1)), trigger=torch.ones(1))
    with pytest.raises(ValueError, match="out must be"):
        b2.resample_by_starts(p, starts, out=torch.empty((n, 2)))
    w, u = torch.full((1, n), 1.0 / n), torch.tensor([0.5])
    with pytest.raises(ValueError, match="out="):
        ss.systematic_starts(w, u, trigger=torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="out must be"):
        ss.systematic_starts(w, u, out=torch.empty(n + 1, dtype=torch.int32))


# --- the gate through the kernels' wrappers (a stubbed library) -------------------
class _CudaLike(torch.Tensor):
    """A CPU tensor that says it lives on the card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_like(t):
    return t.as_subclass(_CudaLike)


class _Lib:
    """Stands in for both built libraries: records each call's arguments."""

    def __init__(self):
        self.calls = []

        def pf_systematic_starts(w, log_z, u, gate, scratch, out, rows, n, tiles, m,
                                 starts_form, stream):
            self.calls.append(("S", gate, out))
            return 0

        def pf_resample_by_starts(p, starts, out, gate, m, n, d, off, stream):
            self.calls.append(("B2", gate, out))
            return 0

        self.pf_systematic_starts = pf_systematic_starts
        self.pf_resample_by_starts = pf_resample_by_starts


@pytest.mark.parametrize("gated", [False, True])
def test_gate_pointer_reaches_the_kernels(monkeypatch, gated):
    """S and B2 on a card tensor: the trigger's pointer is the entry's gate
    and the outputs are the caller's; without a trigger the gate is null
    (the launch is the ungated one) and the outputs are fresh."""
    lib = _Lib()
    monkeypatch.setattr(_nvcc, "load_library", lambda name, *sources: lib)
    monkeypatch.setattr(_nvcc, "on_device", lambda device: contextlib.nullcontext(0))
    n = 20000
    logw, u = _cuda_like(_weights(n)[None]), _cuda_like(torch.tensor([0.3]))
    log_z = _cuda_like(torch.logsumexp(_weights(n)[None], 1))
    p = _cuda_like(torch.randn((n, 1)))
    trig = _cuda_like(torch.ones(1, dtype=torch.int32)) if gated else None
    starts_out = _cuda_like(torch.empty(n, dtype=torch.int32)) if gated else None
    values_out = _cuda_like(torch.empty((n, 1))) if gated else None
    launches = (ss.systematic_starts.launches, b2.resample_by_starts.launches)
    starts = ss.systematic_starts(logw, u, log_z=log_z, trigger=trig, out=starts_out)
    values = b2.resample_by_starts(p, starts, trigger=trig, out=values_out)
    gate = None if trig is None else trig.data_ptr()
    assert [c[:2] for c in lib.calls] == [("S", gate), ("B2", gate)]
    assert lib.calls[0][2] == starts.data_ptr() and lib.calls[1][2] == values.data_ptr()
    if gated:
        assert starts is starts_out and values is values_out
    assert (ss.systematic_starts.launches, b2.resample_by_starts.launches) == (
        launches[0] + ss.plan(1, n).passes, launches[1] + 1)


# --- on the card -------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the captured run replays on the card)")
    return torch.device("cuda")


def _card_run(f, n, T, seed):
    """A run's inputs on the card: the initial state and an SV sequence."""
    zs = torch.from_numpy(_sv_data(T, seed)).to(f.device)
    state0 = f.initialize(torch.Generator(device=f.device).manual_seed(seed), [0.0],
                          [[SIGMA**2 / (1 - ALPHA**2)]])
    return state0, zs


@pytest.mark.cuda
def test_replay_equals_the_eager_body_on_the_card():
    """At N = 2^20, T = 200: ``run``'s graph replay gives the eager run of
    the same body on the same inputs bit for bit: histories and state."""
    dev = _card()
    n, T = 1 << 20, 200
    f = _filter(1, n, dev)
    state0, zs = _card_run(f, n, T, 11)
    state, hist = f.run(torch.Generator(device=dev).manual_seed(3), state0, zs)
    card = f._card_runs[(T, 1)]
    card.load(torch.Generator(device=dev).manual_seed(3), state0, zs)
    card.steps()
    (p_e, lw_e, off_e), rows, trig = card.outputs()
    assert 0 < int(trig.sum()) < T
    assert torch.equal(hist["resampled"], trig)
    assert torch.equal(hist["log_evidence"], rows[:, 0])
    assert torch.equal(hist["ess"], rows[:, 1])
    assert torch.equal(hist["mean"], rows[:, 2:3])
    for a, b in zip(state, (p_e.view(n), lw_e, off_e)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_card_body_equals_host_loop_on_the_card():
    """At N = 2^20, T = 200 on the card: the steps that decide there (B1's
    ``DECIDE`` form, its seed loaded from the device; S and B2 gated) give
    the host's loop's histories and final state bit for bit from the same
    generator, as their plain versions do on the CPU."""
    dev = _card()
    n, T = 1 << 20, 200
    f = _filter(1, n, dev)
    state0, zs = _card_run(f, n, T, 12)
    (p_h, lw_h, off_h), hist_h = f._host_run(torch.Generator(device=dev).manual_seed(4),
                                             state0, zs)
    resampled = hist_h["resampled"]
    assert 0 < int(resampled.sum()) < T
    card = _CardRun(f, T, 1)
    card.load(torch.Generator(device=dev).manual_seed(4), state0, zs)
    card.steps()
    (p_c, lw_c, off_c), rows, trig = card.outputs()
    assert torch.equal(trig, resampled)
    assert torch.equal(rows[:, 0], hist_h["log_evidence"])
    assert torch.equal(rows[:, 1], hist_h["ess"])
    assert torch.equal(rows[:, 2:3], hist_h["mean"])
    for a, b in zip((p_c.view(n), lw_c, off_c), (p_h, lw_h, off_h)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_two_sequences_on_one_graph_each_give_their_own_answer():
    """Two sequences (and generators) replayed in turns on the filter's one
    captured graph: each run equals the eager body's on its own inputs, and
    the returned tensors are copies that later replays leave alone."""
    dev = _card()
    n, T = 1 << 16, 100
    f = _filter(1, n, dev)
    runs = [_card_run(f, n, T, s) for s in (21, 22)]
    outs = [f.run(torch.Generator(device=dev).manual_seed(s), st, zs)
            for s, (st, zs) in zip((5, 6), runs)]
    kept = [(tuple(t.clone() for t in st), {k: v.clone() for k, v in h.items()})
            for st, h in outs]
    again = f.run(torch.Generator(device=dev).manual_seed(5), *runs[0])  # a third replay
    card = f._card_runs[(T, 1)]
    for s, (st0, zs), (state, hist), (state_k, hist_k) in zip((5, 6), runs, outs, kept):
        card.load(torch.Generator(device=dev).manual_seed(s), st0, zs)
        card.steps()
        (p_e, _, _), rows, trig = card.outputs()
        assert torch.equal(hist["resampled"], trig) and torch.equal(hist["log_evidence"], rows[:, 0])
        assert torch.equal(state[0], p_e.view(n))
        for a, b in zip(state, state_k):
            assert torch.equal(a, b)
        for k in hist:
            assert torch.equal(hist[k], hist_k[k]), k
    assert not torch.equal(outs[0][1]["log_evidence"], outs[1][1]["log_evidence"])
    assert torch.equal(again[1]["log_evidence"], outs[0][1]["log_evidence"])


@pytest.mark.cuda
def test_outputs_do_not_alias_the_graph_buffers():
    """Nothing ``run`` returns shares memory with the captured run's buffers."""
    dev = _card()
    n, T = 1 << 16, 40
    f = _filter(1, n, dev)
    state, hist = f.run(torch.Generator(device=dev).manual_seed(1), *_card_run(f, n, T, 31))
    card = f._card_runs[(T, 1)]
    buffers = [card.x0, card.lw0, card.off0, card.zs, card.seeds, card.us, card.xs, card.lws,
               card.x_res, card.starts, card.carry, card.rows, card.trig]

    def span_of(t):
        return t.data_ptr(), t.data_ptr() + t.untyped_storage().nbytes()

    for out in (*state, *hist.values()):
        a0, a1 = span_of(out)
        for buf in buffers:
            b0, b1 = span_of(buf)
            assert a1 <= b0 or b1 <= a0


@pytest.mark.cuda
def test_counters_count_captures_replays_and_launches():
    """One capture a shape, one replay a run; each replay adds T launches of
    B1, T gated launches of B2 (d = 1) and S's passes T times."""
    dev = _card()
    n, T = 1 << 16, 50
    f = _filter(1, n, dev)
    state0, zs = _card_run(f, n, T, 41)
    captures, replays = FusedSIRFilter.graph_captures, FusedSIRFilter.graph_replays
    f.run(torch.Generator(device=dev).manual_seed(1), state0, zs)
    b1, s, res = fused_step.launches, ss.systematic_starts.launches, b2.resample_by_starts.launches
    for i in range(3):
        f.run(torch.Generator(device=dev).manual_seed(2 + i), state0, zs)
    assert FusedSIRFilter.graph_captures == captures + 1
    assert FusedSIRFilter.graph_replays == replays + 4
    assert fused_step.launches - b1 == 3 * T
    assert ss.systematic_starts.launches - s == 3 * T * ss.plan(1, n).passes
    assert b2.resample_by_starts.launches - res == 3 * T
    f.run(torch.Generator(device=dev).manual_seed(9), state0, zs[: T // 2])  # another shape
    assert FusedSIRFilter.graph_captures == captures + 2


@pytest.mark.cuda
def test_the_filter_keeps_the_last_two_shapes():
    """A filter keeps the captured runs of the two shapes it ran last: a
    third length drops the least recently run, which a later run of it
    captures again."""
    dev = _card()
    n = 1 << 14
    f = _filter(1, n, dev)
    state0, zs = _card_run(f, n, 40, 51)
    captures = FusedSIRFilter.graph_captures
    for length, new in ((20, 1), (30, 1), (20, 0), (40, 1), (20, 0), (30, 1)):
        f.run(torch.Generator(device=dev).manual_seed(length), state0, zs[:length])
        assert FusedSIRFilter.graph_captures == captures + new, length
        captures += new
        assert list(f._card_runs)[-1] == (length, 1) and len(f._card_runs) <= 2
