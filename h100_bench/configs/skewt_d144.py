"""Plain reference of the ``skewt_d144`` configuration, in plain PyTorch (no
code of the program): the skew-t sensor-network simulator, the UKF-assisted
EDH and LEDH flow particle filters over batched trials, its control, and the
numbers that compare a run of the program with a run of this filter.

    W_k ~ InvGamma(ν/2, ν/2),  x_k = α x_{k−1} + W_k γ + √W_k L z_k,  Σ = L Lᵀ
    counts_k ~ Poisson(m₁ exp(m₂ clip(x_k)))

Σ_ij = α₀ exp(−‖r_i − r_j‖²/β) + α₁ δ_ij on a √d × √d lattice. The filters
work on the Gaussian model g(x) = αx, Q = Σ, h(x) = m₁ exp(m₂ clip(x)) with
its dense Jacobian, R = diag(h(0)), and the exact Poisson log-likelihood.
Each step: the UKF tracker predicts; the particles propagate with the given
noise; the flow integrates over λ ∈ (0, 1] by Euler on the uniform grid
(EDH: one linearization at the tracker's path η̄ a trial; LEDH: one a
particle, in the Woodbury form, with the log-determinant of the flow);
the weights take the invertible-flow correction; the tracker updates; every
trial whose ESS < ratio·N resamples systematically (positions (u + i)/N);
the history records the weighted mean.

The caller gives the state a step starts from, the process noise and the
generator of the resample's uniforms, one ``torch.rand`` of the triggered
trials' count a step, in trial order: the same inputs the program was
given. :func:`compare` steps this filter from each of the program's states
in turn, so the two agree to rounding at every step, apart from the few
rows a resample swaps where rounding moves a position across a boundary of
the cdf.
"""

from __future__ import annotations

import math

import torch

_LOG_2PI = 1.8378770664093453


# --- the simulator -----------------------------------------------------------
def geometry(cfg: dict, generator, device):
    """Σ (d, d), its Cholesky factor L and the skew vector γ (d,), f32."""
    d = cfg["d"]
    s = math.isqrt(d)
    xs, ys = torch.meshgrid(torch.arange(s), torch.arange(s), indexing="xy")
    r = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=1).double()
    dist2 = ((r[:, None, :] - r[None, :, :]) ** 2).sum(-1)
    sigma = cfg["alpha0"] * torch.exp(-dist2 / cfg["beta"]) + cfg["alpha1"] * torch.eye(d)
    L = torch.linalg.cholesky(sigma)
    v = torch.randn(d, generator=generator, device=device)
    gamma = cfg["gamma_scale"] * v / (torch.linalg.vector_norm(v) + 1e-12)
    return sigma.float().to(device), L.float().to(device), gamma


def simulate(cfg: dict, generator, device):
    """``cfg["trials"]`` trials of ``cfg["steps"]`` steps from x₀ = 0:
    ``(X, Z, Σ, L)`` with X, Z (trials, T, d) f32 (Z the counts)."""
    sigma, L, gamma = geometry(cfg, generator, device)
    B, T, d = cfg["trials"], cfg["steps"], cfg["d"]
    shape = torch.full((B, 1), cfg["nu"] / 2, device=device)
    x = torch.zeros((B, d), device=device)
    xs, zs = [], []
    for _ in range(T):
        W = 1.0 / (torch._standard_gamma(shape, generator=generator) / (cfg["nu"] / 2))
        z = torch.randn((B, d), generator=generator, device=device)
        x = cfg["alpha"] * x + W * gamma + torch.sqrt(W) * (z @ L.T)
        lam = cfg["m1"] * torch.exp(cfg["m2"] * torch.clamp(x, *cfg["clip"]))
        xs.append(x)
        zs.append(torch.poisson(lam, generator=generator))
    return torch.stack(xs, 1), torch.stack(zs, 1), sigma, L


# --- the filter's pieces -----------------------------------------------------
def sym(a):
    return 0.5 * (a + a.transpose(-1, -2))


def chol_ladder(a, jitter: float = 0.0, initial: float = 1e-9, tries: int = 6):
    """The Cholesky factor of each (…, n, n) matrix at the first of the rungs
    jitter, jitter + initial·10^k (k < tries) on which it factorizes."""
    a = sym(a)
    eye = torch.eye(a.shape[-1], device=a.device, dtype=a.dtype)
    out = None
    for eps in [jitter] + [jitter + initial * 10.0**k for k in range(tries)]:
        L, info = torch.linalg.cholesky_ex(a + eps * eye)
        if out is None:
            out, todo = L, info != 0
        else:
            out = torch.where(todo[..., None, None], L, out)
            todo = todo & (info != 0)
        if not bool(todo.any()):
            break
    return out


def chol_solve(L, b):
    return torch.cholesky_solve(b, L)


def h(cfg, x):
    return cfg["m1"] * torch.exp(cfg["m2"] * torch.clamp(x, *cfg["clip"]))


def jac_h(cfg, x):
    """The dense Jacobian of h at each row of x: (…, d, d), diagonal."""
    lo, hi = cfg["clip"]
    inside = ((x >= lo) & (x <= hi)).to(x.dtype)
    return torch.diag_embed(cfg["m2"] * h(cfg, x) * inside)


def mvn_logpdf(x, mean, l_inv, logdet):
    d = x.shape[-1]
    sol = (x - mean) @ l_inv.T
    return -0.5 * ((sol * sol).sum(-1) + logdet + d * _LOG_2PI)


class UKF:
    """The scaled unscented transform (2d + 1 points, additive noise) of the
    tracker, batched over trials."""

    def __init__(self, cfg, Q, R):
        p = cfg["ukf"]
        d = Q.shape[0]
        lam = p["alpha"] ** 2 * (d + p["kappa"]) - d
        self.gamma = math.sqrt(d + lam)
        wm = torch.full((2 * d + 1,), 1.0 / (2.0 * (d + lam)), dtype=torch.float64)
        wc = wm.clone()
        wm[0] = lam / (d + lam)
        wc[0] = wm[0] + (1.0 - p["alpha"] ** 2 + p["beta"])
        self.wm, self.wc = wm.float().to(Q.device), wc.float().to(Q.device)
        self.jitter, self.cfg, self.Q, self.R, self.a = p["jitter"], cfg, Q, R, cfg["alpha"]

    def points(self, mean, cov):
        L = chol_ladder(sym(cov), jitter=self.jitter)
        off = self.gamma * L.transpose(-1, -2)
        m = mean[:, None, :]
        return torch.cat([m, m + off, m - off], dim=1)

    def ut_mean(self, Y):
        return Y[:, 0] + self.wm[1] * torch.sum(Y[:, 1:] - Y[:, :1], dim=1)

    def outer(self, A, B):
        return (self.wc[None, :, None] * A).transpose(-1, -2) @ B

    def predict(self, mean, cov):
        Y = self.a * self.points(mean, cov)
        m = self.ut_mean(Y)
        D = Y - m[:, None]
        return m, self.Q + self.outer(D, D)

    def update(self, mean, cov, z):
        X = self.points(mean, cov)
        Zs = h(self.cfg, X)
        zp = self.ut_mean(Zs)
        DZ = Zs - zp[:, None]
        S = sym(self.R + self.outer(DZ, DZ))
        Pxz = self.outer(X - mean[:, None], DZ)
        L = chol_ladder(S, jitter=self.jitter)
        K = chol_solve(L, Pxz.transpose(-1, -2)).transpose(-1, -2)
        m = mean + (K @ (z - zp)[..., None])[..., 0]
        return m, sym(cov - K @ S @ K.transpose(-1, -2))


def _grid(steps: int):
    dlam = 1.0 / steps
    return dlam, torch.clamp((torch.arange(steps, dtype=torch.float32) + 1) * dlam,
                             max=1.0).tolist()


def edh_flow(cfg, eta, etabar, P, z, R, LR):
    """EDH by Euler over B trials: eta (B, n, d), etabar (B, d), P (B, d, d)."""
    d = eta.shape[-1]
    I = torch.eye(d, device=eta.device)
    dlam, lams = _grid(cfg["lambda_steps"])
    for lam in lams:
        H = jac_h(cfg, etabar)
        e = h(cfg, etabar) - (H @ etabar[..., None])[..., 0]
        S = lam * (H @ P @ H.transpose(-1, -2)) + R
        LS = chol_ladder(S, initial=1e-8)
        A = -0.5 * P @ H.transpose(-1, -2) @ chol_solve(LS, H)
        rinv = chol_solve(LR, (z - e)[..., None])
        inner = (I + lam * A) @ (P @ H.transpose(-1, -2) @ rinv) + A @ etabar[..., None]
        b = ((I + 2.0 * lam * A) @ inner)[..., 0]
        eta = eta + dlam * (eta @ A.transpose(-1, -2) + b[:, None])
        etabar = etabar + dlam * ((A @ etabar[..., None])[..., 0] + b)
    return eta, None


def ledh_flow(cfg, eta0, P, z, R_inv):
    """LEDH by Euler, one linearization a particle (Woodbury form), over B
    trials: eta0 (B, n, d), P (B, d, d). Returns the migrated particles and
    the flow's log-determinant a particle."""
    B, n, d = eta0.shape
    I = torch.eye(d, device=eta0.device)
    P_inv = chol_solve(chol_ladder(P, initial=1e-9), I.expand(B, d, d))
    Pp, Pinvp = P[:, None], P_inv[:, None]  # (B, 1, d, d)
    zp = z[:, None, :, None]
    eta, etabar, theta = eta0, eta0, torch.zeros((B, n), device=eta0.device)
    dlam, lams = _grid(cfg["lambda_steps"])
    dlam = float(torch.tensor(dlam, dtype=torch.float32))
    for lam in lams:
        c = torch.tensor(dlam, dtype=torch.float32) / (2.0 * torch.tensor(lam, dtype=torch.float32))
        one_minus_c = float(1.0 - c)
        H = jac_h(cfg, eta)  # (B, n, d, d)
        e = h(cfg, eta) - (H @ eta[..., None])[..., 0]
        W = sym(H.transpose(-1, -2) @ (R_inv @ H))
        K = torch.stack([Pinvp / lam + W + 1e-8 * I, Pinvp / lam + one_minus_c * W + 1e-8 * I])
        Ls, _ = torch.linalg.cholesky_ex(K)
        LK, Lnum = Ls[0], Ls[1]
        Y = torch.linalg.solve_triangular(LK, W, upper=False)
        G = sym(W - Y.transpose(-1, -2) @ Y)
        A = -0.5 * Pp @ G
        rin = R_inv @ (zp - e[..., None])
        inner = (I + lam * A) @ (Pp @ (H.transpose(-1, -2) @ rin)) + A @ eta0[..., None]
        b = ((I + 2.0 * lam * A) @ inner)[..., 0]
        etabar_new = etabar + dlam * ((A @ etabar[..., None])[..., 0] + b)
        eta = eta + dlam * ((A @ eta[..., None])[..., 0] + b)
        etabar = etabar_new
        theta = theta + 2.0 * (torch.log(torch.diagonal(Lnum, dim1=-2, dim2=-1)).sum(-1)
                               - torch.log(torch.diagonal(LK, dim1=-2, dim2=-1)).sum(-1))
    return eta, theta


class PlainFilter:
    """The plain flow filter over B trials, one step at a time. A state is a
    dict of ``particles`` (B, n, d), ``logw`` (B, n) normalized,
    ``track_mean`` (B, d) and ``track_cov`` (B, d, d); a step also gives
    ``mean`` (B, d), the weighted mean after any resample, and
    ``resampled`` (B,). The per-particle work runs ``chunk`` trials at a
    time."""

    def __init__(self, cfg: dict, kind: str, sigma, L, chunk: int = 100) -> None:
        d, dev = cfg["d"], sigma.device
        self.cfg, self.kind, self.sigma, self.chunk = cfg, kind, sigma, chunk
        R = torch.diag(h(cfg, torch.zeros(d, device=dev)))
        self.R, self.LR = R, chol_ladder(R, initial=1e-10)
        self.R_inv = chol_solve(self.LR, torch.eye(d, device=dev))
        self.ukf = UKF(cfg, sigma, R)
        self.l_inv = torch.linalg.solve_triangular(L, torch.eye(d, device=dev), upper=False)
        self.logdet_q = 2.0 * torch.log(torch.abs(torch.diagonal(L))).sum()

    def start(self, particles0) -> dict:
        """The state every trial starts from: the cloud ``particles0``, equal
        weights, the tracker at (0, Σ)."""
        B, n, d = particles0.shape
        dev = particles0.device
        return {"particles": particles0,
                "logw": torch.full((B, n), -math.log(n), device=dev),
                "track_mean": torch.zeros((B, d), device=dev),
                "track_cov": self.sigma.expand(B, d, d).clone()}

    def step(self, state: dict, z, v, u_gen) -> dict:
        """One step from ``state`` on the counts ``z`` (B, d) with the process
        noise ``v`` (B, n, d); the resample draws one ``torch.rand`` of the
        triggered trials' count from ``u_gen``, in trial order."""
        cfg, a = self.cfg, self.cfg["alpha"]
        p, logw = state["particles"], state["logw"]
        B, n, d = p.shape
        past = state["track_mean"]
        m_pred, P_pred = self.ukf.predict(past, state["track_cov"])
        P = sym(P_pred)
        eta0 = a * p + v
        xs, lws = [], []
        for s in range(0, B, self.chunk):
            sl = slice(s, s + self.chunk)
            if self.kind == "edh":
                xk, theta = edh_flow(cfg, eta0[sl], a * past[sl], P[sl], z[sl], self.R, self.LR)
            else:
                xk, theta = ledh_flow(cfg, eta0[sl], P[sl], z[sl], self.R_inv)
            mean_old = a * p[sl]
            lam = h(cfg, xk)
            corr = (mvn_logpdf(xk, mean_old, self.l_inv, self.logdet_q)
                    + torch.sum(z[sl, None] * torch.log(lam + 1e-10) - lam, dim=-1)
                    - mvn_logpdf(eta0[sl], mean_old, self.l_inv, self.logdet_q))
            lw = logw[sl] if theta is None else logw[sl] + theta
            lw = lw + corr
            xs.append(xk)
            lws.append(lw - torch.logsumexp(lw, dim=-1, keepdim=True))
        p, logw = torch.cat(xs), torch.cat(lws)
        m, cov = self.ukf.update(m_pred, P_pred, z)
        w = torch.exp(logw)
        trig = 1.0 / torch.sum(w * w, dim=-1) < cfg["resample_ess_ratio"] * n
        sel = torch.nonzero(trig)[:, 0]
        if sel.numel():
            u = torch.rand((sel.numel(),), generator=u_gen, device=p.device)
            cdf = torch.cumsum(w[sel].double(), dim=-1)
            pos = (u.double()[:, None] + torch.arange(n, device=p.device,
                                                      dtype=torch.float64)) / n
            idx = torch.searchsorted(cdf / cdf[:, -1:], pos, right=True).clamp_(max=n - 1)
            p = p.index_copy(0, sel, torch.gather(p[sel], 1, idx[..., None].expand(-1, -1, d)))
            logw = logw.index_fill(0, sel, -math.log(n))
        return {"particles": p, "logw": logw, "track_mean": m, "track_cov": cov,
                "mean": (torch.exp(logw)[:, None, :] @ p)[:, 0], "resampled": trig}

    def run(self, state: dict, Z, noise, u_gen) -> list:
        """Every step's state over the counts ``Z`` (B, T, d), with
        ``noise(k)`` step k's process noise."""
        out = []
        for k in range(Z.shape[1]):
            state = self.step(state, Z[:, k], noise(k), u_gen)
            out.append(state)
        return out


def control(plain: PlainFilter, *args) -> list:
    """The control: :meth:`PlainFilter.run` with TF32 matrix products, the
    precision below the configuration's float32 with TF32 off. The caller's
    inputs (the noise among them) stay float32."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        return plain.run(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _rel(a, b):
    return torch.linalg.vector_norm(a - b, dim=-1) / torch.linalg.vector_norm(b, dim=-1)


def step_gaps(prog: dict, ref: dict) -> dict:
    """The gaps of one step a trial, (B,) each, between the program's state
    and the plain filter's step from the program's previous state:
    ``particle``, the median over rows of a row's relative gap (a resample
    position that rounding moves across a cdf boundary swaps a few rows:
    the median reads the flow's rounding, not them); ``track``, the
    tracker's mean; ``mean``, the weighted mean (the swapped rows move it).
    Gaps are relative, in float64."""
    return {"particle": _rel(prog["particles"].double(),
                             ref["particles"].double()).median(-1).values,
            "track": _rel(prog["track_mean"].double(), ref["track_mean"].double()),
            "mean": _rel(prog["mean"].double(), ref["mean"].double())}


def compare(plain: PlainFilter, start: dict, steps: list, Z, noise, u_gen) -> dict:
    """Every step of one unit held against the plain filter's step from the
    program's own previous state (``start`` before step 0), on the same
    counts, noise (``noise(k)``, in order) and resample uniforms (``u_gen``
    at the unit's start; after each step it advances by the program's own
    draws). So each step is compared from where the program stood, and no
    step's gap carries into the next. Over the (trial, step) grid:

    - ``particle_gap_p50``, ``particle_gap_p90``: the median and the 90th
      percentile of the particles' gap (a fault in half of the trials, or
      after step 0, moves the 90th);
    - ``track_gap``: the largest of the tracker's;
    - ``mean_gap_p50``: the median of the weighted mean's.

    Every trial at d = 144 resamples at every step, so the weights that a
    step hands on are equal and nothing compares them apart from the rows
    they choose. (A trial that does not resample hands its weights on
    unchecked: the next step starts from them.)

    The workload's ``limits`` name the numbers a run compares."""
    rows, prev = [], start
    for k, prog in enumerate(steps):
        snap = u_gen.get_state()
        ref = plain.step(prev, Z[:, k], noise(k), u_gen)
        u_gen.set_state(snap)
        torch.rand((int(prog["resampled"].sum()),), generator=u_gen, device=Z.device)
        rows.append(step_gaps(prog, ref))
        prev = prog
    grid = {key: torch.stack([r[key] for r in rows]).flatten() for key in rows[0]}
    clean = {key: torch.nan_to_num(g, nan=math.inf) for key, g in grid.items()}

    def q(x, level):
        return float(torch.quantile(x, level, interpolation="higher"))

    return {"particle_gap_p50": q(clean["particle"], 0.5),
            "particle_gap_p90": q(clean["particle"], 0.9),
            "track_gap": float(clean["track"].max()),
            "mean_gap_p50": q(clean["mean"], 0.5)}
