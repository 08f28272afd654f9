"""Batched dense QP solver — OSQP-style ADMM with fixed iteration count.

Replaces the qpOASES dense active-set backend of the reference
(/root/reference/src/QPPVMPlugin.cpp:21,188,246). Active-set pivoting is
data-dependent control flow — hostile to XLA; instead we use first-order ADMM
whose per-iteration work is *matmul only* (one KKT-inverse apply + one
constraint matvec), so a whole solve is a fixed-shape fused XLA loop that
vmaps across thousands of rollout QPs as batched matmuls.

    minimize   1/2 x^T P x + q^T x
    subject to l <= A x <= u        (equalities: l == u rows)

Robustness pieces (all shape-static, jit/vmap-friendly):
- Ruiz equilibration of [P, A] (OSQP-style) — first-order methods are
  scaling-sensitive and WBC stacks mix Nm, N and rad units.
- Adaptive rho: iterations run in chunks; rho rebalanced by residual ratio,
  KKT inverse rebuilt per chunk.
- Active-set polish with iterative refinement for direct-solver accuracy.
- Warm start carried as an explicit ``QPState`` pytree (the analog of
  qpOASES hot-start in the 1 kHz loop) — serializable, checkpointable.

Residuals reported in ``QPInfo`` are *relative* (OSQP convention), so
failure thresholds are unit-free.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from qppvm_tpu.opt import linalg
from qppvm_tpu.precision import f32_matmuls


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QPProblem:
    P: jax.Array  # (n, n) PSD
    q: jax.Array  # (n,)
    A: jax.Array  # (m, n)
    l: jax.Array  # (m,)
    u: jax.Array  # (m,)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QPState:
    """Warm-start state carried across control ticks. Besides the ADMM
    iterates, carries the previous KKT inverse: at 1 kHz the KKT matrix
    changes slowly, so Newton-Schulz re-converges from it in a handful of
    matmuls — the batched analog of qpOASES hot-start factor reuse."""

    x: jax.Array  # (n,)
    z: jax.Array  # (m,)
    y: jax.Array  # (m,)
    Kinv: Optional[jax.Array] = None  # (n, n) scaled-space KKT inverse
    rho_scale: Optional[jax.Array] = None  # () adapted rho carried over

    @staticmethod
    def zero(n: int, m: int, dtype=jnp.float32) -> "QPState":
        # Kinv starts at zeros: the NS contraction guard then falls back to
        # the cold init on the first tick (keeps pytree structure stable for
        # lax.scan chains).
        return QPState(x=jnp.zeros(n, dtype), z=jnp.zeros(m, dtype),
                       y=jnp.zeros(m, dtype), Kinv=jnp.zeros((n, n), dtype),
                       rho_scale=jnp.ones((), dtype))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QPInfo:
    """Solver status — the analog of the reference's solve-failure signalling
    (/root/reference/src/QPPVMPlugin.cpp:246-249). Residuals are relative."""

    prim_res: jax.Array  # () relative inf-norm of Ax - z
    dual_res: jax.Array  # () relative inf-norm of Px + q + A^T y
    obj: jax.Array       # () objective value


def _rho_vec(l, u, rho):
    """Per-row penalty: boost equality rows, damp fully-unbounded rows
    (OSQP strategy). One-sided rows (e.g. friction-cone faces with
    l = -inf, u = 0) are REAL constraints and keep the base penalty."""
    eq = (u - l) < 1e-8
    loose = (l < -1e12) & (u > 1e12)  # robust to Ruiz row scaling of the 1e20 sentinels
    base = jnp.where(eq, rho * 1e3, rho)
    return jnp.where(loose, rho * 1e-6, base)


def _ruiz(P, A, iters: int = 5):
    """Ruiz equilibration of the KKT block [[P, A^T], [A, 0]].
    Returns diagonal scalings d (n,), e (m,)."""
    n = P.shape[0]
    m = A.shape[0]
    dtype = P.dtype
    d = jnp.ones(n, dtype)
    e = jnp.ones(m, dtype)
    Ps, As = P, A
    for _ in range(iters):
        cn = jnp.maximum(jnp.max(jnp.abs(Ps), axis=0),
                         jnp.max(jnp.abs(As), axis=0) if m > 0 else 0.0)
        rn = jnp.max(jnp.abs(As), axis=1) if m > 0 else jnp.zeros(0, dtype)
        sd = 1.0 / jnp.sqrt(jnp.clip(cn, 1e-8, 1e8))
        se = 1.0 / jnp.sqrt(jnp.clip(rn, 1e-8, 1e8))
        d = d * sd
        e = e * se
        Ps = sd[:, None] * Ps * sd[None, :]
        As = se[:, None] * As * sd[None, :]
    return d, e


def _rel_residuals(P, q, A, x, z, y, Pn=None):
    """Relative OSQP-style residuals. With ``Pn`` (equality-elimination
    path) the dual residual is projected onto the feasible tangent space —
    the unprojected stationarity contains the equality-multiplier component
    E^T nu, which is O(1) at the optimum and would mislead rho adaptation."""
    Ax = A @ x
    Px = P @ x
    Aty = A.T @ y
    prim = jnp.max(jnp.abs(Ax - z)) / (
        jnp.maximum(jnp.max(jnp.abs(Ax)), jnp.max(jnp.abs(z))) + 1.0)
    stat = Px + q + Aty
    if Pn is not None:
        stat = Pn @ stat
    dual = jnp.max(jnp.abs(stat)) / (
        jnp.maximum(jnp.maximum(jnp.max(jnp.abs(Px)), jnp.max(jnp.abs(Aty))),
                    jnp.max(jnp.abs(q))) + 1.0)
    return prim, dual


@f32_matmuls
def solve(
    problem: QPProblem,
    state: Optional[QPState] = None,
    *,
    iters: int = 80,
    rho: float = 0.1,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    refine: int = 2,
    rho_updates: int = 3,
    scale_iters: int = 5,
    inv_method: str = "ns",
    polish_rounds: int = 2,
    assume_warm_kinv: bool = False,
    warm_kinv_iters: int = 12,
    polish_ns_iters: int = 24,
    rho_adapt_tol: float = 0.0,
    rho_scale_min: float = 1e-2,
    n_eq_head: int = 0,
    n_eq_tail: int = 0,
    eq_pin: float = 1.0,
    cold_ns_iters: Optional[int] = None,
    pinv_ns_iters: int = 7,
):
    """One dense QP solve. Returns (x, new_state, info). vmap for batches.

    ``n_eq_head`` / ``n_eq_tail`` (static) mark the first/last rows of A as
    structural equalities (l == u) to be ELIMINATED by nullspace projection
    instead of penalized: x = x_p + P_N xi with P_N = I - E^+E and
    x_p = E^+ b_e (E^+ via a small NS-inverted Gram matrix — matmul-only).
    This removes the x1e3 equality-rho boost from the ADMM matrix K, which
    otherwise dominates its condition number: measured on the humanoid
    ForceAcc cascade, cond(K) drops 67000 -> 5.4 (level 0) and the cold
    Newton-Schulz inverse needs ~6 iterations instead of ~14-20, while the
    equalities (dynamic feasibility + cascade locks) become EXACT — closer
    to the reference's qpOASES hard-constraint semantics
    (/root/reference/src/QPPVMPlugin.cpp:188). It also makes tick-to-tick
    KKT-inverse reuse robust: the eq boost amplified KKT drift past the NS
    contraction guard (measured err ~250 at 1% state perturbation vs 0.18
    after elimination)."""
    P0, q0, A0, l0, u0 = (problem.P, problem.q, problem.A, problem.l,
                          problem.u)
    n = P0.shape[0]
    m = A0.shape[0]
    dtype = P0.dtype
    if state is None:
        state = QPState.zero(n, m, dtype)
    h_eq, t_eq = n_eq_head, n_eq_tail
    has_eq = (h_eq + t_eq) > 0

    if has_eq:
        E0 = jnp.concatenate([A0[:h_eq], A0[m - t_eq:]], axis=0)
        b_e0 = jnp.concatenate([l0[:h_eq], l0[m - t_eq:]])
        A_in0 = A0[h_eq:m - t_eq]
        l_in0 = l0[h_eq:m - t_eq]
        u_in0 = u0[h_eq:m - t_eq]
    else:
        A_in0, l_in0, u_in0 = A0, l0, u0

    # --- Ruiz scaling (inequality rows only; eq rows are row-normalized
    # separately for the Gram inverse) ------------------------------------
    d, e = _ruiz(P0, A_in0, iters=scale_iters)
    P = d[:, None] * P0 * d[None, :]
    q = d * q0
    A = e[:, None] * A_in0 * d[None, :]
    l = e * l_in0
    u = e * u_in0
    I_n = jnp.eye(n, dtype=dtype)

    if has_eq:
        Es_raw = E0 * d[None, :]
        R_eq = jax.lax.rsqrt(jnp.sum(Es_raw ** 2, axis=1) + 1e-12)
        Es = R_eq[:, None] * Es_raw
        b_es = R_eq * b_e0
        # Gram inverse: rows are unit-normalized so G has unit diagonal;
        # the delta shift keeps redundant/locked-dependent rows harmless
        # (least-squares lock).
        n_eq_rows = h_eq + t_eq
        G = Es @ Es.T + 1e-6 * jnp.eye(n_eq_rows, dtype=dtype)
        Ginv = linalg.spd_inverse(G, method=inv_method)
        EpT = Es.T @ Ginv                      # (n, n_eq), delta-biased
        # Newton-Schulz PINV refinement (Ben-Israel–Cohen,
        # X <- X(2I - E X)) from the Gram-delta initializer: the shift
        # leaves a per-direction leak L_i = delta/(sigma_i^2 + delta) — O(1)
        # exactly when an equality pair is NEAR-parallel (sigma_i^2 ~ delta,
        # e.g. rows 1e-3 apart), where one linear refinement cannot recover
        # (measured 2e-4 physical equality residual). NS is QUADRATIC from
        # this always-contractive start (L_i < 1 for every sigma_i > 0), so
        # 7 iterations drive even L = 0.7 to ~1e-11, while exact-duplicate
        # rows (sigma_i = 0) stay in the row space — the correct
        # least-squares lock (tests: test_eq_elim_near_parallel_equality_
        # rows, test_eq_elim_redundant_equalities).
        I_eq = jnp.eye(n_eq_rows, dtype=dtype)

        def _pinv_body(X, _):
            return X @ (2.0 * I_eq - Es @ X), None

        EpT, _ = jax.lax.scan(_pinv_body, EpT, None,
                              length=pinv_ns_iters)
        Pn = I_n - EpT @ Es                    # tangent-space projector
        x_p = EpT @ b_es                       # particular solution (scaled)
        # one linear refinement mops up dtype roundoff
        x_p = x_p + EpT @ (b_es - Es @ x_p)
        Ax_p = A @ x_p
        q_eff = Pn @ (q + P @ x_p)
        l = l - Ax_p
        u = u - Ax_p
        # warm start mapped into the reduced (xi, z~, y) coordinates
        x = Pn @ (state.x / d - x_p)
        z = e * state.z[h_eq:m - t_eq] - Ax_p
        y = state.y[h_eq:m - t_eq] / jnp.maximum(e, 1e-30)
    else:
        Pn = None
        q_eff = q
        # scale warm start into the scaled space
        x = state.x / d
        z = e * state.z
        y = state.y / jnp.maximum(e, 1e-30)

    rho_base = _rho_vec(l, u, jnp.asarray(rho, dtype))
    n_chunks = max(1, rho_updates + 1)
    chunk = max(1, iters // n_chunks)

    # Carried rho may adapt DOWN across ticks (weak-curvature problems need
    # small rho) but never carries an increase: persistently raised rho puts
    # warm-started ADMM in its oscillatory regime. Within-solve adaptation
    # can still raise it transiently. ``rho_scale_min`` floors the carried
    # value: MPC rollout chains with contact switches keep a higher floor
    # (0.1) because a newly-active wrench bound needs O(rho) primal
    # enforcement speed.
    rho_scale = (jnp.clip(state.rho_scale, rho_scale_min, 1.0)
                 if state.rho_scale is not None
                 else jnp.asarray(1.0, dtype))
    Kinv_warm = state.Kinv
    Kinv = None

    def _ns_warm(K, X_guess, iters_, cold_iters_=None):
        """NS iteration hot-started from ``X_guess``, guarded by the
        contraction bound sqrt(||E||_1 ||E||_inf) < 0.9 (a max-entry check
        is NOT a norm bound and let divergent warm starts through); falls
        back to a cold init, and never returns non-finite.

        The cold fallback is the JACOBI-PRESCALED init expressed in the
        original space: NS is equivariant under X0 -> D X0s D with
        K -> D^-1 Ks D^-1, so X0 = D^2 / ||D K D||_1 runs the exact
        prescaled iteration without leaving this scan. A plain
        I / ||K||_1 init needs ~log2(cond(K)) doublings — on mixed-unit
        WBC KKT matrices that exceeds short budgets and a single guard
        rejection then poisons the whole warm chain with a ~90%-wrong
        torque that PRIMAL health cannot see (measured).

        ``cold_iters_``: separate (larger) NS budget for guard-rejected /
        first ticks. A trimmed RT profile (warm budget 4) leaves the
        prescaled COLD start ~3% off even at cond~5; a lax.cond keeps the
        warm fast path at its short budget while rare cold ticks pay the
        full budget (in the unbatched 1 kHz loop only the taken branch
        executes; under vmap both run, so rollout profiles keep
        cold_iters_ == iters_)."""
        I_n = jnp.eye(n, dtype=dtype)
        E = I_n - X_guess @ K
        absE = jnp.abs(E)
        err = jnp.sqrt(jnp.max(jnp.sum(absE, axis=0)) *
                       jnp.max(jnp.sum(absE, axis=1)))
        err = jnp.where(jnp.isfinite(err), err, jnp.asarray(2.0, dtype))
        dg = jnp.einsum("ii->i", K)
        dinv = 1.0 / jnp.maximum(dg, 1e-30)               # D^2 diagonal
        Ks_norm1 = jnp.max(jnp.sum(
            jnp.abs(K) * jnp.sqrt(dinv)[:, None] * jnp.sqrt(dinv)[None, :],
            axis=0))
        cold = jnp.diag(dinv / jnp.maximum(Ks_norm1, 1e-30))
        warm_ok = err < 0.9

        def ns_body(X, _):
            return X @ (2.0 * I_n - K @ X), None

        def _run(X0, length):
            X, _ = jax.lax.scan(ns_body, X0, None, length=length)
            return X

        if cold_iters_ is None or cold_iters_ == iters_:
            X = _run(jnp.where(warm_ok, X_guess, cold), iters_)
        else:
            X = jax.lax.cond(warm_ok,
                             lambda: _run(X_guess, iters_),
                             lambda: _run(cold, cold_iters_))
        return jnp.where(jnp.all(jnp.isfinite(X)), X, cold)

    for chunk_i in range(n_chunks):
        rho_v = rho_base * rho_scale
        if has_eq:
            # K~ = P_N (P + A^T rho A) P_N + sigma I + pin (I - P_N):
            # block-diagonal w.r.t. the range/null split of P_N, so Kinv
            # preserves the tangent space; the pin term only conditions the
            # (solution-irrelevant) null component.
            M0 = P + (A.T * rho_v) @ A
            pin = eq_pin * (jnp.trace(M0) / n)
            K = Pn @ M0 @ Pn + sigma * I_n + pin * (I_n - Pn)
        else:
            K = P + sigma * I_n + (A.T * rho_v) @ A
        # Explicit inverse: K is strongly SPD (sigma shift); iterations then
        # are pure matvecs (batched under vmap). inv_method="ns" keeps even
        # the inversion matmul-only (no triangular solves).
        if (assume_warm_kinv and chunk_i == 0 and Kinv_warm is not None
                and inv_method == "ns"):
            # Hot-start from the last tick's inverse: at 1 kHz the KKT matrix
            # changes slowly and NS re-converges in a few matmuls (the
            # qpOASES hot-start analog). Chunk 0 ONLY: later chunks see a rho
            # change, and a short warm NS there yields an inaccurate inverse
            # that silently floors the dual residual — measured as a humanoid
            # sinking 16 cm in closed loop. They pay the full cold NS.
            Kinv = _ns_warm(K, Kinv_warm, warm_kinv_iters,
                            cold_iters_=cold_ns_iters)
        else:
            # ``cold_ns_iters`` trims the cold inversion budget where the
            # KKT matrix is known well-conditioned (equality-eliminated
            # stacks: cond ~5 needs ~7 iterations, not the safe default 24).
            kw = ({"iters": cold_ns_iters}
                  if (cold_ns_iters is not None and inv_method == "ns")
                  else {})
            Kinv = linalg.spd_inverse(K, method=inv_method, **kw)

        def body(carry, _):
            x, z, y = carry
            rhs = sigma * x - q_eff + A.T @ (rho_v * z - y)
            x_t = Kinv @ rhs
            if has_eq:
                # re-project: floating-point drift into null(P_N) would
                # otherwise leak through z_t = A x_t
                x_t = Pn @ x_t
            z_t = A @ x_t
            x_n = alpha * x_t + (1 - alpha) * x
            z_r = alpha * z_t + (1 - alpha) * z
            z_n = jnp.clip(z_r + y / rho_v, l, u)
            y_n = y + rho_v * (z_r - z_n)
            return (x_n, z_n, y_n), None

        (x, z, y), _ = jax.lax.scan(body, (x, z, y), None, length=chunk)

        prim, dual = _rel_residuals(P, q_eff, A, x, z, y, Pn=Pn)
        factor = jnp.clip(jnp.sqrt(prim / jnp.maximum(dual, 1e-12)), 0.1, 10.0)
        # Gate the update: when BOTH residuals are already below
        # ``rho_adapt_tol`` the ratio is warm-start noise, and repeatedly
        # applying it drifts rho_scale to its floor across ticks — measured
        # as a one-step primal blow-up (prim 0.2 vs dual 1e-4) at the next
        # contact transition in pushed humanoid MPC rollouts.
        adapt = jnp.maximum(prim, dual) > rho_adapt_tol
        factor = jnp.where(adapt, factor, jnp.ones_like(factor))
        rho_scale = jnp.clip(rho_scale * factor, rho_scale_min, 1e2)

    # --- unscale ---------------------------------------------------------
    if has_eq:
        xs = x + x_p                       # xi is projected, so x = x_p + xi
        x = d * xs
        z_in = (z + Ax_p) / jnp.maximum(e, 1e-30)
        y_in = e * y
        # recover equality multipliers from stationarity:
        # P x + q + A_in^T y + E^T y_eq = 0  (scaled, then unscale by R);
        # (E^T)^+ = (E^+)^T = EpT^T with the NS-refined pseudo-inverse
        nu = -(EpT.T @ (P @ xs + q + A.T @ y))
        y_eq = R_eq * nu
        z_eq = b_e0
        z = jnp.concatenate([z_eq[:h_eq], z_in, z_eq[h_eq:]])
        y = jnp.concatenate([y_eq[:h_eq], y_in, y_eq[h_eq:]])
    else:
        x = d * x
        z = z / jnp.maximum(e, 1e-30)
        y = e * y

    if refine > 0:
        for _ in range(polish_rounds):
            x, y = _polish(P0, q0, A0, l0, u0, x, y, steps=refine,
                           inv_method=inv_method, ns_iters=polish_ns_iters)
        z = jnp.clip(A0 @ x, l0, u0)

    prim, dual = _rel_residuals(P0, q0, A0, x, z, y)
    obj = 0.5 * x @ P0 @ x + q0 @ x
    return x, QPState(x=x, z=z, y=y, Kinv=Kinv, rho_scale=rho_scale), QPInfo(
        prim_res=prim, dual_res=dual, obj=obj)


def _polish(P, q, A, l, u, x, y, steps: int, eps_active: float = 1e-4,
            inv_method: str = "ns", ns_iters: int = 24):
    """Active-set polish (OSQP-style): treat near-active rows as equalities
    and solve the equality-constrained KKT system by Schur complement with
    matmul-only inverses + iterative refinement (see opt/linalg.py).
    Shape-static: inactive rows are zeroed rather than removed.

    Active rows are detected from BOTH primal proximity and dual sign
    (y > 0 -> upper side, y < 0 -> lower side, OSQP convention): a
    mid-convergence ADMM iterate can hover O(1e-2) away from a truly active
    bound, where primal proximity alone misses it — measured as a 1-10 Nm
    torque error on saturated WBC ticks that the dual-signed detection
    eliminates."""
    n = P.shape[0]
    dtype = P.dtype
    Ax = A @ x
    y_scale = jnp.max(jnp.abs(y)) + 1e-12
    lo_act = ((Ax - l) < eps_active * (1.0 + jnp.abs(l))) | \
        (y < -1e-6 * y_scale)
    hi_act = ((u - Ax) < eps_active * (1.0 + jnp.abs(u))) | \
        (y > 1e-6 * y_scale)
    # equality rows (l == u) are always active on the "upper" side
    eq = (u - l) < 1e-12 * (1.0 + jnp.abs(u))
    hi_act = hi_act | eq
    lo_act = lo_act & ~hi_act
    act = jnp.logical_or(lo_act, hi_act)
    b_act = jnp.where(hi_act, u, l)
    Aa = A * act[:, None].astype(dtype)
    ba = jnp.where(act, b_act, 0.0).astype(dtype)

    delta = 1e-6 * (1.0 + jnp.trace(P) / n)
    row_reg = jnp.where(act, delta, 1.0).astype(dtype)
    x_p, y_sol = linalg.kkt_solve_schur(P, Aa, -q, ba, delta,
                                        method=inv_method,
                                        refine=max(2, steps),
                                        row_reg=row_reg, ns_iters=ns_iters)
    y_p = jnp.where(act, y_sol, 0.0)

    # Accept polish only if it does not violate inactive constraints and
    # improves the dual residual (guards against a wrong active-set guess).
    Axp = A @ x_p
    scale_l = 1e-6 * (1.0 + jnp.abs(l))
    scale_u = 1e-6 * (1.0 + jnp.abs(u))
    feas = jnp.all(Axp >= l - scale_l) & jnp.all(Axp <= u + scale_u)
    dual_old = jnp.max(jnp.abs(P @ x + q + A.T @ y))
    dual_new = jnp.max(jnp.abs(P @ x_p + q + A.T @ y_p))
    ok = feas & (dual_new <= dual_old + 1e-12) & jnp.all(jnp.isfinite(x_p))
    x = jnp.where(ok, x_p, x)
    y = jnp.where(ok, y_p, y)
    return x, y


def solve_batch(problems: QPProblem, states: Optional[QPState] = None, **kw):
    """vmapped solve over a leading batch axis on every leaf."""
    fn = partial(solve, **kw)
    if states is None:
        return jax.vmap(lambda p: fn(p))(problems)
    return jax.vmap(fn)(problems, states)
