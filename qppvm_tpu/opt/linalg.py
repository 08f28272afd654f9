"""Matmul-only linear algebra for the batched hot path.

Triangular solves and pivoted LU are sequential recurrences that batch
poorly over thousands of small problems. Every factorization in the QP hot
loop is replaced here by Newton-Schulz (NS) iteration (a design choice not
yet measured against batched Cholesky on the GPU):

    X_{k+1} = X_k (2I - K X_k)

which is *pure batched matmul* (quadratic convergence; with the scaled
initialization ||I - X_0 K|| < 1 always holds for SPD K). The CPU/test path
can use exact Cholesky (``method="chol"``) — both paths are numerically
cross-checked in tests/test_linalg.py.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def spd_inverse_chol(K: jax.Array) -> jax.Array:
    """Exact SPD inverse via Cholesky (sequential — CPU/reference path)."""
    L = jnp.linalg.cholesky(K)
    I = jnp.eye(K.shape[-1], dtype=K.dtype)
    Y = jax.scipy.linalg.solve_triangular(L, I, lower=True)
    return jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(L, -1, -2), Y, lower=False)


def spd_inverse_ns(K: jax.Array, iters: int = 24, refine: int = 2) -> jax.Array:
    """SPD inverse by Newton-Schulz; batched-matmul only.

    init: X0 = I / ||K||_1. For SPD K, lambda_max <= ||K||_1, so
    ||I - X0 K||_2 = 1 - lambda_min/||K||_1 < 1 and the error contracts as
    (1 - 1/cond)^(2^k) — about log2(cond)+5 iterations to roundoff.
    ``refine`` extra NS steps run after the main loop in the same dtype.
    """
    n = K.shape[-1]
    I = jnp.eye(n, dtype=K.dtype)
    # Jacobi pre-scaling: K' = D K D with D = diag(K)^(-1/2) — cheap, cuts
    # the condition number of mixed-unit KKT blocks by orders of magnitude.
    dg = jnp.einsum("...ii->...i", K)
    d = jax.lax.rsqrt(jnp.maximum(dg, 1e-30))
    Ks = d[..., :, None] * K * d[..., None, :]
    norm1 = jnp.max(jnp.sum(jnp.abs(Ks), axis=-2), axis=-1)  # max col sum
    scale = 1.0 / jnp.maximum(norm1, 1e-30)
    X = I * scale[..., None, None]

    def body(X, _):
        KX = Ks @ X
        X = X @ (2.0 * I - KX)
        return X, None

    X, _ = jax.lax.scan(body, X, None, length=iters + refine)
    return d[..., :, None] * X * d[..., None, :]


def ns_warm_inverse(K: jax.Array, X_guess: jax.Array,
                    iters: int = 4) -> jax.Array:
    """Newton-Schulz inverse hot-started from ``X_guess`` (e.g. last tick's
    inverse of a slowly-drifting SPD matrix), guarded by the contraction
    bound sqrt(||E||_1 ||E||_inf) < 0.9 with a Jacobi-prescaled cold
    fallback — the same guard/fallback strategy as the QP solver's KKT
    reuse (opt/qp.py _ns_warm), packaged for other slowly-varying inverses
    (mass matrix along an MPC rollout horizon). Batched over leading dims.

    The cold fallback runs the SAME ``iters`` budget (vmap-friendly single
    path); callers whose cold path needs more accuracy should add an
    iterative-refinement step on the solve that consumes the inverse.

    Mid-iteration blow-up (a warm seed that passed the contraction guard
    but overflows in float32) is handled INSIDE the iteration: any step
    producing a non-finite iterate resets to the Jacobi-prescaled cold seed
    and the remaining budget refines from there (the
    fallback is never the raw, un-iterated preconditioner unless the
    blow-up happens on the very last step or ``K`` itself is non-finite,
    in which case no inverse exists to return). Costs one cheap reduction
    per iteration, no extra matmuls."""
    n = K.shape[-1]
    I = jnp.eye(n, dtype=K.dtype)
    E = I - X_guess @ K
    absE = jnp.abs(E)
    err = jnp.sqrt(jnp.max(jnp.sum(absE, axis=-2), axis=-1) *
                   jnp.max(jnp.sum(absE, axis=-1), axis=-1))
    err = jnp.where(jnp.isfinite(err), err, 2.0)
    dg = jnp.einsum("...ii->...i", K)
    dinv = 1.0 / jnp.maximum(dg, 1e-30)
    sq = jnp.sqrt(dinv)
    Ks_norm1 = jnp.max(jnp.sum(
        jnp.abs(K) * sq[..., :, None] * sq[..., None, :], axis=-2), axis=-1)
    cold = (I * (dinv / jnp.maximum(Ks_norm1, 1e-30))[..., None, :])
    X = jnp.where((err < 0.9)[..., None, None], X_guess, cold)

    def body(X, _):
        Xn = X @ (2.0 * I - K @ X)
        bad = ~jnp.all(jnp.isfinite(Xn), axis=(-2, -1), keepdims=True)
        return jnp.where(bad, cold, Xn), None

    X, _ = jax.lax.scan(body, X, None, length=iters)
    return jnp.where(jnp.all(jnp.isfinite(X)), X, cold)


def spd_inverse(K: jax.Array, method: str = "ns", **kw) -> jax.Array:
    if method == "chol":
        return spd_inverse_chol(K)
    return spd_inverse_ns(K, **kw)


def kkt_solve_schur(P, A_act, rhs_x, rhs_y, delta: float, method: str = "ns",
                    refine: int = 3, row_reg=None, ns_iters: int = 24):
    """Solve the (regularized) equality-KKT system

        [P + dI      A^T    ] [x]   [rhs_x]
        [A       -diag(r)   ] [y] = [rhs_y]

    by Schur complement with approximate inverses + iterative refinement —
    matmul-only. ``A_act`` may contain zeroed (inactive) rows; pass
    ``row_reg`` with O(1) entries on those rows (their equation degenerates
    to r*y = -rhs_y, i.e. y -> 0) so the Schur complement stays
    well-conditioned.
    """
    n = P.shape[-1]
    m = A_act.shape[-2]
    dtype = P.dtype
    if row_reg is None:
        # auto-detect all-zero (inactive) rows -> O(1) regularization there
        row_norm = jnp.max(jnp.abs(A_act), axis=-1)
        row_reg = jnp.where(row_norm > 1e-12, delta, 1.0).astype(dtype)
    Pd = P + delta * jnp.eye(n, dtype=dtype)
    kw = {"iters": ns_iters} if method == "ns" else {}
    Pinv = spd_inverse(Pd, method=method, **kw)
    S = A_act @ Pinv @ jnp.swapaxes(A_act, -1, -2)
    S = S + jnp.zeros_like(S).at[..., jnp.arange(m), jnp.arange(m)].set(row_reg)
    Sinv = spd_inverse(S, method=method, **kw)

    def solve_once(rx, ry):
        # y from Schur: (A Pd^-1 A^T + diag(r)) y = A Pd^-1 rx - ry
        t = Pinv @ rx
        y = Sinv @ (A_act @ t - ry)
        x = Pinv @ (rx - jnp.swapaxes(A_act, -1, -2) @ y)
        return x, y

    x, y = solve_once(rhs_x, rhs_y)
    # iterative refinement against the true KKT operator
    for _ in range(refine):
        rx = rhs_x - (Pd @ x + jnp.swapaxes(A_act, -1, -2) @ y)
        ry = rhs_y - (A_act @ x - row_reg * y)
        dx, dy = solve_once(rx, ry)
        x = x + dx
        y = y + dy
    return x, y
