"""iLQR / DDP trajectory optimizer, batched for XLA.

The north star's "DDP-style MPC" layer (greenfield; the reference plans
nothing). Design for XLA:

- **Fixed iteration counts** everywhere (outer iterations, backward pass,
  line-search candidates) — one static program, no data-dependent shapes.
- **Backward pass** is a ``lax.scan`` over the horizon; the Q_uu inverse is
  Newton-Schulz (matmul-only, opt/linalg.py) — no factorization.
- **Parallel line search**: all step sizes are rolled out simultaneously
  under ``vmap`` and the argmin-cost candidate is selected — trading a few
  extra (cheap, batched) rollouts for zero sequential trial-and-error,
  which is the trade a batched accelerator favours.
- Levenberg-Marquardt regularization adapts across the fixed outer
  iterations via carried state (no while_loop restarts).

Generic over (dynamics_fn, cost_fn, final_cost_fn); used with
mpc/centroidal.py for legged MPC, tested against an analytic LQR.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from qppvm_tpu.opt import linalg
from qppvm_tpu.precision import f32_matmuls


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    iterations: int = 10
    alphas: tuple = (1.0, 0.6, 0.3, 0.1, 0.03, 0.0)  # 0.0 = keep current
    reg_init: float = 1e-6
    reg_up: float = 10.0
    reg_down: float = 0.5
    reg_min: float = 1e-9
    reg_max: float = 1e6
    u_min: Optional[float] = None   # optional box clamp on controls
    u_max: Optional[float] = None


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ILQRResult:
    U: jax.Array        # (H, nu) optimized controls
    X: jax.Array        # (H+1, nx) optimized trajectory
    cost: jax.Array     # () final cost
    K: jax.Array        # (H, nu, nx) feedback gains (for tracking)
    k: jax.Array        # (H, nu) feedforward
    reg: jax.Array      # () final LM regularization


def _rollout(dyn, cost, final_cost, x0, U):
    def step(x, u):
        xn = dyn(x, u)
        return xn, (x, cost(x, u))
    xH, (X, cs) = jax.lax.scan(step, x0, U)
    total = jnp.sum(cs) + final_cost(xH)
    return jnp.concatenate([X, xH[None]], axis=0), total


def _rollout_feedback(dyn, cost, final_cost, x0, X_ref, U_ref, K, k, alpha,
                      u_min, u_max):
    def step(x, inp):
        x_r, u_r, K_t, k_t = inp
        u = u_r + alpha * k_t + K_t @ (x - x_r)
        if u_min is not None or u_max is not None:
            u = jnp.clip(u, u_min, u_max)
        xn = dyn(x, u)
        return xn, (x, u, cost(x, u))
    xH, (X, U, cs) = jax.lax.scan(step, x0, (X_ref[:-1], U_ref, K, k))
    total = jnp.sum(cs) + final_cost(xH)
    return jnp.concatenate([X, xH[None]], 0), U, total


def make_solver(dyn: Callable, cost: Callable, final_cost: Callable,
                cfg: ILQRConfig = ILQRConfig()):
    """Returns solve(x0, U0) -> ILQRResult, fully jittable."""

    fx = jax.jacfwd(dyn, argnums=0)
    fu = jax.jacfwd(dyn, argnums=1)
    cx = jax.grad(cost, argnums=0)
    cu = jax.grad(cost, argnums=1)
    cxx = jax.hessian(cost, argnums=0)
    cuu = jax.hessian(cost, argnums=1)
    cux = jax.jacfwd(jax.grad(cost, argnums=1), argnums=0)
    vx_f = jax.grad(final_cost)
    vxx_f = jax.hessian(final_cost)

    def backward(X, U, reg):
        nx = X.shape[1]
        nu_ = U.shape[1]

        def step(carry, inp):
            Vx, Vxx = carry
            x, u = inp
            A = fx(x, u)
            Bm = fu(x, u)
            Qx = cx(x, u) + A.T @ Vx
            Qu = cu(x, u) + Bm.T @ Vx
            Qxx = cxx(x, u) + A.T @ Vxx @ A
            Quu = cuu(x, u) + Bm.T @ Vxx @ Bm
            Qux = cux(x, u) + Bm.T @ Vxx @ A
            Quu_r = Quu + reg * jnp.eye(nu_, dtype=U.dtype)
            # matmul-only inverse; Quu_r is SPD by LM regularization
            Quu_inv = linalg.spd_inverse_ns(Quu_r, iters=20, refine=2)
            k_t = -(Quu_inv @ Qu)
            K_t = -(Quu_inv @ Qux)
            Vx_n = Qx + K_t.T @ Quu @ k_t + K_t.T @ Qu + Qux.T @ k_t
            Vxx_n = Qxx + K_t.T @ Quu @ K_t + K_t.T @ Qux + Qux.T @ K_t
            Vxx_n = 0.5 * (Vxx_n + Vxx_n.T)
            dv = -0.5 * (k_t @ Quu_r @ k_t) - k_t @ Qu
            return (Vx_n, Vxx_n), (K_t, k_t, dv)

        xH = X[-1]
        (Vx0, Vxx0), (K, k, dvs) = jax.lax.scan(
            step, (vx_f(xH), vxx_f(xH)), (X[:-1], U), reverse=True)
        return K, k, jnp.sum(dvs)

    @f32_matmuls
    def solve(x0, U0) -> ILQRResult:
        X0, c0 = _rollout(dyn, cost, final_cost, x0, U0)
        alphas = jnp.asarray(cfg.alphas, X0.dtype)

        def outer(carry, _):
            X, U, c, reg = carry
            K, k, _dv = backward(X, U, reg)

            def try_alpha(a):
                Xa, Ua, ca = _rollout_feedback(
                    dyn, cost, final_cost, x0, X, U, K, k, a,
                    cfg.u_min, cfg.u_max)
                return Xa, Ua, ca

            Xs, Us, costs = jax.vmap(try_alpha)(alphas)
            costs = jnp.where(jnp.isfinite(costs), costs, jnp.inf)
            best = jnp.argmin(costs)
            improved = costs[best] < c - 1e-10
            X_n = jnp.where(improved, Xs[best], X)
            U_n = jnp.where(improved, Us[best], U)
            c_n = jnp.where(improved, costs[best], c)
            reg_n = jnp.clip(
                jnp.where(improved, reg * cfg.reg_down, reg * cfg.reg_up),
                cfg.reg_min, cfg.reg_max)
            return (X_n, U_n, c_n, reg_n), c_n

        reg0 = jnp.asarray(cfg.reg_init, X0.dtype)
        (X, U, c, reg), _ = jax.lax.scan(
            outer, (X0, U0, c0, reg0), None, length=cfg.iterations)
        K, k, _ = backward(X, U, reg)
        return ILQRResult(U=U, X=X, cost=c, K=K, k=k, reg=reg)

    return solve
