"""Hierarchical (prioritized) QP cascade.

Reproduces the semantics of OpenSoT's ``QPOases_sot``
(/root/reference/src/QPPVMPlugin.cpp:188,246; /root/reference/src/ForceAcc.cpp:135-137):
one QP per priority level; level k minimizes its own task residual plus an
eps-regularization, subject to the stack's constraints/bounds AND equality
locks ``A_j x = A_j x_j*`` for every higher-priority level j < k, so lower
levels act only in the null space of higher ones.

All level shapes are static, so the full cascade jits into one XLA program;
warm-start state is a per-level list of ``QPState``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from qppvm_tpu.opt import qp
from qppvm_tpu.precision import f32_matmuls


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LevelData:
    """One priority level: minimize ||A x - b||^2 (rows pre-weighted)."""

    A: jax.Array  # (k, n)
    b: jax.Array  # (k,)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StackData:
    """Numeric data of a whole prioritized stack for one control tick."""

    levels: Tuple[LevelData, ...]
    C: jax.Array   # (mc, n) general constraint rows (may be 0-row)
    lC: jax.Array  # (mc,)
    uC: jax.Array  # (mc,)
    lb: jax.Array  # (n,) box bounds on x (torque limits etc.)
    ub: jax.Array  # (n,)
    # STATIC: the first n_eq rows of C are structural equalities (e.g.
    # DynamicFeasibility) — the solver eliminates them by projection
    # instead of penalizing them (see opt/qp.py n_eq_head).
    n_eq: int = dataclasses.field(metadata=dict(static=True), default=0)
    # STATIC: False when NO constraint in the stack is a box on x (e.g. the
    # ForceAcc stacks: wrench bounds are ROWS on affine expressions, and
    # x itself is unbounded). The solver then drops the identity block
    # entirely — on the humanoid ForceAcc stack that is 44 of ~94 ADMM
    # constraint rows that would otherwise be carried at +/-1e20 bounds.
    has_box: bool = dataclasses.field(metadata=dict(static=True),
                                      default=True)


def warm_start_init(stack: StackData) -> Tuple[qp.QPState, ...]:
    n = stack.lb.shape[0]
    mc = stack.C.shape[0] + (n if stack.has_box else 0)
    states = []
    extra = 0
    for lv in stack.levels:
        m = mc + extra
        states.append(qp.QPState.zero(n, m, stack.lb.dtype))
        extra += lv.A.shape[0]
    return tuple(states)


@f32_matmuls
def solve(
    stack: StackData,
    warm: Optional[Tuple[qp.QPState, ...]] = None,
    *,
    eps: float = 1.0,
    eps_abs_scale: float = 1e-8,
    iters: int = 80,
    refine: int = 2,
    rho: float = 0.1,
    rho_updates: int = 3,
    polish_rounds: int = 2,
    assume_warm_kinv: bool = False,
    polish_ns_iters: int = 24,
    warm_kinv_iters: int = 12,
    rho_adapt_tol: float = 0.0,
    rho_scale_min: float = 1e-2,
    cold_ns_iters: Optional[int] = None,
    scale_iters: int = 5,
    pinv_ns_iters: int = 7,
    reg_diag: Optional[jax.Array] = None,
    method: str = "admm",
    pdip_iters: int = 25,
    per_level_opts: Optional[Sequence[Optional[dict]]] = None,
    eq_elim: bool = True,
):
    """Solve the cascade. Returns (x, warm_states, infos).

    ``eps`` is the OpenSoT-style regularization knob (1.0 in QPPVM at
    /root/reference/src/QPPVMPlugin.cpp:188, 1e4 in ForceAcc at
    /root/reference/src/ForceAcc.cpp:137); the effective Tikhonov weight is
    ``eps * eps_abs_scale * (mean(diag(A^T A)) + 1)``. ``eps_abs_scale`` is
    deliberately tiny: like qpOASES' epsRegularisation, eps must resolve
    redundancy (e.g. the contact-force null space) and condition the KKT
    system WITHOUT fighting the tasks — a too-large weight makes the solver
    prefer small contact forces over supporting the robot's weight.

    ``reg_diag`` (n,) scales the Tikhonov weight per decision variable.
    Use it to pin objective-nullspace variables (e.g. the contact-wrench
    block of a ForceAcc stack, whose distribution no task objective sees)
    with an O(0.1) proximal weight while leaving task-determined variables
    (qddot) nearly unregularized. The proximal center is the warm-start
    solution, so there is no steady-state bias — but the FIRST solve of a
    session must be seeded against zero-bias (see ForceAccPlugin.on_start's
    two-phase seed): regularizing toward x=0 makes small contact forces
    cheaper than supporting the robot's weight.

    ``method`` selects the per-level QP backend: "admm" (warm-started
    first-order, the 1 kHz default) or "pdip" (Mehrotra interior point,
    opt/pdip.py) — the analog of qpOASES ``setToReliable``
    (/root/reference/src/QPPVMPlugin.cpp:190-196). PDIP costs ~2 KKT solves
    per iteration but is exact on heavily-saturated / sliver-feasible-set
    QPs where first-order methods crawl (measured: all-joints-saturated
    torque cascades, ADMM 1-10 Nm off at 300 iterations, PDIP at 1e-8).

    ``eq_elim`` (static): eliminate structural equalities (the stack's
    leading ``n_eq`` constraint rows, e.g. DynamicFeasibility, plus the
    cascade's equality locks) by nullspace projection inside the ADMM
    backend (opt/qp.py ``n_eq_head``/``n_eq_tail``) instead of penalizing
    them with a boosted rho. Exact locks — closer to qpOASES cascade
    semantics — and an orders-of-magnitude better-conditioned ADMM matrix.

    ``per_level_opts`` overrides solver keywords for individual cascade
    levels — the analog of ``QPOases_sot::setOptions(level, opts)`` /
    ``PL_LOW`` (/root/reference/src/QPPVMPlugin.cpp:190-196): entry k (a
    dict of any of this function's solver kwargs, e.g. ``{"iters": 160,
    "method": "pdip"}``) is merged over the global options for level k;
    ``None`` keeps the globals.
    """
    n = stack.lb.shape[0]
    dtype = stack.lb.dtype
    I = jnp.eye(n, dtype=dtype)

    x_prev: Optional[jax.Array] = None
    locked_rows: List[jax.Array] = []
    locked_vals: List[jax.Array] = []
    new_states = []
    infos = []

    global_opts = dict(eps=eps, eps_abs_scale=eps_abs_scale, iters=iters,
                       refine=refine, rho=rho, rho_updates=rho_updates,
                       polish_rounds=polish_rounds,
                       assume_warm_kinv=assume_warm_kinv,
                       polish_ns_iters=polish_ns_iters,
                       warm_kinv_iters=warm_kinv_iters,
                       rho_adapt_tol=rho_adapt_tol,
                       rho_scale_min=rho_scale_min,
                       cold_ns_iters=cold_ns_iters,
                       scale_iters=scale_iters,
                       pinv_ns_iters=pinv_ns_iters,
                       method=method, pdip_iters=pdip_iters,
                       eq_elim=eq_elim)

    for k, lv in enumerate(stack.levels):
        opts = dict(global_opts)
        if per_level_opts is not None and k < len(per_level_opts):
            opts.update(per_level_opts[k] or {})
        lvl_eps = opts.pop("eps")
        lvl_eps_scale = opts.pop("eps_abs_scale")
        lvl_reg_diag = opts.pop("reg_diag", reg_diag)

        P = lv.A.T @ lv.A
        reg = lvl_eps * lvl_eps_scale * (jnp.trace(P) / n + 1.0)
        rvec = (reg * jnp.ones(n, dtype) if lvl_reg_diag is None
                else reg * jnp.asarray(lvl_reg_diag, dtype))
        P = P + jnp.diag(rvec)
        qv = -(lv.A.T @ lv.b)
        if warm is not None:
            # Regularize toward the warm-start solution, not toward zero:
            # ||x - x_prev||^2 damps tick-to-tick jitter without biasing
            # sustained solutions (e.g. gravity-supporting contact forces
            # would otherwise sag toward 0 at large eps).
            qv = qv - rvec * warm[k].x

        if stack.has_box:
            rows = [stack.C, I] + locked_rows
            lo = [stack.lC, stack.lb] + locked_vals
            hi = [stack.uC, stack.ub] + locked_vals
        else:
            rows = [stack.C] + locked_rows
            lo = [stack.lC] + locked_vals
            hi = [stack.uC] + locked_vals
        A_full = jnp.concatenate(rows, axis=0)
        l_full = jnp.concatenate(lo, axis=0)
        u_full = jnp.concatenate(hi, axis=0)

        prob = qp.QPProblem(P=P, q=qv, A=A_full, l=l_full, u=u_full)
        st = warm[k] if warm is not None else None
        lvl_method = opts.pop("method")
        lvl_pdip_iters = opts.pop("pdip_iters")
        lvl_eq_elim = opts.pop("eq_elim")
        if lvl_eq_elim and lvl_method != "pdip":
            # row order is [C; I(box); locked...]: the stack's structural
            # equalities lead C, the cascade's equality locks trail.
            opts["n_eq_head"] = stack.n_eq
            opts["n_eq_tail"] = sum(r.shape[0] for r in locked_rows)
        if lvl_method == "pdip":
            from qppvm_tpu.opt import pdip as _pdip
            x, info = _pdip.solve(prob, iters=lvl_pdip_iters)
            base_st = st if st is not None else qp.QPState.zero(
                n, A_full.shape[0], dtype)
            st_new = dataclasses.replace(
                base_st, x=x, z=jnp.clip(A_full @ x, l_full, u_full))
        else:
            x, st_new, info = qp.solve(prob, st, **opts)
        new_states.append(st_new)
        infos.append(info)

        locked_rows.append(lv.A)
        locked_vals.append(lv.A @ x)
        x_prev = x

    return x_prev, tuple(new_states), tuple(infos)


def solve_failed(infos, tol: float = 1e-3) -> jax.Array:
    """Scalar bool: any level left a large *relative* primal residual
    (infeasible / unconverged) — drives the zero-torque fallback that mirrors
    /root/reference/src/QPPVMPlugin.cpp:246-249."""
    bad = jnp.zeros((), dtype=bool)
    for info in infos:
        bad = bad | (info.prim_res > tol) | ~jnp.isfinite(info.obj)
    return bad
