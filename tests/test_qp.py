"""QP solver tests vs a trusted CPU oracle (scipy) + KKT checks.

Mirrors SURVEY.md §4: "QP kernel tests vs a CPU reference solver (KKT
residuals, ... dense random + structured WBC problems)".
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize

from qppvm_tpu.opt import hierarchy, qp

DT = jnp.float64


def _random_qp(key, n=12, m=8, eq_rows=2):
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    M = jax.random.normal(k1, (n, n), DT)
    P = M @ M.T + 0.1 * jnp.eye(n, dtype=DT)
    q = jax.random.normal(k2, (n,), DT)
    A = jax.random.normal(k3, (m, n), DT)
    c = jax.random.normal(k4, (m,), DT)
    width = jax.random.uniform(k5, (m,), DT, 0.1, 1.0)
    l = c - width
    u = c + width
    # make the first eq_rows equality rows
    l = l.at[:eq_rows].set(c[:eq_rows])
    u = u.at[:eq_rows].set(c[:eq_rows])
    return qp.QPProblem(P=P, q=q, A=A, l=l, u=u)


def _oracle(prob):
    """scipy SLSQP solve of the same QP."""
    P = np.asarray(prob.P)
    q = np.asarray(prob.q)
    A = np.asarray(prob.A)
    l = np.asarray(prob.l)
    u = np.asarray(prob.u)
    n = P.shape[0]

    def f(x):
        return 0.5 * x @ P @ x + q @ x

    def g(x):
        return P @ x + q

    cons = [
        dict(type="ineq", fun=lambda x: A @ x - l, jac=lambda x: A),
        dict(type="ineq", fun=lambda x: u - A @ x, jac=lambda x: -A),
    ]
    res = scipy.optimize.minimize(f, np.zeros(n), jac=g, constraints=cons,
                                  method="SLSQP",
                                  options=dict(maxiter=500, ftol=1e-12))
    assert res.success, res.message
    return res.x, res.fun


@pytest.mark.parametrize("seed", range(5))
def test_admm_matches_oracle(seed):
    prob = _random_qp(jax.random.PRNGKey(seed))
    x, state, info = qp.solve(prob, iters=200, refine=3)
    x_ref, f_ref = _oracle(prob)
    f_admm = float(info.obj)
    # objective within tight tolerance of oracle optimum
    assert f_admm <= f_ref + 1e-5 * (1 + abs(f_ref))
    # feasibility
    Ax = np.asarray(prob.A) @ np.asarray(x)
    assert np.all(Ax >= np.asarray(prob.l) - 1e-6)
    assert np.all(Ax <= np.asarray(prob.u) + 1e-6)
    np.testing.assert_allclose(np.asarray(x), x_ref, atol=5e-4)


def test_warm_start_speeds_convergence():
    """A second solve warm-started at the optimum needs very few iterations."""
    prob = _random_qp(jax.random.PRNGKey(42))
    x, state, _ = qp.solve(prob, iters=300, refine=3)
    x2, _, info2 = qp.solve(prob, state, iters=5, refine=1)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x), atol=1e-6)
    assert float(info2.prim_res) < 1e-6


def test_equality_rows_respected():
    prob = _random_qp(jax.random.PRNGKey(3), eq_rows=3)
    x, _, _ = qp.solve(prob, iters=200, refine=3)
    Ax = np.asarray(prob.A @ x)
    np.testing.assert_allclose(Ax[:3], np.asarray(prob.l[:3]), atol=1e-6)


def test_unconstrained_matches_direct():
    key = jax.random.PRNGKey(7)
    prob = _random_qp(key)
    loose = qp.QPProblem(P=prob.P, q=prob.q, A=prob.A,
                         l=jnp.full_like(prob.l, -1e20),
                         u=jnp.full_like(prob.u, 1e20))
    x, _, _ = qp.solve(loose, iters=100, refine=2)
    x_direct = jnp.linalg.solve(prob.P, -prob.q)
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_direct), atol=1e-6)


def test_vmap_batch():
    keys = jax.random.split(jax.random.PRNGKey(0), 16)
    probs = jax.vmap(_random_qp)(keys)
    xs, states, infos = qp.solve_batch(probs, iters=200, refine=2)
    assert xs.shape == (16, 12)
    assert np.all(np.asarray(infos.prim_res) < 1e-5)
    # each matches its own single solve
    x0, _, _ = qp.solve(jax.tree.map(lambda a: a[3], probs), iters=200,
                        refine=2)
    np.testing.assert_allclose(np.asarray(xs[3]), np.asarray(x0), atol=1e-8)


def test_jit_compiles_and_matches():
    prob = _random_qp(jax.random.PRNGKey(9))
    solve_j = jax.jit(lambda p: qp.solve(p, iters=200, refine=2)[0])
    x_j = solve_j(prob)
    x_e, _, _ = qp.solve(prob, iters=200, refine=2)
    np.testing.assert_allclose(np.asarray(x_j), np.asarray(x_e), atol=1e-9)


# ---------------------------------------------------------------------------
# hierarchy semantics
# ---------------------------------------------------------------------------

def test_cascade_nullspace_semantics():
    """Level-1 objective must not disturb level-0 optimality (the `/` operator
    semantics of /root/reference/src/QPPVMPlugin.cpp:177-179)."""
    key = jax.random.PRNGKey(11)
    n = 10
    k1, k2, k3, k4 = jax.random.split(key, 4)
    A0 = jax.random.normal(k1, (3, n), DT)   # rank-3 -> 7-dim null space
    b0 = jax.random.normal(k2, (3,), DT)
    A1 = jnp.eye(n, dtype=DT)
    b1 = jax.random.normal(k3, (n,), DT)
    stack = hierarchy.StackData(
        levels=(hierarchy.LevelData(A=A0, b=b0), hierarchy.LevelData(A=A1, b=b1)),
        C=jnp.zeros((0, n), DT), lC=jnp.zeros((0,), DT), uC=jnp.zeros((0,), DT),
        lb=jnp.full((n,), -1e20, DT), ub=jnp.full((n,), 1e20, DT),
    )
    x, warm, infos = hierarchy.solve(stack, eps=1.0, iters=200, refine=3)
    # level 0 task achieved as well as unconstrained least squares
    r0 = np.linalg.norm(np.asarray(A0 @ x - b0))
    x_ls = np.linalg.lstsq(np.asarray(A0), np.asarray(b0), rcond=None)[0]
    r0_opt = np.linalg.norm(np.asarray(A0) @ x_ls - np.asarray(b0))
    assert r0 <= r0_opt + 1e-5
    # level 1 optimal within the null space: compare against analytic
    # x* = x0_ls + N z*, z* = argmin ||N z - (b1 - x0_particular)||
    # (use projector-based check: gradient of level-1 objective is orthogonal
    #  to null(A0) at the solution)
    g1 = np.asarray(A1.T @ (A1 @ x - b1))
    N = _nullspace(np.asarray(A0))
    assert np.linalg.norm(N.T @ g1) < 5e-3 * max(1.0, np.linalg.norm(g1))
    assert not bool(hierarchy.solve_failed(infos))


def _nullspace(A):
    _, s, vt = np.linalg.svd(A)
    rank = int(np.sum(s > 1e-10))
    return vt[rank:].T


def test_cascade_with_bounds():
    """Bounds bind at both levels (torque-limit semantics,
    /root/reference/src/QPPVMPlugin.cpp:177-179 << _torque_limits)."""
    n = 6
    A0 = jnp.zeros((2, n), DT).at[0, 0].set(1.0).at[1, 1].set(1.0)
    b0 = jnp.asarray([5.0, -5.0], DT)
    A1 = jnp.eye(n, dtype=DT)
    b1 = jnp.full((n,), 3.0, DT)
    stack = hierarchy.StackData(
        levels=(hierarchy.LevelData(A=A0, b=b0), hierarchy.LevelData(A=A1, b=b1)),
        C=jnp.zeros((0, n), DT), lC=jnp.zeros((0,), DT), uC=jnp.zeros((0,), DT),
        lb=jnp.full((n,), -1.0, DT), ub=jnp.full((n,), 1.0, DT),
    )
    x, _, infos = hierarchy.solve(stack, iters=300, refine=3)
    x = np.asarray(x)
    np.testing.assert_allclose(x[0], 1.0, atol=1e-6)   # clamped at ub
    np.testing.assert_allclose(x[1], -1.0, atol=1e-6)  # clamped at lb
    np.testing.assert_allclose(x[2:], 1.0, atol=1e-6)  # level-1 wants 3 -> ub
    assert not bool(hierarchy.solve_failed(infos))


def test_infeasible_detected():
    n = 4
    C = jnp.zeros((2, n), DT).at[0, 0].set(1.0).at[1, 0].set(1.0)
    lC = jnp.asarray([2.0, -10.0], DT)
    uC = jnp.asarray([10.0, -2.0], DT)   # x0 >= 2 and x0 <= -2: infeasible
    stack = hierarchy.StackData(
        levels=(hierarchy.LevelData(A=jnp.eye(n, dtype=DT), b=jnp.zeros(n, DT)),),
        C=C, lC=lC, uC=uC,
        lb=jnp.full((n,), -1e20, DT), ub=jnp.full((n,), 1e20, DT),
    )
    x, _, infos = hierarchy.solve(stack, iters=100, refine=0)
    assert bool(hierarchy.solve_failed(infos))


# ---------------------------------------------------------------------------
# equality elimination (opt/qp.py n_eq_head / n_eq_tail)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_eq_elim_matches_oracle(seed):
    """Structural-equality elimination (head rows) must match the oracle and
    satisfy the equalities to near machine precision — tighter than the
    rho-boost path it replaces."""
    prob = _random_qp(jax.random.PRNGKey(100 + seed), eq_rows=3)
    x, _, info = qp.solve(prob, iters=200, refine=3, n_eq_head=3)
    x_ref, f_ref = _oracle(prob)
    np.testing.assert_allclose(np.asarray(x), x_ref, atol=5e-4)
    Ax = np.asarray(prob.A @ x)
    np.testing.assert_allclose(Ax[:3], np.asarray(prob.l[:3]), atol=1e-7)
    assert float(info.obj) <= f_ref + 1e-5 * (1 + abs(f_ref))


def test_eq_elim_tail_rows():
    """Tail equality block (the cascade's locked rows live at the END of A)."""
    prob = _random_qp(jax.random.PRNGKey(4), eq_rows=2)
    # move the 2 equality rows to the tail
    perm = jnp.concatenate([jnp.arange(2, 8), jnp.arange(2)])
    prob_t = qp.QPProblem(P=prob.P, q=prob.q, A=prob.A[perm],
                          l=prob.l[perm], u=prob.u[perm])
    x_h, _, _ = qp.solve(prob, iters=200, refine=3, n_eq_head=2)
    x_t, _, _ = qp.solve(prob_t, iters=200, refine=3, n_eq_tail=2)
    np.testing.assert_allclose(np.asarray(x_t), np.asarray(x_h), atol=1e-6)


def test_eq_elim_warm_start_and_vmap():
    """Warm-started re-solve converges instantly; vmap works with the
    static eq args."""
    from functools import partial
    prob = _random_qp(jax.random.PRNGKey(5), eq_rows=3)
    x, state, _ = qp.solve(prob, iters=300, refine=3, n_eq_head=3)
    x2, _, info2 = qp.solve(prob, state, iters=5, refine=1, n_eq_head=3)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x), atol=1e-6)
    assert float(info2.prim_res) < 1e-6

    keys = jax.random.split(jax.random.PRNGKey(6), 8)
    probs = jax.vmap(partial(_random_qp, eq_rows=3))(keys)
    xs, _, infos = jax.vmap(
        lambda p: qp.solve(p, iters=200, refine=2, n_eq_head=3))(probs)
    assert np.all(np.asarray(infos.prim_res) < 1e-5)
    x3, _, _ = qp.solve(jax.tree.map(lambda a: a[3], probs), iters=200,
                        refine=2, n_eq_head=3)
    np.testing.assert_allclose(np.asarray(xs[3]), np.asarray(x3), atol=1e-8)


def test_eq_elim_redundant_equalities():
    """Duplicated equality rows (rank-deficient E) must not break the Gram
    inverse — the delta shift turns the lock into least-squares."""
    prob = _random_qp(jax.random.PRNGKey(8), eq_rows=2)
    A = jnp.concatenate([prob.A[:2], prob.A], axis=0)  # duplicate eq rows
    l = jnp.concatenate([prob.l[:2], prob.l])
    u = jnp.concatenate([prob.u[:2], prob.u])
    prob_r = qp.QPProblem(P=prob.P, q=prob.q, A=A, l=l, u=u)
    x_r, _, _ = qp.solve(prob_r, iters=200, refine=3, n_eq_head=4)
    x_h, _, _ = qp.solve(prob, iters=200, refine=3, n_eq_head=2)
    np.testing.assert_allclose(np.asarray(x_r), np.asarray(x_h), atol=1e-5)


def test_eq_elim_near_parallel_equality_rows():
    """Nearly-linearly-dependent equality rows (1e-3 apart, CONSISTENT rhs):
    the Gram delta shift (1e-6) is comparable to the small eigenvalue
    lambda_2 = 1 - cos(1e-3) ~ 5e-7, so the unrefined projector leaks O(1)
    in the weak direction — the Newton refinements must keep the physical
    equality residual tight anyway (only exact duplicates were
    covered before)."""
    n = 12
    key = jax.random.PRNGKey(42)
    k1, k2, k3 = jax.random.split(key, 3)
    prob = _random_qp(k1, n=n, m=8, eq_rows=0)
    x_star = jax.random.normal(k2, (n,), DT)
    e1 = jax.random.normal(k3, (n,), DT)
    e1 = e1 / jnp.linalg.norm(e1)
    v = jax.random.normal(jax.random.PRNGKey(43), (n,), DT)
    v = v - (v @ e1) * e1
    v = v / jnp.linalg.norm(v)
    e2 = e1 + 1e-3 * v
    e2 = e2 / jnp.linalg.norm(e2)
    E = jnp.stack([e1, e2])
    be = E @ x_star                     # consistent rhs, bounded solution
    A = jnp.concatenate([E, prob.A], axis=0)
    l = jnp.concatenate([be, prob.l])
    u = jnp.concatenate([be, prob.u])
    prob_np = qp.QPProblem(P=prob.P, q=prob.q, A=A, l=l, u=u)
    x, _, _ = qp.solve(prob_np, iters=300, refine=3, n_eq_head=2)
    # equality residual in PHYSICAL units stays at solver precision even in
    # the near-degenerate lock direction
    res = np.asarray(E @ x - be)
    np.testing.assert_allclose(res, 0.0, atol=1e-6)
    x_ref, _ = _oracle(prob_np)
    np.testing.assert_allclose(np.asarray(x), x_ref, atol=1e-3)


def test_eq_elim_runtime_gated_equality_stays_inequality_block():
    """A row whose l == u only at RUNTIME (contact-switch gate) sits in the
    inequality block; the rho boost there still enforces it."""
    prob = _random_qp(jax.random.PRNGKey(12), eq_rows=3)
    # rows 0..2 structurally eliminated; make row 3 a runtime equality
    l = prob.l.at[3].set(prob.u[3])
    prob_g = qp.QPProblem(P=prob.P, q=prob.q, A=prob.A, l=l, u=prob.u)
    x, _, _ = qp.solve(prob_g, iters=300, refine=3, n_eq_head=3)
    Ax = np.asarray(prob_g.A @ x)
    np.testing.assert_allclose(Ax[3], float(prob_g.u[3]), atol=1e-5)
    x_ref, _ = _oracle(prob_g)
    np.testing.assert_allclose(np.asarray(x), x_ref, atol=5e-4)
