"""Rigid-body dynamics: RNEA, mass matrix, forward dynamics, integration.

Capability parity with the XBot::ModelInterface dynamics the reference uses:
``computeNonlinearTerm`` (/root/reference/src/QPPVMPlugin.cpp:65,264,312),
``computeInverseDynamics`` (/root/reference/src/ForceAcc.cpp:217), the joint
inertia matrix behind ``useInertiaMatrix(true)``
(/root/reference/src/QPPVMPlugin.cpp:117,139), and floating-base support
(``setFloatingBaseState``, /root/reference/src/ForceAcc.cpp:274).

Design notes: the RNEA sweep is a trace-time-unrolled recursion of tiny
fused elementwise ops (cheap, latency-bound); the mass matrix deliberately
uses the dense world-frame form  B = sum_i J_i^T I_i J_i  — O(n^2) flops but
pure batched matmul instead of a sequential CRBA recursion, and it vmaps
cleanly over rollout batches.

Generalized-vector layout (floating): ``[base(6, body-frame, angular-first);
joints(nj)]`` for velocities u, accelerations udot and generalized forces.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from qppvm_tpu.model import kinematics, spatial
from qppvm_tpu.model.robot import RobotModel, RobotState
from qppvm_tpu.precision import f32_matmuls


def _base_gravity_acc(model: RobotModel, state: RobotState):
    """Fictitious root acceleration implementing gravity (body coords)."""
    g = model.gravity.astype(state.q.dtype)
    lin = -jnp.einsum("ji,j->i", state.base_rot, g)  # R^T (-g)
    return jnp.concatenate([jnp.zeros(3, state.q.dtype), lin])


def _ext_world_to_body(kin_R, f_world):
    """World linear-first wrench [f; n] at link origin -> body angular-first."""
    n_b = jnp.einsum("ji,j->i", kin_R, f_world[3:])
    f_b = jnp.einsum("ji,j->i", kin_R, f_world[:3])
    return jnp.concatenate([n_b, f_b])


def rnea(
    model: RobotModel,
    state: RobotState,
    udot: jax.Array,
    gravity: bool = True,
    ext_wrenches: Optional[jax.Array] = None,
    kin: Optional[kinematics.KinData] = None,
) -> jax.Array:
    """Recursive Newton-Euler: generalized forces for motion ``udot``.

    ``udot``: (nv,) accelerations.  ``ext_wrenches``: optional (nj, 6) external
    wrenches applied at each link origin, world frame, linear-first (use zeros
    where no force acts).  Returns (nv,) generalized forces: with
    ``udot = 0`` this is the nonlinear term h(q, qd); with full ``udot`` it is
    inverse dynamics.
    """
    nj = model.nj
    dtype = state.q.dtype
    udot = jnp.asarray(udot, dtype)  # callers may pass f64 under x64 tests
    if kin is None:
        kin = kinematics.fk(model, state)

    if model.floating:
        base_udot = udot[:6]
        qdd = udot[6:]
        v_base = state.base_vel
    else:
        base_udot = jnp.zeros(6, dtype)
        qdd = udot
        v_base = jnp.zeros(6, dtype)

    a_base = base_udot
    if gravity:
        a_base = a_base + _base_gravity_acc(model, state)

    # level-parallel forward sweep (body-frame spatial v, a per link)
    E_loc, p_loc = kinematics.joint_local_all(model, state.q)
    v, a = kinematics.propagate_va(model, state.qd, qdd, v_base, a_base,
                                   E_loc, p_loc)

    # per-link net spatial forces (fully vectorized)
    Iv = jnp.einsum("nij,nj->ni", model.inertia, v)
    f = jnp.einsum("nij,nj->ni", model.inertia, a) + spatial.cross_force(v, Iv)
    if ext_wrenches is not None:
        n_b = jnp.einsum("nji,nj->ni", kin.R, ext_wrenches[:, 3:])
        f_b = jnp.einsum("nji,nj->ni", kin.R, ext_wrenches[:, :3])
        f = f - jnp.concatenate([n_b, f_b], axis=-1)

    # backward sweep, level-reversed: children are strictly deeper, so by the
    # time a level is processed all its descendants have been accumulated
    S = kinematics.motion_subspace_all(model, dtype)
    tau = jnp.zeros(nj, dtype)
    f_base = spatial.inertia_apply(model.base_inertia, a_base) + \
        spatial.cross_force(v_base, spatial.inertia_apply(model.base_inertia,
                                                          v_base))
    for idx, par in reversed(kinematics.tree_levels(model.parent)):
        fi = f[idx]
        tau = tau.at[idx].set(jnp.einsum("ni,ni->n", S[idx], fi))
        fp = spatial.xform_force_inv_apply(E_loc[idx], p_loc[idx], fi)
        root = (par < 0)[:, None]
        parc = np.maximum(par, 0)
        f = f.at[parc].add(jnp.where(root, 0.0, fp))
        f_base = f_base + jnp.sum(jnp.where(root, fp, 0.0), axis=0)

    tau = tau + model.armature.astype(dtype) * qdd
    if model.floating:
        return jnp.concatenate([f_base, tau])
    return tau


def nonlinear_term(model: RobotModel, state: RobotState,
                   kin: Optional[kinematics.KinData] = None) -> jax.Array:
    """h(q, qd) = C(q, qd) qd + g(q)  (XBot computeNonlinearTerm,
    /root/reference/src/QPPVMPlugin.cpp:65)."""
    nv = model.nv
    return rnea(model, state, jnp.zeros(nv, state.q.dtype), gravity=True, kin=kin)


def inverse_dynamics(model: RobotModel, state: RobotState, udot: jax.Array,
                     kin: Optional[kinematics.KinData] = None) -> jax.Array:
    """tau = ID(q, qd, qdd)  (XBot computeInverseDynamics,
    /root/reference/src/ForceAcc.cpp:217)."""
    return rnea(model, state, udot, gravity=True, kin=kin)


def _internal_jacobians(model: RobotModel, kin: kinematics.KinData):
    """(nj, 6, nv) angular-first spatial Jacobians at link origins (world
    orientation) — public Jacobians with row blocks swapped."""
    Jpub = kinematics.all_link_jacobians(model, kin)
    return jnp.concatenate([Jpub[:, 3:, :], Jpub[:, :3, :]], axis=1)


def mass_matrix(model: RobotModel, state: RobotState,
                kin: Optional[kinematics.KinData] = None) -> jax.Array:
    """(nv, nv) joint-space inertia matrix B(q) via the dense world-frame form
    B = sum_i J_i^T I_i^w J_i  (batched matmuls)."""
    if kin is None:
        kin = kinematics.fk(model, state)
    J = _internal_jacobians(model, kin)                       # (nj, 6, nv)
    R = kin.R
    Rot6 = jnp.zeros((model.nj, 6, 6), dtype=R.dtype)
    Rot6 = Rot6.at[:, :3, :3].set(R).at[:, 3:, 3:].set(R)
    I_w = Rot6 @ model.inertia @ jnp.swapaxes(Rot6, -1, -2)   # (nj, 6, 6)
    B = jnp.einsum("nri,nrs,nsj->ij", J, I_w, J)
    if model.floating:
        Rb6 = jnp.zeros((6, 6), dtype=R.dtype)
        Rb6 = Rb6.at[:3, :3].set(kin.base_R).at[3:, 3:].set(kin.base_R)
        Jb = jnp.zeros((6, model.nv), dtype=R.dtype)
        Jb = Jb.at[:, :6].set(Rb6)
        I_bw = Rb6 @ model.base_inertia @ Rb6.T
        B = B + Jb.T @ I_bw @ Jb
    off = 6 if model.floating else 0
    idx = jnp.arange(model.nj) + off
    B = B.at[idx, idx].add(model.armature.astype(B.dtype))
    return B


@f32_matmuls
def forward_dynamics(model: RobotModel, state: RobotState, tau: jax.Array,
                     ext_wrenches: Optional[jax.Array] = None,
                     kin: Optional[kinematics.KinData] = None,
                     method: str = "ns",
                     B: Optional[jax.Array] = None,
                     binv: Optional[jax.Array] = None) -> jax.Array:
    """udot = B^{-1} (S^T tau + tau_ext - h). ``tau``: (nj,) actuated torques.

    ``method="ns"`` (default): matmul-only Newton-Schulz inverse apply +
    iterative refinement — the batched hot path (MPC rollouts vmap this
    thousands-wide).
    ``method="chol"`` is the exact CPU/reference path.

    ``B``: precomputed mass matrix at ``state`` (e.g. the control tick's
    ModelData.B — the WBC step already built it for the same state, so the
    sim step should not pay CRBA twice). ``binv``: an (approximate) inverse
    of that B, e.g. a warm Newton-Schulz inverse carried along an MPC
    rollout horizon (linalg.ns_warm_inverse); the solve then costs 3
    matvecs (apply + 2 refinement steps against the TRUE B) instead of a
    22-iteration cold inversion — measured 32 -> ~10 ms per 4096-batch
    rollout step."""
    if kin is None:
        kin = kinematics.fk(model, state)
    h = rnea(model, state, jnp.zeros(model.nv, state.q.dtype), gravity=True,
             ext_wrenches=ext_wrenches, kin=kin)
    if B is None:
        B = mass_matrix(model, state, kin=kin)
    if model.floating:
        tau_gen = jnp.concatenate([jnp.zeros(6, tau.dtype), tau])
    else:
        tau_gen = tau
    rhs = tau_gen - h
    Breg = B + 1e-9 * jnp.eye(model.nv, dtype=B.dtype)
    if method == "chol":
        L = jnp.linalg.cholesky(Breg)
        y = jax.scipy.linalg.solve_triangular(L, rhs, lower=True)
        return jax.scipy.linalg.solve_triangular(L.T, y, lower=False)
    if binv is None:
        from qppvm_tpu.opt import linalg as _linalg
        binv = _linalg.spd_inverse_ns(Breg, iters=22, refine=2)
    x = binv @ rhs
    for _ in range(2):  # refinement against the true B: ~roundoff accuracy
        x = x + binv @ (rhs - Breg @ x)
    return x


def integrate(model: RobotModel, state: RobotState, udot: jax.Array,
              dt) -> RobotState:
    """Semi-implicit Euler; floating-base pose integrated on SE(3)."""
    if model.floating:
        base_vel = state.base_vel + dt * udot[:6]
        qd = state.qd + dt * udot[6:]
        q = state.q + dt * qd
        w_b = base_vel[:3]
        v_b = base_vel[3:]
        base_rot = state.base_rot @ spatial.so3_exp(w_b * dt)
        base_pos = state.base_pos + dt * (state.base_rot @ v_b)
        return RobotState(q=q, qd=qd, base_rot=base_rot, base_pos=base_pos,
                          base_vel=base_vel)
    qd = state.qd + dt * udot
    q = state.q + dt * qd
    return RobotState(q=q, qd=qd, base_rot=state.base_rot,
                      base_pos=state.base_pos, base_vel=state.base_vel)


def kinetic_energy(model: RobotModel, state: RobotState,
                   kin: Optional[kinematics.KinData] = None) -> jax.Array:
    u = state.u if model.floating else state.qd
    B = mass_matrix(model, state, kin=kin)
    return 0.5 * u @ B @ u


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ModelData:
    """Everything tasks need, computed once per control step — the analog of
    XBot's model->update() caching (/root/reference/src/QPPVMPlugin.cpp:352)."""

    kin: kinematics.KinData
    B: jax.Array       # (nv, nv)
    h: jax.Array       # (nv,)
    Binv: Optional[jax.Array]  # (nv, nv); None unless need_binv was set
    J_all: jax.Array   # (nj, 6, nv) public world Jacobians at link origins
    vel_all: jax.Array  # (nj, 6) world link twists [v; w]
    bias_all: jax.Array  # (nj, 6) classical Jdot*u at link origins
    com_pos: jax.Array  # (3,)
    total_mass: jax.Array  # ()
    base_vel: jax.Array  # (6,) [w; v] body coords (copy of state.base_vel)


def frame_data(model: RobotModel, data: "ModelData", name: str):
    """(R, p, J, vel, bias) of a link origin OR an extra named frame (URDF
    fixed-joint child after lumping). Quantities transferred from the parent
    link by the rigid point offset r:  v_f = v_l + w x r,
    J_lin_f = J_lin_l - skew(r) J_ang,  bias_lin_f = bias_lin_l +
    bias_ang x r + w x (w x r)."""
    kin = data.kin
    spec = model.frame_spec(name)
    if spec is None:
        li = model.link_index(name)
        if li >= 0:
            return (kin.R[li], kin.p[li], data.J_all[li], data.vel_all[li],
                    data.bias_all[li])
        # root link frame
        R, p = kin.base_R, kin.base_p
        J = kinematics.link_jacobian(model, kin, name)
        if not model.floating:
            z6 = jnp.zeros(6, p.dtype)
            return R, p, J, z6, z6
        w_b, v_b = data.base_vel[:3], data.base_vel[3:]
        vel = jnp.concatenate([R @ v_b, R @ w_b])
        bias = jnp.concatenate([R @ jnp.cross(w_b, v_b), jnp.zeros(3, p.dtype)])
        return R, p, J, vel, bias
    li, E_off, p_off = spec
    if li < 0:
        # frame rigidly attached to the root link (e.g. an MJCF massless
        # body hanging off the floating base): transfer base quantities by
        # the same rigid point offset as the child-link path below
        Rl, pl = kin.base_R, kin.base_p
        Jl = kinematics.link_jacobian(model, kin, model.root_name)
        if model.floating:
            w_b, v_b = data.base_vel[:3], data.base_vel[3:]
            vl = jnp.concatenate([Rl @ v_b, Rl @ w_b])
            bl = jnp.concatenate([Rl @ jnp.cross(w_b, v_b),
                                  jnp.zeros(3, pl.dtype)])
        else:
            vl = jnp.zeros(6, pl.dtype)
            bl = jnp.zeros(6, pl.dtype)
        E_off = jnp.asarray(E_off, Rl.dtype)
        p_off = jnp.asarray(p_off, pl.dtype)
        R = Rl @ E_off
        p = pl + Rl @ p_off
        r = Rl @ p_off
        S = spatial.skew(r)
        J = jnp.concatenate([Jl[:3] - S @ Jl[3:], Jl[3:]], axis=0)
        w = vl[3:]
        vel = jnp.concatenate([vl[:3] + jnp.cross(w, r), w])
        bias_lin = (bl[:3] + jnp.cross(bl[3:], r)
                    + jnp.cross(w, jnp.cross(w, r)))
        return R, p, J, vel, jnp.concatenate([bias_lin, bl[3:]])
    Rl, pl = kin.R[li], kin.p[li]
    E_off = jnp.asarray(E_off, Rl.dtype)
    p_off = jnp.asarray(p_off, pl.dtype)
    R = Rl @ E_off
    p = pl + Rl @ p_off
    r = Rl @ p_off
    S = spatial.skew(r)
    Jl = data.J_all[li]
    vl = data.vel_all[li]
    bl = data.bias_all[li]
    J = jnp.concatenate([Jl[:3] - S @ Jl[3:], Jl[3:]], axis=0)
    w = vl[3:]
    vel = jnp.concatenate([vl[:3] + jnp.cross(w, r), w])
    bias_lin = bl[:3] + jnp.cross(bl[3:], r) + jnp.cross(w, jnp.cross(w, r))
    bias = jnp.concatenate([bias_lin, bl[3:]])
    return R, p, J, vel, bias


def relative_frame_data(model: RobotModel, data: "ModelData",
                        distal: str, base: str):
    """(R_rel, p_rel, J_rel, vel_rel, bias_rel) of frame ``distal`` relative
    to frame ``base``, expressed in the BASE frame — the non-world
    ``base_link`` Cartesian-task kinematics (OpenSoT Cartesian tasks take a
    base_link; the reference passes "world",
    /root/reference/src/QPPVMPlugin.cpp:129-152, but the capability is part
    of the surface).

        R_rel = R_b^T R_d,   p_rel = R_b^T (p_d - p_b)
        v_rel  = R_b^T (v_d - v_b - w_b x r),  w_rel = R_b^T (w_d - w_b)
        with r = p_d - p_b; J_rel and bias_rel are the exact u-gradient and
        Jdot*u of [v_rel; w_rel] (finite-difference-tested in
        tests/test_dynamics.py).
    """
    R_d, p_d, J_d, v_d, b_d = frame_data(model, data, distal)
    R_b, p_b, J_b, v_b, b_b = frame_data(model, data, base)
    r = p_d - p_b
    S_r = spatial.skew(r)
    w_b = v_b[3:]
    Rt = R_b.T

    R_rel = Rt @ R_d
    p_rel = Rt @ r

    v_rel_w = v_d[:3] - v_b[:3] - jnp.cross(w_b, r)   # world components
    w_rel_w = v_d[3:] - v_b[3:]
    vel = jnp.concatenate([Rt @ v_rel_w, Rt @ w_rel_w])

    J_lin_w = J_d[:3] - J_b[:3] + S_r @ J_b[3:]
    J_ang_w = J_d[3:] - J_b[3:]
    J_rel = jnp.concatenate([Rt @ J_lin_w, Rt @ J_ang_w], axis=0)

    # d/dt with udot = 0: Rdot_b^T x = -R_b^T (w_b x x)
    rdot = v_d[:3] - v_b[:3]
    bias_lin = Rt @ (b_d[:3] - b_b[:3] - jnp.cross(b_b[3:], r)
                     - jnp.cross(w_b, rdot) - jnp.cross(w_b, v_rel_w))
    bias_ang = Rt @ (b_d[3:] - b_b[3:] - jnp.cross(w_b, w_rel_w))
    bias = jnp.concatenate([bias_lin, bias_ang])
    return R_rel, p_rel, J_rel, vel, bias


def compute_model_data(model: RobotModel, state: RobotState,
                       need_binv: bool = False) -> ModelData:
    kin = kinematics.fk(model, state)
    B = mass_matrix(model, state, kin=kin)
    h = nonlinear_term(model, state, kin=kin)
    if need_binv:
        # matmul-only SPD inverse (opt/linalg.py) — no LU on the hot path
        from qppvm_tpu.opt import linalg as _linalg
        Binv = _linalg.spd_inverse(B, method="ns", iters=18)
    else:
        Binv = None
    J_all = kinematics.all_link_jacobians(model, kin)
    u = state.u if model.floating else state.qd
    vel_all = jnp.einsum("nrv,v->nr", J_all, u)
    bias_all = kinematics.bias_accelerations(model, kin, state)
    total_mass, com_pos = kinematics.com(model, kin)
    return ModelData(kin=kin, B=B, h=h, Binv=Binv, J_all=J_all,
                     vel_all=vel_all, bias_all=bias_all, com_pos=com_pos,
                     total_mass=total_mass, base_vel=state.base_vel)
