"""Batched forward kinematics, Jacobians, CoM and bias accelerations.

Equivalent capability to the XBot::ModelInterface kinematic queries the
reference exercises: ``getPose`` (/root/reference/src/QPPVMPlugin.cpp:272,287),
``getJacobian`` (/root/reference/src/ForceAcc.cpp:208), ``getPointPosition``
(/root/reference/src/ForceAcc.cpp:164), plus the Jdot*qd ("bias acceleration")
term needed by acceleration-level Cartesian tasks.

Design: the per-joint FK recursion is unrolled at trace time (static
topology, ~10-40 joints), while everything downstream — Jacobians for *all*
links, CoM, the mass matrix — is expressed as dense batched matmul/einsum over
an ``(nj, ...)`` leading axis so XLA fuses it into a few batched kernels and
``vmap`` adds rollout batching for free.

Public conventions: world frame, linear-first twists/wrenches ``[v; w]`` /
``[f; n]``. Internal generalized-velocity layout for floating models:
``u = [base_twist_body (w,v); qd]``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from qppvm_tpu.model import spatial
from qppvm_tpu.model.robot import PRISMATIC, REVOLUTE, RobotModel, RobotState


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class KinData:
    """Per-step kinematic data for all links (leading axis nj)."""

    R: jax.Array      # (nj, 3, 3) world-from-link rotation
    p: jax.Array      # (nj, 3)   link origin in world
    S_ang: jax.Array  # (nj, 3)   world-frame angular part of joint motion axis
    S_lin_at: jax.Array  # (nj, 3) world joint-axis origin (for point transfer)
    base_R: jax.Array  # (3, 3)
    base_p: jax.Array  # (3,)


def _joint_local(model: RobotModel, i: int, qi):
    """Local (E, p): child-link-i frame from parent-link frame at angle qi."""
    E_tree = model.E_tree[i]
    p_tree = model.p_tree[i]
    axis = model.axis[i]
    if model.joint_type[i] == REVOLUTE:
        Ej = spatial.rot_axis_angle(axis, qi)
        return Ej @ E_tree, p_tree
    elif model.joint_type[i] == PRISMATIC:
        return E_tree, p_tree + jnp.einsum("ji,j->i", E_tree, axis * qi)
    raise ValueError(f"unknown joint type {model.joint_type[i]}")


_LEVEL_CACHE = {}


def tree_levels(parent):
    """Static depth-level structure: list of (joint_idx, parent_idx) numpy
    arrays, one per tree depth. Joints at the same depth have independent
    recursions, so each level is ONE vectorized gather+matmul+scatter instead
    of a chain of per-joint ops — ~3x fewer sequential stages on typical
    humanoid trees (the latency-critical path of the 1 kHz tick)."""
    key = tuple(parent)
    if key not in _LEVEL_CACHE:
        depth = []
        for i, p in enumerate(parent):
            depth.append(0 if p < 0 else depth[p] + 1)
        levels = []
        for d in range(max(depth) + 1 if depth else 0):
            idx = np.asarray([i for i in range(len(parent)) if depth[i] == d],
                             np.int32)
            par = np.asarray([parent[i] for i in idx], np.int32)
            levels.append((idx, par))
        _LEVEL_CACHE[key] = levels
    return _LEVEL_CACHE[key]


def joint_local_all(model: RobotModel, q):
    """Vectorized local transforms for ALL joints: (E (nj,3,3), p (nj,3))."""
    axis = model.axis
    # batched Rodrigues (axes are unit-normalized at model build)
    c = jnp.cos(q)[:, None, None]
    s = jnp.sin(q)[:, None, None]
    K = spatial.skew(axis)                        # (nj, 3, 3)
    I = jnp.eye(3, dtype=q.dtype)
    R_rot = I + s * K + (1.0 - c) * (K @ K)       # rotates by +q about axis
    E_rev = jnp.swapaxes(R_rot, -1, -2) @ model.E_tree
    p_rev = model.p_tree
    p_pri = model.p_tree + jnp.einsum("nji,nj->ni", model.E_tree,
                                      axis * q[:, None])
    is_rev = np.asarray([t == REVOLUTE for t in model.joint_type])
    mask = jnp.asarray(is_rev)[:, None, None]
    E = jnp.where(mask, E_rev, model.E_tree)
    p = jnp.where(mask[:, :, 0], p_rev, p_pri)
    return E, p


def fk(model: RobotModel, state: RobotState) -> KinData:
    """World pose of every link frame + world joint axes (level-parallel)."""
    base_R, base_p = state.base_rot, state.base_pos
    E_loc, p_loc = joint_local_all(model, state.q)
    nj = model.nj
    R = jnp.zeros((nj, 3, 3), state.q.dtype)
    p = jnp.zeros((nj, 3), state.q.dtype)
    for idx, par in tree_levels(model.parent):
        parc = np.maximum(par, 0)
        root = (par < 0)[:, None, None]
        Rp = jnp.where(root, base_R[None], R[parc])
        pp = jnp.where(root[:, :, 0], base_p[None], p[parc])
        R_wi = Rp @ jnp.swapaxes(E_loc[idx], -1, -2)
        p_wi = pp + jnp.einsum("nij,nj->ni", Rp, p_loc[idx])
        R = R.at[idx].set(R_wi)
        p = p.at[idx].set(p_wi)
    S_ang = jnp.einsum("nij,nj->ni", R, model.axis.astype(state.q.dtype))
    return KinData(R=R, p=p, S_ang=S_ang, S_lin_at=p,
                   base_R=base_R, base_p=base_p)


def _ancestor_mask(model: RobotModel) -> jnp.ndarray:
    return jnp.asarray(model.ancestor_mask())


def point_jacobians(model: RobotModel, kin: KinData, points_w: jax.Array,
                    link_idx_mask: jax.Array) -> jax.Array:
    """Jacobian (L, 6, nv) for L world points attached to given links.

    ``points_w``: (L, 3) world points; ``link_idx_mask``: (L, nj) bool — joint j
    moves point l. Rows: linear-first [v; w]. Columns: [base(6, body twist,
    (w,v) order); qd] when floating, else [qd].
    """
    nj = model.nj
    dtype = points_w.dtype
    is_rev = jnp.asarray(
        np.array([t == REVOLUTE for t in model.joint_type]), dtype=bool)

    # Per (point, joint) columns.
    r = points_w[:, None, :] - kin.S_lin_at[None, :, :]       # (L, nj, 3)
    ang_rev = jnp.broadcast_to(kin.S_ang[None], r.shape)      # (L, nj, 3)
    lin_rev = jnp.cross(ang_rev, r)                           # (L, nj, 3)
    lin_pri = jnp.broadcast_to(kin.S_ang[None], r.shape)
    zero = jnp.zeros_like(r)
    ang = jnp.where(is_rev[None, :, None], ang_rev, zero)
    lin = jnp.where(is_rev[None, :, None], lin_rev, lin_pri)
    mask = link_idx_mask[..., None].astype(dtype)
    Jq = jnp.concatenate([lin * mask, ang * mask], axis=-1)   # (L, nj, 6)
    Jq = jnp.swapaxes(Jq, -1, -2)                             # (L, 6, nj)

    if not model.floating:
        return Jq

    # Base columns: point twist from body-frame base twist [w_b; v_b].
    Rb = kin.base_R
    rb = points_w - kin.base_p[None, :]                       # (L, 3)
    J_lin_w = -spatial.skew(rb) @ Rb                          # (L, 3, 3)
    J_lin_v = jnp.broadcast_to(Rb[None], J_lin_w.shape)
    J_ang_w = jnp.broadcast_to(Rb[None], J_lin_w.shape)
    J_ang_v = jnp.zeros_like(J_lin_w)
    Jb = jnp.concatenate(
        [
            jnp.concatenate([J_lin_w, J_lin_v], axis=-1),
            jnp.concatenate([J_ang_w, J_ang_v], axis=-1),
        ],
        axis=-2,
    )                                                          # (L, 6, 6)
    return jnp.concatenate([Jb, Jq], axis=-1)


def all_link_jacobians(model: RobotModel, kin: KinData) -> jax.Array:
    """(nj, 6, nv) world Jacobians at every link origin (linear-first rows)."""
    mask = _ancestor_mask(model)
    return point_jacobians(model, kin, kin.p, mask)


def link_jacobian(model: RobotModel, kin: KinData, link: str) -> jax.Array:
    """(6, nv) world Jacobian of a named link frame origin
    (XBot getJacobian, /root/reference/src/ForceAcc.cpp:208)."""
    li = model.link_index(link)
    if li < 0:  # root link
        if not model.floating:
            return jnp.zeros((6, model.nv), dtype=kin.p.dtype)
        pts = kin.base_p[None]
        m = jnp.zeros((1, model.nj), dtype=bool)
        return point_jacobians(model, kin, pts, m)[0]
    mask = _ancestor_mask(model)[li][None]
    return point_jacobians(model, kin, kin.p[li][None], mask)[0]


def link_pose(model: RobotModel, kin: KinData, link: str):
    """(R, p) world pose of a named link or extra frame (XBot getPose,
    /root/reference/src/QPPVMPlugin.cpp:272)."""
    spec = model.frame_spec(link)
    if spec is not None:
        li, E_off, p_off = spec
        Rp, pp = (kin.base_R, kin.base_p) if li < 0 else (kin.R[li], kin.p[li])
        E_off = jnp.asarray(E_off, Rp.dtype)
        p_off = jnp.asarray(p_off, pp.dtype)
        return Rp @ E_off, pp + Rp @ p_off
    li = model.link_index(link)
    if li < 0:
        return kin.base_R, kin.base_p
    return kin.R[li], kin.p[li]


def point_position(model: RobotModel, kin: KinData, link: str, local_point):
    """World position of a point given in link coords
    (XBot getPointPosition, /root/reference/src/ForceAcc.cpp:164)."""
    R, p = link_pose(model, kin, link)
    return p + R @ jnp.asarray(local_point, dtype=p.dtype)


def com(model: RobotModel, kin: KinData):
    """(total_mass, com_world (3,)). Includes the root link for floating
    models."""
    # spatial.mcI stores m*skew(c) in the (0:3, 3:6) block and m*I3 in the
    # (3:6, 3:6) block; recover m and m*c from those entries:
    # m*cx = M[2,4], m*cy = M[0,5], m*cz = M[1,3].
    m_links = model.inertia[:, 5, 5]                          # (nj,)
    mc_local = jnp.stack(
        [model.inertia[:, 2, 4], model.inertia[:, 0, 5], model.inertia[:, 1, 3]],
        axis=-1,
    )
    com_w = kin.p + jnp.einsum("nij,nj->ni", kin.R, mc_local / jnp.maximum(m_links, 1e-12)[:, None])
    total = jnp.sum(m_links)
    weighted = jnp.sum(m_links[:, None] * com_w, axis=0)
    if model.floating:
        mb = model.base_inertia[5, 5]
        cb_local = jnp.stack(
            [model.base_inertia[2, 4], model.base_inertia[0, 5], model.base_inertia[1, 3]]
        ) / jnp.maximum(mb, 1e-12)
        com_b = kin.base_p + kin.base_R @ cb_local
        total = total + mb
        weighted = weighted + mb * com_b
    return total, weighted / jnp.maximum(total, 1e-12)


def link_velocities(model: RobotModel, kin: KinData, state: RobotState) -> jax.Array:
    """(nj, 6) world twist [v; w] of each link origin = J_all @ u."""
    J = all_link_jacobians(model, kin)
    u = state.u if model.floating else state.qd
    return jnp.einsum("nrv,v->nr", J, u)


def com_velocity(model: RobotModel, kin: KinData, state: RobotState,
                 vel_all: jax.Array) -> jax.Array:
    """Measured CoM velocity (3,), world frame: the mass-weighted average of
    per-link COM-point velocities v_i + w_i x (R_i c_i). ``vel_all`` is the
    (nj, 6) linear-first world link-origin twist array (ModelData.vel_all).
    Used by the force::CoM task's damping term — the D acts on a measured
    velocity error, not on the reference velocity."""
    m_links = model.inertia[:, 5, 5]
    mc_local = jnp.stack(
        [model.inertia[:, 2, 4], model.inertia[:, 0, 5],
         model.inertia[:, 1, 3]], axis=-1)
    c_w = jnp.einsum(
        "nij,nj->ni", kin.R,
        mc_local / jnp.maximum(m_links, 1e-12)[:, None])
    v_pts = vel_all[:, :3] + jnp.cross(vel_all[:, 3:], c_w)
    total = jnp.sum(m_links)
    weighted = jnp.sum(m_links[:, None] * v_pts, axis=0)
    if model.floating:
        mb = model.base_inertia[5, 5]
        cb_local = jnp.stack(
            [model.base_inertia[2, 4], model.base_inertia[0, 5],
             model.base_inertia[1, 3]]) / jnp.maximum(mb, 1e-12)
        w_b = kin.base_R @ state.base_vel[:3]
        v_b = kin.base_R @ state.base_vel[3:]
        v_cb = v_b + jnp.cross(w_b, kin.base_R @ cb_local)
        total = total + mb
        weighted = weighted + mb * v_cb
    return weighted / jnp.maximum(total, 1e-12)


def bias_accelerations(model: RobotModel, kin: KinData, state: RobotState) -> jax.Array:
    """(nj, 6) classical bias acceleration Jdot*u of each link origin,
    linear-first world frame (the Jdot*qd term of acceleration Cartesian
    tasks: xdd = J*udot + Jdot*u).

    Level-parallel propagation of body-frame spatial velocity/acceleration
    with udot = 0 and no gravity, then spatial->classical conversion at each
    link origin: p_dd = a_lin + w x v_lin.
    """
    dtype = state.q.dtype
    vb = state.base_vel if model.floating else jnp.zeros(6, dtype)
    ab = jnp.zeros(6, dtype)
    E_loc, p_loc = joint_local_all(model, state.q)
    v_body, a_body = propagate_va(model, state.qd,
                                  jnp.zeros(model.nj, dtype), vb, ab,
                                  E_loc, p_loc)
    # Rotate to world orientation (reference point stays the link origin).
    w_w = jnp.einsum("nij,nj->ni", kin.R, v_body[:, :3])
    v_w = jnp.einsum("nij,nj->ni", kin.R, v_body[:, 3:])
    aw_ang = jnp.einsum("nij,nj->ni", kin.R, a_body[:, :3])
    aw_lin = jnp.einsum("nij,nj->ni", kin.R, a_body[:, 3:])
    lin_cl = aw_lin + jnp.cross(w_w, v_w)
    return jnp.concatenate([lin_cl, aw_ang], axis=-1)


def motion_subspace_all(model: RobotModel, dtype) -> jax.Array:
    """(nj, 6) local motion subspaces, angular-first."""
    ax = model.axis.astype(dtype)
    z = jnp.zeros_like(ax)
    rev = jnp.asarray(
        np.asarray([t == REVOLUTE for t in model.joint_type]))[:, None]
    return jnp.where(rev, jnp.concatenate([ax, z], -1),
                     jnp.concatenate([z, ax], -1))


def propagate_va(model: RobotModel, qd, qdd, v_base, a_base, E_loc, p_loc):
    """Level-parallel forward sweep of body-frame spatial velocity and
    acceleration: v_i = X v_par + S qd_i ; a_i = X a_par + S qdd_i + v x S qd.
    Returns ((nj, 6), (nj, 6))."""
    nj = model.nj
    # mixed-precision states (e.g. f64 q with f32 qd under x64 tests) must
    # not scatter f64 values into f32 accumulators
    dtype = jnp.result_type(qd.dtype, qdd.dtype, E_loc.dtype)
    qd = qd.astype(dtype)
    qdd = qdd.astype(dtype)
    v_base = v_base.astype(dtype)
    a_base = a_base.astype(dtype)
    S = motion_subspace_all(model, dtype)
    v = jnp.zeros((nj, 6), dtype)
    a = jnp.zeros((nj, 6), dtype)
    for idx, par in tree_levels(model.parent):
        parc = np.maximum(par, 0)
        root = (par < 0)[:, None]
        vp = jnp.where(root, v_base[None], v[parc])
        ap = jnp.where(root, a_base[None], a[parc])
        E = E_loc[idx]
        pl = p_loc[idx]
        vj = S[idx] * qd[idx][:, None]
        v_i = spatial.xform_apply(E, pl, vp) + vj
        a_i = (spatial.xform_apply(E, pl, ap) + S[idx] * qdd[idx][:, None]
               + spatial.cross_motion(v_i, vj))
        v = v.at[idx].set(v_i)
        a = a.at[idx].set(a_i)
    return v, a


def _motion_subspace_local(model: RobotModel, i: int, dtype):
    ax = model.axis[i].astype(dtype)
    z = jnp.zeros(3, dtype)
    if model.joint_type[i] == REVOLUTE:
        return jnp.concatenate([ax, z])
    return jnp.concatenate([z, ax])
