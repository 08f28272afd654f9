"""Force-level tasks over contact wrench variables.

Re-designs ``tasks::force::CoM`` (/root/reference/src/ForceAcc.cpp:103 —
constructed there but not stacked; part of the capability surface per
SURVEY.md §2b C12): centroidal dynamics rows over the contact forces.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax.numpy as jnp

from qppvm_tpu.model import spatial
from qppvm_tpu.opt.variables import AffineExpr
from qppvm_tpu.tasks.base import AssembleCtx, Task


class ForceReg(Task):
    """Contact-force distribution regularizer: a small-weight task pulling
    each contact wrench toward the gate-weighted equal-share support force

        f_des_i = (W * g_i / sum_j g_j) * z_hat,   W = total weight,

    over the stacked contact-wrench variables (tangential/moment targets 0).

    The stance wrenches have a nullspace (internal forces + load
    distribution) that NO reference task constrains — the reference stack
    (/root/reference/src/ForceAcc.cpp:131-133) leaves it to qpOASES's eps
    regularization toward x = 0. This repo's solver's proximal term centers on
    the *warm start* instead (needed for conditioning), so without this task
    the distribution random-walks tick-to-tick to bound vertices (measured:
    a centered quadruped drifting to fz = [272, 111, 10, 88] N), starving
    one foot of friction budget. Pulling toward the equal-share distribution
    (rather than min-norm f = 0) agrees with weight support, so a meaningful
    weight cannot re-introduce the round-1 "small forces + free fall" sag.

    With ``gates_key`` set, a contact's desired share follows its 0..1 gate:
    ramping a gate down schedules a continuous unload of that foot while the
    others pick up its share — the contact-switching primitive.

    refs: ``f`` (additive offset on f_des, e.g. an MPC force plan),
    ``w`` (runtime weight scale)."""

    def __init__(self, name: str, wrenches: Sequence[AffineExpr],
                 w_tan: float = 0.1, w_norm: float = 0.05,
                 gates_key: Optional[str] = None, up_index: int = 2,
                 share_mode: str = "gate",
                 contact_links: Optional[Sequence[str]] = None):
        """``share_mode``:
        - "gate" (default): equal share per unit gate (the round-2 anchor).
        - "static": the share solves the QUASI-STATIC distribution at the
          measured CoM — min ||w||^2 s.t. sum w_i = 1 and
          sum w_i (p_i - com)_xy = 0 over the gated feet (3x3 KKT, solved
          by adjugate — no factorization in the hot path). Measured
          failure of the "gate" anchor on the biped weight shift: with
          the CoM over one foot the equal-share pull keeps fz ~50/50, the
          floating-base moment balance then saturates the +/-30 Nm foot
          moment boxes, and the compromised torque solution skids the
          robot sideways (commanded fz 502/532 N with the CoM over the
          right sole, both feet sliding ~9 cm in 0.3 s). The static
          anchor is weight support at the TRUE load split, so the moment
          rows never fight the regularizer. Requires ``contact_links``.
        """
        self.name = name
        self.wrenches = list(wrenches)
        self.share_mode = share_mode
        self.contact_links = list(contact_links) if contact_links else None
        if share_mode == "static" and not self.contact_links:
            raise ValueError("share_mode='static' needs contact_links")
        # Tangential/moment rows (target 0) can take a larger weight than
        # the normal rows (target = share): zero internal squeeze is always
        # statically consistent, while the share target is only consistent
        # along the resultant-preserving internal mode — w_norm must stay
        # small enough that the solver never trades task tracking (via the
        # dynamics coupling to qddot) for distribution shaping.
        self.w_tan = w_tan
        self.w_norm = w_norm
        self.weight = max(w_tan, w_norm)  # Task-protocol scalar (unused here)
        self.gates_key = gates_key
        self.up_index = up_index

    def ref_init(self, model, data, state):
        n = sum(w.size for w in self.wrenches)
        dt = data.com_pos.dtype
        return {"f": jnp.zeros(n, dt), "w": jnp.ones((), dt)}

    def assemble(self, ctx: AssembleCtx):
        ref = ctx.refs[self.name]
        nc = len(self.wrenches)
        if self.gates_key is not None and self.gates_key in ctx.refs:
            g = ctx.refs[self.gates_key]["active"].astype(ctx.dtype)
        else:
            g = jnp.ones(nc, ctx.dtype)
        W = ctx.data.total_mass * jnp.linalg.norm(
            ctx.model.gravity.astype(ctx.dtype))
        if self.share_mode == "static":
            # gate-masked quasi-static split at the measured CoM (see
            # __init__): w = D A^T (A D A^T + eps I)^-1 [1,0,0], A rows =
            # [ones; (p - com)_xy^T], D = diag(gates); clamp >= 0 and
            # renormalize (CoM outside the gated polygon would otherwise
            # demand negative support).
            from qppvm_tpu.model import kinematics as _k
            P = jnp.stack([_k.link_pose(ctx.model, ctx.data.kin, l)[1]
                           for l in self.contact_links])      # (nc, 3)
            d = P[:, :2] - ctx.data.com_pos[None, :2]         # (nc, 2)
            A = jnp.concatenate([jnp.ones((1, nc), ctx.dtype), d.T],
                                axis=0)                       # (3, nc)
            M3 = (A * g[None, :]) @ A.T \
                + 1e-5 * jnp.eye(3, dtype=ctx.dtype)
            # adjugate 3x3 inverse (matmul-free; no factorization)
            c00 = M3[1, 1] * M3[2, 2] - M3[1, 2] * M3[2, 1]
            c01 = M3[0, 2] * M3[2, 1] - M3[0, 1] * M3[2, 2]
            c02 = M3[0, 1] * M3[1, 2] - M3[0, 2] * M3[1, 1]
            c10 = M3[1, 2] * M3[2, 0] - M3[1, 0] * M3[2, 2]
            c11 = M3[0, 0] * M3[2, 2] - M3[0, 2] * M3[2, 0]
            c12 = M3[0, 2] * M3[1, 0] - M3[0, 0] * M3[1, 2]
            c20 = M3[1, 0] * M3[2, 1] - M3[1, 1] * M3[2, 0]
            c21 = M3[0, 1] * M3[2, 0] - M3[0, 0] * M3[2, 1]
            c22 = M3[0, 0] * M3[1, 1] - M3[0, 1] * M3[1, 0]
            det = (M3[0, 0] * c00 + M3[0, 1] * c10 + M3[0, 2] * c20)
            lam = jnp.stack([c00, c10, c20]) / jnp.maximum(
                jnp.abs(det), 1e-12) * jnp.sign(det)          # Minv @ e1
            w_sh = jnp.maximum(g * (A.T @ lam), 0.0)
            share = W * w_sh / jnp.maximum(jnp.sum(w_sh), 1e-6)
        else:
            share = W * g / jnp.maximum(jnp.sum(g), 1e-6)
        f_des, row_w = [], []
        for i, wr in enumerate(self.wrenches):
            f_des.append(jnp.zeros(wr.size, ctx.dtype)
                         .at[self.up_index].set(share[i]))
            row_w.append(jnp.full((wr.size,), self.w_tan, ctx.dtype)
                         .at[self.up_index].set(self.w_norm))
        f_des = jnp.concatenate(f_des) + ref["f"]
        row_w = jnp.concatenate(row_w) * jnp.asarray(
            ref.get("w", 1.0), ctx.dtype)
        M = jnp.concatenate([w.M for w in self.wrenches], axis=0)
        c = jnp.concatenate([w.c for w in self.wrenches], axis=0)
        return row_w[:, None] * M, row_w * (f_des - c)


class CoM(Task):
    """Centroidal task: choose contact forces realizing a desired CoM
    acceleration (and zero angular-momentum rate):

        sum_i f_i                      = m (a_com_des - g)
        sum_i (p_i - com) x f_i        = dL_des (= 0)

    ``wrenches`` are 3-vector point forces (world frame) at the contact link
    origins, matching the reference's 3-per-foot variables
    (/root/reference/src/ForceAcc.cpp:67).
    """

    def __init__(self, name: str, wrenches: Sequence[AffineExpr],
                 contact_links: Sequence[str], kp: float = 25.0,
                 kd: Optional[float] = None, angular: bool = True):
        self.name = name
        self.wrenches = list(wrenches)
        self.contact_links = list(contact_links)
        self.kp = kp
        self.kd = 10.0 if kd is None else kd
        self.angular = angular

    def ref_init(self, model, data, state):
        z3 = jnp.zeros(3, data.com_pos.dtype)
        return {"p": data.com_pos, "v": z3, "a": z3}

    def assemble(self, ctx: AssembleCtx):
        m = ctx.data.total_mass
        com = ctx.data.com_pos
        ref = ctx.refs[self.name]
        # full PD: the D term acts on the MEASURED CoM velocity error
        # (mass-weighted average of per-link COM-point velocities), not on
        # the reference velocity alone.
        from qppvm_tpu.model import kinematics as _k
        v_com = _k.com_velocity(ctx.model, ctx.data.kin, ctx.state,
                                ctx.data.vel_all)
        a_des = (ref["a"] + self.kp * (ref["p"] - com)
                 + self.kd * (ref["v"] - v_com))
        g = ctx.model.gravity.astype(ctx.dtype)

        lin_M = 0.0
        lin_c = 0.0
        ang_M = 0.0
        ang_c = 0.0
        from qppvm_tpu.model import kinematics as _kin
        for link, wr in zip(self.contact_links, self.wrenches):
            p_i = _kin.link_pose(ctx.model, ctx.data.kin, link)[1]
            lin_M = lin_M + wr.M[:3]
            lin_c = lin_c + wr.c[:3]
            S = spatial.skew(p_i - com)
            ang_M = ang_M + S @ wr.M[:3]
            ang_c = ang_c + S @ wr.c[:3]

        b_lin = m * (a_des - g) - lin_c
        rows = [lin_M]
        rhs = [b_lin]
        if self.angular:
            rows.append(ang_M)
            rhs.append(-ang_c)
        w = jnp.asarray(self.weight, ctx.dtype)
        return w * jnp.concatenate(rows, axis=0), w * jnp.concatenate(rhs)
