"""Receding-horizon centroidal DDP planner feeding the WBC tracker.

Composition (north-star "DDP-style MPC"): iLQR plans CoM/force trajectories
on the reduced SRBD model (mpc/centroidal.py); the whole-body controller
(plugins/force_acc.py) tracks the planned CoM as its waist reference at
1 kHz. One plan() is a single jitted program; warm-started by shifting the
previous control sequence.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from qppvm_tpu.model import dynamics
from qppvm_tpu.model.robot import RobotModel, RobotState
from qppvm_tpu.mpc import centroidal, ilqr


@dataclasses.dataclass(frozen=True)
class CentroidalMPCConfig:
    horizon: int = 40
    dt: float = 0.02
    iterations: int = 8
    w_pos: float = 50.0
    w_ang: float = 20.0
    f_max: float = 1000.0   # box clamp on planned force components


class CentroidalMPC:
    """plan(state, p_ref[, active]) -> (ILQRResult, params)."""

    def __init__(self, model: RobotModel, contact_links: Sequence[str],
                 cfg: CentroidalMPCConfig = CentroidalMPCConfig(),
                 dtype=jnp.float32):
        self.model = model
        self.contact_links = tuple(contact_links)
        self.cfg = cfg
        self.dtype = dtype
        self._plan = jax.jit(self._plan_impl)

    def init_plan(self, state: RobotState,
                  active: Optional[jax.Array] = None) -> jax.Array:
        data = dynamics.compute_model_data(self.model, state)
        params = centroidal.from_robot(self.model, data, self.contact_links,
                                       self.cfg.dt, active)
        return jnp.tile(centroidal.gravity_feedforward(params)[None],
                        (self.cfg.horizon, 1))

    def plan(self, state: RobotState, p_ref, U_prev,
             active: Optional[jax.Array] = None):
        nc = len(self.contact_links)
        active = (jnp.ones(nc, self.dtype) if active is None
                  else jnp.asarray(active, self.dtype))
        return self._plan(state, jnp.asarray(p_ref, self.dtype), U_prev,
                          active)

    def _plan_impl(self, state, p_ref, U_prev, active):
        cfg = self.cfg
        data = dynamics.compute_model_data(self.model, state)
        params = centroidal.from_robot(self.model, data, self.contact_links,
                                       cfg.dt, active)
        x0 = centroidal.init_state(
            data.com_pos,
            # world CoM velocity ~ world base linear velocity (stance)
            state.base_rot @ state.base_vel[3:])
        cost = centroidal.standing_cost(params, p_ref, w_pos=cfg.w_pos,
                                        w_ang=cfg.w_ang)
        dyn = lambda x, u: centroidal.dynamics_step(params, x, u)
        solver = ilqr.make_solver(
            dyn, cost,
            lambda x: 10.0 * cost(x, jnp.zeros(3 * params.nc, self.dtype)),
            ilqr.ILQRConfig(iterations=cfg.iterations,
                            u_min=-cfg.f_max, u_max=cfg.f_max))
        # receding-horizon warm start: shift previous plan by one step
        U0 = jnp.concatenate([U_prev[1:], U_prev[-1:]], axis=0)
        res = solver(x0, U0)
        return res, params

    @staticmethod
    def waist_ref_from_plan(res: ilqr.ILQRResult, k: int = 1):
        """CoM position k steps into the planned trajectory — the reference
        handed to the WBC's waist task."""
        return res.X[k][:3]

    @staticmethod
    def force_ref_offset(res: ilqr.ILQRResult, params, total_weight,
                         k: int = 0, gates=None, wrench_dim: int = 3):
        """``refs["FORCE_REG"]["f"]`` offset realizing the plan's step-k
        contact forces in the WBC: ForceReg anchors the force-distribution
        nullspace at the GATE-WEIGHTED share ``W * g_i / sum(g)`` plus this
        offset (tasks/force.py ForceReg.assemble), so adding
        ``f_plan - gate_share`` makes the commanded distribution TRACK THE
        PLAN instead of the static share — the force::CoM channel the
        reference builds but never wires up
        (/root/reference/src/ForceAcc.cpp:103).

        ``gates``: the plugin's ``refs["contacts"]["active"]`` vector; omit
        only for an all-contacts-on stack (then the anchor really is the
        equal share). ``wrench_dim``: the plugin's per-contact wrench size —
        the centroidal plan's 3-vector forces are embedded in the force rows
        of each ``wrench_dim``-wide block so the offset length always
        matches the ForceReg ref."""
        f_plan = res.U[k].reshape(params.nc, 3)
        g = (jnp.ones(params.nc, f_plan.dtype) if gates is None
             else jnp.asarray(gates, f_plan.dtype))
        share_z = total_weight * g / jnp.maximum(jnp.sum(g), 1e-6)
        share = jnp.zeros_like(f_plan).at[:, 2].set(share_z)
        off3 = f_plan - share                       # (nc, 3)
        if wrench_dim == 3:
            return off3.reshape(-1)
        off = jnp.zeros((params.nc, wrench_dim), f_plan.dtype)
        return off.at[:, :3].set(off3).reshape(-1)
