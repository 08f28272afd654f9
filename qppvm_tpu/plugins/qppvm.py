"""QPPVM: QP priority-based virtual-model control (torque-level).

Full capability parity with the reference plugin
(/root/reference/src/QPPVMPlugin.cpp):

- stack: (right EE + left EE Cartesian impedance, position rows 0..2,
  Kc=700 I, Dc=70 I, inertia-weighted) / (joint impedance K=5 I, D=2 I,
  inertia-weighted) << torque limits   (:105-106,129-152,177-179)
- per tick: tau bounds = tau_const -/+ h (:203-205), stack update (:226),
  hierarchical solve with eps=1.0 (:188,246), zero-torque-fallback on solver
  failure (:246-249), then tau_d += h (gravity/Coriolis compensation, :256)
- on_start: capture current EE poses / joint config as references
  (bumpless start, :261-305)
- optional moving sinusoid reference on the left EE (:217-223)

The whole tick — model update, task assembly, 2-level cascade, torque
reconstruction — is ONE jitted function; warm starts ride along as a pytree.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from qppvm_tpu.model import dynamics
from qppvm_tpu.model.robot import RobotModel, RobotState
from qppvm_tpu.precision import f32_matmuls
from qppvm_tpu.stack.autostack import AutoStack
from qppvm_tpu.tasks.base import Indices
from qppvm_tpu.tasks.torque import (CartesianImpedanceCtrl, JointImpedanceCtrl,
                                    TorqueLimits)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QPPVMAux:
    """Per-tick observables (the MatLogger channel set, reference :254-258)."""

    tau_qp: jax.Array       # torque from the QP, before +h
    tau_desired: jax.Array  # commanded torque (tau_qp + h)
    h: jax.Array            # nonlinear term
    solver_failed: jax.Array  # bool
    prim_res: jax.Array
    ee_left_err: jax.Array   # 6D pose error of the left EE task
    ee_right_err: jax.Array


class QPPVMPlugin:
    """Lifecycle-compatible plugin object (init/on_start/control_loop shape
    mirrors /root/reference/include/QPPVM_RT_plugin/QPPVMPlugin.h:43-46)."""

    # On solver failure the reference zeroes tau_qp, still adds h, and
    # COMMANDS it (gravity-compensation fallback,
    # /root/reference/src/QPPVMPlugin.cpp:246-256) — unlike ForceAcc's
    # skip-actuation. ControlLoop honors this by always commanding.
    failure_policy = "command"

    def __init__(self, model: RobotModel, *,
                 left_ee: str = "arm1_7", right_ee: str = "arm2_7",
                 cart_stiffness: float = 700.0, cart_damping: float = 70.0,
                 joint_stiffness: float = 5.0, joint_damping: float = 2.0,
                 eps: float = 1.0, iters: int = 100, dtype=jnp.float32,
                 sine_ref: bool = False,
                 solver_opts: Optional[Dict[str, Any]] = None):
        if model.floating:
            raise ValueError("QPPVM is a fixed-base controller")
        self.model = model
        self.dtype = dtype
        self.eps = eps
        self.iters = iters
        self.sine_ref = sine_ref
        # RT-loop solver knobs; override per deployment (tools/tune_solver.py
        # sweeps them).
        # polish_rounds=0: measured with tools/tune_solver.py, the
        # active-set polish is always rejected by its acceptance guard in the
        # warm-started RT loop (identical residuals) while it costs a large
        # share of the step; the cold on_start solve keeps full polish for
        # the warm seed.
        # rho_updates=0 (skip the per-tick cold NS inversion) is faster but
        # must be validated closed-loop per deployment — see ForceAccPlugin.
        # rho_adapt_tol/rho_scale_min: gate cross-tick rho adaptation on
        # residual magnitude + keep a 0.1 floor. Without the gate, converged
        # ticks drift rho_scale to its floor via the noise ratio
        # sqrt(prim/dual), and a transient bound activation (sinusoid peak
        # acceleration) spikes the primal residual past the failure
        # threshold for one tick (measured: worst prim 2.9e-2 -> 1.1e-4
        # over the reference sinusoid experiment with the gate).
        self.solver_opts = dict(refine=2, rho_updates=1, polish_rounds=0,
                                assume_warm_kinv=True, polish_ns_iters=16,
                                warm_kinv_iters=12,
                                rho_adapt_tol=1e-3, rho_scale_min=0.1)
        self.solver_opts.update(solver_opts or {})

        nj = model.nj
        Kc = jnp.eye(6, dtype=dtype) * cart_stiffness
        Dc = jnp.eye(6, dtype=dtype) * cart_damping
        self.ee_left = CartesianImpedanceCtrl(
            "LEFT_ARM", left_ee, indices=Indices.range(0, 2),
            stiffness=Kc, damping=Dc, use_inertia_matrix=True)
        self.ee_right = CartesianImpedanceCtrl(
            "RIGHT_ARM", right_ee, indices=Indices.range(0, 2),
            stiffness=Kc, damping=Dc, use_inertia_matrix=True)
        # Elbow impedance pair — constructed but kept OUT of the stack,
        # mirroring the reference's unused elbow tasks
        # (/root/reference/src/QPPVMPlugin.cpp:154-166, links arm1_4/arm2_4).
        # Link names resolve lazily at assemble time, so construction is safe
        # on models without these links.
        self.elbow_left = CartesianImpedanceCtrl(
            "ELBOW_LEFT", left_ee.rsplit("_", 1)[0] + "_4",
            indices=Indices.range(0, 2), stiffness=Kc, damping=Dc,
            use_inertia_matrix=True)
        self.elbow_right = CartesianImpedanceCtrl(
            "ELBOW_RIGHT", right_ee.rsplit("_", 1)[0] + "_4",
            indices=Indices.range(0, 2), stiffness=Kc, damping=Dc,
            use_inertia_matrix=True)
        self.joint_task = JointImpedanceCtrl(
            stiffness=jnp.full((nj,), joint_stiffness, dtype),
            damping=jnp.full((nj,), joint_damping, dtype),
            use_inertia_matrix=True)
        self.torque_limits = TorqueLimits()
        self.stack = ((self.ee_right + self.ee_left)
                      / self.joint_task) << self.torque_limits

        self._step = jax.jit(self._step_impl)

    def drive_pd_profile(self, robot_k, robot_d,
                         keep_joints=("j_arm1_5", "j_arm1_6", "j_arm1_7",
                                      "j_arm2_5", "j_arm2_6", "j_arm2_7")):
        """Drive-level (k, d) to apply when handing the robot to the QP:
        zero everywhere so the QP torques act unopposed, EXCEPT the wrist
        joints which keep their drive PD (the reference zeroes all gains but
        j_arm{1,2}_{5,6,7}, /root/reference/src/QPPVMPlugin.cpp:80-96; the
        profile is pushed to the drives in on_start at :267-269)."""
        import numpy as np
        robot_k = np.asarray(robot_k, dtype=np.float32)
        robot_d = np.asarray(robot_d, dtype=np.float32)
        k = np.zeros_like(robot_k)
        d = np.zeros_like(robot_d)
        for name in keep_joints:
            try:
                i = self.model.dof_index(name)
            except ValueError:
                continue
            k[i] = robot_k[i]
            d[i] = robot_d[i]
        return jnp.asarray(k), jnp.asarray(d)

    # --- lifecycle ------------------------------------------------------
    def on_start(self, state: RobotState):
        """Capture references at the current configuration and return
        (refs, warm, start_pose) — bumpless start (reference :261-305)."""
        data = dynamics.compute_model_data(self.model, state, need_binv=True)
        refs = self.stack.ref_init(self.model, data, state)
        stack_data = self.stack.build(self.model, data, state, refs,
                                      nx=self.model.nj, dtype=self.dtype)
        from qppvm_tpu.opt import hierarchy as _h
        # seed the warm-start pytree (incl. the carried KKT inverses) with one
        # cold full-accuracy solve, so the RT path can assume a valid hot
        # start from tick 0 (bumpless start, reference :261-305)
        _, warm, _ = _h.solve(stack_data, _h.warm_start_init(stack_data),
                              eps=self.eps, iters=self.iters, refine=2)
        start_pose = dict(refs["LEFT_ARM"])
        return refs, warm, start_pose

    def make_refs(self, start_pose, t, t0=0.0):
        """Moving sinusoid on the left EE (reference :217-223):
        y += 0.15 sin(t - t0), z += 0.15 (1 - cos(t - t0))."""
        p = start_pose["p"]
        dy = 0.15 * jnp.sin(t - t0)
        dz = 0.15 * (1.0 - jnp.cos(t - t0))
        return {"R": start_pose["R"],
                "p": p + jnp.stack([jnp.zeros_like(dy), dy, dz]),
                "v": jnp.zeros(6, p.dtype)}

    def control_loop(self, state: RobotState, refs: Dict[str, Any], warm):
        """One tick: returns (tau_desired, new_warm, aux)."""
        return self._step(state, refs, warm)

    def close(self) -> None:
        """Lifecycle-parity hook: the reference's close() flushes its
        MatLogger (/root/reference/src/QPPVMPlugin.cpp:339-342); here the
        trace flush lives in ControlLoop.close() (which calls this first).
        The plugin carries no cross-session state to release."""

    # --- the jitted tick ------------------------------------------------
    @f32_matmuls
    def _step_impl(self, state: RobotState, refs, warm):
        model = self.model
        state = state.astype(self.dtype)
        refs = jax.tree.map(lambda a: jnp.asarray(a, self.dtype), refs)
        data = dynamics.compute_model_data(model, state, need_binv=True)
        stack_data = self.stack.build(model, data, state, refs,
                                      nx=model.nj, dtype=self.dtype)
        from qppvm_tpu.opt import hierarchy
        # warm-started RT loop: single rho chunk — adaptation carries across
        # ticks (rho_scale in QPState); the KKT inverse is then always the
        # 12-iteration warm NS, never a cold 26-iteration rebuild
        x, warm_new, infos = hierarchy.solve(
            stack_data, warm, eps=self.eps, iters=self.iters,
            **self.solver_opts)
        failed = hierarchy.solve_failed(infos, tol=5e-3)
        tau_qp = jnp.where(failed, jnp.zeros_like(x), x)
        h = data.h
        tau_d = tau_qp + h  # reference :256 (runs also on failure -> tau = h)

        from qppvm_tpu.tasks.base import AssembleCtx
        ctx = AssembleCtx(model=model, data=data, state=state, refs=refs,
                          nx=model.nj, dtype=self.dtype)
        ls, ld = self.ee_left.spring_damper_force(ctx)
        rs, rd = self.ee_right.spring_damper_force(ctx)
        aux = QPPVMAux(
            tau_qp=tau_qp, tau_desired=tau_d, h=h, solver_failed=failed,
            prim_res=jnp.max(jnp.stack([i.prim_res for i in infos])),
            ee_left_err=ls + ld, ee_right_err=rs + rd)
        return tau_d, warm_new, aux
