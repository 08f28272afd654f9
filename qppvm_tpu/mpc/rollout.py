"""Closed-loop WBC rollouts for sampling MPC (BASELINE config 5).

Greenfield capability (no reference counterpart — SURVEY.md §2c): roll out
the floating-base WBC controller (ForceAcc-style QP each step) against the
contact dynamics for H steps under ``lax.scan``, fully vmappable over
thousands of scenarios. The per-rollout QP uses a trimmed iteration budget
(warm-started along the horizon) so the whole rollout stays one fused XLA
program dominated by batched matmuls.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from qppvm_tpu.model import dynamics, kinematics
from qppvm_tpu.model.robot import RobotModel, RobotState
from qppvm_tpu.opt import hierarchy, linalg
from qppvm_tpu.plugins.force_acc import ForceAccPlugin
from qppvm_tpu.precision import f32_matmuls
from qppvm_tpu.runtime.robot_interface import (ground_forces, init_anchors,
                                               stop_torques)


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    horizon: int = 16
    dt: float = 0.01
    qp_iters: int = 30
    # Warm-start the KKT inverse along the horizon (the carried QPState Kinv
    # re-converges by a short guarded Newton-Schulz instead of a cold
    # inversion — same strategy as the RT tick, see opt/qp.py). rho is
    # adapted across steps (rho_updates=0), not inside each solve.
    qp_warm_kinv: bool = True
    # 6 warm-NS iterations: with structural equalities eliminated
    # (opt/qp.py n_eq_*) the carried inverse passes the contraction guard
    # along the horizon (guard err ~0.2 at 1% KKT drift vs ~250 before),
    # so the short warm budget actually re-converges instead of falling
    # back to an under-converged cold init; 8 -> 6 left the 4096x8 plan's
    # health bit-identical (prim_res_max 0.0256, cost unchanged).
    qp_warm_kinv_iters: int = 6
    qp_rho_updates: int = 0
    # rho carry policy for the horizon chain: gate cross-step adaptation on
    # residual magnitude and keep a higher floor than the RT loop. Without
    # the gate, easy warm-started steps drift rho_scale to its floor via the
    # noise ratio sqrt(prim/dual), and the next contact transition blows up
    # the primal residual (measured: prim 0.2 vs dual 1e-4 at a foot
    # unloading under 30 N pushes, unrecoverable within the budget).
    qp_rho_adapt_tol: float = 1e-3
    qp_rho_scale_min: float = 0.1
    # Trimmed per-step fixed costs (the iteration-independent solver work —
    # Ruiz + eq-elim pinv + K build + NS inverse — is a large share of a
    # rollout step, tools/profile_mpc_stages.py): 2 Ruiz sweeps reach
    # within a few percent of the 5-sweep equilibration on WBC stacks, and the eq-pinv NS is quadratic from an
    # always-contractive start so 5 iterations already hit ~1e-9 on
    # well-separated equality rows. Health-gated like everything else.
    qp_scale_iters: int = 2
    qp_pinv_ns_iters: int = 5
    # Relative-primal-residual threshold above which a rollout step counts
    # as a solver failure. Deliberately looser than the RT-loop gate
    # (ForceAccPlugin.RT_FAIL_TOL = 5e-3): rollout QPs run trimmed iteration
    # budgets to *rank* MPPI samples, so this flags genuinely
    # infeasible/diverged scenarios, not merely loosely converged solves.
    # The raw worst residual is surfaced alongside for stricter policies.
    fail_tol: float = 0.05
    # NOTE: with sim_substeps > 1, kinematics and contact forces are
    # refreshed per substep but the mass matrix B (and its warm
    # inverse) stays frozen at the step-start state — a deliberate perf
    # tradeoff (B drifts slowly at dt=10 ms; a per-substep CRBA would cost
    # a large share of the rollout step). The approximation error is
    # O(substep * qd * dB/dq), negligible against the contact-model
    # stiffness; callers needing exact substep inertia should set
    # sim_substeps=1 with a smaller dt.
    sim_substeps: int = 1
    contact_kp: float = 2e4
    contact_kd: float = 300.0
    mu: float = 0.8
    # Tangential stiction parameters, h-scaled for the rollout's COARSE
    # substep (plant: kt=2e4, kd_t=5*kd_c=1500 at h=0.25-0.5 ms). The
    # contact MODEL is the plant's (runtime.robot_interface.ground_forces:
    # stiction anchors, patches, moments), but a semi-implicit Euler step is
    # only stable while h*sqrt(kt/m_eff) < 2 and h*kd_t/m_eff < 2; at the
    # rollout's h ~ 10 ms the plant's stiff values chatter at the friction-
    # cone limit and the jittered states blow the rollout QPs (measured:
    # prim_res 5e-2 on NOMINAL standing rollouts). These defaults keep the
    # anchors' stiction semantics with poles inside the coarse-step
    # stability region. tests/test_rollout_physics.py pins one-step
    # equivalence at MATCHED params; the gap these h-scaled DEPLOYED
    # values leave against the true plant (closed loop, real cadence) is
    # measured and bounded in tests/test_rollout_deployed_gap.py.
    contact_kt: float = 4e3
    contact_kd_t: float = 100.0
    # joint hard-stop gains (runtime.robot_interface.stop_torques), h-scaled
    # like the tangential contact params (plant: 2e3/20 at h ~ 0.5 ms)
    stop_kp: float = 200.0
    stop_kd: float = 5.0
    ground_z: float = 0.0


def standing_state(model: RobotModel, contact_links: Sequence[str],
                   cfg: "RolloutConfig" = None) -> RobotState:
    """Home state shifted so the contact links stand ON the ground in static
    equilibrium: lowest contact at ``ground_z`` plus the penetration depth at
    which the compliant contact (kp per contact) carries the robot's weight.
    Starting rollouts from here avoids the free-fall/impact transient of a
    bare ``home_state()`` (the reference robot starts standing in Gazebo,
    /root/reference/src/ForceAcc.cpp:52-55)."""
    cfg = cfg or RolloutConfig()
    st = model.home_state()
    kin = kinematics.fk(model, st)
    idx = [model.link_index(c) for c in contact_links]
    # Pure device computation — no host readback (float()/np.asarray).
    foot_z = jnp.min(jnp.stack([kin.p[li][2] for li in idx]))
    mass = jnp.sum(model.inertia[:, 3, 3]) + model.base_inertia[3, 3]
    g = jnp.linalg.norm(model.gravity)
    pen = mass * g / (len(idx) * cfg.contact_kp)
    shift = foot_z - cfg.ground_z + pen
    zero = jnp.zeros((), st.base_pos.dtype)
    return dataclasses.replace(
        st, base_pos=st.base_pos - jnp.stack([zero, zero,
                                              shift.astype(st.base_pos.dtype)]))




def make_swing_primitive(plugin: ForceAccPlugin, *, z_lift: float = 0.05,
                         t0_max: float = 0.3, dur_frac: float = 0.8,
                         dxy_max: float = 0.25, span_s: float = None,
                         swing_kp: float = 150.0, swing_w: float = 4.0,
                         postural_deweight: float = 0.05):
    """Footstep-recovery primitive: a LOW-DIMENSIONAL continuous decision
    ``theta`` that schedules one swing inside the MPC horizon, shared by the
    rollout dynamics and the execution harness (so the plan and the robot
    run the SAME primitive).

        theta = {"swing": (nc,) logits  — which feet swing (soft choice),
                 "t0":    ()   logit    — when the swing starts,
                 "dxy":   (2,)          — where the foothold moves}

    At horizon fraction t the per-foot swing activation is
    ``a_i * sin(pi * ph)`` with ``ph = clip((t - t0)/dur, 0, 1)`` — the
    contact gate ramps OFF and back ON continuously (the validated
    contact-switch recipe, runtime/contact_switch.py) while the foot
    reference lifts ``z_lift * sin(pi*ph)`` and advances ``dxy`` by a
    smoothstep. Everything is smooth in theta, so MPPI's exponential
    averaging of sampled thetas stays meaningful, and fractional gates are
    exactly the gate semantics the constraint layer defines
    (tasks/generic.py). Lean-only planning is theta = init_theta (swing
    logits at -4 -> activation ~0.02).

    The swing is EXECUTABLE, not just commanded: like the validated
    LegLiftScript recipe (runtime/contact_switch.py tuning notes), the
    active swing foot's task gains/weight ramp up to ``swing_kp``/
    ``swing_w``, its leg's postural rows deweight, and (when ``span_s``,
    the horizon length in seconds, is given) the reference carries velocity
    feedforward — at stance gains (kp 25) the foot task simply cannot track
    a 6 cm lift inside a sub-second horizon and the foot never leaves the
    ground (measured: integral swing-foot height < 0 at full activation).
    Everything stays smooth in theta.

    Returns (apply, init_theta): ``apply(refs_t, theta, t_frac) -> refs_t``.
    """
    links = plugin.contact_links
    model = plugin.model
    # actuated-joint mask of each foot's leg chain (postural deweight)
    from qppvm_tpu.runtime.contact_switch import chain_joints
    leg_masks = []
    for cl in links:
        m = jnp.zeros((model.nj,), jnp.float32)
        idx = [j for j in chain_joints(model, cl) if j < model.nj]
        leg_masks.append(m.at[jnp.asarray(idx)].set(1.0))

    def _ss(x):
        x = jnp.clip(x, 0.0, 1.0)
        return x * x * (3.0 - 2.0 * x)

    # phase layout inside the swing window (fractions of ph in [0, 1]):
    # unload envelope ramps 0->1 over the first RAMP, holds 1, ramps back
    # over the last RAMP; the LIFT happens strictly INSIDE the unloaded
    # plateau. A single sin-shaped gate (the round-3 version) never fully
    # unloads before lifting — at gate 0.6 the cone still demands ~6 N of
    # ground force and the foot task cannot break contact (measured:
    # commanded ref_z +5 cm, physical foot_z pinned at -6 mm).
    RAMP = 0.15
    LIFT0, LIFT1 = RAMP, 1.0 - RAMP

    def apply(refs_t, theta, t_frac):
        a = jax.nn.sigmoid(theta["swing"])            # (nc,)
        t0 = jax.nn.sigmoid(theta["t0"]) * t0_max
        ph = jnp.clip((t_frac - t0) / dur_frac, 0.0, 1.0)
        g_act = _ss(ph / RAMP) * _ss((1.0 - ph) / RAMP)   # unload envelope
        phz = jnp.clip((ph - LIFT0) / (LIFT1 - LIFT0), 0.0, 1.0)
        box = jnp.sin(jnp.pi * phz)                       # lift profile
        smooth = _ss(phz)                                 # xy progress
        dxy = jnp.clip(theta["dxy"], -dxy_max, dxy_max)
        refs_t = dict(refs_t)
        # SQUARED gate factor: sigmoid activation floors 1 - a at ~0.05
        # even for decisive swing logits, and through that residual gate
        # ForceReg still pulls ~8 N of commanded ground force — the leg
        # presses its own swing foot down (measured: foot pinned at -1 mm
        # at full activation). Squaring sends the floor to ~2e-3 (0.4 N)
        # while staying smooth in theta.
        gates = refs_t["contacts"]["active"] * (1.0 - a * g_act) ** 2
        refs_t["contacts"] = {"active": gates}
        dp = jnp.concatenate([dxy * smooth,
                              jnp.reshape(z_lift * box, (1,))])
        if span_s is not None:
            # d/dt feedforward of the primitive trajectory (real seconds)
            in_lift = (phz > 0.0) & (phz < 1.0)
            dphzdt = jnp.where(
                in_lift, 1.0 / ((LIFT1 - LIFT0) * dur_frac * span_s), 0.0)
            dbox = jnp.pi * jnp.cos(jnp.pi * phz) * dphzdt
            dsmooth = 6.0 * phz * (1.0 - phz) * dphzdt
            dv = jnp.concatenate([dxy * dsmooth,
                                  jnp.reshape(z_lift * dbox, (1,))])
        else:
            dv = None
        kd_swing = 2.0 * jnp.sqrt(swing_kp)
        for i, cl in enumerate(links):
            key = cl + "_cartesian"
            tr = dict(refs_t[key])
            act = a[i] * g_act
            tr["p"] = tr["p"] + a[i] * dp
            if dv is not None:
                tr["v"] = tr["v"].at[:3].add(a[i] * dv)
            tr["kp"] = tr["kp"] + act * (swing_kp - tr["kp"])
            tr["kd"] = tr["kd"] + act * (kd_swing - tr["kd"])
            tr["w"] = tr["w"] + act * (swing_w - tr["w"])
            refs_t[key] = tr
        po = dict(refs_t["POSTURAL"])
        de = 1.0
        for i in range(len(links)):
            de_i = (1.0 - a[i] * g_act * (1.0 - postural_deweight)
                    * leg_masks[i])
            de = de * de_i
        po["w"] = po["w"] * de
        refs_t["POSTURAL"] = po
        return refs_t

    def init_theta(dtype=jnp.float32):
        return {"swing": jnp.full((len(links),), -4.0, dtype),
                "t0": jnp.zeros((), dtype),
                "dxy": jnp.zeros((2,), dtype)}

    return apply, init_theta


def make_capture_terminal_cost(plugin: ForceAccPlugin, *,
                               weight: float = 600.0,
                               z_contact: float = 0.03,
                               sharpness: float = 0.008,
                               far_m2: float = 4.0,
                               g: float = 9.81) -> Callable:
    """Instantaneous-capture-point terminal cost: the value beyond the
    rollout horizon (the trimmed chain is stable to
    ~0.7 s while a fall from holding lands at ~1.0 s, so a finite-horizon
    cost comparison is blind exactly at the step-vs-hold decision).

    The ICP  xi = com_xy + com_vel_xy * sqrt(com_z / g)  is where the CoM
    will settle if the robot does nothing but balance; a state is
    capturable iff xi lies over the support. The terminal cost is
    ``weight * smoothmin_i(|xi - p_i|^2 + (1 - w_i) * far_m2)`` over the
    contact feet, with w_i a smooth height gate (feet in the air cannot
    capture; ``far_m2`` prices them as a 2 m-away support). A candidate
    that re-plants a foot under the ICP zeroes this term; holding with
    the ICP outside the stance patch pays ~weight * |xi - p_stance|^2 —
    the post-horizon fall the stage costs cannot see.

    LIPM theory (Pratt's capture point / Koolen et al. capturability);
    implementation is this repo's own. Pure function of the final state —
    safe inside vmap/scan/jit.
    """
    model = plugin.model
    contact_idx = tuple(model.link_index(c) for c in plugin.contact_links)

    def term(model_, state: RobotState):
        kin = kinematics.fk(model_, state)
        _, com_p = kinematics.com(model_, kin)
        vel_all = kinematics.link_velocities(model_, kin, state)
        com_v = kinematics.com_velocity(model_, kin, state, vel_all)
        omega = jnp.sqrt(jnp.maximum(com_p[2], 0.05) / g)
        icp = com_p[:2] + com_v[:2] * omega
        p_feet = jnp.stack([kin.p[li] for li in contact_idx])  # (nc, 3)
        w = jax.nn.sigmoid((z_contact - p_feet[:, 2]) / sharpness)
        d2 = jnp.sum((icp[None, :] - p_feet[:, :2]) ** 2, axis=-1) \
            + (1.0 - w) * far_m2
        # smooth min over feet (temperature 1 cm^2): the NEAREST loaded
        # foot is the capture support
        tau_t = 1e-2
        d2_min = -tau_t * jax.nn.logsumexp(-d2 / tau_t)
        return weight * d2_min

    return term


def make_rollout_fn(plugin: ForceAccPlugin, cfg: RolloutConfig,
                    cost_fn: Callable, swing=None, contact_offsets=None,
                    terminal_cost: Optional[Callable] = None):
    """Build rollout(state0, refs0, warm0, controls, scenario[, theta])
    -> (cost, health).

    ``controls``: (H, 3) waist-reference velocity offsets integrated into the
    waist position reference each step (the MPC decision sequence).
    ``scenario``: pytree of domain-randomization inputs:
      - "push"       (H, 3) external base force [required]
      - "mass_scale" ()     true-robot inertia scale: the SIM runs the
        scaled model while the CONTROLLER keeps the nominal one —
        model-mismatch robustness, not merely disturbance robustness
      - "mu_scale"   ()     ground-friction scale on cfg.mu
      - "gate_seq"   (H, nc) per-step contact-gate multipliers (exercises
        the contact-switch machinery INSIDE the horizon; requires a
        switchable_contacts plugin)
    ``swing``: optional footstep primitive (make_swing_primitive's apply);
    the rollout then takes a trailing ``theta`` decision argument.
    ``contact_offsets``: optional dict link_name -> (K, 3) local contact
    points (flat-foot patches), same convention as SimRobot — pass the
    plant's patches so the rollout feels the same contact moments.

    The rollout's ground contact is ``runtime.robot_interface.ground_forces``
    — the SAME function the SimRobot plant integrates (stiction anchors,
    foot patches, contact moments), so planner physics cannot drift from
    the sim it is validated against. Per-rollout
    anchor state is carried along the horizon exactly like the plant's.
    """
    model = plugin.model
    contact_idx = tuple(model.link_index(c) for c in plugin.contact_links)
    offs = []
    import numpy as _np
    for l in plugin.contact_links:
        if contact_offsets and l in contact_offsets:
            offs.append(tuple(map(tuple, _np.asarray(
                contact_offsets[l], float).reshape(-1, 3).tolist())))
        else:
            offs.append(((0.0, 0.0, 0.0),))
    contact_offs = tuple(offs)
    auto_gate = plugin.switchable_contacts
    # full-nv armature diagonal (zeros on the floating 6): B scales with the
    # body inertias EXCEPT this additive rotor term, so the scenario-scaled
    # sim mass matrix is the cheap affine update s*B + (1-s)*diag(arm)
    arm_full = jnp.zeros(model.nv)
    off6 = 6 if model.floating else 0
    arm_full = arm_full.at[off6:].set(model.armature)

    def one_step(carry, inp):
        state, refs, warm, waist_p, binv, anchors, scen, theta = carry
        u_ctrl, push, gate_t, t_frac = inp
        waist_p = waist_p + u_ctrl * cfg.dt
        refs_t = dict(refs)
        wt = dict(refs_t["waist_task"])
        wt["p"] = waist_p
        refs_t["waist_task"] = wt
        if gate_t is not None:
            ct = dict(refs_t["contacts"])
            ct["active"] = ct["active"] * gate_t
            refs_t["contacts"] = ct
        if swing is not None and theta is not None:
            refs_t = swing(refs_t, theta, t_frac)
        if auto_gate:
            # Contact-aware gating: a foot that has physically left the
            # ground cannot carry its fz >= fz_min unilateral bound — a
            # TOPPLING rollout would otherwise be infeasible BY
            # CONSTRUCTION (measured: 100% fail_frac at a 2 m/s shove) and
            # the planner blind exactly where planning matters. Smooth
            # height gate, composed with command/scenario gates.
            kin_g = kinematics.fk(model, state)
            fz_gate = []
            for li in contact_idx:
                fz_gate.append(jax.nn.sigmoid(
                    (0.01 - kin_g.p[li][2]) / 0.004))
            ct = dict(refs_t["contacts"])
            ct["active"] = ct["active"] * jnp.stack(fz_gate)
            refs_t["contacts"] = ct

        # THE SAME tick implementation as the RT plugin step (never drifts
        # from it), with the rollout's trimmed solver profile layered on top.
        tau, warm, aux, (data, *_rest) = plugin.step_core(
            state, refs_t, warm, solver_opts=rollout_solver_opts)
        # actuator saturation: the rollout must not promise torques the
        # drives cannot deliver (SimRobot clips identically), then joint
        # hard stops (the plant's mechanism, h-scaled gains)
        tau = jnp.clip(tau, -model.tau_max, model.tau_max)
        tau = tau + stop_torques(model, state, k_stop=cfg.stop_kp,
                                 d_stop=cfg.stop_kd)

        # Warm mass-matrix inverse carried along the horizon: B drifts
        # slowly at dt=10 ms, so a guarded 4-iteration NS refresh from last
        # step's inverse replaces a 22-iteration cold inversion per sim
        # step. The control tick's
        # ModelData.B is reused — same state, no second CRBA.
        # Domain randomization: the SIM side runs the mass-scaled model
        # (controller stays nominal — model mismatch is the point); the
        # scaled mass matrix is affine in data.B (armature is additive)
        ms = scen["mass_scale"]
        model_s = dataclasses.replace(
            model, inertia=model.inertia * ms,
            base_inertia=model.base_inertia * ms)
        B_s = ms * data.B + (1.0 - ms) * jnp.diag(
            arm_full.astype(data.B.dtype))
        Breg = B_s + 1e-9 * jnp.eye(model.nv, dtype=data.B.dtype)
        binv = linalg.ns_warm_inverse(Breg, binv, iters=4)
        mu_t = cfg.mu * scen["mu_scale"]

        # physics with disturbance push on the base (world frame, at base):
        # THE SAME ground-contact model as the SimRobot plant
        # (runtime.robot_interface.ground_forces — stiction anchors, foot
        # patches, contact moments), with the rollout's traced mu.
        dtype = state.q.dtype
        for sub_i in range(max(1, cfg.sim_substeps)):
            kin = data.kin if sub_i == 0 else kinematics.fk(model, state)
            J_all = (data.J_all if sub_i == 0
                     else kinematics.all_link_jacobians(model, kin))
            ext, anchors = ground_forces(
                model, contact_idx, contact_offs, cfg.ground_z,
                cfg.contact_kp, cfg.contact_kd, mu_t, cfg.contact_kt,
                kin, J_all, state.u, anchors, dtype,
                kd_t=cfg.contact_kd_t)
            udot = dynamics.forward_dynamics(
                model_s, state, tau, ext_wrenches=ext, kin=kin,
                B=B_s, binv=binv)
            # add base push as direct base acceleration (world force / mass)
            state = dynamics.integrate(model, state, udot,
                                       cfg.dt / max(1, cfg.sim_substeps))
            # inject push as velocity perturbation (impulse approximation)
            dv = push * (cfg.dt / max(1, cfg.sim_substeps))
            base_vel = state.base_vel.at[3:].add(
                jnp.einsum("ji,j->i", state.base_rot, dv))
            state = dataclasses.replace(state, base_vel=base_vel)

        c = cost_fn(model, state, tau, aux)
        # Per-step solver health (SURVEY.md §5: per-rollout residual
        # reporting so infeasible scenarios are detectable in the MPC batch).
        prim = jnp.max(jnp.stack([i.prim_res for i in aux]))
        failed = hierarchy.solve_failed(aux, tol=cfg.fail_tol)
        return (state, refs, warm, waist_p, binv, anchors, scen, theta), \
            (c, prim, failed)

    # Rollout solver profile: the plugin's own solver_opts (incl. method,
    # reg profile, any user overrides) with the horizon-chain knobs layered
    # on top — trimmed iteration budget, no polish, warm-KKT reuse along
    # the scan.
    rollout_solver_opts = dict(
        iters=cfg.qp_iters, refine=0, polish_rounds=0,
        rho_updates=cfg.qp_rho_updates,
        assume_warm_kinv=cfg.qp_warm_kinv,
        warm_kinv_iters=cfg.qp_warm_kinv_iters,
        rho_adapt_tol=cfg.qp_rho_adapt_tol,
        rho_scale_min=cfg.qp_rho_scale_min,
        scale_iters=cfg.qp_scale_iters,
        pinv_ns_iters=cfg.qp_pinv_ns_iters)

    @f32_matmuls
    def rollout(state0: RobotState, refs0, warm0, controls, scenario,
                theta=None):
        """Returns (total_cost, health) where ``health`` reports the worst
        QP residual / failure flag over the horizon — the batch-MPC analog
        of the reference's per-tick solve-failure signal
        (/root/reference/src/ForceAcc.cpp:189-193)."""
        # pin everything to the plugin dtype (callers under x64 test configs
        # would otherwise leak float64 into the scan carry)
        dt = plugin.dtype
        state0 = state0.astype(dt)
        refs0 = jax.tree.map(lambda a: jnp.asarray(a, dt), refs0)
        controls = jnp.asarray(controls, dt)
        scenario = jax.tree.map(lambda a: jnp.asarray(a, dt), scenario)
        push = scenario["push"]  # (H, 3)
        H = push.shape[0]
        one = jnp.ones((), dt)
        scen = {"mass_scale": scenario.get("mass_scale", one),
                "mu_scale": scenario.get("mu_scale", one)}
        gate_seq = scenario.get("gate_seq", None)
        t_fracs = (jnp.arange(H, dtype=dt) + 0.5) / H
        if theta is not None:
            theta = jax.tree.map(lambda a: jnp.asarray(a, dt), theta)
        waist_p0 = refs0["waist_task"]["p"]
        # warm Binv seed: ONE full cold inversion per rollout (amortized
        # over the horizon). A zeros seed would make step 0 fall back to
        # the 4-iteration cold path, which on a cond~1e3 mass matrix leaves
        # ~98% inverse error — enough to corrupt the first sim step.
        B0 = (dynamics.mass_matrix(model, state0)
              + 1e-9 * jnp.eye(model.nv, dtype=dt))
        binv0 = linalg.spd_inverse_ns(B0, iters=22, refine=2)
        # per-rollout stiction-anchor seed: contact-point xy at the start
        # state (the plant does the same at construction)
        anchors0 = init_anchors(model, state0, contact_idx, contact_offs, dt)
        xs = (controls, push, gate_seq, t_fracs)
        carry_f, (costs, prims, fails) = jax.lax.scan(
            one_step,
            (state0, refs0, warm0, waist_p0, binv0, anchors0, scen, theta),
            xs)
        health = {"prim_res_max": jnp.max(prims),
                  "solver_failed": jnp.any(fails)}
        total = jnp.sum(costs)
        if terminal_cost is not None:
            # value beyond the horizon (e.g. make_capture_terminal_cost):
            # evaluated on the FINAL state so step-vs-hold decisions are
            # not blind past the stable rollout horizon
            total = total + terminal_cost(model, carry_f[0])
        return total, health

    def init_carry(state0: RobotState, refs0, warm0, scenario=None,
                   theta=None):
        """The scan carry ``rollout`` starts from — exposed so callers can
        drive ``rollout.one_step`` directly (physics-parity tests, the
        ring-horizon multiple-shooting composition in parallel/ring_horizon
        where the carry IS the ppermute payload)."""
        dt = plugin.dtype
        state0 = state0.astype(dt)
        refs0 = jax.tree.map(lambda a: jnp.asarray(a, dt), refs0)
        one = jnp.ones((), dt)
        scenario = scenario or {}
        scen = {"mass_scale": jnp.asarray(
                    scenario.get("mass_scale", one), dt),
                "mu_scale": jnp.asarray(scenario.get("mu_scale", one), dt)}
        if theta is not None:
            theta = jax.tree.map(lambda a: jnp.asarray(a, dt), theta)
        B0 = (dynamics.mass_matrix(model, state0)
              + 1e-9 * jnp.eye(model.nv, dtype=dt))
        binv0 = linalg.spd_inverse_ns(B0, iters=22, refine=2)
        anchors0 = init_anchors(model, state0, contact_idx, contact_offs, dt)
        return (state0, refs0, warm0, refs0["waist_task"]["p"], binv0,
                anchors0, scen, theta)

    rollout.one_step = one_step
    rollout.init_carry = init_carry
    rollout.solver_opts = rollout_solver_opts
    return rollout


def default_cost(model: RobotModel, state: RobotState, tau, aux,
                 target_height: float = None):
    """Stay upright + keep base height + low effort."""
    up = state.base_rot[2, 2]              # cos(tilt)
    tilt_cost = 50.0 * (1.0 - up)
    vel_cost = 0.1 * jnp.sum(state.base_vel ** 2)
    effort = 1e-5 * jnp.sum(tau ** 2)
    qd_cost = 1e-3 * jnp.sum(state.qd ** 2)
    fall = 200.0 * jnp.maximum(0.3 - state.base_pos[2], 0.0)
    return tilt_cost + vel_cost + effort + qd_cost + fall
