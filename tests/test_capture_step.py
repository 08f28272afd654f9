"""Capture-step recovery, executed closed-loop.

Scenario: the zoo humanoid holds SINGLE SUPPORT (the validated round-3
maneuver) and is shoved laterally toward the lifted-foot side. With one
sole of support the capture point leaves the stance foot immediately —
holding the posture (lean-only) deterministically topples. The capture-
step planner evaluates a FIXED candidate library of swing-primitive
decisions (theta) by rolling each out through the SAME WBC-in-the-loop
dynamics the sampling MPC uses (mpc/rollout.py — plan and execution run
the same primitive and the same reunified plant physics), picks the best,
and EXECUTES it to completion through the shared swing primitive.

Everything is deterministic — no sampling, no seeds: the candidate
evaluation replaces MPPI's stochastic search (the sampled channel is
covered by test_mpc_scenarios), so the round-2/3 seed-sensitivity is gone
by construction.

Round 5 closes the round-4 myopia gap: the planner
now evaluates a PLANT-FIDELITY horizon — dt 0.01 s x 100 steps (1.0 s),
8 substeps (substep h = 1.25 ms), the plant's true stiction parameters
instead of the coarse-step h-scaled ones, and the ICP terminal cost —
long enough that holding's fall (~1.0 s) lands INSIDE the horizon. The
argmin runs over the FULL library: null (keep holding), both crossover
steps, and the round-4 excluded downwind re-plant. Measured ranking
(CPU, deterministic): cross_near 3482 < cross_far 5029 < replant_down
5173 < null 6438 — the planner CHOOSES to step, and chooses the
candidate that executes best (cross_near recovers; null falls at
~1.03 s; replant_down executes worst of the steps). ``fail_tol`` is 0.2
at this config: a 1.2 m/s shove recovery transiently spikes the trimmed
chain's relative primal residual to ~0.13 without diverging; genuinely
broken rollouts still flag (NaN costs are penalized separately).

Asserts:
- the full-library argmin picks a crossover step (not null, not the
  downwind re-plant), and ranks cross_near best — matching execution;
- lean-only (no step authority) falls;
- the executed capture step physically swings the chosen foot >= 5 cm and
  the robot is still upright WITH MARGIN at the tick where lean-only has
  already fallen.

Match: BASELINE north star; the contact machinery of
/root/reference/src/ForceAcc.cpp:74-96 upgraded to a planned, executed
contact change the planner can DECIDE on.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from qppvm_tpu.model import kinematics, zoo
from qppvm_tpu.mpc.rollout import (RolloutConfig, default_cost,
                                   make_capture_terminal_cost,
                                   make_rollout_fn, make_swing_primitive)
from qppvm_tpu.plugins.force_acc import ForceAccPlugin
from qppvm_tpu.runtime.contact_switch import LegLiftPhases, LegLiftScript
from qppvm_tpu.runtime.robot_interface import SimRobot, standing_state

CONTACTS = ("l_sole", "r_sole")
PATCH = [[0.10, 0.05, 0.0], [0.10, -0.05, 0.0],
         [-0.06, 0.05, 0.0], [-0.06, -0.05, 0.0]]
PUSH_VY = 1.2
# plant-fidelity planning horizon (see module docstring): 1.0 s at the
# plant's own stiction parameters, past holding's ~1.03 s fall
H, RDT, RSUB = 100, 0.01, 8


def _setup_single_support():
    model = zoo.humanoid()
    plugin = ForceAccPlugin(model, contact_links=CONTACTS,
                            waist_link="pelvis", iters=40,
                            switchable_contacts=True,
                            use_friction_cones=True, mu=0.6, wrench_dim=6,
                            foot_tasks_6d=False)
    st = standing_state(model, CONTACTS)
    offsets = {c: PATCH for c in CONTACTS}
    robot = SimRobot(model, state=st, dt=1e-3, substeps=2,
                     contact_links=CONTACTS, contact_offsets=offsets)
    refs, warm, initial_waist = plugin.on_start(robot.state)
    phases = LegLiftPhases(settle=150, shift=450, dwell=150, unload=180,
                           lift=250, hold=600, lower=250, reload=200)
    script = LegLiftScript(model, plugin, refs, initial_waist, "l_sole",
                           state=robot.state, phases=phases,
                           lift_height=0.04, swing_kp=100.0, swing_w=3.0)
    for i in range(script.t_hold0 + 100):
        state = robot.state
        tau, warm, aux = plugin.control_loop(state, script.refs_at(i), warm)
        assert not bool(aux.solver_failed), f"setup tick {i}"
        robot.set_reference(tau_ref=tau, q_ref=state.q)
        robot.move()
    base_refs = dict(refs)
    wt = dict(base_refs["waist_task"])
    wt["p"] = script.w1
    base_refs["waist_task"] = wt
    return model, plugin, robot, base_refs, warm, offsets


def _shove(robot):
    bv = robot.state.base_vel.at[4].add(PUSH_VY)
    robot.state = dataclasses.replace(robot.state, base_vel=bv)


def _run(model, plugin, robot, base_refs, warm, theta, swing, ticks):
    """Execute ``theta`` (or hold, if None) from the shoved state; the
    waist reference follows the support centroid. Returns (fall_tick or
    None, up trace, swing-foot xy trace, rt_fail_count)."""
    span_ticks = int(H * RDT * 1e3)
    waist_p = base_refs["waist_task"]["p"]
    ups, foot_xy = [], []
    li = model.link_index("r_sole")
    fall_tick = None
    rt_fails = 0
    for i in range(ticks):
        state = robot.state
        if i % 40 == 0:
            kin_p = kinematics.fk(model, state)
            fm = jnp.mean(jnp.stack(
                [kin_p.p[model.link_index(c)][:2] for c in CONTACTS]),
                axis=0)
            waist_p = waist_p.at[:2].set(
                waist_p[:2] + 0.5 * (fm - waist_p[:2]))
        refs_t = dict(base_refs)
        wt = dict(refs_t["waist_task"])
        wt["p"] = waist_p
        refs_t["waist_task"] = wt
        if theta is not None and i < span_ticks:
            t_frac = jnp.asarray(i / span_ticks, jnp.float32)
            refs_t = swing(refs_t, theta, t_frac)
        tau, warm, aux = plugin.control_loop(state, refs_t, warm)
        rt_fails += int(bool(aux.solver_failed))
        robot.set_reference(tau_ref=tau, q_ref=state.q)
        robot.move()
        up = float(robot.state.base_rot[2, 2])
        ups.append(up)
        kin = kinematics.fk(model, robot.state)
        foot_xy.append(np.asarray(kin.p[li][:2]))
        if up < 0.7 and fall_tick is None:
            fall_tick = i
            break
    return fall_tick, np.asarray(ups), np.asarray(foot_xy), rt_fails


def test_capture_step_recovery_closed_loop():
    model, plugin, robot, base_refs, warm, offsets = _setup_single_support()
    snap = (robot.state, robot._anchors)

    # --- the planner: deterministic FULL-library evaluation through the
    # shared rollout dynamics at PLANT fidelity (same primitive, same
    # contact model, the plant's own stiction params, ICP terminal) -----
    rcfg = RolloutConfig(horizon=H, qp_iters=30, dt=RDT, sim_substeps=RSUB,
                         contact_kp=2e4, contact_kd=300.0,
                         contact_kt=2e4, contact_kd_t=1500.0,
                         stop_kp=2e3, stop_kd=20.0, fail_tol=0.2)
    swing, init_theta = make_swing_primitive(plugin, span_s=H * RDT)
    term = make_capture_terminal_cost(plugin)
    rollout = jax.jit(make_rollout_fn(plugin, rcfg, default_cost,
                                      swing=swing, terminal_cost=term,
                                      contact_offsets=offsets))
    stp = dataclasses.replace(
        robot.state, base_vel=robot.state.base_vel.at[4].add(PUSH_VY))
    U0 = jnp.zeros((H, 3), jnp.float32)
    scen = {"push": jnp.zeros((H, 3), jnp.float32)}
    # The FULL footstep library — including null (keep holding) and the
    # downwind re-plant of the already-lifted foot that round 4 had to
    # exclude (it ranked well under the myopic h-scaled horizon but
    # executed worst). Measured executed outcomes from this state:
    # cross steps recover (upright past lean-only's fall with margin),
    # null falls at ~1.03 s, replant_down falls fastest of the steps.
    candidates = {
        "null": init_theta(),
        "cross_near": {"swing": jnp.asarray([-8.0, 3.0]),
                       "t0": jnp.asarray(-3.0),
                       "dxy": jnp.asarray([0.05, 0.05])},
        "cross_far": {"swing": jnp.asarray([-8.0, 3.0]),
                      "t0": jnp.asarray(-3.0),
                      "dxy": jnp.asarray([0.05, 0.15])},
        "replant_down": {"swing": jnp.asarray([3.0, -8.0]),
                         "t0": jnp.asarray(-3.0),
                         "dxy": jnp.asarray([0.05, 0.10])},
    }
    costs = {}
    for name, th in candidates.items():
        c, health = rollout(stp, base_refs, warm, U0, scen, th)
        # at plant fidelity the 1.2 m/s shove recovery transiently spikes
        # residuals; genuinely diverged rollouts produce non-finite costs
        assert np.isfinite(float(c)), (name, health)
        costs[name] = float(c)
    # THE decision: the argmin over the full library — null included —
    # chooses to step, with the landing that executes best
    best = min(candidates, key=costs.get)
    assert best == "cross_near", costs
    assert costs["null"] > costs[best], costs
    assert costs["replant_down"] > costs[best], costs

    # --- arm A: lean-only (no step authority) falls ----------------------
    _shove(robot)
    fall_lean, ups_lean, _, _ = _run(model, plugin, robot, base_refs, warm,
                                     None, swing, ticks=1300)
    assert fall_lean is not None, "lean-only unexpectedly survived"

    # --- arm B: execute the planner's chosen theta through the shared
    # primitive from the IDENTICAL state ---------------------------------
    robot.state, robot._anchors = snap
    _shove(robot)
    theta_c = candidates[best]
    fall_step, ups_step, foot_xy, rt_fails = _run(
        model, plugin, robot, base_refs, warm, theta_c, swing,
        ticks=fall_lean + 200)
    # the chosen foot PHYSICALLY stepped (swing executed, not just planned)
    step_len = float(np.linalg.norm(foot_xy[-1] - foot_xy[0]))
    assert step_len > 0.05, step_len
    # upright with margin at (and past) the tick where lean-only fell
    assert fall_step is None or fall_step > fall_lean + 150, (
        fall_lean, fall_step)
    assert ups_step[fall_lean] > 0.9, ups_step[fall_lean]
    # solver failures confined to the shove/step transient
    assert rt_fails < 0.05 * (fall_lean + 200), rt_fails
