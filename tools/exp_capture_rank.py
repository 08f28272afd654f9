"""Capture-step library ranking WITH the ICP terminal cost, checked
against executed outcomes (the argmin must run over
the FULL library including null and the downwind re-plant, choose a step,
and match execution).

Replays tests/test_capture_step.py's scenario: zoo humanoid in single
support, shoved toward the lifted-foot side. Every candidate is (a)
rolled out through the shared WBC-in-the-loop dynamics with
make_capture_terminal_cost appended, and (b) executed closed-loop on the
plant to its ground-truth fall tick. Prints the cost table + outcomes.
"""
import jax
jax.config.update("jax_platforms", "cpu")

import dataclasses

import numpy as np
import jax.numpy as jnp

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
H, RDT = 12, 0.06


def setup():
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
        assert not bool(aux.solver_failed), i
        robot.set_reference(tau_ref=tau, q_ref=state.q)
        robot.move()
    base_refs = dict(refs)
    wt = dict(base_refs["waist_task"])
    wt["p"] = script.w1
    base_refs["waist_task"] = wt
    return model, plugin, robot, base_refs, warm


def run_exec(model, plugin, robot, base_refs, warm, theta, swing, ticks):
    span_ticks = int(H * RDT * 1e3)
    waist_p = base_refs["waist_task"]["p"]
    fall_tick = None
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
        robot.set_reference(tau_ref=tau, q_ref=state.q)
        robot.move()
        if float(robot.state.base_rot[2, 2]) < 0.7:
            fall_tick = i
            break
    return fall_tick


def main():
    model, plugin, robot, base_refs, warm = setup()
    snap = (robot.state, robot._anchors)

    rcfg = RolloutConfig(horizon=H, qp_iters=30, dt=RDT, sim_substeps=6)
    swing, init_theta = make_swing_primitive(plugin, span_s=H * RDT)
    term = make_capture_terminal_cost(plugin)
    rollout = jax.jit(make_rollout_fn(plugin, rcfg, default_cost,
                                      swing=swing, terminal_cost=term))
    rollout0 = jax.jit(make_rollout_fn(plugin, rcfg, default_cost,
                                       swing=swing))
    stp = dataclasses.replace(
        robot.state, base_vel=robot.state.base_vel.at[4].add(PUSH_VY))
    U0 = jnp.zeros((H, 3), jnp.float32)
    scen = {"push": jnp.zeros((H, 3), jnp.float32)}
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
    print("name  stage_cost  terminal  total  exec_fall_tick")
    rows = {}
    for name, th in candidates.items():
        c_t, health = rollout(stp, base_refs, warm, U0, scen, th)
        c_0, _ = rollout0(stp, base_refs, warm, U0, scen, th)
        robot.state, robot._anchors = snap
        bv = robot.state.base_vel.at[4].add(PUSH_VY)
        robot.state = dataclasses.replace(robot.state, base_vel=bv)
        fall = run_exec(model, plugin, robot, base_refs, dict(warm) if
                        isinstance(warm, dict) else warm,
                        None if name == "null" else th,
                        swing, ticks=1500)
        rows[name] = (float(c_0), float(c_t) - float(c_0), float(c_t), fall,
                      bool(health["solver_failed"]))
        print(f"{name:14s} {rows[name][0]:9.2f} {rows[name][1]:9.2f} "
              f"{rows[name][2]:9.2f}  fall={fall} "
              f"unhealthy={rows[name][4]}", flush=True)
    best = min(rows, key=lambda k: rows[k][2])
    print(f"ARGMIN over full library: {best}")


if __name__ == "__main__":
    main()
