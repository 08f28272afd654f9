"""Async plan/act pipeline: the control loop acts on
the committed plan while the next plan computes — never blocking the tick
on the planner.

Structural asserts (wall-clock-free, so CI speed doesn't matter):
- the pipeline commits multiple plans over the run;
- every control row consumed comes from a plan whose state snapshot is
  STRICTLY older than the consuming tick (act-on-plan-k-while-planning-
  k+1 semantics; ages grow between commits and reset after);
- plans are consumed time-shifted (row index advances with plan age);
- the closed loop stays healthy and upright through a mid-run shove.
"""
import dataclasses

import jax
import jax.numpy as jnp

from qppvm_tpu.model import zoo
from qppvm_tpu.mpc.rollout import RolloutConfig, standing_state
from qppvm_tpu.mpc.sampling import MPPIConfig, SamplingMPC
from qppvm_tpu.plugins.force_acc import ForceAccPlugin
from qppvm_tpu.runtime.async_mpc import AsyncPlanner
from qppvm_tpu.runtime.robot_interface import SimRobot

CONTACTS = ("l_sole", "r_sole")


def test_async_plan_act_pipeline():
    model = zoo.humanoid()
    plugin = ForceAccPlugin(model, contact_links=CONTACTS,
                            waist_link="pelvis", iters=40)
    st0 = standing_state(model, CONTACTS)
    robot = SimRobot(model, state=st0, dt=1e-3, substeps=2,
                     contact_links=CONTACTS)
    refs, warm, initial_waist = plugin.on_start(robot.state)

    mppi = MPPIConfig(n_samples=16, horizon=4, noise_std=0.2, push_std=20.0)
    rcfg = RolloutConfig(horizon=4, qp_iters=15, dt=0.02)
    mpc = SamplingMPC(plugin, mppi, rcfg)
    planner = AsyncPlanner(mpc, replan_ticks=20, ticks_per_step=20)

    waist_p = initial_waist
    ages = []
    for i in range(400):
        state = robot.state
        u, age = planner.tick(i, state, refs, warm)
        ages.append(age)
        waist_p = waist_p + u * 1e-3
        refs_t = dict(refs)
        wt = dict(refs_t["waist_task"])
        wt["p"] = waist_p
        refs_t["waist_task"] = wt
        tau, warm, aux = plugin.control_loop(state, refs_t, warm)
        assert not bool(aux.solver_failed), f"RT tick {i}"
        robot.set_reference(tau_ref=tau, q_ref=state.q)
        robot.move()
        if i == 150:
            bv = robot.state.base_vel.at[4].add(0.2)
            robot.state = dataclasses.replace(robot.state, base_vel=bv)

    planner.flush()
    # pipeline actually cycled: several launches AND commits
    assert planner.n_launch >= 3, planner.n_launch
    assert planner.n_commit >= 3, planner.n_commit
    # act-on-old-plan semantics: after the first commit every consumed row
    # came from a strictly older snapshot, and the age ADVANCES tick to
    # tick between commits (time-shifted consumption)
    first = next(k for k, a in enumerate(ages) if a >= 0)
    assert all(a > 0 for a in ages[first + 1:]), ages[first:first + 25]
    assert max(ages) >= planner.replan_ticks, max(ages)
    # every committed planning batch healthy (readback AFTER the loop)
    for info in planner.infos:
        assert float(info["solver_fail_frac"]) == 0.0
    # closed loop survived the shove
    up = float(robot.state.base_rot[2, 2])
    assert up > 0.95, up
    z0 = float(st0.base_pos[2])
    assert float(robot.state.base_pos[2]) > z0 - 0.08
