"""Quantify the DEPLOYED-params planner/plant gap.

tests/test_rollout_physics.py pins exact one-step equivalence at MATCHED
stiction params; this test measures what deployment actually runs: the
h-scaled rollout (RolloutConfig defaults kt=4e3/kd_t=100 at the coarse
dt, one QP per 60 plant ticks) against the true plant (SimRobot at
kt=2e4/kd_t=1500, 1 kHz control) from the same state, same refs, same
disturbance — closed loop on both sides. The divergence numbers below
are the measured planner myopia budget: capture-library rankings are
trustworthy only for decisions whose outcome differences exceed this
noise floor (the round-4 downwind re-plant ranked within it — that is
WHY it planned well and fell).

Measured (CPU, zoo humanoid, 0.3 m/s lateral shove, 0.48 s horizon):
base-position divergence stays within a few cm through the horizon; foot
positions agree to ~6 mm early and drift to ~2.9 cm max by the end — the
h-scaled tangential stiffness lets shoved stance feet creep ~2 cm more
than the stiff plant. A capture decision whose candidates differ by less
than these numbers is inside the noise floor.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from qppvm_tpu.model import kinematics, zoo
from qppvm_tpu.mpc.rollout import (RolloutConfig, default_cost,
                                   make_rollout_fn, standing_state)
from qppvm_tpu.plugins.force_acc import ForceAccPlugin
from qppvm_tpu.runtime.robot_interface import SimRobot

CONTACTS = ("l_sole", "r_sole")
PATCH = [[0.10, 0.05, 0.0], [0.10, -0.05, 0.0],
         [-0.06, 0.05, 0.0], [-0.06, -0.05, 0.0]]
H, RDT = 8, 0.06


def test_deployed_rollout_vs_plant_divergence():
    model = zoo.humanoid()
    plugin = ForceAccPlugin(model, contact_links=CONTACTS,
                            waist_link="pelvis", iters=40,
                            use_friction_cones=True, mu=0.6, wrench_dim=6)
    offsets = {c: PATCH for c in CONTACTS}
    st0 = standing_state(model, CONTACTS)
    refs, warm, _ = plugin.on_start(st0)
    shove = lambda s: dataclasses.replace(  # noqa: E731
        s, base_vel=s.base_vel.at[4].add(0.3))

    # --- deployed rollout: h-scaled contact params, coarse dt -----------
    cfg = RolloutConfig(horizon=H, dt=RDT, qp_iters=30, sim_substeps=6)
    rollout = make_rollout_fn(plugin, cfg, default_cost,
                              contact_offsets=offsets)
    one_step = jax.jit(rollout.one_step)
    carry = rollout.init_carry(shove(st0), refs, warm)
    zero3 = jnp.zeros(3, jnp.float32)
    li = [model.link_index(c) for c in CONTACTS]
    roll_base, roll_feet = [], []
    for t in range(H):
        carry, (c, prim, failed) = one_step(
            carry, (zero3, zero3, None, jnp.float32((t + 0.5) / H)))
        assert not bool(failed), t
        kin = kinematics.fk(model, carry[0])
        roll_base.append(np.asarray(carry[0].base_pos))
        roll_feet.append(np.asarray(jnp.stack([kin.p[i] for i in li])))

    # --- true plant: real stiction params, 1 kHz control ----------------
    robot = SimRobot(model, state=shove(st0), dt=1e-3, substeps=2,
                     contact_links=CONTACTS, contact_offsets=offsets)
    warm_p = warm
    plant_base, plant_feet = [], []
    ticks_per = int(RDT * 1e3)
    for i in range(H * ticks_per):
        state = robot.state
        tau, warm_p, aux = plugin.control_loop(state, refs, warm_p)
        assert not bool(aux.solver_failed), i
        robot.set_reference(tau_ref=tau, q_ref=state.q)
        robot.move()
        if (i + 1) % ticks_per == 0:
            kin = kinematics.fk(model, robot.state)
            plant_base.append(np.asarray(robot.state.base_pos))
            plant_feet.append(np.asarray(jnp.stack([kin.p[j] for j in li])))

    roll_base = np.stack(roll_base)
    plant_base = np.stack(plant_base)
    d_base = np.linalg.norm(roll_base - plant_base, axis=-1)
    d_feet = np.linalg.norm(np.stack(roll_feet) - np.stack(plant_feet),
                            axis=-1)
    # the gap exists (this is a DIFFERENT model cadence + h-scaled
    # stiction, not the matched-params identity of test_rollout_physics)…
    # …but stays within the planner-myopia budget the capture planner
    # relies on: a few cm of base divergence over the 0.48 s horizon, and
    # stance feet agreeing to sub-cm (both models hold stiction).
    assert d_base[-1] < 0.06, (d_base, "deployed gap regressed")
    assert float(d_base.mean()) < 0.04, d_base
    assert float(d_feet.max()) < 0.04, d_feet  # measured 0.029
    # both ends upright (the gap is parametric drift, not divergence into
    # different qualitative outcomes)
    assert float(robot.state.base_rot[2, 2]) > 0.95
    assert float(carry[0].base_rot[2, 2]) > 0.95
