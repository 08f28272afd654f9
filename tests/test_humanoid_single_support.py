"""Humanoid single-support contact switch (the flagship config-4 analog of
the quadruped leg-lift e2e): weight shift over one sole, gate-ramped unload, 4 cm swing-sole
lift held on ONE leg (full weight on the stance sole's 6D wrench with CoP
moment bounds), lower, gate-ramped reload — zero solver failures, upright
throughout. Driven by the same LegLiftScript primitive as the quadruped
(runtime/contact_switch.py; with <3 support contacts the weight shift
targets the support centroid)."""
import numpy as np

from qppvm_tpu.model import kinematics, zoo
from qppvm_tpu.plugins.force_acc import ForceAccPlugin
from qppvm_tpu.runtime.contact_switch import LegLiftPhases, LegLiftScript
from qppvm_tpu.runtime.robot_interface import SimRobot, standing_state

CONTACTS = ("l_sole", "r_sole")
PATCH = [[0.10, 0.05, 0.0], [0.10, -0.05, 0.0],
         [-0.06, 0.05, 0.0], [-0.06, -0.05, 0.0]]


def test_humanoid_single_support_lift_and_replant():
    model = zoo.humanoid()
    plugin = ForceAccPlugin(model, contact_links=CONTACTS,
                            waist_link="pelvis", iters=80,
                            switchable_contacts=True,
                            use_friction_cones=True, mu=0.6, wrench_dim=6)
    st = standing_state(model, CONTACTS)
    robot = SimRobot(model, state=st, dt=1e-3, substeps=2,
                     contact_links=CONTACTS, ground_z=0.0,
                     contact_offsets={c: PATCH for c in CONTACTS})
    refs, warm, initial_waist = plugin.on_start(robot.state)
    l_idx = model.link_index("l_sole")
    phases = LegLiftPhases(settle=150, shift=450, dwell=150, unload=180,
                           lift=250, hold=250, lower=250, reload=200)
    script = LegLiftScript(model, plugin, refs, initial_waist, "l_sole",
                           state=robot.state, phases=phases,
                           lift_height=0.04, swing_kp=100.0, swing_w=3.0)

    lift_z, lift_fz, stance_fz = [], [], []
    for i in range(script.total):
        state = robot.state
        tau, warm, aux = plugin.control_loop(state, script.refs_at(i), warm)
        assert not bool(aux.solver_failed), \
            f"tick {i} prim={float(aux.prim_res):.2e}"
        robot.set_reference(tau_ref=tau, q_ref=state.q)
        robot.move()
        if script.t_hold0 <= i < script.t_lower0:
            kin = kinematics.fk(model, robot.state)
            lift_z.append(float(kin.p[l_idx][2]))
            w = np.asarray(aux.wrenches)
            lift_fz.append(float(w[0, 2]))
            stance_fz.append(float(w[1, 2]))

    # swing sole physically in the air, QP commands no force on it
    assert np.mean(lift_z) > 0.02, np.mean(lift_z)
    assert np.max(np.abs(lift_fz)) < 1e-2, np.max(np.abs(lift_fz))
    # ONE leg carries the whole robot
    total_mass = float(kinematics.com(
        model, kinematics.fk(model, robot.state))[0])
    weight = total_mass * 9.81
    assert abs(np.mean(stance_fz) - weight) < 0.3 * weight, (
        np.mean(stance_fz), weight)
    # upright, double support recovered
    up = float(robot.state.base_rot[2, 2])
    assert up > 0.98, up
    w_final = np.asarray(aux.wrenches)
    assert np.all(w_final[:, 2] > 10.0 - 1e-3), w_final[:, 2]
