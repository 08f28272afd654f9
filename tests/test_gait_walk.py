"""Sustained locomotion: the quadruped static walk.

Round 3 proved ONE contact-switch cycle; this chains 8 strides (2 full
crawl-gait cycles, each foot swinging twice, 6 cm per stride) into a walk:
net base displacement, every foothold advanced, zero solver failures,
stance feet laterally pinned, estimator-driven throughout (the controller
never reads simulator ground truth). BASELINE config 4 "contact switching
at 1 kHz" executed as *behavior*; a capability upgrade over the reference's
fixed contact set (/root/reference/src/ForceAcc.cpp:58,74-96).

The recipe (measured in tools/exp_walk.py, each ingredient's absence
reproduced a failure):
- SLOW weight shift (600 ticks): the waist task is priority level 1 — an
  aggressive shift overrides stance-foot holding at level 2 and slides the
  feet (cone-limited) across the ground;
- stance reference y PINNED at nominal (runtime/gait.py): re-anchoring refs
  at actual poses ratchets lateral creep until the support polygon
  degenerates to a line;
- swing lands at nominal y: the swing leg is the lateral drift-correction
  channel;
- deeper touchdown (12 mm) + slower lower/reload: gate-ramped load
  transfer onto a foot that is firmly in contact.
"""
import numpy as np
import jax.numpy as jnp

from qppvm_tpu.model import kinematics, zoo
from qppvm_tpu.plugins.force_acc import ForceAccPlugin
from qppvm_tpu.runtime.contact_switch import LegLiftPhases
from qppvm_tpu.runtime.estimator import FloatingBaseEstimator
from qppvm_tpu.runtime.gait import GaitScript
from qppvm_tpu.runtime.robot_interface import SimRobot, standing_state

CONTACTS = ("foot_fl", "foot_fr", "foot_hr", "foot_hl")


def test_quadruped_static_walk_8_strides():
    model = zoo.quadruped()
    plugin = ForceAccPlugin(model, contact_links=CONTACTS,
                            waist_link="pelvis", iters=60,
                            switchable_contacts=True,
                            use_friction_cones=True, mu=0.5,
                            foot_tasks_6d=False)
    st = standing_state(model, CONTACTS)
    robot = SimRobot(model, state=st, dt=1e-3, substeps=2,
                     contact_links=CONTACTS, ground_z=0.0)
    refs, warm, initial_waist = plugin.on_start(robot.state)
    est = FloatingBaseEstimator(model, CONTACTS)
    est_state = est.init(robot.state)

    phases = LegLiftPhases(settle=100, shift=600, dwell=100, unload=150,
                           lift=250, hold=0, lower=300, reload=250)
    STRIDE = 0.06
    gait = GaitScript(model, plugin, refs, initial_waist,
                      order=("foot_hl", "foot_fl", "foot_hr", "foot_fr"),
                      stride=(STRIDE, 0.0), n_strides=8,
                      shift_mode="edge", phases=phases,
                      touch_depth=0.012)

    kin0 = kinematics.fk(model, robot.state)
    feet_x0 = {c: float(kin0.p[model.link_index(c)][0]) for c in CONTACTS}
    x0 = float(robot.state.base_pos[0])
    z0 = float(robot.state.base_pos[2])
    gates = jnp.ones(len(CONTACTS), jnp.float32)

    for i in range(gait.total):
        imu = robot.get_imu()
        state, est_state = est.update(
            est_state, robot.get_motor_position(),
            robot.get_motor_velocity(), imu.orientation,
            imu.angular_velocity, active=gates)
        refs_t = gait.refs_at(i, state)
        gates = refs_t["contacts"]["active"]
        tau, warm, aux = plugin.control_loop(state, refs_t, warm)
        assert not bool(aux.solver_failed), \
            f"solver failed at tick {i} (prim={float(aux.prim_res):.2e})"
        robot.set_reference(tau_ref=tau, q_ref=state.q)
        robot.move()

    kin1 = kinematics.fk(model, robot.state)
    x1 = float(robot.state.base_pos[0])
    # net base displacement: 8 strides x 6 cm advance each foot 12 cm over
    # 2 cycles; the body travels about one full stride cycle
    assert x1 - x0 > 0.15, (x0, x1)
    # every foothold advanced (>= 75% of the commanded 12 cm)
    for c in CONTACTS:
        dx_c = float(kin1.p[model.link_index(c)][0]) - feet_x0[c]
        assert dx_c > 0.09, (c, dx_c)
    # stance never collapsed laterally (the round-4 ratchet failure mode:
    # all feet within 5 cm of the centerline by stride 3)
    for c in CONTACTS:
        y_c = float(kin1.p[model.link_index(c)][1])
        assert abs(abs(y_c) - 0.2) < 0.06, (c, y_c)
    # upright, height held, all four feet loaded at the end
    assert float(robot.state.base_rot[2, 2]) > 0.98
    assert abs(float(robot.state.base_pos[2]) - z0) < 0.08
    w_final = np.asarray(aux.wrenches)
    assert np.all(w_final[:, 2] >= 10.0 - 1e-3), w_final[:, 2]
