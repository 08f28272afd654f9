"""Close the estimation loop: the controller never sees simulator ground
truth — the floating-base state it acts on comes from FloatingBaseEstimator
(leg odometry + IMU), mirroring the sense->model sync path of
/root/reference/src/ForceAcc.cpp:256-282 without the ground-truth
shared-memory channel."""
import dataclasses

import jax.numpy as jnp
import numpy as np

from qppvm_tpu.model import kinematics, zoo
from qppvm_tpu.plugins.force_acc import ForceAccPlugin
from qppvm_tpu.runtime.estimator import FloatingBaseEstimator
from qppvm_tpu.runtime.robot_interface import SimRobot

CONTACTS = ("foot_fl", "foot_fr", "foot_hr", "foot_hl")


def test_quadruped_stand_on_estimated_state():
    model = zoo.quadruped()
    plugin = ForceAccPlugin(model, iters=60)
    st = model.home_state()
    kin = kinematics.fk(model, st)
    foot_z = min(float(kin.p[model.link_index(c)][2]) for c in CONTACTS)
    st = dataclasses.replace(
        st, base_pos=st.base_pos - jnp.asarray([0.0, 0.0, foot_z],
                                               st.base_pos.dtype))
    robot = SimRobot(model, state=st, dt=1e-3, substeps=4,
                     contact_links=CONTACTS, ground_z=0.0)

    est = FloatingBaseEstimator(model, CONTACTS)
    # anchors initialized from the known starting pose; afterwards the
    # estimator runs on sensors only (q, qd, IMU R/omega)
    est_state = est.init(robot.state)
    state_hat, _ = robot.state, None
    refs, warm, _ = plugin.on_start(robot.state)

    pos_err = []
    vel_err = []
    for i in range(400):
        imu = robot.get_imu()
        state_hat, est_state = est.update(
            est_state, robot.get_motor_position(), robot.get_motor_velocity(),
            imu.orientation, imu.angular_velocity)
        tau, warm, aux = plugin.control_loop(state_hat, refs, warm)
        assert not bool(aux.solver_failed), f"tick {i}"
        robot.set_reference(tau_ref=tau, q_ref=state_hat.q)
        robot.move()
        pos_err.append(float(jnp.linalg.norm(
            state_hat.base_pos - robot.state.base_pos)))
        vel_err.append(float(jnp.linalg.norm(
            state_hat.base_vel[3:] - robot.state.base_vel[3:])))

    # closed on estimated state: robot still standing, estimate tight
    z0 = float(st.base_pos[2])
    z1 = float(robot.state.base_pos[2])
    assert abs(z1 - z0) < 0.05, (z0, z1)
    assert np.max(pos_err) < 0.02, np.max(pos_err)       # < 2 cm
    assert np.mean(vel_err) < 0.05, np.mean(vel_err)     # < 5 cm/s mean


def test_humanoid_stand_on_estimated_state():
    """Flagship-humanoid analog: the config-4 robot
    standing closed on leg-odometry + IMU estimates only."""
    model = zoo.humanoid()
    contacts = ("l_sole", "r_sole")
    patch = [[0.10, 0.05, 0.0], [0.10, -0.05, 0.0],
             [-0.06, 0.05, 0.0], [-0.06, -0.05, 0.0]]
    plugin = ForceAccPlugin(model, contact_links=contacts,
                            waist_link="pelvis", iters=60)
    st = model.home_state()
    kin = kinematics.fk(model, st)
    foot_z = min(float(kin.p[model.link_index(c)][2]) for c in contacts)
    st = dataclasses.replace(
        st, base_pos=st.base_pos - jnp.asarray([0.0, 0.0, foot_z],
                                               st.base_pos.dtype))
    robot = SimRobot(model, state=st, dt=1e-3, substeps=4,
                     contact_links=contacts, ground_z=0.0,
                     contact_offsets={c: patch for c in contacts})

    est = FloatingBaseEstimator(model, contacts)
    est_state = est.init(robot.state)
    refs, warm, _ = plugin.on_start(robot.state)

    pos_err = []
    for i in range(400):
        imu = robot.get_imu()
        state_hat, est_state = est.update(
            est_state, robot.get_motor_position(),
            robot.get_motor_velocity(), imu.orientation,
            imu.angular_velocity)
        tau, warm, aux = plugin.control_loop(state_hat, refs, warm)
        assert not bool(aux.solver_failed), f"tick {i}"
        robot.set_reference(tau_ref=tau, q_ref=state_hat.q)
        robot.move()
        pos_err.append(float(jnp.linalg.norm(
            state_hat.base_pos - robot.state.base_pos)))

    z0 = float(st.base_pos[2])
    z1 = float(robot.state.base_pos[2])
    assert abs(z1 - z0) < 0.05, (z0, z1)
    # transient: anchors are set at the rigid starting pose, then the sole
    # patches compress ~1 cm as the compliant sim settles; steady state is
    # what the controller lives on
    assert np.mean(pos_err[200:]) < 0.03, np.mean(pos_err[200:])
    assert np.max(pos_err) < 0.05, np.max(pos_err)
    up = float(robot.state.base_rot[2, 2])
    assert up > 0.98, up
