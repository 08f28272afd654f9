"""Closed-loop control of the PUBLISHED Gymnasium humanoid.xml
(the reference runs its real robot config in the
control loop, /root/reference/src/QPPVMPlugin.cpp:50-51).

The published humanoid has SPHERE feet and NO ankle joints: it cannot be
quasi-statically stabilized by ANY controller — MuJoCo itself, stepping
the unmodified XML with zero control from qpos0, pitches past up<0.9 at
t = 0.87 s (measured; an ankle-less point-foot biped has no pitch
authority). The honest closed-loop claim is therefore BALANCE EXTENSION:
under the full WBC stack (6D Hertz-patch wrenches, CoM task, joint-limit
constraint, reference-faithful softened drive PD) the robot stays upright
more than twice as long as the passive plant, with zero solver failures
and the CoM held over the feet while it stands.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest

mujoco = pytest.importorskip("mujoco")

from qppvm_tpu.model import kinematics  # noqa: E402
from qppvm_tpu.model.mjcf import load_mjcf  # noqa: E402
from qppvm_tpu.plugins.force_acc import ForceAccPlugin  # noqa: E402
from qppvm_tpu.runtime.robot_interface import SimRobot  # noqa: E402

ASSETS = os.path.join(os.path.dirname(mujoco.__file__), "..", "gymnasium",
                      "envs", "mujoco", "assets")
HUMANOID = os.path.abspath(os.path.join(ASSETS, "humanoid.xml"))
PR = 0.012    # Hertz patch radius: 7.5 cm rubber sphere under ~225 N


def _build(with_plugin=True):
    model = load_mjcf(HUMANOID, tip_frames=True)
    contacts = ("left_foot_tip", "right_foot_tip")
    offsets = {}
    sim_contacts = []
    for c in contacts:
        li, E, p = model.frame_spec(c)
        link = model.link_names[li]
        sim_contacts.append(link)
        p = np.asarray(p)
        offsets[link] = [tuple(p + [PR, 0, 0]), tuple(p + [-PR, 0, 0]),
                         tuple(p + [0, PR, 0]), tuple(p + [0, -PR, 0])]
    st = model.home_state()
    kin = kinematics.fk(model, st)
    tip_z = min(float(kinematics.link_pose(model, kin, c)[1][2])
                for c in contacts)
    st = dataclasses.replace(
        st, base_pos=st.base_pos - jnp.asarray([0, 0, tip_z],
                                               st.base_pos.dtype))
    robot = SimRobot(model, state=st, dt=1e-3, substeps=4,
                     contact_links=tuple(sim_contacts), ground_z=0.0,
                     contact_offsets=offsets, contact_kp=1e5,
                     contact_kd=800.0)
    # reference drive profile: softened PD, never zero
    # (/root/reference/src/ForceAcc.cpp:33-39) — without damping the long
    # light arms flail unstably under pure torque control
    robot.set_damping(2.0 * jnp.ones(model.nj, jnp.float32))
    plugin = None
    if with_plugin:
        plugin = ForceAccPlugin(
            model, contact_links=contacts, waist_link="pelvis", iters=60,
            fz_min=5.0, foot_tasks_6d=False, use_friction_cones=True,
            mu=0.8, wrench_dim=6, moment_box=(450 * PR, 450 * PR, 1.0),
            postural_kp=25.0, use_com_task=True, com_task_weight=3.0,
            use_joint_limits=True)
    return model, contacts, robot, plugin


def _ticks_upright(model, robot, plugin, contacts, max_ticks, thresh=0.9):
    """Run (controlled or passive) until torso up < thresh."""
    warm = refs = None
    n_fail = 0
    com_err = []
    if plugin is not None:
        refs, warm, _ = plugin.on_start(robot.state)
        kin_s = kinematics.fk(model, robot.state)
        fm0 = np.mean([np.asarray(kinematics.link_pose(model, kin_s, c)[1])
                       for c in contacts], axis=0)
        com_s = np.asarray(kinematics.com(model, kin_s)[1])
        cr = dict(refs["COM"])
        cr["p"] = jnp.asarray([fm0[0], fm0[1], com_s[2]], jnp.float32)
        refs["COM"] = cr
    else:
        robot.set_reference(tau_ref=jnp.zeros(model.nj, jnp.float32),
                            q_ref=robot.state.q)
    for i in range(max_ticks):
        if plugin is not None:
            state = robot.state
            tau, warm, aux = plugin.control_loop(state, refs, warm)
            n_fail += int(bool(aux.solver_failed))
            robot.set_reference(tau_ref=tau, q_ref=state.q)
            if i % 50 == 0:
                kin_i = kinematics.fk(model, robot.state)
                com = np.asarray(kinematics.com(model, kin_i)[1])
                fm = np.mean([np.asarray(
                    kinematics.link_pose(model, kin_i, c)[1])
                    for c in contacts], axis=0)
                com_err.append(np.linalg.norm(com[:2] - fm[:2]))
        robot.move()
        if float(robot.state.base_rot[2, 2]) < thresh:
            return i, n_fail, com_err
    return max_ticks, n_fail, com_err


def test_published_humanoid_forceacc_stand():
    # passive plant: same sim, zero commanded torque
    model, contacts, robot_p, _ = _build(with_plugin=False)
    t_passive, _, _ = _ticks_upright(model, robot_p, None, contacts, 1500)
    assert t_passive < 400, t_passive          # it really does fall alone

    # controlled: full WBC stack
    model, contacts, robot_c, plugin = _build(with_plugin=True)
    t_ctrl, n_fail, com_err = _ticks_upright(model, robot_c, plugin,
                                             contacts, 1500)
    # Balance extension, with ABSOLUTE bars (the
    # old 2x-relative bar could pass at 1.2 s vs 0.6 s, and the CoM was
    # checked only over the first 300 ms). Measured deterministic values:
    # passive 287 ticks, controlled 611 ticks, full-window max CoM-over-
    # feet error 0.080 m.
    assert t_ctrl >= 2 * t_passive, (t_passive, t_ctrl)
    assert t_ctrl >= 550, t_ctrl               # >= 0.55 s upright, absolute
    assert n_fail == 0
    # CoM held over the feet for the WHOLE standing window, not a prefix
    assert max(com_err) < 0.10, com_err
