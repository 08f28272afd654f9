"""Published robot models end-to-end: Gymnasium's MuJoCo ant + humanoid.

Run a real PUBLISHED robot description file (not a
synthetic inline model) through the whole stack. This image ships no URDF
robot descriptions, but Gymnasium ships the classic published MJCF robots;
qppvm_tpu.model.mjcf converts MuJoCo's own compilation of those files.
Match: the reference's Centauro config load
(/root/reference/src/QPPVMPlugin.cpp:50-51).

Covers: converter correctness vs MuJoCo itself (FK at body frames, mass
matrix, bias under the floating-base change of basis) on BOTH files —
humanoid.xml exercises multi-joint bodies (abdomen/hip chains, emulated by
massless intermediate links) — and a closed-loop ForceAcc stand on the ant
with capsule-tip contact frames.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest

mujoco = pytest.importorskip("mujoco")

from qppvm_tpu.model import dynamics, kinematics  # noqa: E402
from qppvm_tpu.model.mjcf import load_mjcf  # noqa: E402
from qppvm_tpu.model.robot import RobotState  # noqa: E402

DT = jnp.float64

ASSETS = os.path.join(os.path.dirname(mujoco.__file__), "..", "gymnasium",
                      "envs", "mujoco", "assets")
ANT = os.path.abspath(os.path.join(ASSETS, "ant.xml"))
HUMANOID = os.path.abspath(os.path.join(ASSETS, "humanoid.xml"))


def _quat_to_R(quat):
    w, x, y, z = quat
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _rand_float_state(model, seed):
    rng = np.random.default_rng(seed)
    lo = np.maximum(np.asarray(model.q_min), -1.0)
    hi = np.minimum(np.asarray(model.q_max), 1.0)
    q = rng.uniform(lo, hi)
    qd = rng.uniform(-1.0, 1.0, model.nj)
    w = rng.uniform(-0.5, 0.5, 3)
    ang = np.linalg.norm(w)
    quat = np.concatenate([[np.cos(ang / 2)], np.sin(ang / 2) * w / ang])
    base_pos = rng.uniform(-0.5, 0.5, 3) + np.array([0.0, 0.0, 1.0])
    base_vel = rng.uniform(-1.0, 1.0, 6)
    return q, qd, quat, base_pos, base_vel


def _mj_state(mj, q, qd, quat, base_pos, base_vel):
    d = mujoco.MjData(mj)
    R = _quat_to_R(quat)
    d.qpos[:3] = base_pos
    d.qpos[3:7] = quat
    d.qpos[7:] = q
    d.qvel[:3] = R @ base_vel[3:]
    d.qvel[3:6] = base_vel[:3]
    d.qvel[6:] = qd
    mujoco.mj_forward(mj, d)
    return d


def _basis_T(R, nj):
    n = 6 + nj
    T = np.zeros((n, n))
    T[0:3, 3:6] = R
    T[3:6, 0:3] = np.eye(3)
    T[6:, 6:] = np.eye(nj)
    return T


@pytest.mark.parametrize("path", [ANT, HUMANOID],
                         ids=["ant", "humanoid"])
def test_published_mjcf_matches_mujoco(path):
    model = load_mjcf(path)
    mj = mujoco.MjModel.from_xml_path(path)
    assert model.floating and model.nj == mj.nv - 6
    for seed in range(2):
        q, qd, quat, base_pos, base_vel = _rand_float_state(model, seed)
        d = _mj_state(mj, q, qd, quat, base_pos, base_vel)
        R = _quat_to_R(quat)
        st = RobotState.init(model, q=q, qd=qd, base_rot=R,
                             base_pos=base_pos, base_vel=base_vel, dtype=DT)
        data = dynamics.compute_model_data(model, st)
        # FK at every named MuJoCo body (ours: link frames sit at joint
        # anchors; body frames are registered as extra frames)
        for b in range(1, mj.nbody):
            name = mujoco.mj_id2name(mj, mujoco.mjtObj.mjOBJ_BODY, b)
            name = name if name else f"body_{b}"
            if name == model.root_name:
                continue
            _, p, _, _, _ = dynamics.frame_data(model, data, name)
            np.testing.assert_allclose(np.asarray(p), d.xpos[b], atol=1e-8,
                                       err_msg=f"{path}:{name}")
        # mass matrix under the floating-base change of basis
        B = np.asarray(dynamics.mass_matrix(model, st))
        M_mj = np.zeros((mj.nv, mj.nv))
        mujoco.mj_fullM(mj, d, M_mj)
        T = _basis_T(R, model.nj)
        np.testing.assert_allclose(B, T.T @ M_mj @ T, atol=1e-6)
        # nonlinear term (bias) with the Tdot u convective correction
        h = np.asarray(dynamics.nonlinear_term(model, st))
        tdot_u = np.zeros(mj.nv)
        tdot_u[:3] = R @ np.cross(base_vel[:3], base_vel[3:])
        np.testing.assert_allclose(h, T.T @ (d.qfrc_bias + M_mj @ tdot_u),
                                   atol=1e-6)


def test_ant_forceacc_stand():
    """Closed-loop ForceAcc stand on the published ant: the full stack
    (loader -> model -> tasks -> hierarchy solver -> sim) on a real robot
    file, contacts at the capsule-tip frames."""
    from qppvm_tpu.plugins.force_acc import ForceAccPlugin
    from qppvm_tpu.runtime.robot_interface import SimRobot

    model = load_mjcf(ANT, tip_frames=True)
    contacts = ("body_4_tip", "body_7_tip", "body_10_tip", "body_13_tip")
    plugin = ForceAccPlugin(model, contact_links=contacts,
                            waist_link="torso", iters=60, fz_min=0.2,
                            foot_tasks_6d=False, postural_kp=9.0)
    # SimRobot needs link-level contacts: same points, expressed as offsets
    # on the tip frames' parent links
    import dataclasses
    offsets = {}
    sim_contacts = []
    for c in contacts:
        li, E, p = model.frame_spec(c)
        link = model.link_names[li]
        sim_contacts.append(link)
        offsets[link] = [tuple(p)]
    st = model.home_state()
    kin = kinematics.fk(model, st)
    tip_z = min(float(kinematics.link_pose(model, kin, c)[1][2])
                for c in contacts)
    st = dataclasses.replace(
        st, base_pos=st.base_pos - jnp.asarray([0, 0, tip_z - 0.0],
                                               st.base_pos.dtype))
    robot = SimRobot(model, state=st, dt=1e-3, substeps=4,
                     contact_links=tuple(sim_contacts), ground_z=0.0,
                     contact_offsets=offsets, contact_kp=4e3,
                     contact_kd=60.0)
    refs, warm, _ = plugin.on_start(robot.state)
    z0 = float(robot.state.base_pos[2])
    n_fail = 0
    for i in range(300):
        state = robot.state
        tau, warm, aux = plugin.control_loop(state, refs, warm)
        n_fail += int(bool(aux.solver_failed))
        robot.set_reference(tau_ref=tau, q_ref=state.q)
        robot.move()
    z1 = float(robot.state.base_pos[2])
    w = np.asarray(aux.wrenches)
    total_mass = float(kinematics.com(
        model, kinematics.fk(model, robot.state))[0])
    weight = total_mass * 9.81
    assert n_fail == 0
    assert abs(z1 - z0) < 0.08, (z0, z1)
    assert abs(float(w[:, 2].sum()) - weight) < 0.35 * weight, (
        w[:, 2], weight)
