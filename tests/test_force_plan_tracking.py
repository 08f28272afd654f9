"""The planned-force channel feeds the WBC.

``ForceReg.refs["f"]`` was built for "an MPC force plan" but nothing ever
fed it; these tests close the loop: a deliberate load split commanded
through the offset is REALIZED by the solver, and the centroidal DDP's
optimized contact forces flow into the WBC's distribution during a tracked
squat. Match: tasks/force.py:64,82; the force::CoM capability the reference
constructs but never stacks (/root/reference/src/ForceAcc.cpp:103).
"""
import jax.numpy as jnp
import numpy as np

from qppvm_tpu.model import dynamics, kinematics, zoo
from qppvm_tpu.mpc.ddp_mpc import CentroidalMPC, CentroidalMPCConfig
from qppvm_tpu.plugins.force_acc import ForceAccPlugin
from qppvm_tpu.runtime.robot_interface import SimRobot, standing_state

CONTACTS = ("foot_fl", "foot_fr", "foot_hr", "foot_hl")


def _setup():
    model = zoo.quadruped()
    plugin = ForceAccPlugin(model, contact_links=CONTACTS,
                            waist_link="pelvis", iters=40)
    robot = SimRobot(model, state=standing_state(model, CONTACTS),
                     dt=1e-3, substeps=4, contact_links=CONTACTS)
    refs, warm, initial_waist = plugin.on_start(robot.state)
    return model, plugin, robot, refs, warm, initial_waist


def test_force_ref_split_realized():
    """A commanded 60/40 DIAGONAL load split through
    ``refs["FORCE_REG"]["f"]`` is realized by the commanded wrenches while
    the robot keeps standing. The diagonal mode (fl+hr vs fr+hl) is the
    statically-consistent internal redistribution for point feet — a
    front/hind split is NOT in the wrench nullspace (it changes the pitch
    moment, which the dynamic-feasibility equality pins), so that command
    is rightly rejected by the solver (verified: commanding it moves the
    realized split by <0.1)."""
    model, plugin, robot, refs, warm, _ = _setup()
    data = dynamics.compute_model_data(model, robot.state.astype(jnp.float32))
    W = float(data.total_mass) * 9.81
    share = W / 4.0
    # front feet (fl, fr) +20% of share, hind (hr, hl) -20%: same total
    delta = 0.2 * share
    off = np.zeros((4, 3), np.float32)
    off[0, 2] = +delta   # fl \ diagonal pair up
    off[2, 2] = +delta   # hr /
    off[1, 2] = -delta   # fr \ diagonal pair down
    off[3, 2] = -delta   # hl /
    refs = dict(refs)
    fr_ref = dict(refs["FORCE_REG"])
    fr_ref["f"] = jnp.asarray(off.reshape(-1))
    # boost the runtime weight: at the default anchor weight the warm-
    # centered wrench proximal (a slow pole toward the previous solution)
    # dominates and the commanded split only half-realizes
    fr_ref["w"] = jnp.asarray(5.0)
    refs["FORCE_REG"] = fr_ref

    z0 = float(robot.state.base_pos[2])
    wr_acc = []
    for i in range(400):
        state = robot.state
        tau, warm, aux = plugin.control_loop(state, refs, warm)
        assert not bool(aux.solver_failed), f"tick {i}"
        robot.set_reference(tau_ref=tau, q_ref=state.q)
        robot.move()
        if i >= 200:
            wr_acc.append(np.asarray(aux.wrenches)[:, 2])
    fz = np.mean(wr_acc, axis=0)
    diag_up = fz[0] + fz[2]
    diag_dn = fz[1] + fz[3]
    total = diag_up + diag_dn
    # commanded split: fl+hr = 0.6 W, fr+hl = 0.4 W
    assert abs(diag_up / total - 0.6) < 0.05, (diag_up, diag_dn, total)
    assert abs(total - W) < 0.2 * W, (total, W)
    # the robot still stands (the split is consistent with support)
    assert abs(float(robot.state.base_pos[2]) - z0) < 0.05


def test_ddp_force_plan_feeds_wbc():
    """Closed-loop squat with the centroidal DDP's planned contact forces
    wired into ForceReg: tracking holds AND the commanded distribution
    follows the plan (lower-than-static normal forces while the planned
    CoM accelerates downward)."""
    model, plugin, robot, refs, warm, initial_waist = _setup()
    mpc = CentroidalMPC(model, CONTACTS,
                        CentroidalMPCConfig(horizon=15, dt=0.02,
                                            iterations=4))
    U = mpc.init_plan(robot.state)
    kin0 = kinematics.fk(model, robot.state)
    _, com0 = kinematics.com(model, kin0)
    p_ref = jnp.asarray(com0) - jnp.asarray([0.0, 0.0, 0.04])
    data = dynamics.compute_model_data(model, robot.state.astype(jnp.float32))
    W = float(data.total_mass) * 9.81

    plan_every = 20
    res = params = None
    fails = 0
    track_err = []
    for i in range(600):
        state = robot.state
        if i % plan_every == 0:
            res, params = mpc.plan(state, p_ref, U)
            U = res.U
            f_off = CentroidalMPC.force_ref_offset(res, params, W, k=0)
        waist_p = CentroidalMPC.waist_ref_from_plan(res, k=5)
        refs_t = dict(refs)
        wt = dict(refs_t["waist_task"])
        wt["p"] = initial_waist + (waist_p - jnp.asarray(com0))
        refs_t["waist_task"] = wt
        fr_ref = dict(refs_t["FORCE_REG"])
        fr_ref["f"] = f_off
        fr_ref["w"] = jnp.asarray(5.0)
        refs_t["FORCE_REG"] = fr_ref
        tau, warm, aux = plugin.control_loop(state, refs_t, warm)
        fails += int(bool(aux.solver_failed))
        robot.set_reference(tau_ref=tau, q_ref=state.q)
        robot.move()
        if i % plan_every == plan_every - 1:
            # commanded wrench vs planned force, per foot
            f_plan = np.asarray(res.U[0]).reshape(4, 3)
            f_cmd = np.asarray(aux.wrenches)[:, :3]
            track_err.append(np.linalg.norm(f_cmd[:, 2] - f_plan[:, 2])
                             / max(np.linalg.norm(f_plan[:, 2]), 1e-6))

    kin1 = kinematics.fk(model, robot.state)
    _, com1 = kinematics.com(model, kin1)
    dz = float(com1[2] - com0[2])
    assert fails == 0
    # squat tracking holds with the force plan in the loop
    assert dz < -0.008, dz
    # the commanded normal-force distribution tracks the plan
    # tracks within the warm-centered proximal's lag: the plan's forces
    # are centroidal-consistent, but the wrench proximal (centered on the
    # previous solution) low-passes distribution changes
    assert np.mean(track_err[2:]) < 0.25, track_err
