"""The flagship humanoid walks: >= 4 chained strides through the gait
engine, estimator-driven, zero solver failures (the
round-4 humanoid could execute exactly one stride; chaining destabilized
at the 2nd weight shift).

STRICT XFAIL pinning the round-5 frontier (a red test that flips green when the capability lands, loud on
regression-toward AND on silent fixes). Round 5 SOLVED the 2nd-weight-
shift failure itself: with the full recipe below the double-distance
right-to-left transfer completes cleanly — CoM tracks the reference to
~1 cm with zero gate pauses, feet within 2 mm of nominal, forces fully
redistributed (fzL 832 N / fzR 9 N), zero solver failures (reproduced
3x, /tmp/hum_v7-v9 telemetry 2026-08-21; the stride-0 swing also lands
cleanly). The surviving blocker is DOWNSTREAM and distinct: during
stride 1's extended single support the stance sole migrates outboard
~8 cm (inner-patch-edge pivot walking at 0.05-0.1 m/s under 700-830 N —
NOT stiction slip; the CoP rides the inner patch edge because the CoM
sits inboard, outer patch points unload, and the foot ratchets away
from under the robot), after which the swing foot's absolute replant
target is out of leg reach and the reload finds an unloadable geometry.
The fall lands at the stride-1 lower/reload, ~7 s in.

The recipe stacks every piece of the round-5 biped weight-transfer
diagnosis (docs/ARCHITECTURE.md "Biped weight transfer"):
- ForceReg share_mode="static" (quasi-static CoM-barycentric force split;
  the equal gate-share anchor measurably skids the robot sideways),
- fz-proportional CoPBox instead of the static moment box (full sole
  authority at high load, no fictitious CoP at low load),
- waist_priority="soft" (the reference's own one-level stack shape,
  /root/reference/src/ForceAcc.cpp:131-133; the hard cascade recruits the
  free leg as a momentum actuator once stance CoP saturates),
- GaitScript com_servo (PD+I from MEASURED CoM onto the waist target; the
  D term brakes the transfer before it overshoots),
- capture-point-aware shift pacing (stride k>0 is a double-distance
  transfer) + the transfer-direction-projected unload gate,
- stance_kp/stance_w boost on ALL feet (lightly-loaded feet otherwise get
  dragged decimeters at the default kp 25).

Match: BASELINE config 4 (humanoid, 1 kHz, contact switching);
/root/reference/src/ForceAcc.cpp:58 (fixed contact set, upgraded to a
walking contact schedule).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from qppvm_tpu.model import kinematics, zoo
from qppvm_tpu.plugins.force_acc import ForceAccPlugin
from qppvm_tpu.runtime.contact_switch import LegLiftPhases
from qppvm_tpu.runtime.estimator import sync_model_state
from qppvm_tpu.runtime.gait import GaitScript
from qppvm_tpu.runtime.robot_interface import SimRobot, standing_state

CONTACTS = ("l_sole", "r_sole")
PATCH = [[0.10, 0.05, 0.0], [0.10, -0.05, 0.0],
         [-0.06, 0.05, 0.0], [-0.06, -0.05, 0.0]]
N_STRIDES = 4


@pytest.mark.xfail(
    strict=True,
    reason="stride-1 single-support stance-sole outboard migration "
           "(inner-patch-edge pivot walking) breaks the replant — the "
           "named round-5 frontier; the 2nd weight shift itself is fixed")
def test_humanoid_walks_four_strides():
    model = zoo.humanoid()
    plugin = ForceAccPlugin(model, contact_links=CONTACTS,
                            waist_link="pelvis", iters=80,
                            switchable_contacts=True,
                            use_friction_cones=True, mu=0.6, wrench_dim=6,
                            force_share_mode="static",
                            waist_priority="soft",
                            cop_box=(-0.06, 0.10, 0.05, 0.02))
    st = standing_state(model, CONTACTS)
    robot = SimRobot(model, state=st, dt=1e-3, substeps=2,
                     contact_links=CONTACTS, ground_z=0.0,
                     contact_offsets={c: PATCH for c in CONTACTS})
    refs, warm, initial_waist = plugin.on_start(robot.state)

    phases = LegLiftPhases(settle=150, shift=900, dwell=200, unload=180,
                           lift=250, hold=150, lower=250, reload=200)
    gait = GaitScript(model, plugin, refs, initial_waist,
                      order=("l_sole", "r_sole"), stride=(0.0, 0.0),
                      n_strides=N_STRIDES, phases=phases,
                      shift_mode="centroid", lift_height=0.04,
                      swing_kp=100.0, swing_w=3.0,
                      stance_kp=150.0, stance_w=2.0, touch_depth=0.02,
                      shift_a_max=0.3,
                      com_servo=dict(kp=1.0, kd=1.0, ki=1.0),
                      unload_gate=dict(tol_p=0.025, tol_v=0.07,
                                       max_extra=800))

    idx = {c: model.link_index(c) for c in CONTACTS}
    lift_z = {k: [] for k in range(N_STRIDES)}
    n_fail = 0
    strides_started = 0
    for i in range(gait.total):
        state = sync_model_state(robot, model)
        refs_t = gait.refs_at(i, state)
        strides_started = max(strides_started, gait._k + 1)
        tau, warm, aux = plugin.control_loop(state, refs_t, warm)
        n_fail += int(bool(aux.solver_failed))
        robot.set_reference(tau_ref=tau, q_ref=state.q)
        robot.move()
        up = float(robot.state.base_rot[2, 2])
        assert up > 0.8, f"fell at tick {i} (stride {gait._k})"
        # record swing-foot height during each stride's unloaded window
        s = gait._script
        if s is not None:
            j = i - gait._t0 - gait._extra
            if s.t_lift0 <= j < s.t_lower0:
                kin = kinematics.fk(model, robot.state)
                lift_z[gait._k].append(
                    float(kin.p[idx[s.foot]][2]))

    # all strides ran, each swing foot PHYSICALLY lifted
    assert strides_started == N_STRIDES, strides_started
    for k in range(N_STRIDES):
        assert lift_z[k], f"stride {k} never reached its lift window"
        assert max(lift_z[k]) > 0.02, (k, max(lift_z[k]))
    # upright, zero failures, both soles loaded at the end
    assert float(robot.state.base_rot[2, 2]) > 0.9
    assert n_fail == 0, n_fail
    w_final = np.asarray(aux.wrenches)
    assert np.all(w_final[:, 2] > 10.0 - 1e-3), w_final[:, 2]
