"""Planner physics == plant physics.

The MPC rollout's ground contact is the SAME function the SimRobot plant
integrates (``runtime.robot_interface.ground_forces`` — stiction anchors,
foot patches, contact moments). This test proves it end-to-end: advancing
the real ``rollout.one_step`` and a hand-assembled plant step (the plugin
tick at the rollout's solver profile + ``_sim_step``) from the same state
produces the same trajectory up to the rollout's warm mass-matrix-inverse
approximation. The pre-round-4 viscous point-contact model drifted from the
plant (zero contact moments, no stiction); this pins the reunification.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from qppvm_tpu.model import zoo
from qppvm_tpu.mpc.rollout import (RolloutConfig, default_cost,
                                   make_rollout_fn, standing_state)
from qppvm_tpu.plugins.force_acc import ForceAccPlugin
from qppvm_tpu.runtime import robot_interface as ri

CONTACTS = ("foot_fl", "foot_fr", "foot_hr", "foot_hl")


def test_rollout_one_step_matches_plant_step():
    model = zoo.quadruped()
    plugin = ForceAccPlugin(model, contact_links=CONTACTS,
                            waist_link="pelvis", iters=20,
                            use_friction_cones=True, mu=0.5,
                            foot_tasks_6d=False)
    st0 = standing_state(model, CONTACTS)
    refs, warm, _ = plugin.on_start(st0)
    # the plant's stiction parameters (this test pins exact equivalence at
    # matched params; RolloutConfig's defaults are h-scaled for coarse
    # steps — see contact_kt/contact_kd_t docstring)
    cfg = RolloutConfig(horizon=8, dt=0.01, qp_iters=12,
                        contact_kt=2e4, contact_kd_t=1500.0)
    rollout = make_rollout_fn(plugin, cfg, default_cost)

    contact_idx = tuple(model.link_index(c) for c in CONTACTS)
    contact_offs = tuple((((0.0, 0.0, 0.0),)) for _ in CONTACTS)
    sim = jax.jit(partial(ri._sim_step, model, cfg.dt, contact_idx,
                          contact_offs, cfg.ground_z, cfg.contact_kp,
                          cfg.contact_kd, cfg.mu, cfg.contact_kt))
    one_step = jax.jit(rollout.one_step)

    carry = rollout.init_carry(st0, refs, warm)
    state_p = st0.astype(jnp.float32)
    warm_p = warm
    anchors_p = ri.init_anchors(model, st0, contact_idx, contact_offs)
    zero3 = jnp.zeros(3, jnp.float32)
    nj = model.nj
    zero_kd = jnp.zeros(nj, jnp.float32)

    H = 8
    for t in range(H):
        inp = (zero3, zero3, None, jnp.float32(t / H))
        carry, (c, prim, failed) = one_step(carry, inp)
        assert not bool(failed)
        # plant side: the same tick (same solver profile, same warm chain)
        # followed by the plant integrator
        tau, warm_p, infos, _ = plugin.step_core(
            state_p, refs, warm_p, solver_opts=rollout.solver_opts)
        tau = jnp.clip(tau, -model.tau_max, model.tau_max)
        state_p, anchors_p = sim(state_p, anchors_p, tau, state_p.q,
                                 zero_kd, zero_kd)

    state_r = carry[0]
    anchors_r = carry[5]
    # identical contact model + identical controller => trajectories agree
    # up to the rollout's warm-NS mass-matrix inverse (~1e-6 per solve)
    np.testing.assert_allclose(np.asarray(state_r.q),
                               np.asarray(state_p.q), atol=2e-4)
    np.testing.assert_allclose(np.asarray(state_r.base_pos),
                               np.asarray(state_p.base_pos), atol=2e-4)
    np.testing.assert_allclose(np.asarray(state_r.base_vel),
                               np.asarray(state_p.base_vel), atol=2e-3)
    np.testing.assert_allclose(np.asarray(anchors_r),
                               np.asarray(anchors_p), atol=1e-3)


def test_rollout_contact_moments_on_patch_feet():
    """With plant foot patches threaded into the rollout, the shared contact
    model produces nonzero contact MOMENTS at the link origin (the
    pre-round-4 rollout applied zero moment even for 6D-wrench soles)."""
    model = zoo.humanoid()
    contacts = ("l_sole", "r_sole")
    patch = [[0.10, 0.05, 0.0], [0.10, -0.05, 0.0],
             [-0.06, 0.05, 0.0], [-0.06, -0.05, 0.0]]
    offsets = {c: patch for c in contacts}
    plugin = ForceAccPlugin(model, contact_links=contacts,
                            waist_link="pelvis", iters=20)
    st0 = standing_state(model, contacts)
    refs, warm, _ = plugin.on_start(st0)
    cfg = RolloutConfig(horizon=4, dt=0.01, qp_iters=12)
    rollout = make_rollout_fn(plugin, cfg, default_cost,
                              contact_offsets=offsets)
    from qppvm_tpu.model import kinematics
    carry = rollout.init_carry(st0, refs, warm)
    # lean the state slightly so the patch load is asymmetric
    st = carry[0]
    st = dataclasses.replace(st, base_pos=st.base_pos +
                             jnp.asarray([0.02, 0.0, 0.0], jnp.float32))
    kin = kinematics.fk(model, st)
    J_all = kinematics.all_link_jacobians(model, kin)
    contact_idx = tuple(model.link_index(c) for c in contacts)
    contact_offs = tuple(tuple(map(tuple, patch)) for _ in contacts)
    anchors = ri.init_anchors(model, st, contact_idx, contact_offs)
    ext, _ = ri.ground_forces(model, contact_idx, contact_offs, cfg.ground_z,
                              cfg.contact_kp, cfg.contact_kd, cfg.mu,
                              cfg.contact_kt, kin, J_all, st.u, anchors,
                              jnp.float32)
    mom = np.asarray(ext)[list(contact_idx), 3:]
    assert np.max(np.abs(mom)) > 1e-3, mom
