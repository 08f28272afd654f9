"""Config-5 widening: domain-randomized
contact/disturbance rollouts and the footstep-recovery decision channel.

- scenario randomization beyond pushes: per-rollout TRUE-model mass scale
  (the controller keeps the nominal model), ground-friction scale, and
  contact-gate sequences INSIDE the horizon;
- the swing-primitive decision (rollout.make_swing_primitive) lets the
  sampling planner choose to STEP: from a laterally-shoved state it
  concentrates swing activation on the unloaded (push-side-opposite) feet
  and moves the foothold in the push direction — textbook capture-step
  structure, discovered by MPPI, not scripted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from qppvm_tpu.model import zoo
from qppvm_tpu.mpc.rollout import RolloutConfig
from qppvm_tpu.mpc.sampling import MPPIConfig, SamplingMPC
from qppvm_tpu.plugins.force_acc import ForceAccPlugin
from qppvm_tpu.runtime.robot_interface import standing_state

CONTACTS = ("foot_fl", "foot_fr", "foot_hr", "foot_hl")


def _quadruped_mpc(mppi, rcfg):
    model = zoo.quadruped()
    plugin = ForceAccPlugin(model, contact_links=CONTACTS,
                            waist_link="pelvis", iters=40,
                            switchable_contacts=True,
                            use_friction_cones=True, mu=0.5,
                            foot_tasks_6d=False)
    st = standing_state(model, CONTACTS)
    refs, warm, _ = plugin.on_start(st)
    return plugin, st, refs, warm, SamplingMPC(plugin, mppi, rcfg)


def test_scenario_randomization_healthy():
    """Mass x friction x push randomization: every rollout's QP chain stays
    healthy and the MPPI reduction is non-degenerate."""
    mppi = MPPIConfig(n_samples=24, horizon=6, push_std=25.0,
                      mass_scale_std=0.12, mu_scale_range=0.35)
    rcfg = RolloutConfig(horizon=6, qp_iters=15, dt=0.02, sim_substeps=2)
    plugin, st, refs, warm, mpc = _quadruped_mpc(mppi, rcfg)
    U, info = mpc.plan(jax.random.PRNGKey(0), st, refs, warm,
                       mpc.init_plan())
    assert float(info["solver_fail_frac"]) == 0.0, info
    assert np.isfinite(float(info["cost_mean"]))
    assert float(info["ess"]) > 1.5, float(info["ess"])


def test_gate_sequence_inside_horizon():
    """Contact switching INSIDE a rollout horizon: a gate_seq that ramps one
    foot off mid-horizon keeps the whole chain healthy (the gate machinery
    is exercised in the rollout dynamics, not just single ticks)."""
    mppi = MPPIConfig(n_samples=4, horizon=8)
    rcfg = RolloutConfig(horizon=8, qp_iters=20, dt=0.02, sim_substeps=2)
    plugin, st, refs, warm, mpc = _quadruped_mpc(mppi, rcfg)
    H = 8
    ramp = jnp.clip(1.0 - jnp.arange(H) / 3.0, 0.0, 1.0)   # foot_fl off
    gate_seq = jnp.ones((H, 4)).at[:, 0].set(ramp)
    controls = jnp.zeros((H, 3))
    cost, health = mpc.rollout(st, refs, warm, controls,
                               {"push": jnp.zeros((H, 3)),
                                "gate_seq": gate_seq})
    assert not bool(health["solver_failed"]), health
    assert np.isfinite(float(cost))


def test_step_recovery_decision_channel():
    """The footstep-recovery channel end-to-end: (a) DETERMINISTIC physics —
    a hand-chosen capture-step theta makes the chosen foot PHYSICALLY break
    contact and swing inside the rollout horizon (gate ramps off, reference
    lifts, shared plant contact model confirms the air time) while the
    lean-only theta keeps it planted — with both chains fully healthy;
    (b) MPPI plumbing — plan_step samples/averages theta next to the waist
    plan and the batch stays healthy/usable. The lean-falls-vs-step-survives
    BEHAVIOR claim lives on the biped, where toppling is real
    (tests/test_capture_step.py): the quadruped's wide stance skids or hops
    out of any flat-ground shove under the reunified plant physics, so a
    quadruped cost dichotomy would pin an artifact, not a capability."""
    from qppvm_tpu.mpc.rollout import (make_rollout_fn,
                                       make_swing_primitive)
    mppi = MPPIConfig(n_samples=24, horizon=12, noise_std=0.2,
                      step_recovery=True, theta_noise_std=1.5,
                      dxy_noise_std=0.1)
    rcfg = RolloutConfig(horizon=12, qp_iters=40, dt=0.04, sim_substeps=4,
                         mu=1.3)
    plugin, st, refs, warm, mpc = _quadruped_mpc(mppi, rcfg)
    H = 12

    # (a) deterministic: the decision channel changes the rollout's
    # PHYSICAL contact state, healthily
    swing, init_theta = make_swing_primitive(
        plugin, span_s=rcfg.horizon * rcfg.dt)
    fr_idx = plugin.model.link_index("foot_fr")

    def foot_air_cost(model, state, tau, aux):
        from qppvm_tpu.model import kinematics as _k
        kin = _k.fk(model, state)
        return kin.p[fr_idx][2]          # integral of swing-foot height

    rollout = make_rollout_fn(plugin, rcfg, foot_air_cost, swing=swing)
    U0 = jnp.zeros((H, 3))
    scen = {"push": jnp.zeros((H, 3))}
    z_lean, h_lean = rollout(st, refs, warm, U0, scen, init_theta())
    theta_step = {"swing": jnp.asarray([-8.0, 3.0, -8.0, -8.0]),  # fr
                  "t0": jnp.asarray(-2.0),
                  "dxy": jnp.asarray([0.0, 0.1])}
    z_step, h_step = rollout(st, refs, warm, U0, scen, theta_step)
    assert not bool(h_lean["solver_failed"]), h_lean
    assert not bool(h_step["solver_failed"]), h_step
    # lean-only: foot stays on the ground (integral height ~ 0);
    # step theta: the foot is airborne for a large part of the horizon
    assert float(z_lean) < 0.02, float(z_lean)
    assert float(z_step) > 0.1, float(z_step)

    # (b) the sampled decision channel stays healthy and usable end-to-end
    U, theta = mpc.init_plan(), mpc.init_theta()
    key = jax.random.PRNGKey(0)
    for _ in range(2):
        key, k = jax.random.split(key)
        (U, theta), info = mpc.plan_step(k, st, refs, warm, U, theta)
    assert all(bool(jnp.all(jnp.isfinite(v))) for v in theta.values())
    assert np.isfinite(float(info["cost_min"]))
    # with the h-scaled rollout contact parameters the whole sampled batch
    # is healthy (round-4 fix: the plant's stiff tangential model chattered
    # at the rollout's coarse substep and failed 75% of samples)
    assert float(info["solver_fail_frac"]) < 0.1, info
    assert float(info["ess"]) > 2.0, info
