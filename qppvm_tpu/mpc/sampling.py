"""Sampling MPC (MPPI) over batched WBC rollouts, sharded over a device mesh.

BASELINE config 5: "4096 domain-randomized contact/disturbance rollouts
batched per step, sharded across a multi-host pod slice". Greenfield (the
reference is single-robot single-thread; SURVEY.md §2c).

Device mapping:
- rollouts  -> leading batch axis, vmap + NamedSharding over mesh axis
  "rollout" (DP). Each rollout's QP chain stays on one chip (design decision
  recorded in SURVEY §2c: no TP at 30-60-wide matrices).
- horizon   -> lax.scan inside each rollout (sequential by physics).
- reduction -> MPPI softmax weights: global min/logsumexp over the batch;
  under jit+GSPMD these lower to all-reduce collectives (NCCL over NVLink).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from qppvm_tpu.mpc.rollout import (RolloutConfig, default_cost,
                                   make_rollout_fn, make_swing_primitive)
from qppvm_tpu.plugins.force_acc import ForceAccPlugin
from qppvm_tpu.precision import f32_matmuls


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    n_samples: int = 256
    horizon: int = 16
    lambda_: float = 1.0
    noise_std: float = 0.15
    push_std: float = 0.0     # domain randomization: random base pushes (N)
    # Domain randomization beyond pushes: per-
    # rollout true-robot mass scale (lognormal-ish, the CONTROLLER keeps
    # the nominal model) and ground-friction scale (uniform in
    # [1 - mu_scale_range, 1]). 0 disables.
    mass_scale_std: float = 0.0
    mu_scale_range: float = 0.0
    # Footstep recovery: adds the swing-primitive decision theta
    # (rollout.make_swing_primitive) next to the waist-velocity plan, so
    # the planner can choose to STEP, not only lean. theta is sampled and
    # exponentially averaged exactly like U.
    step_recovery: bool = False
    theta_noise_std: float = 1.0
    dxy_noise_std: float = 0.08
    nu: int = 3               # control dim (waist ref velocity)
    # Additive cost for rollouts whose QP chain failed (large residual /
    # non-finite objective): they stay detectable in ``info`` but never
    # dominate the MPPI average — the batch analog of the reference's
    # skip-actuation-on-failure (/root/reference/src/ForceAcc.cpp:189-193).
    fail_penalty: float = 1e6


class SamplingMPC:
    """MPPI controller: perturb the nominal waist-velocity plan, roll out the
    full WBC-in-the-loop dynamics per sample, exponentially average."""

    def __init__(self, plugin: ForceAccPlugin, mppi: MPPIConfig,
                 rollout_cfg: Optional[RolloutConfig] = None,
                 mesh: Optional[Mesh] = None, cost_fn=default_cost,
                 contact_offsets=None):
        """``contact_offsets``: plant foot patches (SimRobot convention),
        threaded to the rollout so planner and plant feel the same contact
        moments."""
        self.plugin = plugin
        self.mppi = mppi
        self.rcfg = rollout_cfg or RolloutConfig(horizon=mppi.horizon)
        self.mesh = mesh
        self.swing = None
        self.init_theta = None
        if mppi.step_recovery:
            self.swing, self.init_theta = make_swing_primitive(
                plugin, span_s=self.rcfg.horizon * self.rcfg.dt)
        self.rollout = make_rollout_fn(plugin, self.rcfg, cost_fn,
                                       swing=self.swing,
                                       contact_offsets=contact_offsets)
        self._step = jax.jit(self._step_impl)

    def init_plan(self, dtype=jnp.float32):
        return jnp.zeros((self.mppi.horizon, self.mppi.nu), dtype)

    @f32_matmuls
    def _step_impl(self, key, state, refs, warm, U_nom, theta_nom=None):
        m = self.mppi
        K = m.n_samples
        k_noise, k_push, k_ms, k_mu, k_th = jax.random.split(key, 5)
        noise = m.noise_std * jax.random.normal(
            k_noise, (K, m.horizon, m.nu), U_nom.dtype)
        U = U_nom[None] + noise                           # (K, H, nu)
        push = m.push_std * jax.random.normal(
            k_push, (K, m.horizon, 3), U_nom.dtype)
        scenario = {"push": push}
        if m.mass_scale_std > 0.0:
            scenario["mass_scale"] = jnp.exp(
                m.mass_scale_std * jax.random.normal(k_ms, (K,), U_nom.dtype))
        if m.mu_scale_range > 0.0:
            scenario["mu_scale"] = 1.0 - m.mu_scale_range * jax.random.uniform(
                k_mu, (K,), U_nom.dtype)
        theta = None
        if theta_nom is not None:
            ks = {kk: kv for kk, kv in zip(
                theta_nom, jax.random.split(k_th, len(theta_nom)))}
            def _jitter(kk, v):
                std = (m.dxy_noise_std if kk == "dxy" else m.theta_noise_std)
                return v[None] + std * jax.random.normal(
                    ks[kk], (K,) + v.shape, v.dtype)
            theta = {kk: _jitter(kk, v) for kk, v in theta_nom.items()}

        if self.mesh is not None:
            # shard the sample axis over ALL mesh axes (a 2-D (host,
            # rollout) mesh flattens onto the batch; 1-D meshes unchanged)
            spec = NamedSharding(self.mesh, P(self.mesh.axis_names))
            U = jax.lax.with_sharding_constraint(U, spec)
            scenario = jax.tree.map(
                lambda a: jax.lax.with_sharding_constraint(a, spec), scenario)

        if theta is None:
            def one(Uk, scen_k):
                return self.rollout(state, refs, warm, Uk, scen_k)
            costs, health = jax.vmap(one)(U, scenario)
        else:
            def one(Uk, scen_k, th_k):
                return self.rollout(state, refs, warm, Uk, scen_k, th_k)
            costs, health = jax.vmap(one)(U, scenario, theta)
        failed = health["solver_failed"]
        costs = jnp.where(jnp.isfinite(costs), costs, m.fail_penalty)
        costs = costs + m.fail_penalty * failed.astype(costs.dtype)
        beta = jnp.min(costs)                             # all-reduce min
        w = jnp.exp(-(costs - beta) / m.lambda_)
        w = w / jnp.sum(w)                                # all-reduce sum
        U_new = jnp.einsum("k,khu->hu", w, U)
        if theta is not None:
            theta_new = jax.tree.map(
                lambda v: jnp.einsum("k,k...->...", w, v), theta)
        else:
            theta_new = None
        # elite (best-sample) decisions: the exponential AVERAGE of theta
        # is mushy when the decision is discrete-ish (step or don't) — a
        # single committed capture-step sample wins on cost but an average
        # over 23 non-steppers dilutes it to nothing. Surface the argmin
        # sample so callers can act on the planner's actual best choice.
        best = jnp.argmin(costs)
        info = {
            "cost_min": beta,
            "cost_mean": jnp.mean(costs),
            "ess": 1.0 / jnp.sum(w ** 2),                 # effective samples
            # per-batch solver health (SURVEY.md §5): infeasible scenarios
            # are detectable, not silently averaged in
            "solver_fail_frac": jnp.mean(failed.astype(costs.dtype)),
            "prim_res_max": jnp.max(health["prim_res_max"]),
            "U_best": U[best],
            "best_failed": failed[best],
        }
        if theta is not None:
            info["theta_best"] = jax.tree.map(lambda v: v[best], theta)
        if theta_new is not None:
            return (U_new, theta_new), info
        return U_new, info

    def plan(self, key, state, refs, warm, U_nom):
        """One MPC re-planning step. Returns (U_new, info). The first row of
        U_new is the control applied this tick; shift for the next tick."""
        return self._step(key, state, refs, warm, U_nom)

    def plan_step(self, key, state, refs, warm, U_nom, theta_nom):
        """Re-plan with the footstep-recovery decision channel
        (mppi.step_recovery): returns ((U_new, theta_new), info)."""
        return self._step(key, state, refs, warm, U_nom, theta_nom)

    @staticmethod
    def shift_plan(U):
        return jnp.concatenate([U[1:], U[-1:]], axis=0)
