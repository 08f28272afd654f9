"""Sampling-MPC + sharding tests on the virtual 8-device CPU mesh
(SURVEY.md §2c / BASELINE config 5, small shapes)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qppvm_tpu.model import kinematics, zoo
from qppvm_tpu.mpc.rollout import (RolloutConfig, default_cost,
                                   make_rollout_fn, standing_state)
from qppvm_tpu.mpc.sampling import MPPIConfig, SamplingMPC
from qppvm_tpu.parallel import mesh as meshlib
from qppvm_tpu.plugins.force_acc import ForceAccPlugin

CONTACTS = ("foot_fl", "foot_fr", "foot_hr", "foot_hl")


def _standing(model):
    st = model.home_state()
    kin = kinematics.fk(model, st)
    foot_z = min(float(kin.p[model.link_index(c)][2]) for c in CONTACTS)
    return dataclasses.replace(
        st, base_pos=st.base_pos - jnp.asarray([0.0, 0.0, foot_z],
                                               st.base_pos.dtype))


@pytest.fixture(scope="module")
def setup():
    model = zoo.quadruped()
    plugin = ForceAccPlugin(model, iters=40)
    state = _standing(model)
    refs, warm, _ = plugin.on_start(state)
    return model, plugin, state, refs, warm


def test_rollout_finite_cost(setup):
    model, plugin, state, refs, warm = setup
    cfg = RolloutConfig(horizon=4, qp_iters=10)
    rollout = make_rollout_fn(plugin, cfg, default_cost)
    U = jnp.zeros((4, 3), jnp.float32)
    scen = {"push": jnp.zeros((4, 3), jnp.float32)}
    c, health = jax.jit(rollout)(state, refs, warm, U, scen)
    assert np.isfinite(float(c))
    # solver health surfaced per rollout (SURVEY.md §5): quiet standing
    # converges, so the worst residual over the horizon is small
    assert not bool(health["solver_failed"])
    assert float(health["prim_res_max"]) < 0.05
    # standing quietly should be cheap; a hard push costs more
    scen2 = {"push": 300.0 * jnp.ones((4, 3), jnp.float32)}
    c2, _ = jax.jit(rollout)(state, refs, warm, U, scen2)
    assert float(c2) > float(c)


def test_mppi_improves_over_nominal(setup):
    model, plugin, state, refs, warm = setup
    mppi = MPPIConfig(n_samples=16, horizon=3, noise_std=0.1)
    mpc = SamplingMPC(plugin, mppi, RolloutConfig(horizon=3, qp_iters=8))
    U = mpc.init_plan()
    U_new, info = mpc.plan(jax.random.PRNGKey(0), state, refs, warm, U)
    assert U_new.shape == (3, 3)
    assert np.isfinite(float(info["cost_mean"]))
    assert float(info["ess"]) > 1.0
    # batch solver health is reported (SURVEY.md §5)
    assert float(info["solver_fail_frac"]) == 0.0
    assert np.isfinite(float(info["prim_res_max"]))
    shifted = SamplingMPC.shift_plan(U_new)
    assert shifted.shape == U_new.shape


def test_humanoid_rollout_health_under_pushes():
    """The flagship config-5 path: pushed humanoid MPC rollouts must pass
    their per-step QP health check at the bench_mpc settings (round 1
    shipped with solver_fail_frac=1.0 here). Also
    guards the rho carry policy + force-nullspace regularization fixes."""
    model = zoo.humanoid()
    contacts = ("l_sole", "r_sole")
    plugin = ForceAccPlugin(model, contact_links=contacts,
                            waist_link="pelvis", iters=20)
    st = standing_state(model, contacts)
    refs, warm, _ = plugin.on_start(st)
    H = 6
    rcfg = RolloutConfig(horizon=H, qp_iters=20)
    rollout = jax.jit(jax.vmap(
        lambda U, p: make_rollout_fn(plugin, rcfg, default_cost)(
            st, refs, warm, U, {"push": p})))
    K = 16
    k1, k2 = jax.random.split(jax.random.PRNGKey(42))
    U = 0.15 * jax.random.normal(k1, (K, H, 3))
    push = 30.0 * jax.random.normal(k2, (K, H, 3))
    costs, health = rollout(U, push)
    assert bool(jnp.all(jnp.isfinite(costs)))
    fail_frac = float(jnp.mean(health["solver_failed"].astype(jnp.float32)))
    assert fail_frac == 0.0, (
        f"fail_frac={fail_frac}, worst prim="
        f"{float(jnp.max(health['prim_res_max']))}")
    assert float(jnp.max(health["prim_res_max"])) < 0.05


def test_mppi_sharded_matches_unsharded(setup):
    """Same seed, with and without mesh sharding -> identical plan (the
    collective-lowered reduction must be numerically equivalent)."""
    model, plugin, state, refs, warm = setup
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    mppi = MPPIConfig(n_samples=16, horizon=2, noise_std=0.1)
    rcfg = RolloutConfig(horizon=2, qp_iters=6)
    mpc_plain = SamplingMPC(plugin, mppi, rcfg, mesh=None)
    m = meshlib.make_mesh(8)
    mpc_shard = SamplingMPC(plugin, mppi, rcfg, mesh=m)
    key = jax.random.PRNGKey(7)
    U = mpc_plain.init_plan()
    U1, i1 = mpc_plain.plan(key, state, refs, warm, U)
    U2, i2 = mpc_shard.plan(key, state, refs, warm, U)
    # f32 + different cross-device reduction order -> small drift is expected
    np.testing.assert_allclose(np.asarray(U1), np.asarray(U2), atol=1e-4)
    np.testing.assert_allclose(float(i1["cost_mean"]), float(i2["cost_mean"]),
                               rtol=1e-3)


def test_shard_batch_places_on_mesh():
    m = meshlib.make_mesh(8)
    x = jnp.arange(32.0).reshape(32, 1)
    xs = meshlib.shard_batch(x, m)
    assert len(xs.sharding.device_set) == 8


def test_psum_collective_on_mesh():
    """Explicit shard_map + psum sanity (the NCCL-equivalent layer)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    m = meshlib.make_mesh(8)

    def f(x):
        return jax.lax.psum(jnp.sum(x), "rollout")

    x = jnp.arange(64.0)
    out = jax.jit(shard_map(f, mesh=m, in_specs=P("rollout"),
                            out_specs=P()))(x)
    np.testing.assert_allclose(float(out), float(jnp.sum(x)), rtol=1e-6)
