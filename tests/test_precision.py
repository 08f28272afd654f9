"""Every matmul of the deployed programs runs in full float32 (HIGHEST).
On the GPU, float32 matmuls at default precision run as TF32, which keeps
~10 mantissa bits; the Newton-Schulz inverses and the ADMM/KKT applies
need the full 24 (precision.py)."""
import jax
import jax.numpy as jnp
import pytest

from qppvm_tpu.model import zoo
from qppvm_tpu.mpc.rollout import RolloutConfig, standing_state
from qppvm_tpu.mpc.sampling import MPPIConfig, SamplingMPC
from qppvm_tpu.plugins.force_acc import ForceAccPlugin

HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
CONTACTS = ("l_sole", "r_sole")


def _eqns(jaxpr):
    """All equations of a jaxpr and its sub-jaxprs, depth first."""
    for e in jaxpr.eqns:
        yield e
        for v in e.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _eqns(inner)


@pytest.fixture(scope="module")
def humanoid():
    model = zoo.humanoid()
    # the RT profile of bench.py / chip_smoke.py
    plugin = ForceAccPlugin(model, contact_links=CONTACTS,
                            waist_link="pelvis", iters=12,
                            solver_opts=dict(rho_updates=0,
                                             warm_kinv_iters=4,
                                             cold_ns_iters=10, scale_iters=2,
                                             pinv_ns_iters=5))
    state = standing_state(model, CONTACTS)
    refs, warm, _ = plugin.on_start(state)
    return plugin, state, refs, warm


def _assert_all_dots_highest(closed):
    dots = [e for e in _eqns(closed.jaxpr)
            if e.primitive.name == "dot_general"]
    assert len(dots) > 50
    bad = [e for e in dots if e.params["precision"] != HIGHEST]
    assert not bad, f"{len(bad)} of {len(dots)} dots below HIGHEST: " \
        f"{sorted({str(e.params['precision']) for e in bad})}"


def test_wbc_step_dots_are_full_float32(humanoid):
    plugin, state, refs, warm = humanoid
    _assert_all_dots_highest(jax.make_jaxpr(plugin._step_impl)(
        state, refs, warm))


@pytest.mark.gpu
def test_wbc_step_on_gpu_matches_cpu(gpu, humanoid):
    """On the card, the tick's torques agree with the CPU's to the parity
    bar (1e-3 Nm): no matmul of the step fell back to TF32."""
    plugin, state, refs, warm = humanoid
    tau_g, _, aux_g = jax.jit(plugin._step_impl)(state, refs, warm)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        tau_c, _, aux_c = jax.jit(plugin._step_impl)(
            *jax.device_put((state, refs, warm), cpu))
    assert not bool(aux_g.solver_failed) and not bool(aux_c.solver_failed)
    assert float(jnp.max(jnp.abs(tau_g - jax.device_put(tau_c, gpu[0])))) \
        <= 1e-3


def test_mpc_plan_dots_are_full_float32(humanoid):
    plugin, state, refs, warm = humanoid
    mpc = SamplingMPC(plugin, MPPIConfig(n_samples=4, horizon=2),
                      RolloutConfig(horizon=2, qp_iters=12))
    _assert_all_dots_highest(jax.make_jaxpr(mpc._step_impl)(
        jax.random.PRNGKey(0), state, refs, warm, mpc.init_plan()))
