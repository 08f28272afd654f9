"""Debug the humanoid MPC rollout QP health failure.

Sweeps rollout QP profiles at the bench_mpc humanoid config on CPU and
prints health (worst relative primal residual, failure flag) per profile.
"""
import dataclasses
import itertools

import jax

jax.config.update("jax_platforms", "cpu")
from qppvm_tpu.device import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402

from qppvm_tpu.model import kinematics, zoo  # noqa: E402
from qppvm_tpu.mpc.rollout import RolloutConfig, default_cost, make_rollout_fn  # noqa: E402
from qppvm_tpu.plugins.force_acc import ForceAccPlugin  # noqa: E402


def main():
    model = zoo.humanoid()
    contacts = ("l_sole", "r_sole")
    plugin = ForceAccPlugin(model, contact_links=contacts,
                            waist_link="pelvis", iters=20)
    st = model.home_state()
    kin = kinematics.fk(model, st)
    foot_z = min(float(kin.p[model.link_index(c)][2]) for c in contacts)
    st = dataclasses.replace(
        st, base_pos=st.base_pos - jnp.asarray([0.0, 0.0, foot_z]))
    refs, warm, _ = plugin.on_start(st)

    H = 8
    controls = jnp.zeros((H, 3))
    pushes = {
        "zero": jnp.zeros((H, 3)),
        "p30": 30.0 * jax.random.normal(jax.random.PRNGKey(0), (H, 3)),
        "p30b": 30.0 * jax.random.normal(jax.random.PRNGKey(7), (H, 3)),
    }

    for qp_iters, rho_up in itertools.product((10, 20, 30), (0, 1)):
        rcfg = RolloutConfig(horizon=H, qp_iters=qp_iters,
                             qp_rho_updates=rho_up)
        rollout = jax.jit(make_rollout_fn(plugin, rcfg, default_cost))
        line = f"iters={qp_iters:3d} rho_up={rho_up}:"
        for name, push in pushes.items():
            cost, health = rollout(st, refs, warm, controls, {"push": push})
            line += (f"  {name}: prim={float(health['prim_res_max']):.4f}"
                     f" fail={int(bool(health['solver_failed']))}")
        print(line)


if __name__ == "__main__":
    main()
