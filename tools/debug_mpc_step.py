"""Per-step trace of a pushed humanoid rollout: where does QP health die?"""
import dataclasses

import jax

jax.config.update("jax_platforms", "cpu")
from qppvm_tpu.device import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from qppvm_tpu.model import dynamics, kinematics, zoo  # noqa: E402
from qppvm_tpu.mpc.rollout import RolloutConfig  # noqa: E402
from qppvm_tpu.opt import hierarchy  # noqa: E402
from qppvm_tpu.plugins.force_acc import ForceAccPlugin  # noqa: E402

def _contact_forces(model, kin, J_all, u, contact_idx, cfg, dtype, mu=None):
    """Local copy of the pre-round-4 viscous contact model (the package now
    shares runtime.robot_interface.ground_forces with the plant)."""
    import jax.numpy as jnp
    mu = cfg.mu if mu is None else mu
    ext = jnp.zeros((model.nj, 6), dtype)
    for li in contact_idx:
        p = kin.p[li]
        v = J_all[li] @ u
        pen = cfg.ground_z - p[2]
        in_contact = pen > 0.0
        fz = jnp.maximum(cfg.contact_kp * pen - cfg.contact_kd * v[2], 0.0)
        ft = -cfg.contact_kd * v[:2] * 5.0
        ft_max = mu * fz
        ft = ft * jnp.minimum(1.0, ft_max / (jnp.linalg.norm(ft) + 1e-9))
        f = jnp.where(in_contact, jnp.concatenate([ft, fz[None]]),
                      jnp.zeros(3, dtype))
        ext = ext.at[li].add(jnp.concatenate([f, jnp.zeros(3, dtype)]))
    return ext




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
    cfg = RolloutConfig(horizon=H, qp_iters=10)
    contact_idx = tuple(model.link_index(c) for c in contacts)
    push = 30.0 * jax.random.normal(jax.random.PRNGKey(7), (H, 3))

    @jax.jit
    def step(state, refs, warm, push_t):
        data = dynamics.compute_model_data(model, state)
        sd = plugin.stack.build(model, data, state, refs, nx=plugin.opt.size,
                                dtype=plugin.dtype)
        x, warm_new, infos = hierarchy.solve(
            sd, warm, eps=plugin.eps, iters=cfg.qp_iters, refine=0,
            rho_updates=cfg.qp_rho_updates,
            assume_warm_kinv=cfg.qp_warm_kinv,
            warm_kinv_iters=cfg.qp_warm_kinv_iters)
        qddot = plugin.qddot.value(x)
        tau_c = jnp.zeros(model.nv, plugin.dtype)
        wr = []
        for cl, w in zip(plugin.contact_links, plugin.wrenches):
            Jc = dynamics.frame_data(model, data, cl)[2][:3]
            tau_c = tau_c + Jc.T @ w.value(x)
            wr.append(w.value(x))
        tau_full = dynamics.rnea(model, state, qddot, gravity=True,
                                 kin=data.kin)
        tau = (tau_full - tau_c)[6:]
        tau = jnp.clip(tau, -model.tau_max, model.tau_max)

        kin2 = kinematics.fk(model, state)
        J_all = kinematics.all_link_jacobians(model, kin2)
        ext = _contact_forces(model, kin2, J_all, state.u, contact_idx, cfg,
                              state.q.dtype)
        udot = dynamics.forward_dynamics(model, state, tau, ext_wrenches=ext,
                                         kin=kin2)
        state2 = dynamics.integrate(model, state, udot, cfg.dt)
        dv = push_t * cfg.dt
        base_vel = state2.base_vel.at[3:].add(
            jnp.einsum("ji,j->i", state2.base_rot, dv))
        state2 = dataclasses.replace(state2, base_vel=base_vel)
        prims = jnp.stack([i.prim_res for i in infos])
        duals = jnp.stack([i.dual_res for i in infos])
        fz = jnp.stack([w[2] for w in wr])
        # sim contact normal forces
        fz_sim = jnp.stack([ext[li][2] for li in contact_idx])
        return state2, warm_new, prims, duals, fz, fz_sim, qddot

    state = st
    for t in range(H):
        state, warm, prims, duals, fz, fz_sim, qddot = step(
            state, refs, warm, push[t])
        print(f"t={t}: prim={np.array(prims)} dual={np.array(duals)} "
              f"qp_fz={np.array(fz).round(1)} sim_fz={np.array(fz_sim).round(1)} "
              f"base_z={float(state.base_pos[2]):.3f} "
              f"|v|={float(jnp.linalg.norm(state.base_vel)):.2f} "
              f"|qddot|={float(jnp.linalg.norm(qddot)):.1f}")


if __name__ == "__main__":
    main()
