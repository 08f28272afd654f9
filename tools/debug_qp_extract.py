"""Extract the failing rollout QP (level 2 at the worst pushed step) and
study it: ADMM @ many iters, PDIP, scipy reference — feasible or not?"""
import dataclasses

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from qppvm_tpu.device import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from qppvm_tpu.model import dynamics, kinematics, zoo  # noqa: E402
from qppvm_tpu.mpc.rollout import RolloutConfig  # noqa: E402
from qppvm_tpu.opt import hierarchy, qp  # noqa: E402
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
    st = st.astype(jnp.float32)
    refs, warm, _ = plugin.on_start(st)

    H = 8
    cfg = RolloutConfig(horizon=H, qp_iters=10)
    contact_idx = tuple(model.link_index(c) for c in contacts)
    push = 30.0 * jax.random.normal(jax.random.PRNGKey(7), (H, 3))

    def sim_step(state, tau):
        kin2 = kinematics.fk(model, state)
        J_all = kinematics.all_link_jacobians(model, kin2)
        ext = _contact_forces(model, kin2, J_all, state.u, contact_idx, cfg,
                              state.q.dtype)
        udot = dynamics.forward_dynamics(model, state, tau, ext_wrenches=ext,
                                         kin=kin2)
        return dynamics.integrate(model, state, udot, cfg.dt)

    state = st
    stacks = []
    warms = []
    for t in range(H):
        state32 = state.astype(jnp.float32)
        data = dynamics.compute_model_data(model, state32)
        sd = plugin.stack.build(model, data, state32, refs,
                                nx=plugin.opt.size, dtype=jnp.float32)
        stacks.append(sd)
        warms.append(warm)
        x, warm, infos = hierarchy.solve(
            sd, warm, eps=plugin.eps, iters=cfg.qp_iters, refine=0,
            rho_updates=cfg.qp_rho_updates,
            assume_warm_kinv=cfg.qp_warm_kinv,
            warm_kinv_iters=cfg.qp_warm_kinv_iters)
        prims = [float(i.prim_res) for i in infos]
        qddot = plugin.qddot.value(x)
        tau_c = jnp.zeros(model.nv, jnp.float32)
        for cl, w in zip(plugin.contact_links, plugin.wrenches):
            Jc = dynamics.frame_data(model, data, cl)[2][:3]
            tau_c = tau_c + Jc.T @ w.value(x)
        tau_full = dynamics.rnea(model, state32, qddot, gravity=True,
                                 kin=data.kin)
        tau = jnp.clip((tau_full - tau_c)[6:], -model.tau_max, model.tau_max)
        state = sim_step(state, tau)
        dv = push[t] * cfg.dt
        bv = state.base_vel.at[3:].add(
            jnp.einsum("ji,j->i", state.base_rot, dv))
        state = dataclasses.replace(state, base_vel=bv)
        print(f"t={t}: prims={np.round(prims, 4)}")

    # pick the worst step (t=7 from prior trace) and analyze its level-2 QP
    t_bad = 7
    sd = stacks[t_bad]
    wstates = warms[t_bad]

    # build the level-2 problem exactly as hierarchy.solve does
    n = sd.lb.shape[0]
    dtype = jnp.float64
    I = jnp.eye(n, dtype=dtype)
    eps, eps_abs_scale = plugin.eps, 1e-8
    # level 1 solve first (exact, x64, many iters)
    lv1, lv2 = sd.levels
    A1, b1 = lv1.A.astype(dtype), lv1.b.astype(dtype)
    A2, b2 = lv2.A.astype(dtype), lv2.b.astype(dtype)
    C = sd.C.astype(dtype)

    P1 = A1.T @ A1
    reg1 = eps * eps_abs_scale * (jnp.trace(P1) / n + 1.0)
    prob1 = qp.QPProblem(P=P1 + reg1 * I, q=-(A1.T @ b1),
                         A=jnp.concatenate([C, I]),
                         l=jnp.concatenate([sd.lC.astype(dtype),
                                            sd.lb.astype(dtype)]),
                         u=jnp.concatenate([sd.uC.astype(dtype),
                                            sd.ub.astype(dtype)]))
    x1, st1, info1 = qp.solve(prob1, None, iters=2000, rho_updates=20,
                              refine=3, polish_rounds=3)
    print("level1 exact: prim=%.2e dual=%.2e" % (info1.prim_res,
                                                 info1.dual_res))

    P2 = A2.T @ A2
    reg2 = eps * eps_abs_scale * (jnp.trace(P2) / n + 1.0)
    prob2 = qp.QPProblem(
        P=P2 + reg2 * I, q=-(A2.T @ b2),
        A=jnp.concatenate([C, I, A1]),
        l=jnp.concatenate([sd.lC.astype(dtype), sd.lb.astype(dtype),
                           A1 @ x1]),
        u=jnp.concatenate([sd.uC.astype(dtype), sd.ub.astype(dtype),
                           A1 @ x1]))
    x2, st2, info2 = qp.solve(prob2, None, iters=2000, rho_updates=20,
                              refine=3, polish_rounds=3)
    print("level2 exact: prim=%.2e dual=%.2e" % (info2.prim_res,
                                                 info2.dual_res))

    # how many iterations does a COLD f32 ADMM need on level 2?
    prob2_32 = jax.tree.map(lambda a: a.astype(jnp.float32), prob2)
    for it in (10, 20, 30, 50, 100, 200):
        for ru in (0, 1, 3):
            x, _, info = qp.solve(prob2_32, None, iters=it, rho_updates=ru,
                                  refine=0, polish_rounds=0)
            print(f"  cold f32 iters={it:4d} rho_up={ru}: "
                  f"prim={float(info.prim_res):.4f} "
                  f"dual={float(info.dual_res):.4f}")

    # warm-started from the carried state, like the rollout does
    w2 = jax.tree.map(lambda a: a.astype(jnp.float32), wstates[1])
    for it in (10, 20, 30):
        x, _, info = qp.solve(prob2_32, w2, iters=it, rho_updates=0,
                              refine=0, polish_rounds=0,
                              assume_warm_kinv=True, warm_kinv_iters=16)
        print(f"  warm f32 iters={it:4d}: prim={float(info.prim_res):.4f} "
              f"dual={float(info.dual_res):.4f}")

    np.savez("/tmp/qp_bad.npz",
             **{k: np.asarray(v) for k, v in dataclasses.asdict(prob2).items()})


if __name__ == "__main__":
    main()
