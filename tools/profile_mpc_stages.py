"""Batched per-stage cost decomposition of one MPC rollout step.

Times each stage of the rollout tick as its own chained-scan XLA program at
MPC batch size (default 4096), state-fed-back so nothing hoists. This is
the shape-level profiler behind the bench_mpc assembly-bound diagnosis:
compare stage sums against the measured plan-step time.

Usage: python tools/profile_mpc_stages.py [--batch 4096] [--cpu]
"""
import argparse
import dataclasses
import json
import time

import jax

from qppvm_tpu.device import enable_compile_cache  # noqa: E402

enable_compile_cache()

import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _chain(fn, carry0, n=8, reps=3):
    def wrapped(c):
        def body(c, _):
            return fn(c), None
        out, _ = jax.lax.scan(body, c, None, length=n)
        return out
    j = jax.jit(wrapped)
    out = j(carry0)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = j(carry0)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / (reps * n) * 1e3  # ms per step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--qp-iters", type=int, default=12)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    from qppvm_tpu.model import dynamics, zoo
    from qppvm_tpu.mpc.rollout import RolloutConfig, standing_state
    from qppvm_tpu.opt import hierarchy
    from qppvm_tpu.plugins.force_acc import ForceAccPlugin

    model = zoo.humanoid()
    contacts = ("l_sole", "r_sole")
    plugin = ForceAccPlugin(model, contact_links=contacts,
                            waist_link="pelvis", iters=20)
    st = standing_state(model, contacts)
    refs, warm, _ = plugin.on_start(st)
    B = args.batch

    def bcast(t):
        return jax.tree.map(
            lambda a: jnp.broadcast_to(a, (B,) + a.shape), t)

    key = jax.random.PRNGKey(0)
    sts = bcast(st)
    dq = 0.01 * jax.random.normal(key, (B, model.nj), jnp.float32)
    sts = dataclasses.replace(sts, q=sts.q + dq)
    refs_b = bcast(refs)
    warm_b = bcast(warm)
    rcfg = RolloutConfig(qp_iters=args.qp_iters)
    ro_opts = dict(iters=rcfg.qp_iters, refine=0, polish_rounds=0,
                   rho_updates=rcfg.qp_rho_updates,
                   assume_warm_kinv=rcfg.qp_warm_kinv,
                   warm_kinv_iters=rcfg.qp_warm_kinv_iters,
                   rho_adapt_tol=rcfg.qp_rho_adapt_tol,
                   rho_scale_min=rcfg.qp_rho_scale_min)

    out = {}

    # 1. model update (compute_model_data: FK + Jacobians + RNEA + B + Binv)
    def model_fn(s):
        d = jax.vmap(lambda x: dynamics.compute_model_data(model, x))(s)
        return dataclasses.replace(s, q=s.q + 1e-9 * d.h[:, -model.nj:])
    out["model_data_ms"] = _chain(model_fn, sts)

    # 2. sim step (forward dynamics + integrate)
    def sim_fn(s):
        def one(x):
            udot = dynamics.forward_dynamics(
                model, x, jnp.zeros(model.nj, jnp.float32))
            return dynamics.integrate(model, x, udot, 1e-5)
        return jax.vmap(one)(s)
    out["sim_step_ms"] = _chain(sim_fn, sts)

    # 3. stack assembly (data recomputed once outside; chained through refs)
    data_b = jax.jit(jax.vmap(
        lambda x: dynamics.compute_model_data(model, x)))(sts)

    def asm_fn(carry):
        r, acc = carry
        s2 = jax.vmap(lambda d_, s_, r_: plugin.stack.build(
            model, d_, s_, r_, nx=plugin.opt.size, dtype=plugin.dtype))(
                data_b, sts, r)
        r = dict(r)
        p = dict(r["waist_task"])
        p["p"] = p["p"] + 1e-9 * s2.levels[0].b[:, :3]
        r["waist_task"] = p
        return (r, acc + s2.levels[0].b[:, 0])
    out["stack_assembly_ms"] = _chain(
        asm_fn, (refs_b, jnp.zeros((B,), plugin.dtype)))

    # 4. hierarchy solve at rollout profile (chained through warm)
    sd_b = jax.jit(jax.vmap(lambda d_, s_, r_: plugin.stack.build(
        model, d_, s_, r_, nx=plugin.opt.size, dtype=plugin.dtype)))(
            data_b, sts, refs_b)

    def solve_fn(w):
        _, w2, _ = jax.vmap(lambda sd_, w_: hierarchy.solve(
            sd_, w_, eps=plugin.eps,
            eps_abs_scale=plugin.eps_abs_scale,
            reg_diag=plugin.reg_diag, **ro_opts))(sd_b, w)
        return w2
    out["solve_ms"] = _chain(solve_fn, warm_b)

    # 4b. solve with 0 ADMM iterations (fixed costs: Ruiz + eq-elim + K
    # build + NS inverse + residuals)
    def solve0_fn(w):
        o = dict(ro_opts, iters=1)
        _, w2, _ = jax.vmap(lambda sd_, w_: hierarchy.solve(
            sd_, w_, eps=plugin.eps,
            eps_abs_scale=plugin.eps_abs_scale,
            reg_diag=plugin.reg_diag, **o))(sd_b, w)
        return w2
    out["solve_fixed_ms"] = _chain(solve0_fn, warm_b)

    # 5. full step_core chained through state (tau -> q feedback)
    def full_fn(carry):
        s, w = carry
        tau, w2, infos, _ = jax.vmap(
            lambda s_, w_: plugin.step_core(s_, refs, w_,
                                            solver_opts=ro_opts))(s, w)
        qd = jnp.clip(s.qd + 1e-3 * tau / 10.0, -5.0, 5.0)
        s2 = dataclasses.replace(
            s, q=jnp.clip(s.q + 1e-3 * qd, model.q_min, model.q_max), qd=qd)
        return (s2, w2)
    out["full_tick_ms"] = _chain(full_fn, (sts, warm_b))

    out.update(batch=B, qp_iters=args.qp_iters,
               device=str(jax.devices()[0].device_kind))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
