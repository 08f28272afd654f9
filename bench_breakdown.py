"""Per-component latency breakdown of one WBC tick (chained on-device).

Times, via sequential lax.scan chains (no host RTT):
  1. model update      (FK + RNEA + mass matrix + Jacobians + bias)
  2. stack assembly    (task matrices)
  3. hierarchy solve   (2-level ADMM cascade + polish)
Needs a GPU. Usage: python bench_breakdown.py [--robot humanoid]
"""
import argparse
import dataclasses
import json
import time

import jax

from qppvm_tpu.device import enable_compile_cache, require_gpu


def _chain(fn, carry0, n=100, reps=3):
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
    return (time.perf_counter() - t0) / (reps * n) * 1e3  # ms/step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--robot", default="humanoid")
    args = ap.parse_args()
    devices = require_gpu()
    enable_compile_cache()

    import jax.numpy as jnp
    from qppvm_tpu.model import dynamics, zoo
    from qppvm_tpu.opt import hierarchy
    from qppvm_tpu.plugins.force_acc import ForceAccPlugin

    model = zoo.by_name(args.robot)
    contacts = (("l_sole", "r_sole") if args.robot in ("humanoid", "biped")
                else ("foot_fl", "foot_fr", "foot_hr", "foot_hl"))
    plugin = ForceAccPlugin(model, contact_links=contacts,
                            waist_link="pelvis", iters=30)
    state = model.home_state()
    refs, warm, _ = plugin.on_start(state)
    data = dynamics.compute_model_data(model, state)
    sd = plugin.stack.build(model, data, state, refs, nx=plugin.opt.size,
                            dtype=plugin.dtype)

    # 1. model update: chain through q (dependency via tiny feedback)
    def model_fn(st):
        d = dynamics.compute_model_data(model, st)
        return dataclasses.replace(st, q=st.q + 1e-9 * d.h[-model.nj:])
    t_model = _chain(model_fn, state)

    # 2. stack assembly (model data fixed): chain through refs
    def asm_fn(carry):
        r, acc = carry
        s2 = plugin.stack.build(model, data, state, r, nx=plugin.opt.size,
                                dtype=plugin.dtype)
        r = dict(r)
        p = dict(r["waist_task"])
        p["p"] = p["p"] + 1e-9 * s2.levels[0].b[:3]
        r["waist_task"] = p
        return (r, acc + s2.levels[0].b[0])
    t_asm = _chain(asm_fn, (refs, jnp.zeros((), plugin.dtype)))

    # 3. solve (stack data fixed): chain through warm
    def solve_fn(w):
        x, w2, infos = hierarchy.solve(sd, w, eps=plugin.eps, iters=30,
                                       refine=2, rho_updates=1,
                                       polish_rounds=1, assume_warm_kinv=True)
        return w2
    t_solve = _chain(solve_fn, warm)

    # full step, chained through STATE: tau feeds back into (q, qd) via a
    # cheap integrator, so model update + stack assembly CANNOT be hoisted
    # out of the scan (a warm-only chain leaves state/refs as scan constants
    # and XLA hoists everything that depends only on them).
    def full_fn(carry):
        st, w = carry
        tau, w2, _ = plugin._step_impl(st, refs, w)
        qd = jnp.clip(st.qd + 1e-3 * tau / 10.0, -5.0, 5.0)
        st2 = dataclasses.replace(
            st, q=jnp.clip(st.q + 1e-3 * qd, model.q_min, model.q_max),
            qd=qd)
        return (st2, w2)
    t_full = _chain(full_fn, (state, warm))

    print(json.dumps({
        "robot": args.robot,
        "model_update_ms": t_model,
        "stack_assembly_ms": t_asm,
        "hierarchy_solve_ms": t_solve,
        "full_step_ms": t_full,
        "device": devices[0].device_kind,
    }))


if __name__ == "__main__":
    main()
