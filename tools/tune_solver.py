"""Sweep RT-solver knobs on the GPU: throughput of the flagship humanoid
WBC step (bench.py's workload) per solver configuration.

Usage:  python tools/tune_solver.py [--batch 1024] [--reps 5]

Prints one JSON line per config: solves/s + final relative residuals of a
chained 50-step warm-started run (the residuals are the cheap on-device
quality signal; full closed-loop quality is gated by the CPU test suite —
tests/test_humanoid_config4.py, tests/test_parity.py).
"""
import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp

from qppvm_tpu.device import enable_compile_cache, require_gpu
from qppvm_tpu.model import zoo
from qppvm_tpu.plugins.force_acc import ForceAccPlugin

CONFIGS = {
    "base_i30_p16_w12": dict(iters=30, solver_opts={}),
    "i30_p10_w8": dict(iters=30, solver_opts=dict(polish_ns_iters=10,
                                                  warm_kinv_iters=8)),
    "i20_p10_w8": dict(iters=20, solver_opts=dict(polish_ns_iters=10,
                                                  warm_kinv_iters=8)),
    "i16_p8_w6": dict(iters=16, solver_opts=dict(polish_ns_iters=8,
                                                 warm_kinv_iters=6)),
    "i30_nopolish": dict(iters=30, solver_opts=dict(polish_rounds=0)),
    "i30_nopolish_w8": dict(iters=30, solver_opts=dict(polish_rounds=0,
                                                       warm_kinv_iters=8)),
    "i40_nopolish": dict(iters=40, solver_opts=dict(polish_rounds=0)),
    # rho_updates=0: single ADMM chunk per tick -> zero cold NS inversions
    # on warm ticks (rho_scale is carried across ticks in QPState, so the
    # cross-tick adaptation loop still closes; only intra-solve rho
    # rebalancing is dropped).
    "i30_nopolish_ru0": dict(iters=30, solver_opts=dict(polish_rounds=0,
                                                        rho_updates=0)),
    "i30_nopolish_ru0_w8": dict(iters=30, solver_opts=dict(
        polish_rounds=0, rho_updates=0, warm_kinv_iters=8)),
    "i40_nopolish_ru0": dict(iters=40, solver_opts=dict(polish_rounds=0,
                                                        rho_updates=0)),
    "i60_nopolish_ru0": dict(iters=60, solver_opts=dict(polish_rounds=0,
                                                        rho_updates=0)),
    # Matmul-precision experiments: "high" = 3 compensated bf16 passes
    # (~f32 mantissa coverage), X6 = 6 passes (full f32 emulation).
    "i30_nopolish_px6": dict(iters=30, solver_opts=dict(polish_rounds=0),
                             precision="BF16_BF16_F32_X6"),
    "i30_nopolish_phigh": dict(iters=30, solver_opts=dict(polish_rounds=0),
                               precision="high"),
    "i30_nopolish_ru0_px6": dict(iters=30, solver_opts=dict(
        polish_rounds=0, rho_updates=0), precision="BF16_BF16_F32_X6"),
    # --- equality-elimination era (opt/qp.py n_eq_*): the projected ADMM
    # matrix is ~100-10000x better conditioned, so the NS inversion budget
    # (warm_kinv_iters) and possibly the ADMM iteration count shrink.
    "eq_i30_ru0_w16": dict(iters=30, solver_opts=dict(
        polish_rounds=0, rho_updates=0, warm_kinv_iters=16)),
    "eq_i30_ru0_w8": dict(iters=30, solver_opts=dict(
        polish_rounds=0, rho_updates=0, warm_kinv_iters=8)),
    "eq_i30_ru0_w6": dict(iters=30, solver_opts=dict(
        polish_rounds=0, rho_updates=0, warm_kinv_iters=6)),
    "eq_i30_ru0_w4": dict(iters=30, solver_opts=dict(
        polish_rounds=0, rho_updates=0, warm_kinv_iters=4)),
    "eq_i20_ru0_w6": dict(iters=20, solver_opts=dict(
        polish_rounds=0, rho_updates=0, warm_kinv_iters=6)),
    "eq_i16_ru0_w6": dict(iters=16, solver_opts=dict(
        polish_rounds=0, rho_updates=0, warm_kinv_iters=6)),
    "noeq_i30_ru0_w16": dict(iters=30, solver_opts=dict(
        polish_rounds=0, rho_updates=0, warm_kinv_iters=16, eq_elim=False)),
    "eq2_i16_ru0_w4": dict(iters=16, solver_opts=dict(
        polish_rounds=0, rho_updates=0, warm_kinv_iters=4)),
    "eq2_i12_ru0_w4": dict(iters=12, solver_opts=dict(
        polish_rounds=0, rho_updates=0, warm_kinv_iters=4)),
    "eq2_i10_ru0_w4": dict(iters=10, solver_opts=dict(
        polish_rounds=0, rho_updates=0, warm_kinv_iters=4)),
    "eq2_i8_ru0_w3": dict(iters=8, solver_opts=dict(
        polish_rounds=0, rho_updates=0, warm_kinv_iters=3)),
}


def run_one(name, cfg, batch, reps):
    from qppvm_tpu import precision
    cfg = dict(cfg)
    precision.set_matmul_precision(cfg.pop("precision", "float32"))
    model = zoo.humanoid()
    plugin = ForceAccPlugin(model, contact_links=("l_sole", "r_sole"),
                            waist_link="pelvis", **cfg)
    state = model.home_state()
    refs, warm, _ = plugin.on_start(state)

    step = jax.jit(jax.vmap(lambda s, r, w: plugin._step_impl(s, r, w)[0]))
    states = jax.tree.map(lambda a: jnp.broadcast_to(a, (batch,) + a.shape),
                          state)
    refs_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (batch,) + a.shape),
                          refs)
    warm_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (batch,) + a.shape),
                          warm)
    key = jax.random.PRNGKey(0)
    dq = 0.01 * jax.random.normal(key, (batch, model.nj), jnp.float32)
    states = dataclasses.replace(states, q=states.q + dq)

    tau = step(states, refs_b, warm_b)
    tau.block_until_ready()
    if not bool(jnp.all(jnp.isfinite(tau))) or bool(
            jnp.all(jnp.abs(tau) < 1e-9)):
        print(json.dumps({"config": name, "error": "nonfinite/zero tau"}))
        return

    t0 = time.perf_counter()
    for _ in range(reps):
        tau = step(states, refs_b, warm_b)
    tau.block_until_ready()
    dt = (time.perf_counter() - t0) / reps
    solves_per_s = batch / dt

    # chained warm-started residual check (50 ticks on one item)
    def chained(state, refs, warm):
        def body(w, _):
            tau, w2, aux = plugin._step_impl(state, refs, w)
            return w2, (tau, aux.prim_res, aux.solver_failed)
        _, (taus, pr, failed) = jax.lax.scan(body, warm, None, length=50)
        return taus, pr, failed

    taus, pr, failed = jax.jit(chained)(state, refs, warm)
    taus.block_until_ready()
    print(json.dumps({
        "config": name,
        "solves_per_s": round(float(solves_per_s), 1),
        "chain_prim_res_max": float(jnp.max(pr)),
        "chain_any_failed": bool(jnp.any(failed)),
        "chain_tau_finite": bool(jnp.all(jnp.isfinite(taus))),
    }), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", type=str, default=None)
    args = ap.parse_args()
    require_gpu()
    enable_compile_cache()
    for name, cfg in CONFIGS.items():
        if args.only and args.only not in name:
            continue
        run_one(name, cfg, args.batch, args.reps)


if __name__ == "__main__":
    main()
