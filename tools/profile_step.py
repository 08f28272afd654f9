"""jax.profiler harness: capture a device trace of the WBC step and the
MPC planning step (SURVEY.md §5 tracing/profiling).

Writes a TensorBoard-compatible trace (xplane) per section under --out;
inspect with `tensorboard --logdir <out>` or xprof, or read it with
``jax.profiler.ProfileData.from_file``. The trace attributes the step
budget at op granularity.

Usage: python tools/profile_step.py [--out chiprun_out/trace]
"""
import argparse
import os
import sys

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from qppvm_tpu.device import enable_compile_cache, require_gpu  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/trace")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    require_gpu()
    enable_compile_cache()

    import dataclasses

    import jax.numpy as jnp

    from qppvm_tpu.model import zoo
    from qppvm_tpu.mpc.rollout import standing_state
    from qppvm_tpu.plugins.force_acc import ForceAccPlugin

    model = zoo.humanoid()
    contacts = ("l_sole", "r_sole")
    plugin = ForceAccPlugin(model, contact_links=contacts,
                            waist_link="pelvis", iters=30)
    state = standing_state(model, contacts)
    refs, warm, _ = plugin.on_start(state)

    B = args.batch
    step = jax.jit(jax.vmap(plugin._step_impl))
    states = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape),
                          state)
    refs_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape),
                          refs)
    warm_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape),
                          warm)
    dq = 0.01 * jax.random.normal(jax.random.PRNGKey(0), (B, model.nj),
                                  jnp.float32)
    states = dataclasses.replace(states, q=states.q + dq)

    out = step(states, refs_b, warm_b)
    jax.block_until_ready(out)  # compile outside the trace

    os.makedirs(args.out, exist_ok=True)
    with jax.profiler.trace(args.out):
        for _ in range(args.reps):
            out = step(states, refs_b, warm_b)
        jax.block_until_ready(out)
    print(f"trace written to {args.out} "
          f"(batch={B}, reps={args.reps}); view with tensorboard/xprof")


if __name__ == "__main__":
    main()
