"""Multi-device scaling benchmark (BASELINE: >= 80% linear scaling).

Shards the batched humanoid WBC step over a ``rollout`` mesh of 1..N devices
and reports throughput + parallel efficiency over the GPUs of one host.

Prints one JSON line per mesh size, then a summary line. Needs GPUs.
Usage: python bench_scaling.py [--batch 256]
"""
import argparse
import json
import time

import jax

from qppvm_tpu.device import enable_compile_cache, require_gpu


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args()
    devices = require_gpu()
    enable_compile_cache()

    import dataclasses

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from qppvm_tpu.model import zoo
    from qppvm_tpu.plugins.force_acc import ForceAccPlugin

    model = zoo.humanoid()
    plugin = ForceAccPlugin(model, contact_links=("l_sole", "r_sole"),
                            waist_link="pelvis", iters=30)
    state = model.home_state()
    refs, warm, _ = plugin.on_start(state)

    B = args.batch
    key = jax.random.PRNGKey(0)
    dq = 0.01 * jax.random.normal(key, (B, model.nj), jnp.float32)
    batch = lambda t: jax.tree.map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape).copy(), t)
    states = dataclasses.replace(batch(state), q=batch(state).q + dq)
    refs_b = batch(refs)
    warm_b = batch(warm)

    step = jax.vmap(lambda s, r, w: plugin._step_impl(s, r, w)[0])

    results = []
    sizes = [n for n in [1, 2, 4, 8, len(jax.devices())]
             if n <= len(jax.devices())]
    sizes = sorted(set(sizes))
    for nd in sizes:
        mesh = Mesh(np.asarray(jax.devices()[:nd]), ("rollout",))
        spec = NamedSharding(mesh, P("rollout"))
        shard = lambda t: jax.tree.map(
            lambda a: jax.device_put(a, NamedSharding(
                mesh, P("rollout", *([None] * (a.ndim - 1))))), t)
        s_sh, r_sh, w_sh = shard(states), shard(refs_b), shard(warm_b)
        fn = jax.jit(step)
        out = fn(s_sh, r_sh, w_sh)
        out.block_until_ready()
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(s_sh, r_sh, w_sh)
        out.block_until_ready()
        dt = (time.perf_counter() - t0) / reps
        results.append((nd, B / dt))
        print(json.dumps({"devices": nd, "solves_per_s": B / dt}))

    base = results[0][1]
    eff = [(nd, r / (base * nd)) for nd, r in results]
    last_nd, last_eff = eff[-1]
    print(json.dumps({
        "metric": "multi_device_scaling_efficiency",
        "value": last_eff,
        "unit": f"fraction_linear@{last_nd}dev",
        "vs_baseline": last_eff / 0.8,
        "per_device": {str(nd): e for nd, e in eff},
        "device": devices[0].device_kind,
    }))


if __name__ == "__main__":
    main()
