"""Ring-horizon multiple shooting over the REAL WBC rollout tick
(`ring_horizon` composed with the actual rollout carry —
state + refs + warm QP pytree — on the 8-virtual-device mesh, where
ppermute payload size and warm-state validity across segment boundaries are
the actual risks, not toy dynamics).

The step_fn here is ``rollout.one_step`` from mpc/rollout.py — the full WBC
tick (model update -> stack build -> hierarchical QP -> tau) plus the
shared plant contact physics — and the ring carry is its full scan carry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qppvm_tpu.model import zoo
from qppvm_tpu.mpc.rollout import (RolloutConfig, default_cost,
                                   make_rollout_fn, standing_state)
from qppvm_tpu.parallel import mesh as meshlib
from qppvm_tpu.parallel.ring_horizon import ring_rollout
from qppvm_tpu.plugins.force_acc import ForceAccPlugin

CONTACTS = ("foot_fl", "foot_fr", "foot_hr", "foot_hl")


@pytest.fixture(scope="module")
def setup():
    model = zoo.quadruped()
    plugin = ForceAccPlugin(model, contact_links=CONTACTS,
                            waist_link="pelvis", iters=20,
                            use_friction_cones=True, mu=0.5,
                            foot_tasks_6d=False)
    st = standing_state(model, CONTACTS)
    refs, warm, _ = plugin.on_start(st)
    cfg = RolloutConfig(horizon=8, dt=0.01, qp_iters=12)
    rollout = make_rollout_fn(plugin, cfg, default_cost)
    carry0 = rollout.init_carry(st, refs, warm)
    H = 8
    t_fracs = (jnp.arange(H, dtype=jnp.float32) + 0.5) / H
    # mild waist commands + pushes so the trajectory is not a fixed point
    U = (0.05 * jnp.ones((H, 3), jnp.float32),
         5.0 * jnp.ones((H, 3), jnp.float32), None, t_fracs)
    ref_final, ref_outs = jax.jit(
        lambda c, u: jax.lax.scan(rollout.one_step, c, u))(carry0, U)
    return rollout, carry0, U, ref_final, ref_outs


def _payload_bytes(tree):
    return sum(np.prod(l.shape) * l.dtype.itemsize
               for l in jax.tree.leaves(tree))


def test_ring_exact_on_real_wbc_tick(setup):
    rollout, carry0, U, ref_final, ref_outs = setup
    mesh = meshlib.make_mesh(4, axis="seg")
    final, outs, info = ring_rollout(rollout.one_step, carry0, U, mesh,
                                     sweeps=None)
    # outputs (cost, prim_res, failed per step) match the sequential scan
    for a, b in zip(jax.tree.leaves(outs), jax.tree.leaves(ref_outs)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)
    assert float(info.defect) < 1e-5
    # the full-horizon chain stays healthy through segment boundaries
    # (warm QP state rides the ppermute ring)
    costs, prims, fails = ref_outs
    assert not bool(np.any(np.asarray(fails)))
    ring_fails = np.asarray(outs[2])
    assert not bool(np.any(ring_fails))
    # final carries agree (state + warm pytree survived the ring intact)
    st_r = final[0]
    st_s = ref_final[0]
    np.testing.assert_allclose(np.asarray(st_r.q), np.asarray(st_s.q),
                               rtol=1e-5, atol=1e-6)


def test_ring_defect_shrinks_and_payload_reported(setup):
    rollout, carry0, U, _, _ = setup
    mesh = meshlib.make_mesh(4, axis="seg")
    defects = []
    for s in (1, 4):
        _, _, info = ring_rollout(rollout.one_step, carry0, U, mesh,
                                  sweeps=s)
        defects.append(float(info.defect))
    assert defects[1] < 1e-5          # sweeps == S exact
    assert defects[0] >= defects[1]   # cold 1-sweep carries a defect
    # The ppermute payload is the full rollout carry: report its size so
    # the scaling decision (ring vs local scan) is evidence-based.
    payload = _payload_bytes(carry0)
    print(f"ring carry payload: {payload / 1024:.1f} KiB")
    # KKT inverses dominate; keep the payload sane (one hop/sweep)
    assert payload < 8 * 1024 * 1024
