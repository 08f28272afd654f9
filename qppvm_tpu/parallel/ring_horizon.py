"""Horizon-parallel rollout: multiple shooting over a ``ppermute`` ring.

The reference has no sequences or horizons (SURVEY.md §5 "long-context":
it is a single-timestep QP per 1 kHz tick — /root/reference/src/
QPPVMPlugin.cpp:308); the MPC layer's horizon is this system's analog of long
context. Normally the horizon stays local to a chip (``lax.scan`` per
rollout — SURVEY.md §2c) and scale-out is across the *rollout* batch. This
module is the growth path for horizons that outgrow one chip: shard the
time axis over a mesh axis and recover the sequential dynamics by
**multiple shooting**.

How it works (classic temporal decomposition):

- Split the horizon ``T`` into ``S`` contiguous segments, one per device on
  mesh axis ``axis``. Each device holds its segment's controls and a *guess*
  of the carry (state) entering its segment.
- One **sweep** = every device scans its own segment from its boundary guess
  (all S segments run in parallel), then passes its end-carry to the next
  device with a single ``lax.ppermute`` ring hop; device 0 pins the true
  initial carry.
- After ``k`` sweeps the first ``k`` segments are exact, so ``sweeps=S``
  reproduces ``lax.scan`` semantics exactly (it *is* sequential, executed
  as S parallel scans per sweep). In warm-started MPC the boundary guesses
  come from the previous plan and 1-2 sweeps give small defects — that is the
  payoff: wall-clock per sweep is T/S steps instead of T.

Communication is one carry-sized ``ppermute`` per sweep — the
full trajectory is never gathered; outputs stay sharded over time.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


class RingRolloutInfo(NamedTuple):
    """Diagnostics of a multiple-shooting rollout.

    defect: max-abs mismatch between each segment's settled entry guess and
      its predecessor's end carry (0.0 when the rollout is exact). The analog
      of the reference's per-tick constraint-residual print
      (/root/reference/src/ForceAcc.cpp:203) at the trajectory level.
    boundaries: settled per-segment entry carries, leading axis S — feed back
      as ``boundary_guess`` next MPC tick for warm-started 1-2 sweep plans.
    """

    defect: jax.Array
    boundaries: Any


def _ring_next(tree, axis: str, size: int):
    """Send each device's value to the next device on the ring (i -> i+1)."""
    perm = [(i, (i + 1) % size) for i in range(size)]
    return jax.tree.map(lambda x: jax.lax.ppermute(x, axis, perm), tree)


def ring_rollout(
    step_fn: Callable[[Any, Any], Tuple[Any, Any]],
    x0: Any,
    U: Any,
    mesh: Mesh,
    *,
    axis: str = "seg",
    sweeps: Optional[int] = None,
    boundary_guess: Optional[Any] = None,
) -> Tuple[Any, Any, RingRolloutInfo]:
    """Multiple-shooting rollout of ``step_fn`` with the horizon sharded.

    Args:
      step_fn: ``(carry, u_t) -> (carry, out_t)`` — same contract as the body
        of ``lax.scan``. Must be jit-pure (it is traced inside ``shard_map``).
      x0: initial carry pytree (replicated).
      U: control pytree; every leaf has leading time axis ``T`` divisible by
        the mesh axis size ``S``.
      mesh: mesh containing ``axis``.
      sweeps: number of ring sweeps. ``None`` / ``>= S`` → exact (equals
        ``lax.scan``). Fewer sweeps → approximation whose ``info.defect`` the
        caller should monitor (warm-started MPC plans typically need 1-2).
      boundary_guess: optional per-segment entry-carry guesses, leading axis
        ``S`` (e.g. ``info.boundaries`` from the previous MPC plan).
        Defaults to broadcasting ``x0``.

    Returns:
      ``(final_carry, outs, info)`` — ``outs`` has leading time axis ``T``
      sharded over ``axis``; ``final_carry`` is replicated.
    """
    S = mesh.shape[axis]
    n_sweeps = S if sweeps is None else min(int(sweeps), S)
    if n_sweeps < 1:
        raise ValueError("sweeps must be >= 1")
    T = jax.tree.leaves(U)[0].shape[0]
    if T % S != 0:
        raise ValueError(f"horizon T={T} not divisible by segments S={S}")

    if boundary_guess is None:
        boundary_guess = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (S,) + jnp.shape(x)), x0)

    seg_spec = lambda t: jax.tree.map(  # noqa: E731
        lambda x: P(axis, *([None] * (x.ndim - 1))), t)
    rep_spec = lambda t: jax.tree.map(lambda x: P(), t)  # noqa: E731

    out_shapes = jax.eval_shape(
        lambda c, u: jax.lax.scan(step_fn, c, u)[1],
        x0, jax.tree.map(lambda x: x[: T // S], U))

    def _seg(x0_rep, b_local, U_seg):
        # Sharded leaves keep a leading local-size-1 segment axis; drop it.
        b = jax.tree.map(lambda x: x[0], b_local)
        idx = jax.lax.axis_index(axis)

        def scan_carry_only(carry_in):
            return jax.lax.scan(
                lambda c, u: (step_fn(c, u)[0], None), carry_in, U_seg)[0]

        def pin_first(prev_end):
            return jax.tree.map(
                lambda g, p: jnp.where(idx == 0, g, p), x0_rep, prev_end)

        def sweep(b, _):
            end = scan_carry_only(b)
            return pin_first(_ring_next(end, axis, S)), None

        if n_sweeps > 1:
            b, _ = jax.lax.scan(sweep, b, None, length=n_sweeps - 1)

        # Final pass produces outputs from the settled boundaries.
        end, outs = jax.lax.scan(step_fn, b, U_seg)
        # Defect is a diagnostic, not part of the compute graph — detach it
        # (pmax has no differentiation rule, and gradients must flow through
        # the rollout itself, not its residual monitor).
        inc_d = jax.lax.stop_gradient(pin_first(_ring_next(end, axis, S)))
        b_d = jax.lax.stop_gradient(b)
        defect = jax.tree.reduce(
            jnp.maximum,
            jax.tree.map(lambda a, c: jnp.max(jnp.abs(a - c)), inc_d, b_d),
            jnp.zeros(()))
        defect = jax.lax.pmax(defect, axis)
        # Last segment's end carry is the trajectory's final carry.
        final = jax.tree.map(
            lambda e: jax.lax.psum(
                jnp.where(idx == S - 1, e, jnp.zeros_like(e)), axis), end)
        settled = jax.tree.map(lambda x: x[None], b)
        return final, outs, defect, settled

    fn = jax.shard_map(
        _seg, mesh=mesh,
        in_specs=(rep_spec(x0), seg_spec(boundary_guess), seg_spec(U)),
        out_specs=(rep_spec(x0), seg_spec(out_shapes), P(),
                   seg_spec(boundary_guess)))
    final, outs, defect, settled = fn(x0, boundary_guess, U)
    return final, outs, RingRolloutInfo(defect=defect, boundaries=settled)
