"""AutoStack: the `+` / `/` / `<<` task-stack DSL (L5 of SURVEY.md §1).

Re-designs OpenSoT's AutoStack (/root/reference/src/QPPVMPlugin.cpp:177-179:
``(_ee_task_right + _ee_task_left) / (_joint_task) << _torque_limits``;
/root/reference/src/ForceAcc.cpp:131-133). An AutoStack is *static
structure*; per tick it assembles numeric ``StackData`` from the model data —
inside jit, so stack assembly + hierarchical solve fuse into one XLA program.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import jax.numpy as jnp

from qppvm_tpu.model.dynamics import ModelData
from qppvm_tpu.model.robot import RobotModel, RobotState
from qppvm_tpu.opt import hierarchy
from qppvm_tpu.tasks.base import BOX, ROWS, AssembleCtx, Constraint, Task


class AutoStack:
    """Ordered priority levels + attached constraints."""

    def __init__(self, level0: Sequence[Task] | Task):
        if isinstance(level0, Task):
            level0 = [level0]
        self.levels: List[List[Task]] = [list(level0)]
        self.constraints: List[Constraint] = []

    # --- DSL ------------------------------------------------------------
    def __truediv__(self, other) -> "AutoStack":
        """Append a lower-priority level (`/` operator)."""
        if isinstance(other, AutoStack):
            if other.constraints:
                self.constraints.extend(other.constraints)
            self.levels.extend(other.levels)
            return self
        self.levels.append([other] if isinstance(other, Task) else list(other))
        return self

    def __lshift__(self, constraint: Constraint) -> "AutoStack":
        """Attach a constraint/bound (`<<` operator)."""
        self.constraints.append(constraint)
        return self

    # --- assembly -------------------------------------------------------
    def tasks(self) -> List[Task]:
        out = []
        for lv in self.levels:
            for t in lv:
                out.extend(t.base_tasks())
        return out

    def ref_init(self, model: RobotModel, data: ModelData,
                 state: RobotState) -> Dict[str, Any]:
        """Initial references for every task (bumpless start — the analog of
        on_start reference capture, /root/reference/src/QPPVMPlugin.cpp:271-279)."""
        refs: Dict[str, Any] = {}
        for t in self.tasks():
            refs[t.name] = t.ref_init(model, data, state)
        return refs

    def build(self, model: RobotModel, data: ModelData, state: RobotState,
              refs: Dict[str, Any], nx: int, dtype=jnp.float32
              ) -> hierarchy.StackData:
        """Assemble numeric StackData for one tick (the analog of
        autostack->update(q), /root/reference/src/QPPVMPlugin.cpp:226)."""
        ctx = AssembleCtx(model=model, data=data, state=state, refs=refs,
                          nx=nx, dtype=dtype)
        levels = []
        for lv in self.levels:
            As, bs = [], []
            for t in lv:
                A, b = t.assemble(ctx)
                As.append(A)
                bs.append(b)
            levels.append(hierarchy.LevelData(
                A=jnp.concatenate(As, axis=0), b=jnp.concatenate(bs)))

        big = jnp.asarray(1e20, dtype)
        lb = jnp.full((nx,), -big, dtype)
        ub = jnp.full((nx,), big, dtype)
        # ROWS constraints are assembled equality-first (stable order within
        # each group): the solver eliminates the leading ``n_eq`` structural
        # equality rows by projection (opt/qp.py n_eq_head). Gated
        # constraints that become equalities only at runtime (contact
        # switches) stay in the inequality block.
        #
        # COMPATIBILITY NOTE (warm-state serialization): this equality-first
        # permutation fixes the row order of C — and therefore the layout of
        # the z/y vectors in any QPState persisted via runtime/checkpoint.py.
        # A warm state saved before a change to constraint ordering (or to
        # ``is_equality`` flags) indexes different rows and must be
        # discarded, not resumed. ``constraint_row_order()`` exposes the
        # effective order for external consumers.
        #
        # INVARIANT consumed by the solver: every row of an
        # ``is_equality`` constraint must have lb == ub — the eliminator
        # takes l as the equality RHS without re-checking
        # (opt/qp.py n_eq_head). ``validate(...)`` asserts this on host.
        C_rows, lC_rows, uC_rows = [], [], []
        n_eq = 0
        has_box = False
        ordered = ([c for c in self.constraints if c.is_equality]
                   + [c for c in self.constraints if not c.is_equality])
        for c in ordered:
            kind, C, lo, hi = c.assemble(ctx)
            if kind == BOX:
                has_box = True
                lb = jnp.maximum(lb, lo.astype(dtype))
                ub = jnp.minimum(ub, hi.astype(dtype))
            elif kind == ROWS:
                C_rows.append(C.astype(dtype))
                lC_rows.append(lo.astype(dtype))
                uC_rows.append(hi.astype(dtype))
                if c.is_equality:
                    n_eq += C.shape[0]
            else:
                raise ValueError(f"unknown constraint kind {kind}")
        if C_rows:
            C = jnp.concatenate(C_rows, axis=0)
            lC = jnp.concatenate(lC_rows)
            uC = jnp.concatenate(uC_rows)
        else:
            C = jnp.zeros((0, nx), dtype)
            lC = jnp.zeros((0,), dtype)
            uC = jnp.zeros((0,), dtype)
        return hierarchy.StackData(levels=tuple(levels), C=C, lC=lC, uC=uC,
                                   lb=lb, ub=ub, n_eq=n_eq, has_box=has_box)

    def constraint_row_order(self) -> List[str]:
        """Names of ROWS constraints in effective (equality-first) C-row
        order — for consumers that index C rows or persist warm states."""
        ordered = ([c for c in self.constraints if c.is_equality]
                   + [c for c in self.constraints if not c.is_equality])
        return [c.name for c in ordered]

    @staticmethod
    def validate(stack_data: hierarchy.StackData, tol: float = 1e-6) -> None:
        """Host-side debug check of the solver's elimination invariant: the
        leading ``n_eq`` rows of C must be true equalities (u - l < tol).
        A miscounted n_eq (or a gated row drifting into the equality block)
        would silently hard-pin inequality rows to their lower bound with no
        solver-visible signal. Call from tests / once at
        plugin construction — not inside jit."""
        import numpy as np
        n_eq = stack_data.n_eq
        if n_eq == 0:
            return
        gap = np.asarray(stack_data.uC[:n_eq] - stack_data.lC[:n_eq])
        if not np.all(gap < tol):
            raise AssertionError(
                f"stack n_eq={n_eq} but rows {np.nonzero(gap >= tol)[0]} "
                f"have u - l >= {tol}: not structural equalities")

    def log(self, trace, stack_data: hierarchy.StackData,
            x=None, infos=None) -> None:
        """Self-logging hook (autostack->log(logger),
        /root/reference/src/QPPVMPlugin.cpp:227; solver->log, :250): per-level
        task matrices' norms, residuals of the solution, and solver status
        into a TraceBuffer."""
        import numpy as np
        for i, lv in enumerate(stack_data.levels):
            trace.add(f"stack/level{i}_b", np.asarray(lv.b))
            if x is not None:
                trace.add(f"stack/level{i}_residual",
                          np.asarray(lv.A @ x - lv.b))
        if x is not None:
            trace.add("stack/x", np.asarray(x))
        if infos is not None:
            for i, info in enumerate(infos):
                trace.add(f"solver/level{i}_prim_res",
                          float(info.prim_res))
                trace.add(f"solver/level{i}_dual_res",
                          float(info.dual_res))
                trace.add(f"solver/level{i}_obj", float(info.obj))
