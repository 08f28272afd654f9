"""Static-topology robot model and state pytrees.

Design notes
------------
The reference delegates all kinematics/dynamics to ``XBot::ModelInterface``
(RBDL/KDL-backed C++, see /root/reference/src/QPPVMPlugin.cpp:50,65 and
/root/reference/src/ForceAcc.cpp:43,208,217). Here the model is a *pytree of
arrays plus static metadata*: topology (parent indices, joint types, ancestor
masks) is static aux data so jitted functions unroll fixed-shape computation;
numeric parameters (joint frames, inertias, limits) are array leaves so one
compiled program serves any robot of the same topology (domain randomization
over inertial params under ``vmap`` comes for free).

Conventions
-----------
- Link ``i`` connects to ``parent[i]`` (``-1`` = root link) through joint ``i``.
- Internal spatial algebra is Featherstone angular-first; the *public* API
  (Jacobians, twists, wrenches) is linear-first ``[v; w]`` / ``[f; n]`` in the
  world frame, matching the reference's KDL/OpenSoT ordering.
- Floating base: the root link is a free body. The generalized velocity is
  ``u = [base_twist_body(6, angular-first); qd(nj)]`` with nv = 6 + nj.
  For a fixed base nv = nj.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from qppvm_tpu.model import spatial

REVOLUTE = 0
PRISMATIC = 1


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Robot description. Array fields are pytree leaves; metadata is static."""

    # --- array leaves ---------------------------------------------------
    axis: jax.Array  # (nj, 3) joint axis in joint frame
    E_tree: jax.Array  # (nj, 3, 3) child-from-parent coordinate rotation at q=0
    p_tree: jax.Array  # (nj, 3) joint-frame origin in parent link coords
    inertia: jax.Array  # (nj, 6, 6) spatial inertia of link i in link-i coords
    base_inertia: jax.Array  # (6, 6) spatial inertia of the root link
    q_home: jax.Array  # (nj,) named "home" configuration
    q_min: jax.Array  # (nj,)
    q_max: jax.Array  # (nj,)
    tau_max: jax.Array  # (nj,) effort limits (XBot getEffortLimits)
    v_max: jax.Array  # (nj,) velocity limits
    armature: jax.Array  # (nj,) reflected rotor inertia added on B's diagonal
    gravity: jax.Array  # (3,) world-frame gravity acceleration

    # --- static metadata ------------------------------------------------
    parent: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    joint_type: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    joint_names: Tuple[str, ...] = dataclasses.field(metadata=dict(static=True))
    link_names: Tuple[str, ...] = dataclasses.field(metadata=dict(static=True))
    root_name: str = dataclasses.field(metadata=dict(static=True))
    floating: bool = dataclasses.field(metadata=dict(static=True))
    # Extra named frames rigidly attached to links (URDF fixed-joint children
    # after lumping): name -> (parent link idx [-1 = root], E row-major 9-tuple,
    # p 3-tuple). Static metadata (hashable, trace-time constant).
    frames: Tuple[Tuple[str, int, Tuple[float, ...], Tuple[float, ...]], ...] = \
        dataclasses.field(default=(), metadata=dict(static=True))

    # ---------------------------------------------------------------------
    @property
    def nj(self) -> int:
        return len(self.parent)

    @property
    def nv(self) -> int:
        return self.nj + 6 if self.floating else self.nj

    def dof_index(self, joint_name: str) -> int:
        """Index of a joint in q (XBot getDofIndex,
        /root/reference/src/QPPVMPlugin.cpp:84-96)."""
        return self.joint_names.index(joint_name)

    def link_index(self, link_name: str) -> int:
        if link_name == self.root_name:
            return -1
        try:
            return self.link_names.index(link_name)
        except ValueError:
            raise KeyError(
                f"unknown link {link_name!r}; known links: "
                f"{(self.root_name,) + self.link_names}, frames: "
                f"{tuple(f[0] for f in self.frames)}") from None

    def frame_spec(self, name: str):
        """(parent_link_idx, E_off, p_off) for an extra frame, else None."""
        for fname, li, E, p in self.frames:
            if fname == name:
                import numpy as _np
                return li, _np.asarray(E, float).reshape(3, 3), _np.asarray(p, float)
        return None

    def is_frame(self, name: str) -> bool:
        return any(f[0] == name for f in self.frames)

    def ancestor_mask(self) -> np.ndarray:
        """(nj, nj) bool; m[l, j] = joint j is on the path root->link l.

        Static (depends only on topology); used to turn per-link Jacobians into
        one batched masked product.
        """
        nj = self.nj
        m = np.zeros((nj, nj), dtype=bool)
        for l in range(nj):
            j = l
            while j >= 0:
                m[l, j] = True
                j = self.parent[j]
        return m

    def home_state(self) -> "RobotState":
        return RobotState.init(self, self.q_home)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RobotState:
    """Generalized position/velocity state (pure data, batchable).

    ``base_rot``/``base_pos`` give the world pose of the root link;
    ``base_vel`` is the root spatial twist in *body* coords, angular-first.
    For fixed-base robots these stay at identity/zero.
    """

    q: jax.Array  # (nj,)
    qd: jax.Array  # (nj,)
    base_rot: jax.Array  # (3, 3) world-from-base rotation (maps base->world)
    base_pos: jax.Array  # (3,)
    base_vel: jax.Array  # (6,) [w; v] in base coords

    @staticmethod
    def init(model: RobotModel, q=None, qd=None, base_rot=None, base_pos=None,
             base_vel=None, dtype=jnp.float32) -> "RobotState":
        nj = model.nj
        return RobotState(
            q=jnp.zeros(nj, dtype) if q is None else jnp.asarray(q, dtype),
            qd=jnp.zeros(nj, dtype) if qd is None else jnp.asarray(qd, dtype),
            base_rot=jnp.eye(3, dtype=dtype) if base_rot is None else jnp.asarray(base_rot, dtype),
            base_pos=jnp.zeros(3, dtype) if base_pos is None else jnp.asarray(base_pos, dtype),
            base_vel=jnp.zeros(6, dtype) if base_vel is None else jnp.asarray(base_vel, dtype),
        )

    @property
    def u(self) -> jax.Array:
        """Generalized velocity [base_twist(6); qd] (floating) — caller must
        know model.floating; provided for floating models."""
        return jnp.concatenate([self.base_vel, self.qd])

    def astype(self, dtype) -> "RobotState":
        return jax.tree.map(lambda a: jnp.asarray(a, dtype), self)


def build_model(
    *,
    parent,
    joint_type,
    axis,
    E_tree,
    p_tree,
    mass,
    com,
    inertia_com,
    joint_names,
    link_names,
    root_name="base_link",
    floating=False,
    base_mass=0.0,
    base_com=None,
    base_inertia_com=None,
    q_home=None,
    q_min=None,
    q_max=None,
    tau_max=None,
    v_max=None,
    armature=None,
    gravity=(0.0, 0.0, -9.81),
    dtype=jnp.float32,
) -> RobotModel:
    """Assemble a RobotModel from per-link primitive data."""
    nj = len(parent)
    axis = jnp.asarray(axis, dtype).reshape(nj, 3)
    E_tree = jnp.asarray(E_tree, dtype).reshape(nj, 3, 3)
    p_tree = jnp.asarray(p_tree, dtype).reshape(nj, 3)
    I_links = jnp.stack(
        [
            spatial.mcI(
                jnp.asarray(mass[i], dtype),
                jnp.asarray(com[i], dtype),
                jnp.asarray(inertia_com[i], dtype),
            )
            for i in range(nj)
        ]
    )
    if base_com is None:
        base_com = jnp.zeros(3, dtype)
    if base_inertia_com is None:
        base_inertia_com = jnp.eye(3, dtype=dtype) * 1e-6
    base_I = spatial.mcI(
        jnp.asarray(base_mass, dtype), jnp.asarray(base_com, dtype),
        jnp.asarray(base_inertia_com, dtype)
    )

    def vec(x, default):
        if x is None:
            return jnp.full((nj,), default, dtype)
        return jnp.asarray(x, dtype).reshape(nj)

    return RobotModel(
        axis=axis,
        E_tree=E_tree,
        p_tree=p_tree,
        inertia=I_links,
        base_inertia=base_I,
        q_home=vec(q_home, 0.0),
        q_min=vec(q_min, -3.1),
        q_max=vec(q_max, 3.1),
        tau_max=vec(tau_max, 200.0),
        v_max=vec(v_max, 10.0),
        armature=vec(armature, 0.0),
        gravity=jnp.asarray(gravity, dtype),
        parent=tuple(int(p) for p in parent),
        joint_type=tuple(int(t) for t in joint_type),
        joint_names=tuple(joint_names),
        link_names=tuple(link_names),
        root_name=root_name,
        floating=bool(floating),
    )
