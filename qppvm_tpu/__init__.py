"""qppvm_tpu — a JAX whole-body-control (WBC) + MPC framework.

A from-scratch JAX/XLA/Pallas re-design of the capability surface of
ADVRHumanoids/qppvm (OpenSoT-style hierarchical QP whole-body control inside a
1 kHz real-time loop), built accelerator-first:

- ``qppvm_tpu.model``    — rigid-body dynamics (FK, Jacobians, RNEA; mass
  matrix via batched J^T I J sums; forward dynamics via matmul-only B^-1)
  as pure, vmappable functions over static-topology robot models.
- ``qppvm_tpu.opt``      — batched dense QP solvers (ADMM / PDIP) with fixed
  iteration counts (jit-friendly), warm start, and a hierarchical cascade that
  reproduces the semantics of OpenSoT's ``QPOases_sot``.
- ``qppvm_tpu.tasks``    — torque/acceleration/force tasks and constraints
  (Cartesian & joint impedance, torque limits, dynamic feasibility, wrench
  bounds, friction cones) as small pure functions emitting (A, b, C, lb, ub).
- ``qppvm_tpu.stack``    — the ``+`` / ``/`` / ``<<`` AutoStack DSL compiling a
  static stack spec into ONE jitted control-step function.
- ``qppvm_tpu.runtime``  — plugin lifecycle + control-loop harness, simulated
  robot backend, RT-safe trace logging (MatLogger analog).
- ``qppvm_tpu.mpc``      — sampling MPC over vmapped rollouts, sharded over a
  ``jax.sharding.Mesh``.
- ``qppvm_tpu.parallel`` — mesh/sharding helpers and collectives.

Reference parity citations use ``/root/reference`` paths (file:line).
"""

__version__ = "0.1.0"

from qppvm_tpu.model.robot import RobotModel, RobotState  # noqa: F401
