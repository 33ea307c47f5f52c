"""Core numeric ops: norms, splines, rollouts, linear algebra.

Counterpart of mujoco_mpc_tpu/ops/__init__.py. ops.rollout and
ops.megarollout are imported by their users (they depend on physics,
which depends on ops.linalg).
"""

from mujoco_mpc_torch.ops import linalg, norms, spline

__all__ = ["linalg", "norms", "spline"]
