"""Dense Cholesky for the joint-space inertia.

Counterpart of mujoco_mpc_tpu/ops/linalg.py. The JAX package unrolls the
factor over columns because XLA's batched LAPACK calls lower poorly on a
TPU; on the card, one batched factor and two batched triangular solves
are a handful of launches against hundreds for the unrolled loop, so the
port calls torch.linalg. `chol_factor` checks nothing on the host
(cholesky_ex, no error check: a host sync), and the inertia it factors,
M + h diag(damping) with armature, is positive definite, where the JAX
version's pivot floor (eps) never binds.
"""

from __future__ import annotations

import torch


def chol_factor(a: torch.Tensor) -> torch.Tensor:
  """Lower-triangular Cholesky factor of an SPD matrix (..., n, n)."""
  return torch.linalg.cholesky_ex(a, check_errors=False).L


def chol_solve(low: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solve A x = b given L = chol_factor(A); b is (..., n) or (..., n, k)."""
  vec = b.dim() == low.dim() - 1
  if vec:
    b = b[..., None]
  y = torch.linalg.solve_triangular(low, b, upper=False)
  x = torch.linalg.solve_triangular(low.transpose(-1, -2), y, upper=True)
  return x[..., 0] if vec else x


def solve_sym(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """SPD solve through the Cholesky factor."""
  return chol_solve(chol_factor(a), b)
