"""Dense Cholesky with the JAX package's pivot floor.

Counterpart of mujoco_mpc_tpu/ops/linalg.py. `chol_factor` is JAX's
factor: a column loop that floors each pivot at `eps`, so a singular or
indefinite matrix gives a finite factor (a pivot of sqrt(eps)) where an
unfloored factor gives NaN. Each column is one batched product with the
columns already factored, so a factor is a few launches a column and
reads nothing back to the host. The general step (physics/step.py)
factors the inertia with torch.linalg.cholesky_ex instead, one launch:
there the floor does not bind (tests/test_torch_linalg.py::
test_inertia_pivots_stay_above_the_floor holds the smallest pivot of
every registered model's inertia at least 1e6 times eps).
"""

from __future__ import annotations

import torch


def chol_factor(a: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
  """Lower-triangular Cholesky of an SPD matrix (..., n, n), each pivot
  floored at eps."""
  n = a.shape[-1]
  eye = torch.eye(n, dtype=a.dtype, device=a.device)
  diag = eye.bool()
  below = torch.ones_like(diag).tril(-1)
  low = torch.zeros_like(a)
  for j in range(n):
    # column j of A less the factored columns' part (low's columns j and
    # beyond are still zero)
    r = a[..., :, j] - (low @ low[..., j, :, None])[..., 0]
    ljj = torch.sqrt(torch.clamp(r[..., j], min=eps))[..., None]
    col = torch.where(diag[j], ljj,
                      torch.where(below[:, j], r / ljj, 0.0))
    # out of place, so that autograd in either mode sees each column
    low = low + col[..., :, None] * eye[j]
  return low


def chol_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:  # noqa: E741
  """Solve A x = b given L = chol_factor(A); b is (..., n) or (..., n, k)."""
  vec = b.dim() == l.dim() - 1
  if vec:
    b = b[..., None]
  y = torch.linalg.solve_triangular(l, b, upper=False)
  x = torch.linalg.solve_triangular(l.transpose(-1, -2), y, upper=True)
  return x[..., 0] if vec else x


def solve_sym(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """SPD solve through the floored Cholesky factor."""
  return chol_solve(chol_factor(a), b)
