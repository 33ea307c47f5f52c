"""Blocked band Cholesky for block-pentadiagonal SPD systems.

Counterpart of mujoco_mpc_tpu/ops/band.py. The direct optimizer's
Gauss-Newton Hessian over configurations q_{0:T} couples each timestep to
its two neighbours on each side (3-configuration residual stencils that
overlap by two): a symmetric block-pentadiagonal matrix, which the
reference factors with a scalar band Cholesky (mju_cholFactorBand,
mjpc/direct/direct.cc:2342-2372). Here, as in the JAX package, the factor
is blocked: a recursion over the T block rows whose steps are n x n
Cholesky factors, triangular solves and products, in O(T n^2) memory
instead of the dense (T n)^2. JAX scans; here the recursions are Python
loops over T <= 64 rows of a few torch.linalg calls each.

Band layout (block bandwidth 2):
  diag[t]  = A[t, t]     (n, n), SPD after regularization
  off1[t]  = A[t, t-1]   (n, n), off1[0] ignored
  off2[t]  = A[t, t-2]   (n, n), off2[0:2] ignored

Factor L (the same layout, diag lower-triangular):
  L2[t] Ld[t-2]^T = A2[t]
  L1[t] Ld[t-1]^T = A1[t] - L2[t] L1[t-1]^T
  Ld[t] Ld[t]^T   = A0[t] - L1[t] L1[t]^T - L2[t] L2[t]^T

Nothing here reads a value back to the host: a block that is not positive
definite gives a NaN factor, as jnp.linalg.cholesky does, instead of
cholesky's error (a host sync).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BandFactor(NamedTuple):
  diag: torch.Tensor  # (T, n, n) lower-triangular Cholesky blocks
  off1: torch.Tensor  # (T, n, n)
  off2: torch.Tensor  # (T, n, n)


def cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
  """Lower Cholesky factor of a (..., n, n), NaN where a is not positive
  definite (jnp.linalg.cholesky's answer), without a host sync."""
  low, info = torch.linalg.cholesky_ex(a, check_errors=False)
  return torch.where((info == 0)[..., None, None], low,
                     torch.full_like(low, float("nan")))


def _right_solve(low: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
  """a low^-T: X low^T = a (JAX's solve_triangular(low, a.T, lower=True).T)."""
  return torch.linalg.solve_triangular(low, a.transpose(-1, -2),
                                       upper=False).transpose(-1, -2)


def factor(diag: torch.Tensor, off1: torch.Tensor,
           off2: torch.Tensor) -> BandFactor:
  """Blocked Cholesky of a symmetric block-pentadiagonal matrix."""
  T, n = diag.shape[0], diag.shape[-1]
  eye = torch.eye(n, dtype=diag.dtype, device=diag.device)
  # rows 0 and 1 have no left neighbours: zeroed off-blocks against
  # identity "previous" diagonals solve to zeros
  off1 = off1.clone()
  off1[0] = 0.0
  off2 = off2.clone()
  off2[:2] = 0.0
  ld1, ld2 = eye, eye  # Ld[t-1], Ld[t-2]
  l1_prev = torch.zeros((n, n), dtype=diag.dtype, device=diag.device)
  lds, l1s, l2s = [], [], []
  for t in range(T):
    l2 = _right_solve(ld2, off2[t])
    l1 = _right_solve(ld1, off1[t] - l2 @ l1_prev.T)
    s = diag[t] - l1 @ l1.T - l2 @ l2.T
    ld = cholesky_or_nan(0.5 * (s + s.T))
    lds.append(ld)
    l1s.append(l1)
    l2s.append(l2)
    ld1, ld2, l1_prev = ld, ld1, l1
  return BandFactor(torch.stack(lds), torch.stack(l1s), torch.stack(l2s))


def solve(f: BandFactor, b: torch.Tensor) -> torch.Tensor:
  """Solve A x = b given the band factor; b is (T, n) or (T, n, k)."""
  squeeze = b.dim() == 2
  if squeeze:
    b = b[..., None]
  T, n, k = b.shape
  zero = torch.zeros((n, k), dtype=b.dtype, device=b.device)
  # forward: L y = b
  y1, y2, ys = zero, zero, []
  for t in range(T):
    y = torch.linalg.solve_triangular(
        f.diag[t], b[t] - f.off1[t] @ y1 - f.off2[t] @ y2, upper=False)
    ys.append(y)
    y1, y2 = y, y1
  # backward: L^T x = y, with the shifted L1[t+1] and L2[t+2]
  x1, x2, xs = zero, zero, [None] * T
  for t in reversed(range(T)):
    rhs = ys[t]
    if t + 1 < T:
      rhs = rhs - f.off1[t + 1].T @ x1
    if t + 2 < T:
      rhs = rhs - f.off2[t + 2].T @ x2
    x = torch.linalg.solve_triangular(f.diag[t].T, rhs, upper=True)
    xs[t] = x
    x1, x2 = x, x1
  out = torch.stack(xs)
  return out[..., 0] if squeeze else out


def _scatter_rows(T: int, parts) -> torch.Tensor:
  """(T, ...) zeros plus each (offset j, block (T-2, ...)) added at rows
  t + j, in the order given (index_add_ into a fresh tensor)."""
  blk0 = parts[0][1]
  out = blk0.new_zeros((T,) + tuple(blk0.shape[1:]))
  ts = torch.arange(blk0.shape[0], device=blk0.device)
  for j, blk in parts:
    out.index_add_(0, ts + j, blk)
  return out


def assemble_from_stencils(jtj: torch.Tensor, T: int):
  """Band blocks from per-stencil 3 x 3 block outer products.

  jtj: (T-2, 3n, 3n), where stencil t couples configurations (t, t+1,
  t+2). Returns (diag, off1, off2), each (T, n, n)."""
  n = jtj.shape[-1] // 3
  blk = jtj.reshape(-1, 3, n, 3, n).permute(1, 3, 0, 2, 4)  # (3,3,T-2,n,n)
  diag = _scatter_rows(T, [(0, blk[0, 0]), (1, blk[1, 1]), (2, blk[2, 2])])
  off1 = _scatter_rows(T, [(1, blk[1, 0]), (2, blk[2, 1])])
  off2 = _scatter_rows(T, [(2, blk[2, 0])])
  return diag, off1, off2


def scatter_grad(jtr: torch.Tensor, T: int) -> torch.Tensor:
  """Gradient (T, n) from per-stencil (T-2, 3n) contributions; with a
  trailing dimension, (T-2, 3n, k) -> (T, n, k)."""
  n = jtr.shape[1] // 3
  blk = jtr.reshape((jtr.shape[0], 3, n) + tuple(jtr.shape[2:]))
  return _scatter_rows(T, [(j, blk[:, j]) for j in range(3)])
