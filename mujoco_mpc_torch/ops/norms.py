"""Convex norms of residual blocks (reference mjpc/norm.cc:61-200).

Counterpart of mujoco_mpc_tpu/ops/norms.py: `norm_value` maps a residual
block to a scalar; `norm_grad_hess` gives the closed-form gradient and
Gauss-Newton Hessian the derivative planners' cost expansion uses.
"""

from __future__ import annotations

import enum

import torch


class NormType(enum.IntEnum):
  """Values match the reference XML convention (sensor user[0]),
  including the gap at 4 (mjpc/norm.h:24-36)."""
  NULL = -1
  QUADRATIC = 0
  L22 = 1
  L2 = 2
  COSH = 3
  POWER_LOSS = 5
  SMOOTH_ABS = 6
  SMOOTH_ABS2 = 7
  RECTIFY = 8


def num_norm_params(norm: NormType) -> int:
  """Parameter count per norm (reference NormParameterDimension)."""
  return {
      NormType.NULL: 0, NormType.QUADRATIC: 0, NormType.L22: 2,
      NormType.L2: 1, NormType.COSH: 1, NormType.POWER_LOSS: 1,
      NormType.SMOOTH_ABS: 1, NormType.SMOOTH_ABS2: 2, NormType.RECTIFY: 1,
  }[NormType(norm)]


def norm_value(x: torch.Tensor, norm: NormType, p=0.0, q=0.0,
               dim: int = -1) -> torch.Tensor:
  """Norm of residual block x, reduced over `dim` (the last axis by
  default; the tile layout reduces the leading axis)."""
  norm = NormType(norm)
  if norm == NormType.NULL:
    return x.select(dim, 0)
  if norm == NormType.QUADRATIC:
    return 0.5 * torch.sum(x * x, dim=dim)
  if norm == NormType.L22:
    c = torch.sum(x * x, dim=dim)
    return torch.pow(torch.pow(c, q / 2) + p ** q, 1.0 / q) - p
  if norm == NormType.L2:
    return torch.sqrt(torch.sum(x * x, dim=dim) + p * p) - p
  if norm == NormType.COSH:
    return torch.sum(p * p * (torch.cosh(x / p) - 1.0), dim=dim)
  if norm == NormType.POWER_LOSS:
    return torch.sum(torch.pow(torch.abs(x), p), dim=dim)
  if norm == NormType.SMOOTH_ABS:
    return torch.sum(torch.sqrt(x * x + p * p) - p, dim=dim)
  if norm == NormType.SMOOTH_ABS2:
    return torch.sum(
        torch.pow(torch.pow(torch.abs(x), q) + p ** q, 1.0 / q) - p, dim=dim)
  if norm == NormType.RECTIFY:
    # softplus when p > 0, relu otherwise (p is runtime-tunable)
    p_t = torch.as_tensor(p, dtype=x.dtype, device=x.device)
    safe_p = torch.clamp(p_t, min=1e-10)
    soft = torch.sum(safe_p * torch.log1p(torch.exp(x / safe_p)), dim=dim)
    hard = torch.sum(torch.clamp(x, min=0.0), dim=dim)
    return torch.where(p_t > 0, soft, hard)
  raise ValueError(f"unknown norm {norm}")


def _outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return a[..., :, None] * b[..., None, :]


def norm_grad_hess(x: torch.Tensor, norm: NormType, p=0.0, q=0.0):
  """(value (...), gradient (..., n), Gauss-Newton Hessian (..., n, n)) of
  a norm of residual blocks x (..., n); p and q may be 0-d tensors."""
  norm = NormType(norm)
  n = x.shape[-1]
  eye = torch.eye(n, dtype=x.dtype, device=x.device)
  if norm == NormType.NULL:
    return (x[..., 0], torch.ones_like(x),
            x.new_zeros(x.shape[:-1] + (n, n)))
  if norm == NormType.QUADRATIC:
    return 0.5 * torch.sum(x * x, dim=-1), x, eye.expand(
        x.shape[:-1] + (n, n))
  if norm == NormType.L22:
    c = torch.clamp(torch.sum(x * x, dim=-1), min=1e-15)[..., None]
    d = torch.pow(c, q / 2 - 1)
    a = torch.pow(c, q / 2) + p ** q
    s = torch.pow(a, 1.0 / q)
    b = s / a * d
    cc = (1 - q) * d / a + (q - 2) / c
    h = b[..., None] * (eye + _outer(x, x) * cc[..., None])
    return s[..., 0] - p, b * x, h
  if norm == NormType.L2:
    s = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + p * p)
    safe = torch.clamp(s, min=1e-15)
    g = x / safe
    return s[..., 0] - p, g, (eye - _outer(g, g)) / safe[..., None]
  if norm == NormType.COSH:
    v = torch.sum(p * p * (torch.cosh(x / p) - 1.0), dim=-1)
    return v, p * torch.sinh(x / p), torch.diag_embed(torch.cosh(x / p))
  if norm == NormType.POWER_LOSS:
    s = torch.abs(x)
    v = torch.sum(torch.pow(s, p), dim=-1)
    g = torch.sign(x) * p * torch.pow(s, p - 1)
    return v, g, torch.diag_embed((p - 1) * p * torch.pow(s, p - 2))
  if norm == NormType.SMOOTH_ABS:
    s = torch.sqrt(x * x + p * p)
    safe = torch.clamp(s, min=1e-15)
    g = x / safe
    return torch.sum(s - p, dim=-1), g, torch.diag_embed((1 - g * g) / safe)
  if norm == NormType.SMOOTH_ABS2:
    a = torch.abs(x)
    dd = torch.pow(a, q)
    e = dd + p ** q
    s = torch.pow(e, 1.0 / q)
    c = s * torch.pow(torch.clamp(a, min=1e-15), q - 2) / e
    return (torch.sum(s - p, dim=-1), c * x,
            torch.diag_embed(c * (q - 1) * (1 - dd / e)))
  if norm == NormType.RECTIFY:
    # branch-free on p (runtime-tunable), with the overflow-stable
    # softplus and sigmoid forms
    p_t = torch.as_tensor(p, dtype=x.dtype, device=x.device)
    safe_p = torch.clamp(p_t, min=1e-10)
    z = x / safe_p
    v_soft = torch.sum(safe_p * (torch.clamp(z, min=0.0) +
                                 torch.log1p(torch.exp(-torch.abs(z)))),
                       dim=-1)
    sig = torch.sigmoid(z)
    h_soft = torch.diag_embed(sig * (1.0 - sig) / safe_p)
    v_hard = torch.sum(torch.clamp(x, min=0.0), dim=-1)
    g_hard = (x > 0).to(x.dtype)
    soft = p_t > 0
    return (torch.where(soft, v_soft, v_hard), torch.where(soft, sig, g_hard),
            torch.where(soft, h_soft, torch.zeros_like(h_soft)))
  raise ValueError(f"unknown norm {norm}")
