"""Convex norms of residual blocks (reference mjpc/norm.cc:61-200).

Counterpart of mujoco_mpc_tpu/ops/norms.py::norm_value. The gradients and
Hessians (`norm_grad_hess`) come with the derivative planners.
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
