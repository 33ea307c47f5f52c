"""Fixed-size time splines for control policies.

Counterpart of mujoco_mpc_tpu/ops/spline.py (reference TimeSpline,
mjpc/spline/spline.cc:103-160). A policy is (times (k,), values
(..., k, dim)); leading dimensions of `values` are a batch of policies on
one time grid (the JAX package vmaps over them).

Interpolation: clamp outside the node range; ZERO holds the lower node;
LINEAR lerps; CUBIC is a Hermite spline with finite-difference slopes
(one-sided at the ends).
"""

from __future__ import annotations

import enum

import torch


class Interp(enum.IntEnum):
  ZERO = 0
  LINEAR = 1
  CUBIC = 2


def sample_many(times: torch.Tensor, values: torch.Tensor, ts: torch.Tensor,
                interp: Interp) -> torch.Tensor:
  """Sample at a vector of times ts (m,) -> (..., m, dim)."""
  k = times.shape[0]
  ts = torch.as_tensor(ts, dtype=times.dtype, device=times.device)
  if k == 1:
    return values[..., :1, :].expand(
        *values.shape[:-2], ts.shape[0], values.shape[-1])
  # lower index of the bracketing interval, clamped to [0, k-2]
  upper = torch.searchsorted(times.contiguous(), ts.contiguous(), right=True)
  lo = torch.clamp(upper - 1, 0, k - 2)
  t0, t1 = times[lo], times[lo + 1]
  p0, p1 = values[..., lo, :], values[..., lo + 1, :]
  below = (ts <= times[0])[:, None]
  above = (ts >= times[k - 1])[:, None]

  if interp == Interp.ZERO:
    out = p0
  elif interp == Interp.LINEAR:
    s = torch.clamp((ts - t0) / torch.clamp(t1 - t0, min=1e-10), 0.0, 1.0)
    s = s[:, None]
    out = p0 * (1 - s) + p1 * s
  else:  # CUBIC Hermite, finite-difference slopes
    def slope(i):
      im1 = torch.clamp(i - 1, 0, k - 1)
      ip1 = torch.clamp(i + 1, 0, k - 1)
      left = (values[..., i, :] - values[..., im1, :]) / torch.clamp(
          times[i] - times[im1], min=1e-10)[:, None]
      right = (values[..., ip1, :] - values[..., i, :]) / torch.clamp(
          times[ip1] - times[i], min=1e-10)[:, None]
      # interior: average of one-sided slopes; ends: the one-sided slope
      w_l = torch.where(i > 0, 0.5, 0.0).to(times.dtype)[:, None]
      w_r = torch.where(i < k - 1, 0.5, 0.0).to(times.dtype)[:, None]
      tot = torch.clamp(w_l + w_r, min=0.5)
      return (w_l * left + w_r * right) / tot

    m0, m1 = slope(lo), slope(lo + 1)
    h = t1 - t0
    s = torch.clamp((ts - t0) / torch.clamp(h, min=1e-10), 0.0, 1.0)
    s, h = s[:, None], h[:, None]
    s2, s3 = s * s, s * s * s
    out = ((2 * s3 - 3 * s2 + 1) * p0 + (s3 - 2 * s2 + s) * h * m0 +
           (-2 * s3 + 3 * s2) * p1 + (s3 - s2) * h * m1)

  out = torch.where(below, values[..., :1, :], out)
  return torch.where(above, values[..., k - 1:, :], out)


def sample(times: torch.Tensor, values: torch.Tensor, t,
           interp: Interp) -> torch.Tensor:
  """Sample the spline at scalar time t -> (..., dim)."""
  t = torch.as_tensor(t, dtype=times.dtype, device=times.device)
  return sample_many(times, values, t.reshape(1), interp)[..., 0, :]


def resample(times: torch.Tensor, values: torch.Tensor,
             new_times: torch.Tensor, interp: Interp) -> torch.Tensor:
  """Re-express the spline on a new time grid (UpdateNominalPolicy,
  reference mjpc/planners/sampling/planner.cc:240-323)."""
  return sample_many(times, values, new_times, interp)
