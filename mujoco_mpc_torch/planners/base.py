"""What a planning iteration reports (reference Planner::Plots).

Counterpart of mujoco_mpc_tpu/planners/base.py. The Planner protocol comes
with the second planner (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PlanInfo(NamedTuple):
  """Diagnostics from one planning iteration (reference Planner::Plots)."""
  costs: torch.Tensor  # per-candidate total returns
  winner: torch.Tensor  # index of the selected candidate
  best_return: torch.Tensor  # scalar winning return

