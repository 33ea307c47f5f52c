"""State estimators: ground truth, EKF, UKF, the batch smoother and the
direct optimizer.

Counterpart of mujoco_mpc_tpu/estimators/__init__.py; the registry mirrors
the reference's (mjpc/estimators/include.cc:23-41). `Direct` is exported
but not registered: it optimizes a window, it does not filter.
"""

from mujoco_mpc_torch.estimators.batch import Batch, BatchState
from mujoco_mpc_torch.estimators.direct import Direct, DirectConfig
from mujoco_mpc_torch.estimators.ground_truth import GroundTruth
from mujoco_mpc_torch.estimators.kalman import Kalman, KalmanState
from mujoco_mpc_torch.estimators.unscented import Unscented, UnscentedState

ESTIMATORS = {
    "ground_truth": GroundTruth,
    "kalman": Kalman,
    "unscented": Unscented,
    "batch": Batch,
}


def get_estimator(name: str, model, **kwargs):
  if name not in ESTIMATORS:
    raise KeyError(
        f"unknown estimator {name!r}; available: {sorted(ESTIMATORS)}")
  return ESTIMATORS[name](model, **kwargs)


__all__ = [
    "Batch", "BatchState", "Direct", "DirectConfig", "ESTIMATORS",
    "GroundTruth", "Kalman", "KalmanState", "Unscented", "UnscentedState",
    "get_estimator",
]
