"""Planners: the 7 algorithms of the reference registry
(mjpc/planners/include.cc:30-53).

Counterpart of mujoco_mpc_tpu/planners/__init__.py.
"""

from mujoco_mpc_torch.planners.base import Planner, PlanInfo
from mujoco_mpc_torch.planners.cross_entropy import (CEMConfig, CEMPolicy,
                                                     CrossEntropyPlanner)
from mujoco_mpc_torch.planners.gradient import (GradientConfig,
                                                GradientPlanner,
                                                GradientPolicy)
from mujoco_mpc_torch.planners.ilqg import (ILQGConfig, ILQGPlanner,
                                            ILQGPolicy)
from mujoco_mpc_torch.planners.ilqs import (ILQSConfig, ILQSPlanner,
                                            ILQSPolicy)
from mujoco_mpc_torch.planners.robust import RobustConfig, RobustPlanner
from mujoco_mpc_torch.planners.sample_gradient import (SampleGradientPlanner,
                                                       SGConfig, SGPolicy)
from mujoco_mpc_torch.planners.sampling import (SamplingConfig,
                                                SamplingPlanner,
                                                SamplingPolicy)

__all__ = [
    "CEMConfig", "CEMPolicy", "CrossEntropyPlanner", "GradientConfig",
    "GradientPlanner", "GradientPolicy", "ILQGConfig", "ILQGPlanner",
    "ILQGPolicy", "ILQSConfig", "ILQSPlanner", "ILQSPolicy", "PlanInfo",
    "Planner", "RobustConfig", "RobustPlanner", "SGConfig", "SGPolicy",
    "SampleGradientPlanner", "SamplingConfig", "SamplingPlanner",
    "SamplingPolicy",
]
