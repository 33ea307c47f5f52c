"""Task system: registry and base classes.

Counterpart of mujoco_mpc_tpu/tasks/__init__.py.
"""

from mujoco_mpc_torch.tasks.base import (CostSpec, Task, TaskParams,
                                         cost_terms, cost_value)
from mujoco_mpc_torch.tasks.registry import get_task, register, task_names

__all__ = ["CostSpec", "Task", "TaskParams", "cost_terms", "cost_value",
           "get_task", "register", "task_names"]
