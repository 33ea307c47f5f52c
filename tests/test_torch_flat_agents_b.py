"""The Agent on the four flat-ground tasks of the general route on the
CPU, as tests/test_torch_flat_agents.py checks the kernel tasks (its
check): the plan goes through the general batched rollout, with the
warning that names the reason."""

import pytest

from tests import torch_flat_cases as fc
from tests.test_torch_flat_agents import check_agent
from tests.torch_engine_cases import release_jax_executables  # noqa: F401


@pytest.mark.parametrize("name", fc.GENERAL_TASKS)
def test_general_task_agent_plans_on_cpu(name):
  check_agent(name)
