"""The per-task tests of tests/test_torch_small_tasks.py (the task against
JAX's, residual, one step, the Agent's returns) over Arm Reach, Fingers
and Push; the tests, the fixtures and their tolerances are that file's."""

from tests.test_torch_small_tasks import (  # noqa: F401 (collected)
    HALF_A, case_fixture, jax_run, test_small_task_agent_plans_on_cpu,
    test_small_task_matches_jax_task, test_small_task_residual_matches_jax,
    test_small_task_step_matches_jax)
from tests.torch_cases import SMALL_TASKS
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

case = case_fixture(tuple(n for n in SMALL_TASKS if n not in HALF_A))
