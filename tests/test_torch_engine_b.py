"""The port's general forward pass held against the JAX package and
against MuJoCo C, in float64 on the CPU: the Humanoid and the swimmer
(fluid forces, a filter and an integrator activation). The models, their
checks and tolerances: tests/torch_engine_cases.py."""

import pytest

from tests import torch_engine_cases as cases
from tests.torch_engine_cases import release_jax_executables  # noqa: F401


@pytest.fixture(scope="module",
                params=["humanoid", "swimmer"])
def case(request):
  return cases.engine_case(request.param)


def test_forward_matches_jax(case):
  cases.check_forward(case)


def test_smooth_matches_mujoco(case):
  cases.check_smooth(case)
