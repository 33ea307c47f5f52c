"""The host build of the CUDA kernel's float64 returns against the plain
version in float64: every case of tests/test_torch_kernel_host.py over 30
steps at 1e-9. The build and the cases are that file's; the float32
returns are in test_torch_kernel_host_returns.py."""

import pytest
import torch

from tests.test_torch_kernel_host import _CASES, check_returns
from tests.test_torch_kernel_host import lib  # noqa: F401 (fixture)
from tests.torch_engine_cases import release_jax_executables  # noqa: F401


@pytest.mark.parametrize("name", sorted(_CASES))
def test_host_kernel_float64_returns_match_plain(lib, name):  # noqa: F811
  """30 steps, against the plain version in float64. Measured: rel
  7.6e-16 (Walker) and 1.4e-15 (Humanoid)."""
  check_returns(lib, name, torch.float64, 30, 1e-9)
