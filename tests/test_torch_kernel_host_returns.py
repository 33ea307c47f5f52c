"""The host build of the CUDA kernel's returns against the plain version:
every case of tests/test_torch_kernel_host.py, float32 over 4 steps at
rtol 2e-3 here, and float64 over 30 at 1e-9 in
test_torch_kernel_host_returns64.py (measured: rel 7.6e-16 for the
Walker, 1.4e-15 for the Humanoid), so that the test workers share them
out. The build and the cases are that file's."""

import pytest
import torch

from tests.test_torch_kernel_host import _CASES, check_returns
from tests.test_torch_kernel_host import lib  # noqa: F401 (fixture)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_host_kernel_returns_match_plain(lib, name):  # noqa: F811
  check_returns(lib, name, torch.float32, 4, 2e-3)
