"""Interactive web dashboard (the reference GUI surface, headless-native).

Counterpart of mujoco_mpc_tpu/ui; see ui.server for the map to
mjpc/simulate.{h,cc} + app.cc.
"""

from mujoco_mpc_torch.ui.server import AgentUI, make_server  # noqa: F401
