"""The rigid-body physics engine (the reference's MuJoCo role).

Counterpart of mujoco_mpc_tpu/physics/__init__.py, less the `step`
function: here `physics.step` stays the module physics/step.py, which the
port's modules import as `from mujoco_mpc_torch.physics import step`; the
function is `physics.step.step`.
"""

from mujoco_mpc_torch.physics.io import from_mjmodel, load_model, make_data
from mujoco_mpc_torch.physics.step import forward, integrate_pos, inverse
from mujoco_mpc_torch.physics.types import (Contact, Data, GeomType,
                                            JointType, Model, Option,
                                            SensorType)

__all__ = [
    "Contact", "Data", "GeomType", "JointType", "Model", "Option",
    "SensorType", "forward", "from_mjmodel", "integrate_pos", "inverse",
    "load_model", "make_data",
]
