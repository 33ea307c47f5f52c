"""Model / Data dataclasses of torch tensors.

Counterpart of mujoco_mpc_tpu/physics/types.py. Structural quantities
(sizes, tree indices, joint types, collision pairs, names) are Python
metadata; numeric parameters are tensors on one device. Conventions match
MuJoCo: quaternions (w, x, y, z); joint types FREE/BALL/SLIDE/HINGE;
spatial 6-vectors [angular; linear] about the world origin.

`Data` holds the simulation state only. The derived fields of the JAX
`Data` (kinematics, inertia, contacts, sensors) are outputs of the general
engine, which this package does not have yet (ROADMAP queue 1 item 3).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional, Tuple

import torch


class JointType(enum.IntEnum):
  FREE = 0
  BALL = 1
  SLIDE = 2
  HINGE = 3


class GeomType(enum.IntEnum):
  PLANE = 0
  HFIELD = 1
  SPHERE = 2
  CAPSULE = 3
  ELLIPSOID = 4
  CYLINDER = 5
  BOX = 6
  MESH = 7


class ActDyn(enum.IntEnum):
  NONE = 0
  INTEGRATOR = 1
  FILTER = 2
  FILTEREXACT = 3


class GainBias(enum.IntEnum):
  FIXED = 0  # gain: gainprm[0]
  AFFINE = 1  # prm[0] + prm[1]*length + prm[2]*velocity
  MUSCLE = 2  # unsupported (gated at load time)


class TrnType(enum.IntEnum):
  JOINT = 0
  SITE = 1
  TENDON = 2


class EqType(enum.IntEnum):
  CONNECT = 0
  WELD = 1
  JOINT = 2


class ObjType(enum.IntEnum):
  BODY = 0
  XBODY = 1
  GEOM = 2
  SITE = 3
  JOINT = 4


class SensorType(enum.IntEnum):
  JOINTPOS = 0
  JOINTVEL = 1
  FRAMEPOS = 2
  FRAMEQUAT = 3
  FRAMEXAXIS = 4
  FRAMEYAXIS = 5
  FRAMEZAXIS = 6
  FRAMELINVEL = 7
  FRAMEANGVEL = 8
  SUBTREECOM = 9
  SUBTREELINVEL = 10
  ACTUATORFRC = 11
  TOUCH = 12
  ACCELEROMETER = 13
  GYRO = 14
  USER = 15
  SUBTREEANGMOM = 16


@dataclasses.dataclass
class Option:
  """Simulation options."""
  timestep: torch.Tensor  # ()
  gravity: torch.Tensor  # (3,)
  impratio: torch.Tensor  # ()
  viscosity: torch.Tensor  # ()
  density: torch.Tensor  # ()
  wind: torch.Tensor  # (3,)
  integrator: int = 0  # 0 = semi-implicit Euler
  has_fluid: bool = False

  def replace(self, **kw) -> "Option":
    return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class Model:
  """Physics model. Field names and meanings follow the JAX Model."""

  # ------- static structure -------------------------------------------------
  nq: int
  nv: int
  nu: int
  na: int
  nbody: int
  njnt: int
  ngeom: int
  nsite: int
  nmocap: int
  nuserdata: int
  nsensordata: int

  body_parentid: Tuple[int, ...]
  body_rootid: Tuple[int, ...]
  body_jntadr: Tuple[int, ...]
  body_jntnum: Tuple[int, ...]
  body_dofadr: Tuple[int, ...]
  body_dofnum: Tuple[int, ...]
  body_mocapid: Tuple[int, ...]
  body_names: Tuple[str, ...]

  jnt_type: Tuple[int, ...]
  jnt_qposadr: Tuple[int, ...]
  jnt_dofadr: Tuple[int, ...]
  jnt_bodyid: Tuple[int, ...]
  jnt_limited: Tuple[bool, ...]
  jnt_names: Tuple[str, ...]

  dof_bodyid: Tuple[int, ...]
  dof_jntid: Tuple[int, ...]

  geom_type: Tuple[int, ...]
  geom_condim: Tuple[int, ...]
  geom_bodyid: Tuple[int, ...]
  geom_names: Tuple[str, ...]
  geom_dataid: Tuple[int, ...]
  hfield_nrow: int
  hfield_ncol: int
  collision_pairs: Tuple[Tuple[int, int], ...]

  site_bodyid: Tuple[int, ...]
  site_names: Tuple[str, ...]

  actuator_trntype: Tuple[int, ...]
  actuator_trnid: Tuple[int, ...]
  actuator_dyntype: Tuple[int, ...]
  actuator_gaintype: Tuple[int, ...]
  actuator_biastype: Tuple[int, ...]
  actuator_actadr: Tuple[int, ...]
  actuator_names: Tuple[str, ...]

  sensor_spec: Tuple[Tuple[int, int, int, int, int], ...]
  sensor_names: Tuple[str, ...]

  has_spring: bool
  has_frictionloss: bool

  custom_numeric: Tuple[Tuple[str, Tuple[float, ...]], ...]
  keyframes: Tuple[Tuple[str, Any], ...]

  # ------- numeric parameters -----------------------------------------------
  opt: Option

  qpos0: torch.Tensor  # (nq,)
  qpos_spring: torch.Tensor  # (nq,)

  body_pos: torch.Tensor  # (nbody, 3)
  body_quat: torch.Tensor  # (nbody, 4)
  body_ipos: torch.Tensor  # (nbody, 3)
  body_iquat: torch.Tensor  # (nbody, 4)
  body_mass: torch.Tensor  # (nbody,)
  body_inertia: torch.Tensor  # (nbody, 3)
  body_subtreemass: torch.Tensor  # (nbody,)

  jnt_pos: torch.Tensor  # (njnt, 3)
  jnt_axis: torch.Tensor  # (njnt, 3)
  jnt_range: torch.Tensor  # (njnt, 2)
  jnt_stiffness: torch.Tensor  # (njnt,)
  jnt_solref: torch.Tensor  # (njnt, 2)
  jnt_margin: torch.Tensor  # (njnt,)

  dof_damping: torch.Tensor  # (nv,)
  dof_armature: torch.Tensor  # (nv,)
  dof_frictionloss: torch.Tensor  # (nv,)
  dof_ancestor_mask: torch.Tensor  # (nv, nv) bool
  dof_body_mask: torch.Tensor  # (nv, nbody) bool
  body_ancestor_mask: torch.Tensor  # (nbody, nbody) bool
  cdofdot_vel_mask: torch.Tensor  # (nv, nv) bool

  hfield_data: torch.Tensor
  hfield_size: torch.Tensor  # (4,)
  geom_pos: torch.Tensor  # (ngeom, 3)
  geom_quat: torch.Tensor  # (ngeom, 4)
  geom_size: torch.Tensor  # (ngeom, 3)
  geom_friction: torch.Tensor  # (ngeom, 3)
  geom_solref: torch.Tensor  # (ngeom, 2)
  geom_solimp: torch.Tensor  # (ngeom, 5)
  geom_margin: torch.Tensor  # (ngeom,)

  site_pos: torch.Tensor  # (nsite, 3)
  site_quat: torch.Tensor  # (nsite, 4)

  actuator_gear: torch.Tensor  # (nu, 6)
  actuator_ctrlrange: torch.Tensor  # (nu, 2)
  actuator_forcerange: torch.Tensor  # (nu, 2)
  actuator_ctrllimited: torch.Tensor  # (nu,) bool
  actuator_forcelimited: torch.Tensor  # (nu,) bool
  actuator_gainprm: torch.Tensor  # (nu, 3)
  actuator_biasprm: torch.Tensor  # (nu, 3)
  actuator_dynprm: torch.Tensor  # (nu, 3)
  actuator_actrange: torch.Tensor  # (nu, 2)

  # ------- fixed tendons ----------------------------------------------------
  ntendon: int = 0
  tendon_joints: Tuple[Tuple[Tuple[int, float], ...], ...] = ()
  tendon_limited: Tuple[bool, ...] = ()
  tendon_names: Tuple[str, ...] = ()
  tendon_range: Optional[torch.Tensor] = None
  tendon_stiffness: Optional[torch.Tensor] = None
  tendon_damping: Optional[torch.Tensor] = None
  tendon_lengthspring: Optional[torch.Tensor] = None
  tendon_solref_lim: Optional[torch.Tensor] = None
  tendon_solimp_lim: Optional[torch.Tensor] = None
  tendon_margin: Optional[torch.Tensor] = None

  # ------- convex mesh collision geometry -----------------------------------
  nmesh: int = 0
  mesh_names: Tuple[str, ...] = ()
  mesh_hullvert: Optional[torch.Tensor] = None  # (nmesh, VCAP, 3)
  mesh_facenorm: Optional[torch.Tensor] = None  # (nmesh, NCAP, 3)

  # ------- equality constraints ---------------------------------------------
  neq: int = 0
  eq_type: Tuple[int, ...] = ()
  eq_obj1id: Tuple[int, ...] = ()
  eq_obj2id: Tuple[int, ...] = ()
  eq_active0: Tuple[bool, ...] = ()
  eq_data: Optional[torch.Tensor] = None  # (neq, 11)
  eq_solref: Optional[torch.Tensor] = None  # (neq, 2)
  eq_solimp: Optional[torch.Tensor] = None  # (neq, 5)
  eq_diagapprox: Tuple[float, ...] = ()

  def replace(self, **kw) -> "Model":
    return dataclasses.replace(self, **kw)

  # --------------------------- name lookups --------------------------------
  def _name_id(self, names: Tuple[str, ...], name: str, kind: str) -> int:
    try:
      return names.index(name)
    except ValueError:
      raise KeyError(f"no {kind} named {name!r}; have {names}") from None

  def body(self, name: str) -> int:
    return self._name_id(self.body_names, name, "body")

  def joint(self, name: str) -> int:
    return self._name_id(self.jnt_names, name, "joint")

  def geom(self, name: str) -> int:
    return self._name_id(self.geom_names, name, "geom")

  def site(self, name: str) -> int:
    return self._name_id(self.site_names, name, "site")

  def tendon(self, name: str) -> int:
    return self._name_id(self.tendon_names, name, "tendon")

  def sensor(self, name: str) -> int:
    return self._name_id(self.sensor_names, name, "sensor")

  def custom(self, name: str, default=None):
    """MJCF <custom><numeric> lookup (reference GetNumberOrDefault)."""
    for key, vals in self.custom_numeric:
      if key == name:
        return vals[0] if len(vals) == 1 else vals
    return default

  def keyframe(self, name: str):
    for key, val in self.keyframes:
      if key == name:
        return val
    raise KeyError(f"no keyframe named {name!r}")

  @property
  def device(self) -> torch.device:
    return self.qpos0.device

  @property
  def dtype(self) -> torch.dtype:
    return self.qpos0.dtype


@dataclasses.dataclass
class Data:
  """Simulation state (the state fields of the JAX Data)."""
  time: torch.Tensor  # ()
  qpos: torch.Tensor  # (nq,)
  qvel: torch.Tensor  # (nv,)
  act: torch.Tensor  # (na,)
  ctrl: torch.Tensor  # (nu,)
  qfrc_applied: torch.Tensor  # (nv,)
  xfrc_applied: torch.Tensor  # (nbody, 6)
  mocap_pos: torch.Tensor  # (nmocap, 3)
  mocap_quat: torch.Tensor  # (nmocap, 4)
  userdata: torch.Tensor  # (nuserdata,)

  def replace(self, **kw) -> "Data":
    return dataclasses.replace(self, **kw)
