"""Model / Data dataclasses of torch tensors.

Counterpart of mujoco_mpc_tpu/physics/types.py. Structural quantities
(sizes, tree indices, joint types, collision pairs, names) are Python
metadata; numeric parameters are tensors on one device. Conventions match
MuJoCo: quaternions (w, x, y, z); joint types FREE/BALL/SLIDE/HINGE;
spatial 6-vectors [angular; linear] about the world origin.

`Data` holds the simulation state and the derived fields the general
engine (physics/step.py) fills: kinematics, inertia, forces, contacts,
sensors and the constraint solve's warm start, as in the JAX Data. The
engine takes leading batch dimensions: a field of shape (n, 3) in one
state is (*b, n, 3) in a batch. Residuals read the batch-trailing view
(`batch_trailing`).
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


# the numeric fields that Model.with_values may replace -> the keys of the
# engine's constants (Model.const) built from their values; no other
# constant reads them
VALUE_CONSTS = {
    "dof_damping": frozenset(),
    "site_pos": frozenset(),
    "body_mass": frozenset({"sensors_host"}),
    "body_inertia": frozenset({"sensors_host"}),
}


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

  def to(self, device) -> "Model":
    """A copy with every tensor on `device` (this Model where they all
    are), which builds its engine constants there."""
    return _on(self, torch.device(device))

  def with_values(self, **kw) -> "Model":
    """replace() of the numeric fields in VALUE_CONSTS, keeping this
    Model's constants: the new Model shares them (each built once for
    both) but for those built from the replaced values, which it builds
    for itself."""
    unknown = set(kw) - set(VALUE_CONSTS)
    if unknown:
      raise ValueError(f"with_values: no constant list for {sorted(unknown)}"
                       f" (fields: {sorted(VALUE_CONSTS)})")
    out = dataclasses.replace(self, **kw)
    out.__dict__["_const"] = self.__dict__.setdefault("_const", {})
    out.__dict__["_own"] = self.__dict__.get("_own", frozenset()).union(
        *(VALUE_CONSTS[k] for k in kw))
    return out

  def const(self, key, build):
    """`build()`, made once per Model object and kept: the engine's
    constants derived from the static structure (index and mask tensors
    on the model's device), so that a step copies nothing from the host.
    `replace` makes a new Model, which builds its own; `with_values` one
    that shares them."""
    own = key in self.__dict__.get("_own", ())
    cache = self.__dict__.setdefault("_own_const" if own else "_const", {})
    if key not in cache:
      cache[key] = build()
    return cache[key]

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

  def sensor_adr(self, name: str) -> Tuple[int, int]:
    """(address, dim) of a named sensor in sensordata."""
    spec = self.sensor_spec[self.sensor(name)]
    return spec[3], spec[4]

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
class Contact:
  """The contact points of the static candidate pairs, dense: an inactive
  point has dist > 0 and carries no force. Shapes per state; `pairs`, the
  (g1, g2) geom pair of each point (its normal points g1 -> g2), is static
  and set by collision.collide (empty in make_data's placeholder)."""
  dist: torch.Tensor  # (npt,) signed distance, the margin taken off
  pos: torch.Tensor  # (npt, 3) midpoint
  frame: torch.Tensor  # (npt, 3, 3) rows: normal, tangent1, tangent2
  friction: torch.Tensor  # (npt,) sliding
  torsion: torch.Tensor  # (npt,) torsional (condim >= 4)
  roll: torch.Tensor  # (npt,) rolling (condim 6)
  solref: torch.Tensor  # (npt, 2)
  solimp: torch.Tensor  # (npt, 5)
  geom1: torch.Tensor  # (npt,) int
  geom2: torch.Tensor  # (npt,) int
  force: torch.Tensor  # (npt, 3) solved force in the contact frame
  pairs: tuple = ()

  def replace(self, **kw) -> "Contact":
    return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class Data:
  """Simulation state and the general engine's derived fields (the JAX
  Data's fields; the derived ones are None until make_data or the engine
  fills them)."""
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

  # kinematics
  xpos: Optional[torch.Tensor] = None  # (nbody, 3)
  xquat: Optional[torch.Tensor] = None  # (nbody, 4)
  xmat: Optional[torch.Tensor] = None  # (nbody, 3, 3)
  xipos: Optional[torch.Tensor] = None  # (nbody, 3) body CoM
  ximat: Optional[torch.Tensor] = None  # (nbody, 3, 3) inertial frame
  xanchor: Optional[torch.Tensor] = None  # (njnt, 3)
  xaxis: Optional[torch.Tensor] = None  # (njnt, 3)
  geom_xpos: Optional[torch.Tensor] = None  # (ngeom, 3)
  geom_xmat: Optional[torch.Tensor] = None  # (ngeom, 3, 3)
  site_xpos: Optional[torch.Tensor] = None  # (nsite, 3)
  site_xmat: Optional[torch.Tensor] = None  # (nsite, 3, 3)
  subtree_com: Optional[torch.Tensor] = None  # (nbody, 3)

  # velocities and dynamics
  cdof: Optional[torch.Tensor] = None  # (nv, 6)
  cvel: Optional[torch.Tensor] = None  # (nbody, 6)
  qM: Optional[torch.Tensor] = None  # (nv, nv)
  qLD: Optional[torch.Tensor] = None  # (nv, nv) Cholesky factor
  qfrc_bias: Optional[torch.Tensor] = None  # (nv,)
  qfrc_passive: Optional[torch.Tensor] = None  # (nv,)
  qfrc_actuator: Optional[torch.Tensor] = None  # (nv,)
  qfrc_constraint: Optional[torch.Tensor] = None  # (nv,)
  actuator_force: Optional[torch.Tensor] = None  # (nu,)
  act_dot: Optional[torch.Tensor] = None  # (na,)
  qacc: Optional[torch.Tensor] = None  # (nv,)

  contact: Optional[Contact] = None
  sensordata: Optional[torch.Tensor] = None  # (nsensordata,)
  # the constraint solve's duals, its next warm start (physics/solver.py
  # row layout); zeros are a cold start
  efc_lambda: Optional[torch.Tensor] = None  # (nrow,)

  def replace(self, **kw) -> "Data":
    return dataclasses.replace(self, **kw)

  def to(self, device) -> "Data":
    """A copy with every tensor on `device`, its contacts' too (this Data
    where they all are)."""
    return _on(self, torch.device(device))


def _on(obj, device: torch.device):
  """obj (a Model, Option, Data or Contact) with every tensor on `device`,
  its nested Option or Contact too; obj itself where nothing moved."""
  kw = {}
  for f in dataclasses.fields(obj):
    v = getattr(obj, f.name)
    if isinstance(v, torch.Tensor):
      w = v.to(device)
    elif isinstance(v, (Option, Contact)):
      w = _on(v, device)
    else:
      continue
    if w is not v:
      kw[f.name] = w
  return dataclasses.replace(obj, **kw) if kw else obj


def _moved(obj, nb: int, leading: bool):
  """obj (a Data or Contact) with nb batch dimensions moved from leading
  to trailing (leading=True) or back; views, no copies."""
  kw = {}
  for f in dataclasses.fields(obj):
    v = getattr(obj, f.name)
    if isinstance(v, Contact):
      kw[f.name] = _moved(v, nb, leading)
    elif isinstance(v, torch.Tensor) and nb:
      d = v.dim()
      lead, trail = list(range(nb)), list(range(d - nb, d))
      kw[f.name] = (torch.movedim(v, lead, trail) if leading
                    else torch.movedim(v, trail, lead))
    else:
      kw[f.name] = v
  return dataclasses.replace(obj, **kw)


def batch_trailing(d: Data) -> Data:
  """The component-leading, batch-trailing view of a Data with leading
  batch dimensions (qpos (*b, nq) -> (nq, *b)), the layout task residuals
  and transitions read (physics/tilestep.py::StepView). One state is its
  own view."""
  return _moved(d, d.qpos.dim() - 1, True)


def batch_leading(d: Data, nb: int) -> Data:
  """The inverse of batch_trailing for nb batch dimensions."""
  return _moved(d, nb, False)
