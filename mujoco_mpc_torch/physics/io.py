"""Host-side MJCF loading: mujoco.MjModel -> Model of torch tensors.

Counterpart of mujoco_mpc_tpu/physics/io.py. The `mujoco` package is used
only as an MJCF parser on the host. A loaded Model can also be written to a
snapshot file (`save_snapshot`) and read back without `mujoco`
(`load_snapshot`): machines that run the port need not have `mujoco`.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.physics import types

# supported narrowphase pair kinds of the general engine (collision.py)
_SUPPORTED_PAIRS = {
    (types.GeomType.PLANE, types.GeomType.SPHERE),
    (types.GeomType.PLANE, types.GeomType.CAPSULE),
    (types.GeomType.PLANE, types.GeomType.BOX),
    (types.GeomType.PLANE, types.GeomType.ELLIPSOID),
    (types.GeomType.PLANE, types.GeomType.CYLINDER),
    (types.GeomType.SPHERE, types.GeomType.SPHERE),
    (types.GeomType.SPHERE, types.GeomType.CAPSULE),
    (types.GeomType.SPHERE, types.GeomType.BOX),
    (types.GeomType.CAPSULE, types.GeomType.CAPSULE),
    (types.GeomType.CAPSULE, types.GeomType.BOX),
    (types.GeomType.BOX, types.GeomType.BOX),
    (types.GeomType.HFIELD, types.GeomType.SPHERE),
    (types.GeomType.HFIELD, types.GeomType.CAPSULE),
    (types.GeomType.HFIELD, types.GeomType.BOX),
    (types.GeomType.PLANE, types.GeomType.MESH),
    (types.GeomType.SPHERE, types.GeomType.MESH),
    (types.GeomType.CAPSULE, types.GeomType.MESH),
    (types.GeomType.BOX, types.GeomType.MESH),
    (types.GeomType.MESH, types.GeomType.MESH),
}


def _fibonacci_sphere(n: int) -> np.ndarray:
  """(n, 3) roughly uniform unit directions (hull-vertex reduction set)."""
  i = np.arange(n, dtype=np.float64)
  phi = np.pi * (3.0 - np.sqrt(5.0)) * i
  z = 1.0 - 2.0 * (i + 0.5) / n
  r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
  return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


def _names(mj, adr_list, count) -> tuple:
  out = []
  raw = mj.names
  for i in range(count):
    adr = int(adr_list[i])
    end = raw.find(b"\x00", adr)
    out.append(raw[adr:end].decode())
  return tuple(out)


def _sensor_type_map(mujoco):
  s = mujoco.mjtSensor
  return {
      int(s.mjSENS_JOINTPOS): types.SensorType.JOINTPOS,
      int(s.mjSENS_JOINTVEL): types.SensorType.JOINTVEL,
      int(s.mjSENS_FRAMEPOS): types.SensorType.FRAMEPOS,
      int(s.mjSENS_FRAMEQUAT): types.SensorType.FRAMEQUAT,
      int(s.mjSENS_FRAMEXAXIS): types.SensorType.FRAMEXAXIS,
      int(s.mjSENS_FRAMEYAXIS): types.SensorType.FRAMEYAXIS,
      int(s.mjSENS_FRAMEZAXIS): types.SensorType.FRAMEZAXIS,
      int(s.mjSENS_FRAMELINVEL): types.SensorType.FRAMELINVEL,
      int(s.mjSENS_FRAMEANGVEL): types.SensorType.FRAMEANGVEL,
      int(s.mjSENS_SUBTREECOM): types.SensorType.SUBTREECOM,
      int(s.mjSENS_SUBTREELINVEL): types.SensorType.SUBTREELINVEL,
      int(s.mjSENS_ACTUATORFRC): types.SensorType.ACTUATORFRC,
      int(s.mjSENS_TOUCH): types.SensorType.TOUCH,
      int(s.mjSENS_ACCELEROMETER): types.SensorType.ACCELEROMETER,
      int(s.mjSENS_GYRO): types.SensorType.GYRO,
      int(s.mjSENS_SUBTREEANGMOM): types.SensorType.SUBTREEANGMOM,
      int(s.mjSENS_USER): types.SensorType.USER,
  }


def _obj_type_map(mujoco):
  o = mujoco.mjtObj
  return {
      int(o.mjOBJ_BODY): types.ObjType.BODY,
      int(o.mjOBJ_XBODY): types.ObjType.XBODY,
      int(o.mjOBJ_GEOM): types.ObjType.GEOM,
      int(o.mjOBJ_SITE): types.ObjType.SITE,
      int(o.mjOBJ_JOINT): types.ObjType.JOINT,
      int(o.mjOBJ_UNKNOWN): types.ObjType.BODY,
  }


def _collision_pairs(mj) -> tuple:
  """Static broadphase: contype/conaffinity + body-filter compatible pairs."""
  pairs = []
  excluded = set()
  for i in range(mj.nexclude):
    sig = int(mj.exclude_signature[i])
    excluded.add((sig >> 16, sig & 0xFFFF))
    excluded.add((sig & 0xFFFF, sig >> 16))
  for g1 in range(mj.ngeom):
    for g2 in range(g1 + 1, mj.ngeom):
      b1, b2 = int(mj.geom_bodyid[g1]), int(mj.geom_bodyid[g2])
      if b1 == b2:
        continue
      # parent-child filter (as in MuJoCo, unless one parent is world)
      w1 = int(mj.body_weldid[b1])
      w2 = int(mj.body_weldid[b2])
      if w1 == w2:
        continue
      p1 = int(mj.body_weldid[mj.body_parentid[w1]])
      p2 = int(mj.body_weldid[mj.body_parentid[w2]])
      if (w1 == p2 or w2 == p1) and not (p1 == 0 or p2 == 0):
        continue
      if (b1, b2) in excluded:
        continue
      t1 = int(mj.geom_contype[g1]) & int(mj.geom_conaffinity[g2])
      t2 = int(mj.geom_contype[g2]) & int(mj.geom_conaffinity[g1])
      if not (t1 or t2):
        continue
      ty1, ty2 = int(mj.geom_type[g1]), int(mj.geom_type[g2])
      a, b = (g1, g2) if ty1 <= ty2 else (g2, g1)
      key = (types.GeomType(min(ty1, ty2)), types.GeomType(max(ty1, ty2)))
      if key not in _SUPPORTED_PAIRS:
        continue  # unsupported narrowphase; skipped (documented limitation)
      pairs.append((a, b))
  return tuple(pairs)


def _dof_ancestor_mask(body_parentid, body_dofadr, body_dofnum,
                       dof_bodyid) -> np.ndarray:
  """mask[i, j] = True iff dof i is on the kinematic path of dof j (i<=j)."""
  nv = len(dof_bodyid)
  # dof parent pointer: previous dof within body, else last dof of nearest
  # dof-bearing ancestor body.
  dof_parent = np.full(nv, -1, dtype=np.int64)
  for b in range(len(body_parentid)):
    adr, num = body_dofadr[b], body_dofnum[b]
    if num == 0:
      continue
    p = body_parentid[b]
    anc_last = -1
    while p >= 0:
      if body_dofnum[p] > 0:
        anc_last = body_dofadr[p] + body_dofnum[p] - 1
        break
      if p == 0:
        break
      p = body_parentid[p]
    for k in range(num):
      dof_parent[adr + k] = adr + k - 1 if k > 0 else anc_last
  mask = np.zeros((nv, nv), dtype=bool)
  for j in range(nv):
    i = j
    while i >= 0:
      mask[i, j] = True
      i = dof_parent[i]
  return mask


def _dof_body_mask(body_parentid, body_dofadr, body_dofnum,
                   nv: int) -> np.ndarray:
  """mask[i, b] = True iff dof i is on the kinematic path from world to b."""
  nbody = len(body_parentid)
  mask = np.zeros((nv, nbody), dtype=bool)
  for b in range(1, nbody):
    p = b
    while p > 0:
      adr, num = body_dofadr[p], body_dofnum[p]
      for k in range(num):
        mask[adr + k, b] = True
      p = body_parentid[p]
  return mask


def _body_ancestor_mask(body_parentid) -> np.ndarray:
  """mask[a, b] = True iff body a is an ancestor-or-self of body b."""
  nbody = len(body_parentid)
  mask = np.zeros((nbody, nbody), dtype=bool)
  for b in range(nbody):
    p = b
    while True:
      mask[p, b] = True
      if p == 0:
        break
      p = body_parentid[p]
  return mask


def _cdofdot_vel_mask(body_parentid, body_dofadr, body_dofnum,
                      jnt_type, jnt_dofadr, jnt_bodyid, nv) -> np.ndarray:
  """mask[k, i] = True iff dof i's velocity enters the chain velocity v_k
  that rotates cdof[k]: cdof_dot[k] = v_k x cdof[k].

  Hinge/slide use strict-ancestor velocity; ball/free rotational axes move
  with the full child angular velocity; free-joint translations have
  constant cdof (all-zero row)."""
  JointType = types.JointType
  nbody = len(body_parentid)
  body_anc_dofs = [[] for _ in range(nbody)]
  for b in range(1, nbody):
    p = body_parentid[b]
    dofs = list(body_anc_dofs[p])
    dofs += [body_dofadr[p] + k for k in range(body_dofnum[p])]
    body_anc_dofs[b] = dofs
  mask = np.zeros((nv, nv), dtype=bool)
  for j in range(len(jnt_type)):
    b = jnt_bodyid[j]
    vadr = jnt_dofadr[j]
    jt = jnt_type[j]
    anc = body_anc_dofs[b]
    same_body_earlier = [body_dofadr[b] + k
                         for k in range(body_dofnum[b])
                         if body_dofadr[b] + k < vadr]
    pre = anc + same_body_earlier
    if jt in (JointType.HINGE, JointType.SLIDE):
      mask[vadr, pre] = True
    elif jt == JointType.BALL:
      for i in range(3):
        mask[vadr + i, pre] = True
        mask[vadr + i, vadr:vadr + 3] = True
    elif jt == JointType.FREE:
      for i in range(3):
        mask[vadr + 3 + i, pre] = True
        mask[vadr + 3 + i, vadr:vadr + 6] = True
  return mask


def load_model(path_or_xml: str, dtype=torch.float32,
               device=devices.DEFAULT) -> types.Model:
  """Load an MJCF file (or XML string) into a Model."""
  import mujoco  # host-only import

  device = devices.resolve(device)

  if path_or_xml.lstrip().startswith("<"):
    mj = mujoco.MjModel.from_xml_string(path_or_xml)
  else:
    mj = mujoco.MjModel.from_xml_path(path_or_xml)
  return from_mjmodel(mj, dtype=dtype, device=device)


def from_mjmodel(mj, dtype=torch.float32,
                 device=devices.DEFAULT) -> types.Model:
  import mujoco

  sens_map = _sensor_type_map(mujoco)
  obj_map = _obj_type_map(mujoco)

  def a(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                           device=device)

  def bt(x):
    return torch.as_tensor(np.asarray(x, dtype=bool), device=device)

  def ti(x):
    return tuple(int(v) for v in np.asarray(x).ravel())

  for i in range(mj.nu):
    trn = int(mj.actuator_trntype[i])
    if trn not in (int(mujoco.mjtTrn.mjTRN_JOINT),
                   int(mujoco.mjtTrn.mjTRN_SITE),
                   int(mujoco.mjtTrn.mjTRN_TENDON)):
      raise NotImplementedError(
          f"actuator {i}: transmission type {trn} unsupported (joint/site/"
          "tendon only)")
    if int(mj.actuator_gaintype[i]) > 1 or int(mj.actuator_biastype[i]) > 1:
      raise NotImplementedError("muscle actuators unsupported")

  trn_map = {
      int(mujoco.mjtTrn.mjTRN_JOINT): types.TrnType.JOINT,
      int(mujoco.mjtTrn.mjTRN_SITE): types.TrnType.SITE,
      int(mujoco.mjtTrn.mjTRN_TENDON): types.TrnType.TENDON,
  }

  # fixed tendons only: constant-coefficient joint couplings
  tendon_joints = []
  for i in range(mj.ntendon):
    adr, num = int(mj.tendon_adr[i]), int(mj.tendon_num[i])
    wraps = []
    for w in range(adr, adr + num):
      if int(mj.wrap_type[w]) != int(mujoco.mjtWrap.mjWRAP_JOINT):
        raise NotImplementedError(
            f"tendon {i}: spatial tendon wrapping unsupported "
            "(fixed joint tendons only)")
      wraps.append((int(mj.wrap_objid[w]), float(mj.wrap_prm[w])))
    tendon_joints.append(tuple(wraps))

  # convex mesh collision hulls: vertex clouds + deduped face normals
  VCAP, NCAP = 64, 24
  mesh_hulls, mesh_norms = [], []
  if mj.nmesh:
    sphere_dirs = _fibonacci_sphere(128)
  for i in range(mj.nmesh):
    vadr, vnum = int(mj.mesh_vertadr[i]), int(mj.mesh_vertnum[i])
    v = np.asarray(mj.mesh_vert[vadr:vadr + vnum], dtype=np.float64)
    if vnum > VCAP:
      idx = np.unique(np.argmax(sphere_dirs @ v.T, axis=1))
      v = v[idx]
      if v.shape[0] > VCAP:
        com = v.mean(0)
        v = v[np.argsort(-np.linalg.norm(v - com, axis=1))[:VCAP]]
    pad = np.broadcast_to(v[:1], (VCAP - v.shape[0], 3))
    mesh_hulls.append(np.concatenate([v, pad]))
    fadr, fnum = int(mj.mesh_faceadr[i]), int(mj.mesh_facenum[i])
    f = np.asarray(mj.mesh_face[fadr:fadr + fnum], dtype=np.int64)
    verts_all = np.asarray(mj.mesh_vert[vadr:vadr + vnum],
                           dtype=np.float64)
    e1 = verts_all[f[:, 1]] - verts_all[f[:, 0]]
    e2 = verts_all[f[:, 2]] - verts_all[f[:, 0]]
    n = np.cross(e1, e2)
    nn = np.linalg.norm(n, axis=1)
    n = n[nn > 1e-12] / nn[nn > 1e-12][:, None]
    n = n * np.where(
        (n[:, 0] + 1e-6 * n[:, 1] + 1e-12 * n[:, 2]) < 0, -1.0, 1.0)[:, None]
    n = np.unique(np.round(n, 2), axis=0)
    n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    if n.shape[0] > NCAP:
      n = n[np.linspace(0, n.shape[0] - 1, NCAP).astype(int)]
    if n.shape[0] == 0:
      n = np.asarray([[0.0, 0.0, 1.0]])
    padn = np.broadcast_to(n[:1], (NCAP - n.shape[0], 3))
    mesh_norms.append(np.concatenate([n, padn]))

  eq_supported = {
      int(mujoco.mjtEq.mjEQ_CONNECT): types.EqType.CONNECT,
      int(mujoco.mjtEq.mjEQ_WELD): types.EqType.WELD,
      int(mujoco.mjtEq.mjEQ_JOINT): types.EqType.JOINT,
  }
  eq_types = []
  for i in range(mj.neq):
    et = int(mj.eq_type[i])
    if et not in eq_supported:
      raise NotImplementedError(
          f"equality {i}: type {et} unsupported (connect/weld/joint only)")
    eq_types.append(int(eq_supported[et]))
  # per-row diagApprox from invweight0 (see types.Model.eq_diagapprox)
  eq_diagapprox = []
  for i in range(mj.neq):
    if not mj.eq_active0[i]:
      continue
    et, o1, o2 = int(mj.eq_type[i]), int(mj.eq_obj1id[i]), int(mj.eq_obj2id[i])
    if et == int(mujoco.mjtEq.mjEQ_CONNECT):
      tr = float(mj.body_invweight0[o1, 0] + mj.body_invweight0[o2, 0])
      eq_diagapprox += [tr] * 3
    elif et == int(mujoco.mjtEq.mjEQ_WELD):
      tr = float(mj.body_invweight0[o1, 0] + mj.body_invweight0[o2, 0])
      ro = float(mj.body_invweight0[o1, 1] + mj.body_invweight0[o2, 1])
      eq_diagapprox += [tr] * 3 + [ro] * 3
    else:
      da = float(mj.dof_invweight0[mj.jnt_dofadr[o1]])
      if o2 >= 0:
        da += float(mj.dof_invweight0[mj.jnt_dofadr[o2]])
      eq_diagapprox.append(da)

  sensor_spec = []
  for i in range(mj.nsensor):
    st = int(mj.sensor_type[i])
    if st not in sens_map:
      raise NotImplementedError(f"sensor type {st} unsupported")
    sensor_spec.append((
        int(sens_map[st]),
        int(obj_map.get(int(mj.sensor_objtype[i]), types.ObjType.BODY)),
        int(mj.sensor_objid[i]),
        int(mj.sensor_adr[i]),
        int(mj.sensor_dim[i]),
    ))

  numerics = []
  name_tuple = _names(mj, mj.name_numericadr, mj.nnumeric)
  for i in range(mj.nnumeric):
    adr, num = int(mj.numeric_adr[i]), int(mj.numeric_size[i])
    numerics.append(
        (name_tuple[i],
         tuple(float(v) for v in mj.numeric_data[adr:adr + num])))

  keyframes = []
  key_names = _names(mj, mj.name_keyadr, mj.nkey)
  for i in range(mj.nkey):
    keyframes.append((key_names[i], (
        tuple(float(v) for v in mj.key_qpos[i]),
        tuple(float(v) for v in mj.key_qvel[i]),
        tuple(float(v) for v in mj.key_ctrl[i]),
    )))

  subtreemass = np.array(mj.body_mass, dtype=np.float64)
  for b in range(mj.nbody - 1, 0, -1):
    subtreemass[int(mj.body_parentid[b])] += subtreemass[b]

  ancestor = _dof_ancestor_mask(
      ti(mj.body_parentid), ti(mj.body_dofadr), ti(mj.body_dofnum),
      ti(mj.dof_bodyid))
  dof_body = _dof_body_mask(
      ti(mj.body_parentid), ti(mj.body_dofadr), ti(mj.body_dofnum),
      int(mj.nv))
  body_anc = _body_ancestor_mask(ti(mj.body_parentid))
  cdofdot_vel = _cdofdot_vel_mask(
      ti(mj.body_parentid), ti(mj.body_dofadr), ti(mj.body_dofnum),
      ti(mj.jnt_type), ti(mj.jnt_dofadr), ti(mj.jnt_bodyid), int(mj.nv))

  nuserdata = max(int(mj.nuserdata), 16)  # room for task FSM state

  opt = types.Option(
      timestep=a(mj.opt.timestep),
      gravity=a(mj.opt.gravity),
      impratio=a(mj.opt.impratio),
      viscosity=a(mj.opt.viscosity),
      density=a(mj.opt.density),
      wind=a(mj.opt.wind),
      integrator=int(mj.opt.integrator),
      has_fluid=bool(mj.opt.viscosity > 0 or mj.opt.density > 0),
  )

  return types.Model(
      nq=int(mj.nq), nv=int(mj.nv), nu=int(mj.nu), na=int(mj.na),
      nbody=int(mj.nbody), njnt=int(mj.njnt), ngeom=int(mj.ngeom),
      nsite=int(mj.nsite), nmocap=int(mj.nmocap), nuserdata=nuserdata,
      nsensordata=int(mj.nsensordata),
      body_parentid=ti(mj.body_parentid),
      body_rootid=ti(mj.body_rootid),
      body_jntadr=ti(mj.body_jntadr),
      body_jntnum=ti(mj.body_jntnum),
      body_dofadr=ti(mj.body_dofadr),
      body_dofnum=ti(mj.body_dofnum),
      body_mocapid=ti(mj.body_mocapid),
      body_names=_names(mj, mj.name_bodyadr, mj.nbody),
      jnt_type=ti(mj.jnt_type),
      jnt_qposadr=ti(mj.jnt_qposadr),
      jnt_dofadr=ti(mj.jnt_dofadr),
      jnt_bodyid=ti(mj.jnt_bodyid),
      jnt_limited=tuple(bool(v) for v in mj.jnt_limited),
      jnt_names=_names(mj, mj.name_jntadr, mj.njnt),
      dof_bodyid=ti(mj.dof_bodyid),
      dof_jntid=ti(mj.dof_jntid),
      geom_type=ti(mj.geom_type),
      geom_condim=ti(mj.geom_condim),
      geom_bodyid=ti(mj.geom_bodyid),
      geom_dataid=ti(mj.geom_dataid),
      hfield_nrow=int(mj.hfield_nrow[0]) if mj.nhfield else 0,
      hfield_ncol=int(mj.hfield_ncol[0]) if mj.nhfield else 0,
      geom_names=_names(mj, mj.name_geomadr, mj.ngeom),
      collision_pairs=_collision_pairs(mj),
      site_bodyid=ti(mj.site_bodyid),
      site_names=_names(mj, mj.name_siteadr, mj.nsite),
      actuator_trntype=tuple(
          int(trn_map[int(t)]) for t in mj.actuator_trntype),
      actuator_trnid=tuple(int(v[0]) for v in mj.actuator_trnid),
      actuator_dyntype=ti(mj.actuator_dyntype),
      actuator_gaintype=ti(mj.actuator_gaintype),
      actuator_biastype=ti(mj.actuator_biastype),
      actuator_actadr=ti(mj.actuator_actadr),
      actuator_names=_names(mj, mj.name_actuatoradr, mj.nu),
      has_spring=bool(np.any(np.asarray(mj.jnt_stiffness) != 0)),
      has_frictionloss=bool(np.any(np.asarray(mj.dof_frictionloss) != 0)),
      sensor_spec=tuple(sensor_spec),
      sensor_names=_names(mj, mj.name_sensoradr, mj.nsensor),
      custom_numeric=tuple(numerics),
      keyframes=tuple(keyframes),
      opt=opt,
      qpos0=a(mj.qpos0),
      qpos_spring=a(mj.qpos_spring),
      body_pos=a(mj.body_pos),
      body_quat=a(mj.body_quat),
      body_ipos=a(mj.body_ipos),
      body_iquat=a(mj.body_iquat),
      body_mass=a(mj.body_mass),
      body_inertia=a(mj.body_inertia),
      body_subtreemass=a(subtreemass),
      jnt_pos=a(mj.jnt_pos),
      jnt_axis=a(mj.jnt_axis),
      jnt_range=a(mj.jnt_range),
      jnt_stiffness=a(mj.jnt_stiffness),
      jnt_solref=a(mj.jnt_solref),
      jnt_margin=a(mj.jnt_margin),
      dof_damping=a(mj.dof_damping),
      dof_armature=a(mj.dof_armature),
      dof_frictionloss=a(mj.dof_frictionloss),
      dof_ancestor_mask=bt(ancestor),
      dof_body_mask=bt(dof_body),
      body_ancestor_mask=bt(body_anc),
      cdofdot_vel_mask=bt(cdofdot_vel),
      hfield_data=(a(mj.hfield_data.reshape(
          mj.hfield_nrow[0], mj.hfield_ncol[0]) * mj.hfield_size[0, 2])
                   if mj.nhfield else a(np.zeros((1, 1)))),
      hfield_size=(a(mj.hfield_size[0]) if mj.nhfield
                   else a(np.asarray([1.0, 1.0, 1.0, 1.0]))),
      geom_pos=a(mj.geom_pos),
      geom_quat=a(mj.geom_quat),
      geom_size=a(mj.geom_size),
      geom_friction=a(mj.geom_friction),
      geom_solref=a(mj.geom_solref),
      geom_solimp=a(mj.geom_solimp),
      geom_margin=a(mj.geom_margin),
      site_pos=a(mj.site_pos),
      site_quat=a(mj.site_quat),
      actuator_gear=a(mj.actuator_gear),
      actuator_ctrlrange=a(mj.actuator_ctrlrange),
      actuator_forcerange=a(mj.actuator_forcerange),
      actuator_ctrllimited=bt(mj.actuator_ctrllimited),
      actuator_forcelimited=bt(mj.actuator_forcelimited),
      actuator_gainprm=a(mj.actuator_gainprm[:, :3]),
      actuator_biasprm=a(mj.actuator_biasprm[:, :3]),
      actuator_dynprm=a(mj.actuator_dynprm[:, :3]),
      actuator_actrange=a(mj.actuator_actrange),
      nmesh=int(mj.nmesh),
      mesh_names=_names(mj, mj.name_meshadr, mj.nmesh),
      mesh_hullvert=(a(np.stack(mesh_hulls)) if mesh_hulls else None),
      mesh_facenorm=(a(np.stack(mesh_norms)) if mesh_norms else None),
      ntendon=int(mj.ntendon),
      tendon_joints=tuple(tendon_joints),
      tendon_limited=tuple(bool(v) for v in mj.tendon_limited),
      tendon_names=_names(mj, mj.name_tendonadr, mj.ntendon),
      tendon_range=a(mj.tendon_range),
      tendon_stiffness=a(mj.tendon_stiffness),
      tendon_damping=a(mj.tendon_damping),
      tendon_lengthspring=a(mj.tendon_lengthspring),
      tendon_solref_lim=a(mj.tendon_solref_lim),
      tendon_solimp_lim=a(mj.tendon_solimp_lim),
      tendon_margin=a(mj.tendon_margin),
      neq=int(mj.neq),
      eq_type=tuple(eq_types),
      eq_diagapprox=tuple(eq_diagapprox),
      eq_obj1id=ti(mj.eq_obj1id),
      eq_obj2id=ti(mj.eq_obj2id),
      eq_active0=tuple(bool(v) for v in mj.eq_active0),
      eq_data=a(mj.eq_data),
      eq_solref=a(mj.eq_solref),
      eq_solimp=a(mj.eq_solimp),
  )


def make_data(m: types.Model, dtype=None) -> types.Data:
  """Fresh Data at the model reference configuration qpos0, its derived
  fields allocated (zeros, identity frames, an inactive contact set of the
  model's point count and a cold warm start), as the JAX make_data."""
  from mujoco_mpc_torch.physics import collision, solver

  dtype = dtype or m.dtype
  dev = m.device

  def z(*shape):
    return torch.zeros(shape, dtype=dtype, device=dev)

  # mocap bodies start at their model pose (mjData convention)
  if m.nmocap:
    order = sorted((b for b in range(m.nbody) if m.body_mocapid[b] >= 0),
                   key=lambda b: m.body_mocapid[b])
    mocap_pos0 = torch.stack([m.body_pos[b] for b in order]).to(dtype)
    mocap_quat0 = torch.stack([m.body_quat[b] for b in order]).to(dtype)
  else:
    mocap_pos0 = z(0, 3)
    mocap_quat0 = z(0, 4)

  def eye(n):
    return torch.eye(3, dtype=dtype, device=dev).expand(n, 3, 3).clone()

  npt = max(collision.npoints(m), 1)  # contact points, not pairs
  contact = types.Contact(
      dist=torch.full((npt,), 1e10, dtype=dtype, device=dev),
      pos=z(npt, 3), frame=eye(npt), friction=z(npt), torsion=z(npt),
      roll=z(npt), solref=z(npt, 2), solimp=z(npt, 5),
      geom1=torch.zeros((npt,), dtype=torch.int32, device=dev),
      geom2=torch.zeros((npt,), dtype=torch.int32, device=dev),
      force=z(npt, 3))
  quat0 = torch.zeros((max(m.nbody, 1), 4), dtype=dtype, device=dev)
  quat0[:, 0] = 1.0
  return types.Data(
      time=z(),
      qpos=m.qpos0.to(dtype).clone(),
      qvel=z(m.nv),
      act=z(m.na),
      ctrl=z(m.nu),
      qfrc_applied=z(m.nv),
      xfrc_applied=z(m.nbody, 6),
      mocap_pos=mocap_pos0,
      mocap_quat=mocap_quat0,
      userdata=z(m.nuserdata),
      xpos=z(m.nbody, 3), xquat=quat0, xmat=eye(m.nbody),
      xipos=z(m.nbody, 3), ximat=eye(m.nbody), xanchor=z(m.njnt, 3),
      xaxis=z(m.njnt, 3), geom_xpos=z(m.ngeom, 3), geom_xmat=eye(m.ngeom),
      site_xpos=z(m.nsite, 3), site_xmat=eye(m.nsite),
      subtree_com=z(m.nbody, 3), cdof=z(m.nv, 6), cvel=z(m.nbody, 6),
      qM=z(m.nv, m.nv), qLD=z(m.nv, m.nv), qfrc_bias=z(m.nv),
      qfrc_passive=z(m.nv), qfrc_actuator=z(m.nv), qfrc_constraint=z(m.nv),
      actuator_force=z(m.nu), act_dot=z(m.na), qacc=z(m.nv),
      contact=contact, sensordata=z(m.nsensordata),
      efc_lambda=z(max(solver.nrow_static(m), 1)),
  )


# ---------------------------------------------------------------------------
# snapshots: a loaded Model as plain arrays + JSON metadata, no mujoco needed
# ---------------------------------------------------------------------------

_STATIC_KEY = "__static__"


def _tuples(x):
  """JSON lists back to the tuples the Model's static fields hold."""
  if isinstance(x, list):
    return tuple(_tuples(v) for v in x)
  return x


def save_snapshot(path: str, m: types.Model, **extra) -> None:
  """Write a Model to an .npz file: every tensor field as an array, the
  static fields as one JSON string under `__static__` (Option fields as
  `opt.<name>`), plus the `extra` named arrays."""
  arrays, static = {}, {}
  items = [(f.name, getattr(m, f.name)) for f in dataclasses.fields(m)
           if f.name != "opt"]
  items += [(f"opt.{f.name}", getattr(m.opt, f.name))
            for f in dataclasses.fields(m.opt)]
  for name, v in items:
    if isinstance(v, torch.Tensor):
      arrays[name] = v.detach().cpu().numpy()
    else:
      static[name] = v
  arrays[_STATIC_KEY] = np.asarray(json.dumps(static))
  np.savez(path, **arrays, **extra)


def load_snapshot(path: str, dtype=torch.float32, device=devices.DEFAULT):
  """(Model, {extra name: ndarray}) from an .npz written by save_snapshot;
  floating arrays are cast to `dtype`."""
  device = devices.resolve(device)
  with np.load(path, allow_pickle=False) as f:
    arrays = {k: f[k] for k in f.files}
  static = {k: _tuples(v)
            for k, v in json.loads(str(arrays[_STATIC_KEY])).items()}

  def tensor(x):
    x = np.asarray(x)
    t = torch.as_tensor(x, device=device)
    return t.to(dtype) if np.issubdtype(x.dtype, np.floating) else t

  def build(cls, prefix):
    kw = {}
    for f in dataclasses.fields(cls):
      key = prefix + f.name
      if key in static:
        kw[f.name] = static[key]
      elif key in arrays:
        kw[f.name] = tensor(arrays[key])
    return kw

  kw = build(types.Model, "")
  kw["opt"] = types.Option(**build(types.Option, "opt."))
  used = {f.name for f in dataclasses.fields(types.Model)}
  used |= {_STATIC_KEY} | {k for k in arrays if k.startswith("opt.")}
  extra = {k: v for k, v in arrays.items() if k not in used}
  return types.Model(**kw), extra
