"""Narrowphase collision: static candidate pairs to a dense contact set.

Counterpart of mujoco_mpc_tpu/physics/collision.py. The broadphase ran at
load (physics/io.py), so every candidate pair is evaluated every step and
an inactive point just carries a positive distance: fixed shapes, no
data-dependent control flow. Each pair kind gives a fixed number of points
(a capsule on a plane 2, a box on a plane its 8 corners, box against box
16, a mesh its _MESH_COUNTS, a box on a heightfield its 8 corners).

As the tile step (tilestep.COINCIDE), and unlike the JAX package, a pair
whose closest points coincide up to rounding (crossing capsule axes, a
sphere centre on a capsule's axis, a sphere centre inside a box on the
mid-plane of its nearest face) takes no normal from the rounding residue:
its rows are degenerate and the solver drops them (ROADMAP queue 3).
Elsewhere the points are the JAX package's. That holds for the mesh pairs
too: their support-function SAT takes its normal from a fixed axis set
(face normals, the centre direction, 13 fixed axes), never from two
coincident points, so they keep JAX's points. Their k deepest vertices
are chosen as jax.lax.top_k chooses them, ties to the lowest vertex index
(a stable sort; torch.topk orders ties otherwise), so a hull face lying
flat on a plane gives JAX's contact set. Depths within _TIE_GRAIN count as
tied: where a face lies square to the contact axis at any other angle,
its vertices tie only up to rounding, and the port takes the lowest
index on the CPU and on the card alike, where JAX's pick follows its
matmul's rounding (ROADMAP queue 3). A heightfield sample
at the field's far edge gathers its clamped neighbour, as a JAX gather
does out of bounds.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_mpc_torch.physics import math
from mujoco_mpc_torch.physics.tilestep import COINCIDE
from mujoco_mpc_torch.physics.types import Contact, Data, GeomType, Model

def _frame_from_normal(n: torch.Tensor) -> torch.Tensor:
  """(..., 3, 3) rows [normal, tangent1, tangent2] of unit normals n."""
  c = (torch.abs(n[..., 0]) < 0.5).to(n.dtype)
  ref = torch.stack([c, 1.0 - c, torch.zeros_like(c)], dim=-1)
  t1 = math.normalize(math.cross(n, ref))
  t2 = math.cross(n, t1)
  return torch.stack([n, t1, t2], dim=-2)


def _separation(c1, c2):
  """(norm (..., 1), unit) of c2 - c1, both 0 where the two points
  coincide to within COINCIDE machine epsilons of their coordinates."""
  delta = c2 - c1
  eps = torch.finfo(delta.dtype).eps
  same = (math.dot(delta, delta) <= (COINCIDE * eps) ** 2 *
          (1.0 + math.dot(c1, c1)))[..., None]
  return math.safe_norm(torch.where(same, torch.zeros_like(delta), delta))


# each pair function returns a list of (dist, pos, normal); the normal
# points from geom1 into geom2. It takes a group of P pairs of its kind at
# once: p (..., P, 3) centres, m (..., P, 3, 3) frames, s (P, 3) sizes.


_SIGNS = [(sx, sy, sz) for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
          for sz in (-1.0, 1.0)]
_SIGNS_ON = {}  # _SIGNS as a tensor, per (device, dtype)


def _corners(bp, bm, bsize):
  """(..., 8, 3) world corners of a box, in _SIGNS order."""
  key = (bp.device, bp.dtype)
  if key not in _SIGNS_ON:
    _SIGNS_ON[key] = torch.tensor(_SIGNS, dtype=bp.dtype, device=bp.device)
  return bp[..., None, :] + torch.matmul(
      _SIGNS_ON[key] * bsize[..., None, :], bm.transpose(-1, -2))


def _clip(x, half):
  """x clipped to [-half, half], half a tensor broadcasting against x."""
  return torch.maximum(torch.minimum(x, half), -half)


def _plane_sphere(pp, pm, sp, sm, psize, ssize):
  n = pm[..., :, 2]
  r = ssize[..., 0]
  dist = math.dot(n, sp - pp) - r
  pos = sp - n * (r + 0.5 * dist)[..., None]
  return [(dist, pos, n)]


def _plane_capsule(pp, pm, cp, cm, psize, csize):
  n = pm[..., :, 2]
  axis = cm[..., :, 2]
  r, half = csize[..., 0], csize[..., 1]
  out = []
  for sgn in (-1.0, 1.0):
    end = cp + (sgn * half)[..., None] * axis
    dist = math.dot(n, end - pp) - r
    out.append((dist, end - n * (r + 0.5 * dist)[..., None], n))
  return out


def _plane_box(pp, pm, bp, bm, psize, bsize):
  n = pm[..., :, 2]
  corners = _corners(bp, bm, bsize)
  dist = math.dot(n[..., None, :], corners - pp[..., None, :])
  pos = corners - n[..., None, :] * (0.5 * dist)[..., None]
  return [(dist[..., i], pos[..., i, :], n) for i in range(8)]


def _plane_ellipsoid(pp, pm, ep, em, psize, esize):
  n = pm[..., :, 2]
  nl = math.mat_tvec(em, n)
  denom = torch.linalg.vector_norm(esize * nl, dim=-1, keepdim=True) + 1e-12
  support = ep + math.mat_vec(em, -(esize * esize * nl) / denom)
  dist = math.dot(n, support - pp)
  return [(dist, support - n * (0.5 * dist)[..., None], n)]


def _sphere_sphere(p1, m1, p2, m2, s1, s2):
  dn, n = _separation(p1, p2)
  dist = dn[..., 0] - (s1[..., 0] + s2[..., 0])
  return [(dist, p1 + n * (s1[..., 0] + 0.5 * dist)[..., None], n)]


def _closest_on_segment(p, a, axis, half):
  t = torch.maximum(torch.minimum(math.dot(p - a, axis), half), -half)
  return a + t[..., None] * axis


def _sphere_capsule(p1, m1, p2, m2, s1, s2):
  seg = _closest_on_segment(p1, p2, m2[..., :, 2], s2[..., 1])
  dn, n = _separation(p1, seg)
  dist = dn[..., 0] - (s1[..., 0] + s2[..., 0])
  return [(dist, p1 + n * (s1[..., 0] + 0.5 * dist)[..., None], n)]


def _capsule_capsule(p1, m1, p2, m2, s1, s2):
  a1, u1, h1 = p1, m1[..., :, 2], s1[..., 1]
  a2, u2, h2 = p2, m2[..., :, 2], s2[..., 1]
  r = a2 - a1
  uu = math.dot(u1, u2)
  ru1 = math.dot(r, u1)
  ru2 = math.dot(r, u2)
  det = 1.0 - uu * uu
  safe_det = torch.clamp(det, min=1e-9)
  t1 = _clip((ru1 - uu * ru2) / safe_det, h1)
  t2 = _clip(math.dot(a1 + t1[..., None] * u1 - a2, u2), h2)
  t1 = _clip(math.dot(a2 + t2[..., None] * u2 - a1, u1), h1)
  c1 = a1 + t1[..., None] * u1
  c2 = a2 + t2[..., None] * u2
  dn, n = _separation(c1, c2)
  dist = dn[..., 0] - (s1[..., 0] + s2[..., 0])
  return [(dist, c1 + n * (s1[..., 0] + 0.5 * dist)[..., None], n)]


def _sphere_box_point(center, radius, bp, bm, bsize):
  local = math.mat_tvec(bm, center - bp)
  clamped = torch.maximum(torch.minimum(local, bsize), -bsize)
  inside = torch.all(torch.abs(local) < bsize, dim=-1)
  face_dist = bsize - torch.abs(local)
  k = torch.argmin(face_dist, dim=-1)
  onehot = k[..., None] == torch.arange(3, device=k.device)
  sgn = torch.sign(local)
  push = torch.where(onehot, sgn * bsize, torch.zeros_like(local))
  surf_inside = torch.where(onehot, push, local)
  surf = torch.where(inside[..., None], surf_inside, clamped)
  world = bp + math.mat_vec(bm, surf)
  dn, unit = math.safe_norm(center - world)
  dn = dn[..., 0]
  n_out = -unit
  # a centre within rounding of the chosen face axis's mid-plane has no
  # side to be pushed out of: no normal (COINCIDE)
  eps = torch.finfo(local.dtype).eps
  off = local * local > (COINCIDE * eps) ** 2 * (
      1.0 + math.dot(center, center))[..., None]
  n_in = math.mat_vec(bm, torch.where(onehot & off, -sgn,
                                      torch.zeros_like(sgn)))
  n = torch.where(inside[..., None], n_in, n_out)
  dist = torch.where(inside, -dn - radius, dn - radius)
  pos = world + (0.5 * dist)[..., None] * (-n)
  return dist, pos, n


def _sphere_box(p1, m1, p2, m2, s1, s2):
  return [_sphere_box_point(p1, s1[..., 0], p2, m2, s2)]


def _capsule_box(p1, m1, p2, m2, s1, s2):
  return [_sphere_box_point(p1 + (sgn * s1[..., 1])[..., None] * m1[..., :, 2],
                            s1[..., 0], p2, m2, s2) for sgn in (-1.0, 1.0)]


def _box_box(p1, m1, p2, m2, s1, s2):
  """Face-SAT box-box: one shared normal and the 16 corners (the JAX
  package's scheme: face axes only, corners outside the other box's
  cross-section deactivated by a lateral-overhang guard)."""
  t = p2 - p1
  axes = torch.cat([m1.transpose(-1, -2), m2.transpose(-1, -2)], dim=-2)
  r1 = torch.sum(torch.abs(axes @ m1) * s1[..., None, :], dim=-1)
  r2 = torch.sum(torch.abs(axes @ m2) * s2[..., None, :], dim=-1)
  proj = math.mat_vec(axes, t)
  sep = torch.abs(proj) - (r1 + r2)
  k = torch.argmax(sep, dim=-1)
  ax_k = torch.gather(axes, -2, k[..., None, None].expand(
      *k.shape, 1, 3))[..., 0, :]
  pr_k = torch.gather(proj, -1, k[..., None])
  n = ax_k * torch.sign(pr_k)

  def support(nv, mm, ss):
    return torch.sum(torch.abs(math.mat_tvec(mm, nv)) * ss, dim=-1)

  sup1, sup2 = support(n, m1, s1), support(n, m2, s2)
  big = 4.0 * (torch.amax(s1, dim=-1) + torch.amax(s2, dim=-1))

  def corner_points(pc, mc, sc, po, mo, so, sup_o, sgn):
    """The 8 corners of the c box against the o box's slab along n."""
    n_loc = torch.abs(math.mat_tvec(mo, n))
    slack = 0.05 * torch.amin(so, dim=-1)
    rel = _corners(pc, mc, sc) - po[..., None, :]  # (..., 8, 3)
    dist = sgn * math.dot(rel, n[..., None, :]) - sup_o[..., None]
    local = torch.matmul(rel, mo)  # each corner in o's frame
    overhang = torch.amax(
        torch.abs(local) - so[..., None, :]
        - big[..., None, None] * n_loc[..., None, :], dim=-1) - slack[
            ..., None]
    d_eff = torch.maximum(dist, overhang)
    pos = rel + po[..., None, :] - (0.5 * d_eff * sgn)[..., None] * n[
        ..., None, :]
    return [(d_eff[..., i], pos[..., i, :], n) for i in range(8)]

  return (corner_points(p2, m2, s2, p1, m1, s1, sup1, 1.0) +
          corner_points(p1, m1, s1, p2, m2, s2, sup2, -1.0))


_DISPATCH = {
    (GeomType.PLANE, GeomType.SPHERE): _plane_sphere,
    (GeomType.PLANE, GeomType.CAPSULE): _plane_capsule,
    (GeomType.PLANE, GeomType.BOX): _plane_box,
    (GeomType.PLANE, GeomType.ELLIPSOID): _plane_ellipsoid,
    (GeomType.PLANE, GeomType.CYLINDER): _plane_capsule,  # approximation
    (GeomType.SPHERE, GeomType.SPHERE): _sphere_sphere,
    (GeomType.SPHERE, GeomType.CAPSULE): _sphere_capsule,
    (GeomType.SPHERE, GeomType.BOX): _sphere_box,
    (GeomType.CAPSULE, GeomType.CAPSULE): _capsule_capsule,
    (GeomType.CAPSULE, GeomType.BOX): _capsule_box,
    (GeomType.BOX, GeomType.BOX): _box_box,
}

# ---------------------------------------------------------------------------
# convex meshes: support-function SAT over the hull-vertex clouds and face
# normals that physics/io.py builds (VCAP vertices, NCAP normals, each
# padded with copies of its first). Each mesh pair function takes its
# group's hulls as well: hull2/norm2 (P, VCAP, 3)/(P, NCAP, 3) of the mesh
# geom2, hull1/norm1 of geom1 where that is a mesh too.

_MESH_EXTRA_AXES = 13  # half-sphere fixed axes appended to the SAT set
_FIXED_AXES = {}  # the fixed axes, per (device, dtype)


def _mesh_axes_fixed(like):
  """(13, 3) golden-spiral axes over the upper half-sphere."""
  key = (like.device, like.dtype)
  if key not in _FIXED_AXES:
    i = np.arange(_MESH_EXTRA_AXES, dtype=np.float64)
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i
    z = (i + 0.5) / _MESH_EXTRA_AXES
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    _FIXED_AXES[key] = torch.as_tensor(
        np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1),
        dtype=like.dtype, device=like.device)
  return _FIXED_AXES[key]


def _mesh_world(hull, norm, p, mat):
  """(..., P, VCAP, 3) world hull vertices, (..., P, NCAP, 3) world face
  normals."""
  mt = mat.transpose(-1, -2)
  return torch.matmul(hull, mt) + p[..., None, :], torch.matmul(norm, mt)


# the grain at which vertex depths count as tied (m): 2^-30 in float64,
# 2^-17 in float32, some 10^7 and 10^2 times their rounding at a hull's
# centimetre scale
_TIE_GRAIN = {torch.float64: 2.0 ** -30, torch.float32: 2.0 ** -17}


def _deepest(depth, k: int):
  """Indices of the k smallest of depth (..., V) along its last axis, as
  jax.lax.top_k(-depth, k) picks them (ties to the lowest index), with
  depths equal to within _TIE_GRAIN counted as ties: the vertices of a
  hull face square to an axis tie exactly, but their computed depths
  differ by rounding, which the device's matmul decides."""
  grain = _TIE_GRAIN[depth.dtype]
  return torch.sort(torch.round(depth / grain), dim=-1,
                    stable=True).indices[..., :k]


def _take(x, idx):
  """x (..., V, 3) at idx (..., k) -> (..., k, 3)."""
  return torch.take_along_dim(x, idx[..., None], dim=-2)


def _sat_contacts(v1, axes1, v2, axes2, c1, c2, k: int, inflate1=0.0):
  """The k deepest vertices of cloud v2 (..., V2, 3) against cloud v1
  (..., V1, 3), inflated by inflate1 (...,), along the least-penetrating
  axis of the face axes axes1, axes2, the centre direction c1 -> c2 and
  the fixed axes; each axis oriented hull1 -> hull2."""
  _, cdir = math.safe_norm(c2 - c1)
  lead = cdir.shape[:-1]
  fixed = _mesh_axes_fixed(cdir)
  axes = torch.cat([axes1.expand(lead + axes1.shape[-2:]),
                    axes2.expand(lead + axes2.shape[-2:]),
                    cdir[..., None, :],
                    fixed.expand(lead + fixed.shape)], dim=-2)  # (..., K, 3)
  sgn = torch.where(math.dot(axes, cdir[..., None, :]) >= 0, 1.0, -1.0)
  axes = axes * sgn.to(axes.dtype)[..., None]
  at = axes.transpose(-1, -2)
  sep = (torch.amin(torch.matmul(v2, at), dim=-2) -
         torch.amax(torch.matmul(v1, at), dim=-2) -
         (inflate1[..., None] if torch.is_tensor(inflate1) else inflate1))
  best = torch.argmax(sep, dim=-1)
  axis = _take(axes, best[..., None])[..., 0, :]
  hi1 = torch.amax(math.dot(v1, axis[..., None, :]), dim=-1) + inflate1
  depth2 = math.dot(v2, axis[..., None, :])  # (..., V2)
  idx = _deepest(depth2, k)
  pts = _take(v2, idx)
  dist = torch.take_along_dim(depth2, idx, dim=-1) - hi1[..., None]
  pos = pts - (0.5 * torch.clamp(dist, max=0.0))[..., None] * axis[
      ..., None, :]
  return [(dist[..., j], pos[..., j, :], axis) for j in range(k)]


def _plane_mesh(pp, pm, mp, mm, psize, msize, hull2, norm2):
  """The 4 deepest hull vertices against the plane."""
  n = pm[..., :, 2]
  v, _ = _mesh_world(hull2, norm2, mp, mm)
  h = math.dot(v - pp[..., None, :], n[..., None, :])  # (..., VCAP)
  idx = _deepest(h, 4)
  hk = torch.take_along_dim(h, idx, dim=-1)
  pos = _take(v, idx) - (0.5 * torch.clamp(hk, max=0.0))[..., None] * n[
      ..., None, :]
  return [(hk[..., j], pos[..., j, :], n) for j in range(4)]


def _no_axes(p):
  return p.new_zeros((0, 3))


def _sphere_mesh(sp, sm, mp, mm, ssize, msize, hull2, norm2):
  v2, n2 = _mesh_world(hull2, norm2, mp, mm)
  return _sat_contacts(sp[..., None, :], _no_axes(sp), v2, n2, sp,
                       torch.mean(v2, dim=-2), k=1, inflate1=ssize[..., 0])


def _capsule_mesh(cp, cm, mp, mm, csize, msize, hull2, norm2):
  axis = cm[..., :, 2]
  half = csize[..., 1][..., None]
  ends = torch.stack([cp + half * axis, cp - half * axis], dim=-2)
  v2, n2 = _mesh_world(hull2, norm2, mp, mm)
  return _sat_contacts(ends, _no_axes(cp), v2, n2, cp,
                       torch.mean(v2, dim=-2), k=2, inflate1=csize[..., 0])


def _box_mesh(bp, bm, mp, mm, bsize, msize, hull2, norm2):
  v2, n2 = _mesh_world(hull2, norm2, mp, mm)
  return _sat_contacts(_corners(bp, bm, bsize), bm.transpose(-1, -2), v2,
                       n2, bp, torch.mean(v2, dim=-2), k=4)


def _mesh_mesh(p1, m1, p2, m2, s1, s2, hull1, norm1, hull2, norm2):
  v1, n1 = _mesh_world(hull1, norm1, p1, m1)
  v2, n2 = _mesh_world(hull2, norm2, p2, m2)
  return _sat_contacts(v1, n1, v2, n2, torch.mean(v1, dim=-2),
                       torch.mean(v2, dim=-2), k=4)


_MESH_DISPATCH = {GeomType.PLANE: _plane_mesh, GeomType.SPHERE: _sphere_mesh,
                  GeomType.CAPSULE: _capsule_mesh, GeomType.BOX: _box_mesh,
                  GeomType.MESH: _mesh_mesh}

_MESH_COUNTS = {GeomType.PLANE: 4, GeomType.SPHERE: 1, GeomType.CAPSULE: 2,
                GeomType.BOX: 4, GeomType.MESH: 4}


# ---------------------------------------------------------------------------
# heightfields: each point a sphere against the local plane of the field's
# bilinear surface (field 0, its heights scaled by physics/io.py). Each
# heightfield pair function takes the field (nrow, ncol) and its size (4,).


def hfield_sample(field, hsize, x, y):
  """Bilinear height and its x and y gradients of the field at local
  (x, y), elementwise over any shape. A coordinate at the far edge (the
  clip bound nc - 1 - 1e-6 rounds to nc - 1 in float32) gathers its
  neighbour clamped to the last row or column, as JAX's gather does."""
  nr, nc = field.shape
  rx, ry = hsize[0], hsize[1]
  zero = x.new_zeros(())
  fx = math.clip((x + rx) / (2.0 * rx) * (nc - 1), zero,
                 x.new_full((), nc - 1 - 1e-6))
  fy = math.clip((y + ry) / (2.0 * ry) * (nr - 1), zero,
                 x.new_full((), nr - 1 - 1e-6))
  ix = torch.floor(fx).to(torch.int64)
  iy = torch.floor(fy).to(torch.int64)
  tx, ty = fx - ix.to(fx.dtype), fy - iy.to(fy.dtype)
  ix1 = torch.clamp(ix + 1, max=nc - 1)
  iy1 = torch.clamp(iy + 1, max=nr - 1)
  h00, h01 = field[iy, ix], field[iy, ix1]
  h10, h11 = field[iy1, ix], field[iy1, ix1]
  h = (h00 * (1 - tx) * (1 - ty) + h01 * tx * (1 - ty) +
       h10 * (1 - tx) * ty + h11 * tx * ty)
  dhdx = ((h01 - h00) * (1 - ty) + (h11 - h10) * ty) * (nc - 1) / (2.0 * rx)
  dhdy = ((h10 - h00) * (1 - tx) + (h11 - h01) * tx) * (nr - 1) / (2.0 * ry)
  return h, dhdx, dhdy


def _hfield_point(field, hsize, hp, hm, point, radius):
  """A sphere (point, radius) against the field's local plane; the
  normal points from the field into the other geom."""
  local = math.mat_tvec(hm, point - hp)
  h, gx, gy = hfield_sample(field, hsize, local[..., 0], local[..., 1])
  n_local = torch.stack([-gx, -gy, torch.ones_like(gx)], dim=-1)
  n_local = n_local / torch.linalg.vector_norm(n_local, dim=-1,
                                               keepdim=True)
  dist = (local[..., 2] - h) * n_local[..., 2] - radius
  n = math.mat_vec(hm, n_local)
  return dist, point - n * (radius + 0.5 * dist)[..., None], n


def _hfield_points(field, hsize, hp, hm, points, radius):
  """_hfield_point over the K points (..., K, 3) of each geom at once
  (radius (..., K)): a list of K (dist, pos, normal)."""
  dist, pos, n = _hfield_point(field, hsize, hp[..., None, :],
                               hm[..., None, :, :], points, radius)
  return [(dist[..., i], pos[..., i, :], n[..., i, :])
          for i in range(points.shape[-2])]


def _hfield_sphere(hp, hm, sp, sm, hs, ssize, field, hsize):
  return [_hfield_point(field, hsize, hp, hm, sp, ssize[..., 0])]


def _hfield_capsule(hp, hm, cp, cm, hs, csize, field, hsize):
  ends = torch.stack([cp + (sgn * csize[..., 1])[..., None] * cm[..., :, 2]
                      for sgn in (-1.0, 1.0)], dim=-2)
  return _hfield_points(field, hsize, hp, hm, ends,
                        csize[..., 0, None].expand(ends.shape[:-1]))


def _hfield_box(hp, hm, bp, bm, hs, bsize, field, hsize):
  corners = _corners(bp, bm, bsize)
  return _hfield_points(field, hsize, hp, hm, corners,
                        corners.new_zeros(corners.shape[:-1]))


_HFIELD_DISPATCH = {GeomType.SPHERE: _hfield_sphere,
                    GeomType.CAPSULE: _hfield_capsule,
                    GeomType.BOX: _hfield_box}


def _pair_fn(t1, t2):
  """The group function of a pair of geom types (t1 <= t2)."""
  if t2 == GeomType.MESH:
    return _MESH_DISPATCH[t1]
  if t1 == GeomType.HFIELD:
    return _HFIELD_DISPATCH[t2]
  return _DISPATCH[(t1, t2)]


def _group_arrays(m: Model, fn, g1, g2, dtype):
  """The model arrays a group function takes beyond the geoms' poses and
  sizes: the mesh hulls, or the heightfield."""
  if fn in _HFIELD_DISPATCH.values():
    return {"field": m.hfield_data.to(dtype),
            "hsize": m.hfield_size.to(dtype)}
  out = {}
  if fn in _MESH_DISPATCH.values():
    sides = (("1", g1), ("2", g2)) if fn is _mesh_mesh else (("2", g2),)
    for side, geoms in sides:
      mid = torch.as_tensor([m.geom_dataid[g] for g in geoms],
                            device=m.device)
      out["hull" + side] = m.mesh_hullvert.to(dtype)[mid]
      out["norm" + side] = m.mesh_facenorm.to(dtype)[mid]
  return out


def pair_slots(m: Model):
  """Static (slot_start, slot_count) of each candidate pair in the
  Contact arrays, in m.collision_pairs order (the JAX layout, mesh and
  heightfield pairs included)."""
  slots = []
  start = 0
  for g1, g2 in m.collision_pairs:
    t1, t2 = GeomType(m.geom_type[g1]), GeomType(m.geom_type[g2])
    if t1 in (GeomType.PLANE, GeomType.HFIELD) and t2 == GeomType.BOX:
      count = 8
    elif t1 == GeomType.BOX and t2 == GeomType.BOX:
      count = 16
    elif t1 in (GeomType.PLANE, GeomType.HFIELD) and t2 in (
        GeomType.CAPSULE, GeomType.CYLINDER):
      count = 2
    elif t1 == GeomType.CAPSULE and t2 == GeomType.BOX:
      count = 2
    elif t2 == GeomType.MESH:
      count = _MESH_COUNTS[t1]
    else:
      count = 1
    slots.append((start, count))
    start += count
  return tuple(slots)


def npoints(m: Model) -> int:
  """Total static contact-point count of the candidate pairs."""
  slots = pair_slots(m)
  return slots[-1][0] + slots[-1][1] if slots else 0


def point_condims(m: Model):
  """condim of every contact point (the max of its geoms')."""
  out = []
  for (start, count), (g1, g2) in zip(pair_slots(m), m.collision_pairs):
    out.extend([max(m.geom_condim[g1], m.geom_condim[g2])] * count)
  return tuple(out)


def angular_points(m: Model):
  """(torsion points, rolling points): the point indices of condim >= 4
  and condim 6 pairs, which add torsional and rolling rows."""
  tor, rol = [], []
  for (start, count), (g1, g2) in zip(pair_slots(m), m.collision_pairs):
    condim = max(m.geom_condim[g1], m.geom_condim[g2])
    for i in range(start, start + count):
      if condim >= 4:
        tor.append(i)
      if condim >= 6:
        rol.append(i)
  return tuple(tor), tuple(rol)


def geom_pair_slots(m: Model, ga: int, gb: int):
  """(slot_start, slot_count, sign) of the candidate pair {ga, gb}: sign
  +1 where normals point ga -> gb, -1 where the pair is stored flipped."""
  slots = pair_slots(m)
  for i, (g1, g2) in enumerate(m.collision_pairs):
    if (g1, g2) == (ga, gb):
      return slots[i] + (1.0,)
    if (g1, g2) == (gb, ga):
      return slots[i] + (-1.0,)
  raise KeyError(f"geom pair ({ga}, {gb}) is not a collision candidate")


def point_pairs(m: Model) -> tuple:
  """The (g1, g2) geom pair of every contact point."""
  out = []
  for (start, count), pair in zip(pair_slots(m), m.collision_pairs):
    out.extend([tuple(pair)] * count)
  return tuple(out)


def _point_constants(m: Model, dtype):
  """Per-point friction, torsion, roll, solref, solimp, margin, geom1 and
  geom2, from the model's pair parameters."""
  fr = m.geom_friction.to(dtype)
  sr, si = m.geom_solref.to(dtype), m.geom_solimp.to(dtype)
  mg = m.geom_margin.to(dtype)
  cols = {k: [] for k in ("friction", "torsion", "roll", "solref", "solimp",
                          "margin")}
  g1s, g2s = [], []
  for (start, count), (g1, g2) in zip(pair_slots(m), m.collision_pairs):
    vals = {"friction": torch.maximum(fr[g1, 0], fr[g2, 0]),
            "torsion": torch.maximum(fr[g1, 1], fr[g2, 1]),
            "roll": torch.maximum(fr[g1, 2], fr[g2, 2]),
            "solref": 0.5 * (sr[g1] + sr[g2]),
            "solimp": 0.5 * (si[g1] + si[g2]),
            "margin": torch.maximum(mg[g1], mg[g2])}
    for k, v in vals.items():
      cols[k].extend([v] * count)
    g1s.extend([g1] * count)
    g2s.extend([g2] * count)
  out = {k: torch.stack(v) for k, v in cols.items()}
  out["geom1"] = torch.as_tensor(g1s, dtype=torch.int32, device=m.device)
  out["geom2"] = torch.as_tensor(g2s, dtype=torch.int32, device=m.device)
  return out


def _groups(m: Model):
  """The candidate pairs grouped by pair function: (function, geom1 ids,
  geom2 ids) per group, in first-seen order, and for every contact point
  in slot order its index in the groups' concatenated points (each group
  pair-major)."""
  order, members = [], {}
  for i, (g1, g2) in enumerate(m.collision_pairs):
    fn = _pair_fn(GeomType(m.geom_type[g1]), GeomType(m.geom_type[g2]))
    if fn not in members:
      order.append(fn)
      members[fn] = []
    members[fn].append(i)
  slots = pair_slots(m)
  perm = [0] * npoints(m)
  base = 0
  groups = []
  for fn in order:
    idx = members[fn]
    count = slots[idx[0]][1]
    for p, i in enumerate(idx):
      for k in range(count):
        perm[slots[i][0] + k] = base + p * count + k
    base += len(idx) * count
    groups.append((fn, [m.collision_pairs[i][0] for i in idx],
                   [m.collision_pairs[i][1] for i in idx]))
  return groups, perm


def collide(m: Model, d: Data) -> Data:
  """Evaluate every candidate pair, one call per pair kind over all its
  pairs; Data with the dense Contact arrays (slot order)."""
  if not m.collision_pairs:
    return d  # make_data's inactive placeholder
  dtype = d.qpos.dtype
  batch = d.qpos.shape[:-1]
  groups, perm = m.const("collide_groups", lambda: _groups(m))
  size = m.geom_size.to(dtype)
  dists, poss, normals = [], [], []
  for gi, (fn, g1, g2) in enumerate(groups):
    i1 = m.const(("collide_g1", gi), lambda: torch.as_tensor(
        g1, device=m.device))
    i2 = m.const(("collide_g2", gi), lambda: torch.as_tensor(
        g2, device=m.device))
    arrays = m.const(("collide_arrays", gi, dtype),
                     lambda: _group_arrays(m, fn, g1, g2, dtype))
    pts = fn(d.geom_xpos[..., i1, :], d.geom_xmat[..., i1, :, :],
             d.geom_xpos[..., i2, :], d.geom_xmat[..., i2, :, :], size[i1],
             size[i2], **arrays)
    # (..., P, K) and (..., P, K, 3), pair-major
    npair = len(g1)
    dists.append(torch.stack([x[0].expand(batch + (npair,)) for x in pts],
                             dim=-1).reshape(batch + (-1,)))
    poss.append(torch.stack([x[1].expand(batch + (npair, 3)) for x in pts],
                            dim=-2).reshape(batch + (-1, 3)))
    normals.append(torch.stack([x[2].expand(batch + (npair, 3))
                                for x in pts], dim=-2).reshape(
                                    batch + (-1, 3)))
  order = m.const("collide_perm", lambda: torch.as_tensor(
      perm, device=m.device))
  dist = torch.cat(dists, dim=-1)[..., order]
  pos = torch.cat(poss, dim=-2)[..., order, :]
  normal = torch.cat(normals, dim=-2)[..., order, :]
  c = m.const(("contact_consts", dtype), lambda: _point_constants(m, dtype))
  npt = dist.shape[-1]

  def per_point(x):
    return x.expand(batch + x.shape)

  contact = Contact(
      dist=dist - c["margin"],
      pos=pos,
      frame=_frame_from_normal(normal),
      friction=per_point(c["friction"]),
      torsion=per_point(c["torsion"]),
      roll=per_point(c["roll"]),
      solref=per_point(c["solref"]),
      solimp=per_point(c["solimp"]),
      geom1=per_point(c["geom1"]),
      geom2=per_point(c["geom2"]),
      force=normal.new_zeros(batch + (npt, 3)),
      pairs=m.const("point_pairs", lambda: point_pairs(m)))
  return d.replace(contact=contact)
