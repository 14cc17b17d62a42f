"""Ray-primitive intersection: vectorized closest-hit.

The reference's ``World::hit`` is a scalar linear scan with a running-closest
bound (``/root/reference/raytracer/src/common.rs:237-258``), calling
``Sphere::hit`` (half-b quadratic, common.rs:60-98) and
``Triangle::intersect`` (plane + 3 edge tests, common.rs:124-166) one
primitive at a time.  Here the same mathematics is a broadcast ray x primitive
computation with a masked argmin — the running-closest semantics collapse to
"global min with first-index tie-break", which is provably identical for the
reference's strict/non-strict comparison mix (spheres: strict, first wins;
triangles beat spheres at exactly-equal t because common.rs:142 accepts
``t == t_max``).

Two formulations are provided:

* ``*_batch`` — the fast wavefront path.  Triangle edge tests use the scalar
  triple-product identity ``n . (e x (p - v)) == (p - v) . (n x e)`` so every
  per-(ray, primitive) quantity is a rank-2 [B, P] array built from [B, 3] x
  [3, P] contractions (K=3) — no [B, P, 3] intermediates are materialized.

* ``*_exact`` — per-ray ops in the reference's exact arithmetic order (cross
  products materialized), used by the sequential parity renderer for
  bit-identical golden comparisons.

Everything is differentiable: guarded sqrt/div (the "double where" pattern)
keeps NaNs out of both the primal and the cotangent paths.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from . import maths
from .scene import Scene, triangle_normals

INF = jnp.float32(jnp.inf)
T_MIN = jnp.float32(0.001)  # shadow-acne epsilon, common.rs:242,250


def contract3(a, b_t):
    """[B, 3] x [3, P] -> [B, P] contraction as three explicit broadcast
    multiply-adds.

    NOT a jnp.dot on purpose: a float32 dot on the GPU may run in TF32 by
    default, which keeps ~3 decimal digits — enough to shift intersection t
    by 1e-3 and visibly corrupt the image.  Three f32 multiply-adds keep full
    precision, fuse with their consumers, and for K=3 cost no more than a
    matrix unit would.
    """
    return (a[:, 0:1] * b_t[0][None, :]
            + a[:, 1:2] * b_t[1][None, :]
            + a[:, 2:3] * b_t[2][None, :])


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HitRecord:
    """Batched HitRecord (common.rs:42-47) plus a hit mask."""
    t: jax.Array          # [B] f32, inf when no hit
    position: jax.Array   # [B, 3]
    normal: jax.Array     # [B, 3] unit
    mat: jax.Array        # [B] int32 material index
    hit: jax.Array        # [B] bool


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ScenePack:
    """Derived per-primitive constants for the fast path.

    Built with plain jnp ops from Scene arrays so gradients flow through to
    sphere centers/radii and triangle vertices.
    """
    # spheres
    center_t: jax.Array     # [3, S] — transposed for [B,3]x[3,S] contractions
    center_sq_minus_r2: jax.Array  # [S] = |c|^2 - r^2
    # triangles
    n_t: jax.Array          # [3, T] unnormalized plane normal (common.rs:131-133)
    d: jax.Array            # [T] = n . v0 (common.rs:140)
    g0_t: jax.Array         # [3, T] = n x e0   (edge-test constants)
    g1_t: jax.Array         # [3, T] = n x e1
    g2_t: jax.Array         # [3, T] = n x e2
    v0g0: jax.Array         # [T] = v0 . g0
    v1g1: jax.Array         # [T] = v1 . g1
    v2g2: jax.Array         # [T] = v2 . g2
    unit_normal: jax.Array  # [T, 3] — Triangle::new normal (common.rs:116-123)


def pack_scene(scene: Scene) -> ScenePack:
    c = scene.sphere_center
    r = scene.sphere_radius
    v0, v1, v2 = scene.tri_v0, scene.tri_v1, scene.tri_v2
    e0 = v1 - v0
    e1 = v2 - v1
    e2 = v0 - v2
    n = maths.cross(v1 - v0, v2 - v0)
    return ScenePack(
        center_t=c.T,
        center_sq_minus_r2=jnp.sum(c * c, axis=-1) - r * r,
        n_t=n.T,
        d=maths.dot(n, v0),
        g0_t=maths.cross(n, e0).T,
        g1_t=maths.cross(n, e1).T,
        g2_t=maths.cross(n, e2).T,
        v0g0=maths.dot(v0, maths.cross(n, e0)),
        v1g1=maths.dot(v1, maths.cross(n, e1)),
        v2g2=maths.dot(v2, maths.cross(n, e2)),
        unit_normal=triangle_normals(scene),
    )


# ---------------------------------------------------------------------------
# Fast batch path
# ---------------------------------------------------------------------------

def sphere_hits_batch(origin, direction, scene: Scene, pack: ScenePack,
                      t_min=T_MIN) -> Tuple[jax.Array, jax.Array]:
    """Closest sphere per ray.  Returns (t [B] — inf if none, index [B]).

    Half-b quadratic with a == 1 exactly: the reference evaluates
    ``ray.direction.length_squared()`` on an NVec3, which is hardcoded to 1.0
    (maths.rs:127-128), so no division by a is performed here either.
    """
    # half_b = oc . d = o.d - c.d ;  c(B,S) contractions are K=3 matmuls
    od = maths.dot(origin, direction)                       # [B]
    cd = contract3(direction, pack.center_t)                          # [B, S]
    half_b = od[:, None] - cd
    oo = maths.dot(origin, origin)                          # [B]
    oc_c = contract3(origin, pack.center_t)                           # [B, S]
    c = oo[:, None] - 2.0 * oc_c + pack.center_sq_minus_r2[None, :]
    disc = half_b * half_b - c
    has_root = disc >= 0.0
    # guard value must be POSITIVE: sqrt'(0) = inf would leak NaN into
    # the cotangents of masked lanes (inf * 0 upstream zero)
    sq = maths.safe_sqrt(jnp.where(has_root, disc, 1.0))
    root1 = -half_b - sq
    root2 = -half_b + sq
    # min root in the open interval (t_min, inf): root1 <= root2 always,
    # so pick root1 when admissible else root2 (common.rs:88-92)
    t = jnp.where(root1 > t_min, root1, jnp.where(root2 > t_min, root2, INF))
    t = jnp.where(has_root & scene.sphere_valid[None, :], t, INF)
    idx = jnp.argmin(t, axis=-1)
    t_best = jnp.take_along_axis(t, idx[:, None], axis=-1)[:, 0]
    return t_best, idx


def triangle_hits_batch(origin, direction, scene: Scene, pack: ScenePack,
                        t_min=T_MIN, parity_plane_sign: bool = True
                        ) -> Tuple[jax.Array, jax.Array]:
    """Closest triangle per ray.  Returns (t [B] — inf if none, index [B]).

    Plane equation with the reference's sign quirk when
    ``parity_plane_sign`` (t = (n.o + d)/(n.dir), common.rs:140-141 — correct
    only for origins at/near 0); otherwise the standard (d - n.o)/(n.dir).

    Edge tests via the triple-product constants from pack_scene: the
    reference's ``n . (e_k x (p - v_k)) < 0 -> reject`` (common.rs:147-163)
    becomes ``o.g_k + t (d.g_k) - v_k.g_k < 0``.
    """
    no = contract3(origin, pack.n_t)                                  # [B, T]
    nd = contract3(direction, pack.n_t)                               # [B, T]
    parallel = jnp.abs(nd) < 1e-8                           # is_zero, common.rs:135-138
    nd_safe = jnp.where(parallel, 1.0, nd)
    if parity_plane_sign:
        t = (no + pack.d[None, :]) / nd_safe
    else:
        t = (pack.d[None, :] - no) / nd_safe
    ok = (~parallel) & (t >= t_min)                         # non-strict, common.rs:142

    og0 = contract3(origin, pack.g0_t)
    dg0 = contract3(direction, pack.g0_t)
    og1 = contract3(origin, pack.g1_t)
    dg1 = contract3(direction, pack.g1_t)
    og2 = contract3(origin, pack.g2_t)
    dg2 = contract3(direction, pack.g2_t)
    ok &= (og0 + t * dg0 - pack.v0g0[None, :]) >= 0.0
    ok &= (og1 + t * dg1 - pack.v1g1[None, :]) >= 0.0
    ok &= (og2 + t * dg2 - pack.v2g2[None, :]) >= 0.0
    ok &= scene.tri_valid[None, :]

    t = jnp.where(ok, t, INF)
    idx = jnp.argmin(t, axis=-1)
    t_best = jnp.take_along_axis(t, idx[:, None], axis=-1)[:, 0]
    return t_best, idx


def closest_hit_batch_argmin(origin, direction, scene: Scene, pack: ScenePack,
                             t_min=T_MIN, parity_plane_sign: bool = True
                             ) -> HitRecord:
    """World::hit via broadcast [B, S] + argmin + gather.

    Kept as the reference formulation for testing; ``closest_hit_batch``
    (the scan-with-select version below) is the production path: it needs
    no post-argmin gathers.
    """
    ts, si = sphere_hits_batch(origin, direction, scene, pack, t_min)
    tt, ti = triangle_hits_batch(origin, direction, scene, pack, t_min,
                                 parity_plane_sign)
    tri_wins = tt <= ts
    t = jnp.where(tri_wins, tt, ts)
    hit = jnp.isfinite(t)
    t_safe = jnp.where(hit, t, 0.0)
    position = origin + t_safe[:, None] * direction

    # sphere normal: ((p - c) / r).normalize() (common.rs:94-95)
    cen = scene.sphere_center[si]
    rad = scene.sphere_radius[si][:, None]
    sph_raw = (position - cen) / jnp.where(rad == 0.0, 1.0, rad)
    ln = maths.safe_sqrt(jnp.sum(sph_raw * sph_raw, axis=-1, keepdims=True))
    sph_n = sph_raw / jnp.where(ln == 0.0, 1.0, ln)
    tri_n = pack.unit_normal[ti]
    normal = jnp.where(tri_wins[:, None], tri_n, sph_n)

    mat = jnp.where(tri_wins, scene.tri_mat[ti], scene.sphere_mat[si])
    return HitRecord(t=t, position=position, normal=normal,
                     mat=mat.astype(jnp.int32), hit=hit)


def closest_hit_batch(origin, direction, scene: Scene, pack: ScenePack,
                      t_min=T_MIN, parity_plane_sign: bool = True) -> HitRecord:
    """World::hit (common.rs:237-258) over the whole wavefront,
    scan-with-select formulation.

    Walks primitives with a lax.scan whose carry is [B]-shaped planes
    (running best t + the winning primitive's attributes selected in place)
    — every array keeps the ray batch in the minor dimension and no
    gathers are emitted.  Mirrors the Pallas kernel's loop
    structure; same semantics as the argmin version: spheres first-of-equals
    wins (strict <), triangles beat spheres at equal t (<=), later triangle
    beats earlier at exactly-equal t (measure-zero deviation from the
    reference's first-wins, as in the kernel).

    Differentiable: the scan is reverse-mode differentiable and the select
    planes route cotangents to the winning primitive only.
    """
    B = origin.shape[0]
    ox, oy, oz = origin[:, 0], origin[:, 1], origin[:, 2]
    dx, dy, dz = direction[:, 0], direction[:, 1], direction[:, 2]

    t_best = jnp.full((B,), INF)
    nx = jnp.zeros((B,))
    ny = jnp.zeros((B,))
    nz = jnp.ones((B,))
    sg = jnp.ones((B,))
    mat = jnp.zeros((B,), jnp.int32)

    def sphere_step(carry, xs):
        t_best, nx, ny, nz, sg, mat = carry
        c, r, m, valid = xs
        ocx = ox - c[0]
        ocy = oy - c[1]
        ocz = oz - c[2]
        half_b = ocx * dx + ocy * dy + ocz * dz
        cc = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = half_b * half_b - cc
        ok = disc >= 0.0
        sq = maths.safe_sqrt(jnp.where(ok, disc, 1.0))
        root1 = -half_b - sq
        root2 = -half_b + sq
        t = jnp.where(root1 > t_min, root1,
                      jnp.where(root2 > t_min, root2, INF))
        t = jnp.where(ok & valid, t, INF)
        better = t < t_best
        t_safe = jnp.where(better, t, 0.0)
        # normal direction from center (normalized below, after the scan,
        # using the winning center stored componentwise)
        t_best = jnp.where(better, t, t_best)
        nx = jnp.where(better, c[0], nx)
        ny = jnp.where(better, c[1], ny)
        nz = jnp.where(better, c[2], nz)
        sg = jnp.where(better, jnp.where(r < 0.0, -1.0, 1.0), sg)
        mat = jnp.where(better, m, mat)
        return (t_best, nx, ny, nz, sg, mat), None

    (t_best, cx, cy, cz, sg, mat), _ = jax.lax.scan(
        sphere_step, (t_best, nx, ny, nz, sg, mat),
        (scene.sphere_center, scene.sphere_radius,
         scene.sphere_mat, scene.sphere_valid))

    sphere_hit = jnp.isfinite(t_best)
    ts_safe = jnp.where(sphere_hit, t_best, 0.0)
    # sphere normal ((p - c)/r).normalize() (common.rs:94-95): the radius
    # divide cancels in the normalization up to its SIGN — a negative radius
    # flips the normal (the RTiOW hollow-glass trick), carried in ``sg``
    snx = ox + ts_safe * dx - cx
    sny = oy + ts_safe * dy - cy
    snz = oz + ts_safe * dz - cz
    ln = maths.safe_sqrt(snx * snx + sny * sny + snz * snz)
    ln = jnp.where(ln == 0.0, 1.0, ln) * sg
    nx = snx / ln
    ny = sny / ln
    nz = snz / ln

    def tri_step(carry, xs):
        t_best, nx, ny, nz, mat = carry
        n, d, g0, g1, g2, w0, w1, w2, un, m, valid = xs
        nd = n[0] * dx + n[1] * dy + n[2] * dz
        no = n[0] * ox + n[1] * oy + n[2] * oz
        parallel = jnp.abs(nd) < 1e-8
        nd_safe = jnp.where(parallel, 1.0, nd)
        if parity_plane_sign:
            t = (no + d) / nd_safe
        else:
            t = (d - no) / nd_safe
        ok = (~parallel) & (t >= t_min) & valid
        e0 = (ox * g0[0] + oy * g0[1] + oz * g0[2]
              + t * (dx * g0[0] + dy * g0[1] + dz * g0[2]) - w0)
        ok &= e0 >= 0.0
        e1 = (ox * g1[0] + oy * g1[1] + oz * g1[2]
              + t * (dx * g1[0] + dy * g1[1] + dz * g1[2]) - w1)
        ok &= e1 >= 0.0
        e2 = (ox * g2[0] + oy * g2[1] + oz * g2[2]
              + t * (dx * g2[0] + dy * g2[1] + dz * g2[2]) - w2)
        ok &= e2 >= 0.0
        better = ok & (t <= t_best)   # triangle wins ties (common.rs:142)
        t_best = jnp.where(better, t, t_best)
        nx = jnp.where(better, un[0], nx)
        ny = jnp.where(better, un[1], ny)
        nz = jnp.where(better, un[2], nz)
        mat = jnp.where(better, m, mat)
        return (t_best, nx, ny, nz, mat), None

    if scene.num_triangles > 0:
        (t_best, nx, ny, nz, mat), _ = jax.lax.scan(
            tri_step, (t_best, nx, ny, nz, mat),
            (pack.n_t.T, pack.d, pack.g0_t.T, pack.g1_t.T, pack.g2_t.T,
             pack.v0g0, pack.v1g1, pack.v2g2, pack.unit_normal,
             scene.tri_mat, scene.tri_valid))

    hit = jnp.isfinite(t_best)
    t_safe = jnp.where(hit, t_best, 0.0)
    position = origin + t_safe[:, None] * direction
    normal = jnp.stack([nx, ny, nz], axis=-1)
    return HitRecord(t=t_best, position=position, normal=normal,
                     mat=mat.astype(jnp.int32), hit=hit)


# ---------------------------------------------------------------------------
# Exact path (sequential parity renderer) — reference arithmetic order
# ---------------------------------------------------------------------------

def closest_hit_exact(origin, direction, scene: Scene,
                      parity_plane_sign: bool = True) -> HitRecord:
    """Single-ray (shape [3]) closest hit in the reference's exact op order.

    Vectorized only across primitives (per-lane arithmetic identical to the
    scalar loop).  Returns a HitRecord of scalars (shape []).
    """
    # --- spheres: common.rs:74-97
    oc = origin[None, :] - scene.sphere_center              # [S, 3]
    half_b = jnp.sum(oc * direction[None, :], axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - scene.sphere_radius * scene.sphere_radius
    disc = half_b * half_b - c
    has_root = disc >= 0.0
    # guard value must be POSITIVE: sqrt'(0) = inf would leak NaN into
    # the cotangents of masked lanes (inf * 0 upstream zero)
    sq = maths.safe_sqrt(jnp.where(has_root, disc, 1.0))
    root1 = -half_b - sq
    root2 = -half_b + sq
    ts = jnp.where(root1 > T_MIN, root1, jnp.where(root2 > T_MIN, root2, INF))
    ts = jnp.where(has_root & scene.sphere_valid, ts, INF)
    si = jnp.argmin(ts)
    t_s = ts[si]

    # --- triangles: common.rs:131-165
    v0, v1, v2 = scene.tri_v0, scene.tri_v1, scene.tri_v2
    n = maths.cross(v1 - v0, v2 - v0)                       # [T, 3]
    cos_al = jnp.sum(n * direction[None, :], axis=-1)
    parallel = (cos_al > -1e-8) & (cos_al < 1e-8)
    cos_safe = jnp.where(parallel, 1.0, cos_al)
    d = jnp.sum(n * v0, axis=-1)
    n_dot_o = jnp.sum(n * origin[None, :], axis=-1)
    if parity_plane_sign:
        tt = (n_dot_o + d) / cos_safe
    else:
        tt = (d - n_dot_o) / cos_safe
    ok = (~parallel) & (tt >= T_MIN)
    p = origin[None, :] + tt[:, None] * direction[None, :]
    ok &= jnp.sum(n * maths.cross(v1 - v0, p - v0), axis=-1) >= 0.0
    ok &= jnp.sum(n * maths.cross(v2 - v1, p - v1), axis=-1) >= 0.0
    ok &= jnp.sum(n * maths.cross(v0 - v2, p - v2), axis=-1) >= 0.0
    ok &= scene.tri_valid
    tt = jnp.where(ok, tt, INF)
    ti = jnp.argmin(tt)
    t_t = tt[ti]

    tri_wins = t_t <= t_s
    t = jnp.where(tri_wins, t_t, t_s)
    hit = jnp.isfinite(t)
    t_safe = jnp.where(hit, t, 0.0)
    position = origin + t_safe * direction

    cen = scene.sphere_center[si]
    rad = scene.sphere_radius[si]
    sph_raw = (position - cen) / jnp.where(rad == 0.0, 1.0, rad)
    ln = maths.safe_sqrt(jnp.sum(sph_raw * sph_raw))
    sph_n = sph_raw / jnp.where(ln == 0.0, 1.0, ln)
    tri_unit_n = triangle_normals(scene)[ti]
    normal = jnp.where(tri_wins, tri_unit_n, sph_n)
    mat = jnp.where(tri_wins, scene.tri_mat[ti], scene.sphere_mat[si])
    return HitRecord(t=t, position=position, normal=normal,
                     mat=mat.astype(jnp.int32), hit=hit)
