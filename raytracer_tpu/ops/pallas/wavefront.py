"""Fused path-trace kernel for the GPU: Pallas on the Triton route.

The XLA wavefront renderer (render.py) writes the whole ray state to
device memory after every bounce and intersects with one ``lax.scan`` step
per primitive, which XLA does not fuse across.  This kernel is the
standard GPU design instead: one program per block of pixels, with the
ray state of every pixel held in registers across all samples and
bounces, and the image written once.

  grid = (pixel blocks,): each block owns ``block_pixels`` consecutive
  pixels of its row band (a power of two), loops samples with
  ``fori_loop`` and bounces with a ``while_loop`` that exits as soon as
  no pixel of the block is alive.  Blocks run in parallel and in no
  order; nothing carries over between them.

  The scene stays in device memory as packed tables (spheres: (11, S) —
  center xyz, radius, r^2, material kind/albedo/fuzz/ir; triangles:
  (21, T) — plane normal, d, edge-test constants g_k and v_k.g_k,
  material), read one scalar at a time by primitive index; every thread
  of the block reads the same address, which the L1 and L2 caches serve.
  Instead of tracking a hit INDEX and gathering afterwards, the loop
  keeps the winning primitive's attributes in select planes.

  Optional cluster culling: primitives are grouped by a median split
  (``cluster_spheres`` / ``cluster_triangles``) and a cluster's members
  are visited only when some live pixel of the block can reach its
  bounding box before its current closest hit.

Semantics are the reference algorithm exactly as in render.py/_bounce_step
(common.rs:263-285 bounce rules, materials.rs:42-102 scatter rules,
common.rs:60-166 intersections, cube-sample RNG distribution) with the same
pcg3d counter streams, so the kernel agrees with the XLA path to float
rounding (different FMA contraction and division rounding).
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ... import rng
from ...camera import Camera
from ...scene import Scene

_SEED_MIX = np.uint32(0x85EBCA6B)

# pixels and warps per program (powers of two).  Measured on the H100:
# 128 pixels x 4 warps was fastest of 64..256 pixels x 2..4 warps on all
# three timed scenes (PERF.md)
BLOCK_PIXELS = 128
NUM_WARPS = 4

# sphere table rows
_SPH_CX, _SPH_CY, _SPH_CZ, _SPH_R, _SPH_R2 = 0, 1, 2, 3, 4
_SPH_KIND, _SPH_AR, _SPH_AG, _SPH_AB, _SPH_FUZZ, _SPH_IR = 5, 6, 7, 8, 9, 10
SPH_ROWS = 11

# triangle table rows.  The shading normal is NOT stored: it is the
# normalized plane normal, recovered once per bounce by _resolve_tri_normals.
# _TRI_EXTRA holds the material's fuzz (metal) or ir (dielectric) — they are
# mutually exclusive by kind, so one row serves both (materials.rs:7-12).
(_TRI_NX, _TRI_NY, _TRI_NZ, _TRI_D,
 _TRI_G0X, _TRI_G0Y, _TRI_G0Z, _TRI_W0,
 _TRI_G1X, _TRI_G1Y, _TRI_G1Z, _TRI_W1,
 _TRI_G2X, _TRI_G2Y, _TRI_G2Z, _TRI_W2,
 _TRI_KIND, _TRI_EXTRA, _TRI_AR, _TRI_AG, _TRI_AB) = range(21)
TRI_ROWS = 21

T_MIN = np.float32(0.001)
BIG = np.float32(3.0e38)


def pack_spheres(scene: Scene, perm=None) -> np.ndarray:
    """Host-side (SPH_ROWS, S) f32 table; per-sphere material flattened in.
    ``perm`` optionally reorders the columns (cluster_spheres order)."""
    c = np.asarray(scene.sphere_center, np.float32)
    r = np.asarray(scene.sphere_radius, np.float32)
    valid = np.asarray(scene.sphere_valid)
    mat = np.asarray(scene.sphere_mat)
    if perm is not None:
        c, r, valid, mat = c[perm], r[perm], valid[perm], mat[perm]
    kind = np.asarray(scene.materials.kind, np.float32)[mat]
    alb = np.asarray(scene.materials.color, np.float32)[mat]
    fuzz = np.asarray(scene.materials.fuzz, np.float32)[mat]
    ir = np.asarray(scene.materials.ir, np.float32)[mat]
    S = c.shape[0]
    out = np.zeros((SPH_ROWS, S), np.float32)
    out[_SPH_CX], out[_SPH_CY], out[_SPH_CZ] = c[:, 0], c[:, 1], c[:, 2]
    out[_SPH_R] = r
    out[_SPH_R2] = np.where(valid, r * r, -1.0)  # invalid -> r2<0 never hits
    # negative radius flips the geometric normal ((p-c)/r, common.rs:94-95,
    # the RTiOW hollow-glass trick): encoded as kind+4 so the kernel recovers
    # the sign without an extra select plane in the intersection loop
    out[_SPH_KIND] = kind + np.where(valid & (r < 0.0), 4.0, 0.0)
    out[_SPH_AR], out[_SPH_AG], out[_SPH_AB] = alb[:, 0], alb[:, 1], alb[:, 2]
    out[_SPH_FUZZ] = fuzz
    out[_SPH_IR] = ir
    # invalid spheres: push center far away AND r2<0 (the r2<0 mask is the
    # real guard; the far center keeps disc strongly negative)
    out[_SPH_CX] = np.where(valid, out[_SPH_CX], 1e9)
    return out


def pack_triangles(scene: Scene, perm=None) -> np.ndarray:
    """Host-side (TRI_ROWS, T) f32 table of precomputed plane/edge constants
    (the ScenePack quantities, intersect.py).  ``perm`` optionally reorders
    the columns (cluster_triangles order)."""
    v0 = np.asarray(scene.tri_v0, np.float64)
    v1 = np.asarray(scene.tri_v1, np.float64)
    v2 = np.asarray(scene.tri_v2, np.float64)
    valid = np.asarray(scene.tri_valid)
    mat = np.asarray(scene.tri_mat)
    if perm is not None:
        v0, v1, v2 = v0[perm], v1[perm], v2[perm]
        valid, mat = valid[perm], mat[perm]
    kind = np.asarray(scene.materials.kind, np.float32)[mat]
    alb = np.asarray(scene.materials.color, np.float32)[mat]
    fuzz = np.asarray(scene.materials.fuzz, np.float32)[mat]
    ir = np.asarray(scene.materials.ir, np.float32)[mat]
    n = np.cross(v1 - v0, v2 - v0)
    d = np.einsum("ij,ij->i", n, v0)
    g0 = np.cross(n, v1 - v0)
    g1 = np.cross(n, v2 - v1)
    g2 = np.cross(n, v0 - v2)
    w0 = np.einsum("ij,ij->i", v0, g0)
    w1 = np.einsum("ij,ij->i", v1, g1)
    w2 = np.einsum("ij,ij->i", v2, g2)
    T = v0.shape[0]
    out = np.zeros((TRI_ROWS, T), np.float32)
    out[_TRI_NX], out[_TRI_NY], out[_TRI_NZ] = n[:, 0], n[:, 1], n[:, 2]
    out[_TRI_D] = d
    out[_TRI_G0X], out[_TRI_G0Y], out[_TRI_G0Z] = g0[:, 0], g0[:, 1], g0[:, 2]
    out[_TRI_W0] = w0
    out[_TRI_G1X], out[_TRI_G1Y], out[_TRI_G1Z] = g1[:, 0], g1[:, 1], g1[:, 2]
    out[_TRI_W1] = w1
    out[_TRI_G2X], out[_TRI_G2Y], out[_TRI_G2Z] = g2[:, 0], g2[:, 1], g2[:, 2]
    out[_TRI_W2] = w2
    out[_TRI_KIND] = kind
    out[_TRI_EXTRA] = np.where(kind == 1.0, fuzz,
                               np.where(kind == 2.0, ir, 0.0))
    out[_TRI_AR], out[_TRI_AG], out[_TRI_AB] = alb[:, 0], alb[:, 1], alb[:, 2]
    # invalid triangles: zero normal -> parallel test rejects every ray
    for row in range(TRI_ROWS):
        out[row] = np.where(valid, out[row], 0.0)
    return out


def _median_split_order(points: np.ndarray, leaf_target: int):
    """BVH-style recursive median split over ``points`` [N, 3].

    Returns (perm, leaf_slices): ``perm`` reorders primitives so every leaf's
    members are contiguous; ``leaf_slices`` is a list of (start, end) into the
    permuted order.  Balanced by construction (split at the median of the
    widest axis), deterministic, host-side numpy only.
    """
    leaves: list[np.ndarray] = []

    def rec(ids: np.ndarray):
        if len(ids) <= leaf_target:
            leaves.append(ids)
            return
        pts = points[ids]
        ax = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
        order = np.argsort(pts[:, ax], kind="stable")
        h = len(ids) // 2
        rec(ids[order[:h]])
        rec(ids[order[h:]])

    rec(np.arange(len(points)))
    perm = np.concatenate(leaves) if leaves else np.arange(0)
    slices = []
    off = 0
    for leaf in leaves:
        slices.append((off, off + len(leaf)))
        off += len(leaf)
    return perm, slices


def _safe_inv_dir(dx, dy, dz):
    """Per-lane 1/d with tiny components clamped (slab test stays finite
    and conservative: an axis-parallel ray outside a slab gets a huge
    positive tnear and misses; inside, the +/-huge pair brackets it)."""
    tiny = jnp.float32(1e-20)

    def inv(v):
        mag = jnp.maximum(jnp.abs(v), tiny)
        return jnp.where(v >= 0.0, 1.0 / mag, -1.0 / mag)

    return inv(dx), inv(dy), inv(dz)


def _aabb_test(ab_ref, ci, ox, oy, oz, idx, idy, idz, t_best, alive):
    """Conservative ray x AABB slab overlap: could any live lane hit
    something inside box ``ci`` closer than its t_best?  Columns of
    ``ab_ref`` are [lox, loy, loz, hix, hiy, hiz]; empty nodes carry
    lo > hi and always miss.  Much tighter than a bounding sphere on the
    flat layouts culling actually meets (balls scattered on a ground
    plane, surface patches of a mesh)."""
    tx0 = (ab_ref[0, ci] - ox) * idx
    tx1 = (ab_ref[3, ci] - ox) * idx
    ty0 = (ab_ref[1, ci] - oy) * idy
    ty1 = (ab_ref[4, ci] - oy) * idy
    tz0 = (ab_ref[2, ci] - oz) * idz
    tz1 = (ab_ref[5, ci] - oz) * idz
    tnear = jnp.maximum(jnp.maximum(jnp.minimum(tx0, tx1),
                                    jnp.minimum(ty0, ty1)),
                        jnp.maximum(jnp.minimum(tz0, tz1), 0.0))
    tfar = jnp.minimum(jnp.minimum(jnp.maximum(tx0, tx1),
                                   jnp.maximum(ty0, ty1)),
                       jnp.maximum(tz0, tz1))
    return (tnear <= tfar) & (tfar > T_MIN) & (tnear <= t_best) & alive


def _aabb_pad_np(lo: np.ndarray, hi: np.ndarray):
    pad = 1e-4 + 1e-5 * np.maximum(np.abs(lo), np.abs(hi))
    return ((lo - pad).astype(np.float32), (hi + pad).astype(np.float32))


def cluster_spheres(scene: Scene, leaf_target: int = 48):
    """Cluster the valid spheres for block-level culling.

    Returns (perm, bounds, ranges): ``perm`` is a permutation of ALL sphere
    columns (valid members leaf-contiguous first, invalid padding last, so it
    feeds straight into ``pack_spheres(scene, perm=...)``); ``bounds`` is
    (4, C) f32 [bcx, bcy, bcz, br^2] bounding spheres; ``ranges`` is (2, C)
    int32 [start, end) member ranges in the permuted table.
    """
    c = np.asarray(scene.sphere_center, np.float64)
    r = np.asarray(scene.sphere_radius, np.float64)
    valid = np.asarray(scene.sphere_valid)
    vidx = np.nonzero(valid)[0]
    perm_v, slices = _median_split_order(c[vidx], leaf_target)
    perm = np.concatenate([vidx[perm_v], np.nonzero(~valid)[0]]).astype(
        np.int64)
    C = max(len(slices), 1)
    bounds = np.zeros((6, C), np.float32)
    bounds[0:3] = 1.0
    bounds[3:6] = -1.0
    ranges = np.zeros((2, C), np.int32)
    for k, (s, e) in enumerate(slices or [(0, 0)]):
        mem = perm[s:e]
        if len(mem) == 0:
            continue
        cm, rm = c[mem], np.abs(r[mem])[:, None]
        lo = (cm - rm).min(axis=0)
        hi = (cm + rm).max(axis=0)
        bounds[0:3, k], bounds[3:6, k] = _aabb_pad_np(lo, hi)
        ranges[0, k], ranges[1, k] = s, e
    return perm, bounds, ranges


def cluster_triangles(scene: Scene, leaf_target: int = 64):
    """Same as cluster_spheres for triangles (split on centroids, bound all
    three vertices)."""
    v0 = np.asarray(scene.tri_v0, np.float64)
    v1 = np.asarray(scene.tri_v1, np.float64)
    v2 = np.asarray(scene.tri_v2, np.float64)
    valid = np.asarray(scene.tri_valid)
    cen = (v0 + v1 + v2) / 3.0
    vidx = np.nonzero(valid)[0]
    perm_v, slices = _median_split_order(cen[vidx], leaf_target)
    perm = np.concatenate([vidx[perm_v], np.nonzero(~valid)[0]]).astype(
        np.int64)
    C = max(len(slices), 1)
    bounds = np.zeros((6, C), np.float32)
    bounds[0:3] = 1.0
    bounds[3:6] = -1.0
    ranges = np.zeros((2, C), np.int32)
    for k, (s, e) in enumerate(slices or [(0, 0)]):
        mem = perm[s:e]
        if len(mem) == 0:
            continue
        verts = np.concatenate([v0[mem], v1[mem], v2[mem]], axis=0)
        bounds[0:3, k], bounds[3:6, k] = _aabb_pad_np(
            verts.min(axis=0), verts.max(axis=0))
        ranges[0, k], ranges[1, k] = s, e
    return perm, bounds, ranges


def _sphere_loop(sph_ref, sphc_b_ref, sphc_r_ref, n_spheres, n_sph_clusters,
                 ox, oy, oz, dx, dy, dz, alive, hs0):
    """Closest-hit over the sphere table (common.rs:60-98), optionally
    with cluster culling.  hs0 = (t_best, nx, ny, nz, kind, ar, ag, ab, fz,
    irx); nx/ny/nz carry the WINNING CENTER until _sphere_normals."""

    def sph_body(si, hs):
        (t_best, nx, ny, nz, kind, ar, ag, ab, fz, irx) = hs
        cx = sph_ref[_SPH_CX, si]
        cy = sph_ref[_SPH_CY, si]
        cz = sph_ref[_SPH_CZ, si]
        r2 = sph_ref[_SPH_R2, si]
        ocx = ox - cx
        ocy = oy - cy
        ocz = oz - cz
        half_b = ocx * dx + ocy * dy + ocz * dz
        cc = ocx * ocx + ocy * ocy + ocz * ocz - r2
        disc = half_b * half_b - cc
        ok = (disc >= 0.0) & (r2 > 0.0)
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        root1 = -half_b - sq
        root2 = -half_b + sq
        t = jnp.where(root1 > T_MIN, root1,
                      jnp.where(root2 > T_MIN, root2, BIG))
        t = jnp.where(ok, t, BIG)
        better = t < t_best
        t_best = jnp.where(better, t, t_best)
        # sphere normal at p: ((p - c)/r).normalize(); defer to
        # after the loop needing (cx, cy, cz, rinv) — store those
        nx = jnp.where(better, cx, nx)
        ny = jnp.where(better, cy, ny)
        nz = jnp.where(better, cz, nz)
        kind = jnp.where(better, sph_ref[_SPH_KIND, si], kind)
        ar = jnp.where(better, sph_ref[_SPH_AR, si], ar)
        ag = jnp.where(better, sph_ref[_SPH_AG, si], ag)
        ab = jnp.where(better, sph_ref[_SPH_AB, si], ab)
        fz = jnp.where(better, sph_ref[_SPH_FUZZ, si], fz)
        irx = jnp.where(better, sph_ref[_SPH_IR, si], irx)
        return (t_best, nx, ny, nz, kind, ar, ag, ab, fz, irx)

    if n_sph_clusters > 0:
        # block-level culling: one AABB slab test over the block's rays
        # per cluster; when no live ray can beat its current closest hit,
        # the member loop runs with a zero trip count (traced bounds, no
        # cond needed)
        ivx, ivy, ivz = _safe_inv_dir(dx, dy, dz)

        def sph_cluster_body(ci, hs):
            t_best = hs[0]
            possible = _aabb_test(sphc_b_ref, ci, ox, oy, oz, ivx, ivy,
                                  ivz, t_best, alive)
            any_p = jnp.max(jnp.where(possible, 1.0, 0.0))
            s0 = jnp.where(any_p > 0.0, sphc_r_ref[0, ci], 0)
            s1 = jnp.where(any_p > 0.0, sphc_r_ref[1, ci], 0)
            return jax.lax.fori_loop(s0, s1, sph_body, hs)

        return jax.lax.fori_loop(0, n_sph_clusters, sph_cluster_body, hs0)
    return jax.lax.fori_loop(0, n_spheres, sph_body, hs0)


def _sphere_normals(ox, oy, oz, dx, dy, dz, hs):
    """Recover the sphere hit normal from the stored winning center:
    normalize(p - c), flipped for negative radii ((p-c)/r, common.rs:94-95;
    the sign rides the kind encoding, kind+4 <=> r<0)."""
    (t_best, nx, ny, nz, kind, ar, ag, ab, fz, irx) = hs
    hpx = ox + t_best * dx
    hpy = oy + t_best * dy
    hpz = oz + t_best * dz
    snx = hpx - nx
    sny = hpy - ny
    snz = hpz - nz
    slen = jnp.sqrt(snx * snx + sny * sny + snz * snz)
    slen = jnp.where(slen == 0.0, 1.0, slen)
    neg_r = kind >= 3.5
    slen = jnp.where(neg_r, -slen, slen)
    kind = jnp.where(neg_r, kind - 4.0, kind)
    nx = snx / slen
    ny = sny / slen
    nz = snz / slen
    return (t_best, nx, ny, nz, kind, ar, ag, ab, fz, irx), (hpx, hpy, hpz)


def _make_tri_body(tri_ref, parity_plane_sign, ox, oy, oz, dx, dy, dz):
    """Triangle closest-hit fori_loop body (common.rs:124-166 via edge
    constants) over the triangle table."""

    def read(row, ti):
        return tri_ref[row, ti]

    def tri_body(ti, hs):
        (t_best, nx, ny, nz, kind, ar, ag, ab, fz, irx) = hs
        tnx = read(_TRI_NX, ti)
        tny = read(_TRI_NY, ti)
        tnz = read(_TRI_NZ, ti)
        td = read(_TRI_D, ti)
        nd = tnx * dx + tny * dy + tnz * dz
        no = tnx * ox + tny * oy + tnz * oz
        par = jnp.abs(nd) < 1e-8
        nd_safe = jnp.where(par, 1.0, nd)
        if parity_plane_sign:
            t = (no + td) / nd_safe
        else:
            t = (td - no) / nd_safe
        ok = (~par) & (t >= T_MIN)
        g0x = read(_TRI_G0X, ti)
        g0y = read(_TRI_G0Y, ti)
        g0z = read(_TRI_G0Z, ti)
        e0 = (ox * g0x + oy * g0y + oz * g0z
              + t * (dx * g0x + dy * g0y + dz * g0z)
              - read(_TRI_W0, ti))
        ok &= e0 >= 0.0
        g1x = read(_TRI_G1X, ti)
        g1y = read(_TRI_G1Y, ti)
        g1z = read(_TRI_G1Z, ti)
        e1 = (ox * g1x + oy * g1y + oz * g1z
              + t * (dx * g1x + dy * g1y + dz * g1z)
              - read(_TRI_W1, ti))
        ok &= e1 >= 0.0
        g2x = read(_TRI_G2X, ti)
        g2y = read(_TRI_G2Y, ti)
        g2z = read(_TRI_G2Z, ti)
        e2 = (ox * g2x + oy * g2y + oz * g2z
              + t * (dx * g2x + dy * g2y + dz * g2z)
              - read(_TRI_W2, ti))
        ok &= e2 >= 0.0
        # triangle wins ties (<=): common.rs:142 vs World::hit
        better = ok & (t <= t_best)
        t_best = jnp.where(better, t, t_best)
        # carry the PLANE normal; kind+8 marks a triangle winner so
        # _resolve_tri_normals normalizes it once after the loop (the
        # shading normal is normalize(cross(v1-v0, v2-v0)), common.rs:121)
        nx = jnp.where(better, tnx, nx)
        ny = jnp.where(better, tny, ny)
        nz = jnp.where(better, tnz, nz)
        tkind = read(_TRI_KIND, ti)
        textra = read(_TRI_EXTRA, ti)
        kind = jnp.where(better, tkind + 8.0, kind)
        ar = jnp.where(better, read(_TRI_AR, ti), ar)
        ag = jnp.where(better, read(_TRI_AG, ti), ag)
        ab = jnp.where(better, read(_TRI_AB, ti), ab)
        # EXTRA is fuzz for metal, ir for dielectric (mutually exclusive)
        t_met = (tkind >= 0.5) & (tkind < 1.5)
        t_die = (tkind >= 1.5) & (tkind < 2.5)
        fz = jnp.where(better, jnp.where(t_met, textra, 0.0), fz)
        irx = jnp.where(better, jnp.where(t_die, textra, 1.0), irx)
        return (t_best, nx, ny, nz, kind, ar, ag, ab, fz, irx)

    return tri_body


def _resolve_tri_normals(hs):
    """Post-triangle-loop fixup: lanes whose winner is a triangle (kind+8
    marker from _make_tri_body) carry the raw PLANE normal — normalize it
    into the shading normal and strip the marker.  One normalize per
    bounce instead of 3 table rows per triangle."""
    (t_best, nx, ny, nz, kind, ar, ag, ab, fz, irx) = hs
    is_tri = kind >= 7.5
    ln = jnp.sqrt(nx * nx + ny * ny + nz * nz)
    ln = jnp.where(ln == 0.0, 1.0, ln)
    nx = jnp.where(is_tri, nx / ln, nx)
    ny = jnp.where(is_tri, ny / ln, ny)
    nz = jnp.where(is_tri, nz / ln, nz)
    kind = jnp.where(is_tri, kind - 8.0, kind)
    return (t_best, nx, ny, nz, kind, ar, ag, ab, fz, irx)


def _scatter_bookkeep(pix_u, s_u, b, ox, oy, oz, dx, dy, dz, hpx, hpy, hpz,
                      hs, tpr, tpg, tpb, rr, rg, rb, alive, seg):
    """RNG draw + material scatter (materials.rs:30-102) + bounce
    bookkeeping (common.rs:263-285).  Returns the next bounce's carry
    (minus the incremented bounce counter, added by the caller)."""
    (t_best, nx, ny, nz, kind, ar, ag, ab, fz, irx) = hs
    hit = t_best < BIG
    hpx = jnp.where(hit, hpx, ox)
    hpy = jnp.where(hit, hpy, oy)
    hpz = jnp.where(hit, hpz, oz)

    bx, by, bz = rng.pcg3d(pix_u, s_u, jnp.uint32(1 + b))
    two = jnp.float32(2.0)
    onef = jnp.float32(1.0)
    rx = rng.random_f32_from_bits24(bx) * two - onef
    ry = rng.random_f32_from_bits24(by) * two - onef
    rz = rng.random_f32_from_bits24(bz) * two - onef
    rl = jnp.sqrt(rx * rx + ry * ry + rz * rz)
    rx, ry, rz = rx / rl, ry / rl, rz / rl   # unit cube sample

    # diffuse: normal + rand (degenerate -> normal)
    sdx = nx + rx
    sdy = ny + ry
    sdz = nz + rz
    deg = ((jnp.abs(sdx) < 1e-8) & (jnp.abs(sdy) < 1e-8)
           & (jnp.abs(sdz) < 1e-8))
    sl = jnp.sqrt(sdx * sdx + sdy * sdy + sdz * sdz)
    sl = jnp.where(sl == 0.0, 1.0, sl)
    difx = jnp.where(deg, nx, sdx / sl)
    dify = jnp.where(deg, ny, sdy / sl)
    difz = jnp.where(deg, nz, sdz / sl)

    # metal: reflect + fuzz*rand; absorb below surface
    dn = dx * nx + dy * ny + dz * nz
    rfx = dx - two * dn * nx
    rfy = dy - two * dn * ny
    rfz = dz - two * dn * nz
    mx = rfx + fz * rx
    my = rfy + fz * ry
    mz = rfz + fz * rz
    met_keep = (mx * nx + my * ny + mz * nz) >= 0.0
    ml = jnp.sqrt(mx * mx + my * my + mz * mz)
    ml = jnp.where(ml == 0.0, 1.0, ml)
    metx = mx / ml
    mety = my / ml
    metz = mz / ml

    # dielectric: reference's inverted front-face rule
    inside = dn >= 0.0
    sgn = jnp.where(inside, jnp.float32(-1.0), onef)
    nex = sgn * nx
    ney = sgn * ny
    nez = sgn * nz
    ratio = jnp.where(inside, onef / irx, irx)
    cos_t = -(dx * nex + dy * ney + dz * nez)
    px = ratio * (dx + cos_t * nex)
    py = ratio * (dy + cos_t * ney)
    pz = ratio * (dz + cos_t * nez)
    pl2 = px * px + py * py + pz * pz
    para = -jnp.sqrt(jnp.abs(onef - pl2))
    qx = px + para * nex
    qy = py + para * ney
    qz = pz + para * nez
    ql = jnp.sqrt(qx * qx + qy * qy + qz * qz)
    ql = jnp.where(ql == 0.0, 1.0, ql)
    diex = qx / ql
    diey = qy / ql
    diez = qz / ql

    is_dif = kind < 0.5
    is_met = (kind >= 0.5) & (kind < 1.5)
    is_die = (kind >= 1.5) & (kind < 2.5)
    is_emi = kind >= 2.5

    scr = jnp.where(is_die, onef, ar)
    scg = jnp.where(is_die, onef, ag)
    scb = jnp.where(is_die, onef, ab)
    ndx = jnp.where(is_dif, difx,
                    jnp.where(is_met, metx,
                              jnp.where(is_die, diex, nx)))
    ndy = jnp.where(is_dif, dify,
                    jnp.where(is_met, mety,
                              jnp.where(is_die, diey, ny)))
    ndz = jnp.where(is_dif, difz,
                    jnp.where(is_met, metz,
                              jnp.where(is_die, diez, nz)))
    term = is_emi | (is_met & ~met_keep)

    # ---- bounce bookkeeping (common.rs:263-285) --------------
    miss = alive & ~hit
    terminal = alive & hit & term
    cont = alive & hit & ~term

    # sky from current direction (dir is unit; renormalize like
    # the reference does is a no-op here up to rounding)
    tsky = jnp.float32(0.5) * (dy + onef)
    skyr = onef - tsky * jnp.float32(0.5)
    skyg = onef - tsky * jnp.float32(0.3)
    skyb = onef

    rr = rr + jnp.where(miss, tpr * skyr,
                        jnp.where(terminal, tpr * scr, 0.0))
    rg = rg + jnp.where(miss, tpg * skyg,
                        jnp.where(terminal, tpg * scg, 0.0))
    rb = rb + jnp.where(miss, tpb * skyb,
                        jnp.where(terminal, tpb * scb, 0.0))
    tpr = jnp.where(cont, tpr * scr, tpr)
    tpg = jnp.where(cont, tpg * scg, tpg)
    tpb = jnp.where(cont, tpb * scb, tpb)
    ox = jnp.where(cont, hpx, ox)
    oy = jnp.where(cont, hpy, oy)
    oz = jnp.where(cont, hpz, oz)
    dx = jnp.where(cont, ndx, dx)
    dy = jnp.where(cont, ndy, dy)
    dz = jnp.where(cont, ndz, dz)
    alive_f = jnp.where(cont, 1.0, 0.0)
    return (ox, oy, oz, dx, dy, dz, tpr, tpg, tpb, rr, rg, rb, alive_f, seg)


def _pixel_setup(width, height, shard_rows, block, seed_ref):
    """Per-block pixel ids and activity.  Block ``i`` owns pixels
    ``i * block ...`` of its row band, in raster order.

    seed_ref = [seed word, row offset, row stride]: this call renders
    ``shard_rows`` global rows offset, offset + stride, offset + 2*stride,
    ... (stride = n_devices interleaves rows across the mesh; see
    parallel/sharding.py).  Pixel ids and RNG streams depend only on the
    global (row, col), so any (offset, stride) tiling is bitwise identical
    to the matching rows of a whole-image render."""
    lane = jax.lax.broadcasted_iota(jnp.int32, (block,), 0)
    p = pl.program_id(0) * block + lane
    band_row = p // width
    pcol = p - band_row * width
    row_offset = seed_ref[1].astype(jnp.int32)
    row_stride = seed_ref[2].astype(jnp.int32)
    prow = row_offset + band_row * row_stride
    # pixels past the band, or past the image, are dead from the start
    active0 = (band_row < shard_rows) & (prow < height)
    prow = jnp.minimum(prow, height - 1)
    pix_u = (prow * width + pcol).astype(jnp.uint32) + seed_ref[0]
    return (active0, prow.astype(jnp.float32), pcol.astype(jnp.float32),
            pix_u)


def _make_kernel(width, height, spp, depth, n_spheres, n_tris, block,
                 parity_plane_sign, n_sph_clusters, n_tri_clusters,
                 shard_rows):
    inv_w1 = np.float32(width - 1)
    inv_h1 = np.float32(height - 1)

    def kernel(cam_ref, seed_ref, sph_ref, sphc_b_ref, sphc_r_ref, tri_ref,
               tric_b_ref, tric_r_ref, out_r, out_g, out_b, out_seg):
        active0, prow_f, pcol_f, pix_u = _pixel_setup(
            width, height, shard_rows, block, seed_ref)

        ox0 = cam_ref[0]
        oy0 = cam_ref[1]
        oz0 = cam_ref[2]
        llcx, llcy, llcz = cam_ref[3], cam_ref[4], cam_ref[5]
        hx, hy, hz = cam_ref[6], cam_ref[7], cam_ref[8]
        vx, vy, vz = cam_ref[9], cam_ref[10], cam_ref[11]

        zero = jnp.zeros((block,), jnp.float32)
        one = jnp.ones((block,), jnp.float32)

        def trace_sample(s, carry):
            acc_r, acc_g, acc_b, seg = carry
            s_u = s.astype(jnp.uint32)

            ju, jv, _ = rng.pcg3d(pix_u, s_u, jnp.uint32(0))
            u = (pcol_f + rng.random_f32_from_bits24(ju)) / inv_w1
            v = (prow_f + rng.random_f32_from_bits24(jv)) / inv_h1

            dx = llcx + u * hx + v * vx - ox0
            dy = llcy + u * hy + v * vy - oy0
            dz = llcz + u * hz + v * vz - oz0
            dlen = jnp.sqrt(dx * dx + dy * dy + dz * dz)
            dx, dy, dz = dx / dlen, dy / dlen, dz / dlen

            # the bounce loop exits once no pixel of the block is alive
            def bounce_cond(st):
                return (st[0] < depth) & (jnp.max(st[13]) > 0.0)

            def bounce_body(st):
                (b, ox, oy, oz, dx, dy, dz, tpr, tpg, tpb,
                 rr, rg, rb, alive_f, seg) = st
                alive = alive_f > 0.5
                seg = seg + alive_f

                # ---- closest hit over spheres (common.rs:60-98) ----------
                hs0 = (jnp.full((block,), BIG),
                       zero, zero, one,            # winning center (nx..nz)
                       zero, zero, zero, zero,     # kind, ar, ag, ab
                       zero, one)                  # fz, irx
                hs = _sphere_loop(sph_ref, sphc_b_ref, sphc_r_ref,
                                  n_spheres, n_sph_clusters,
                                  ox, oy, oz, dx, dy, dz, alive, hs0)
                hs, (hpx, hpy, hpz) = _sphere_normals(
                    ox, oy, oz, dx, dy, dz, hs)

                # ---- triangles (common.rs:124-166 via edge constants) ----
                if n_tris > 0:
                    tri_body = _make_tri_body(tri_ref, parity_plane_sign,
                                              ox, oy, oz, dx, dy, dz)
                    if n_tri_clusters > 0:
                        ivx, ivy, ivz = _safe_inv_dir(dx, dy, dz)

                        def tri_cluster_body(ci, hs):
                            possible = _aabb_test(
                                tric_b_ref, ci, ox, oy, oz, ivx, ivy, ivz,
                                hs[0], alive)
                            any_p = jnp.max(jnp.where(possible, 1.0, 0.0))
                            s0 = jnp.where(any_p > 0.0, tric_r_ref[0, ci], 0)
                            s1 = jnp.where(any_p > 0.0, tric_r_ref[1, ci], 0)
                            return jax.lax.fori_loop(s0, s1, tri_body, hs)

                        hs = jax.lax.fori_loop(0, n_tri_clusters,
                                               tri_cluster_body, hs)
                    else:
                        hs = jax.lax.fori_loop(0, n_tris, tri_body, hs)
                    hs = _resolve_tri_normals(hs)
                    t_best = hs[0]
                    hpx = ox + t_best * dx
                    hpy = oy + t_best * dy
                    hpz = oz + t_best * dz

                # ---- RNG draw + scatter + bookkeeping --------------------
                (ox, oy, oz, dx, dy, dz, tpr, tpg, tpb, rr, rg, rb,
                 alive_f, seg) = _scatter_bookkeep(
                    pix_u, s_u, b, ox, oy, oz, dx, dy, dz, hpx, hpy, hpz,
                    hs, tpr, tpg, tpb, rr, rg, rb, alive, seg)
                return (b + 1, ox, oy, oz, dx, dy, dz, tpr, tpg, tpb,
                        rr, rg, rb, alive_f, seg)

            st = (jnp.int32(0),
                  jnp.broadcast_to(ox0, (block,)),
                  jnp.broadcast_to(oy0, (block,)),
                  jnp.broadcast_to(oz0, (block,)),
                  dx, dy, dz, one, one, one, zero, zero, zero,
                  jnp.where(active0, 1.0, 0.0), seg)
            st = jax.lax.while_loop(bounce_cond, bounce_body, st)
            rr, rg, rb, seg = st[10], st[11], st[12], st[14]
            return (acc_r + rr, acc_g + rg, acc_b + rb, seg)

        acc_r, acc_g, acc_b, seg = jax.lax.fori_loop(
            0, spp, trace_sample, (zero, zero, zero, zero))

        inv_spp = jnp.float32(1.0 / spp)
        out_r[...] = acc_r * inv_spp
        out_g[...] = acc_g * inv_spp
        out_b[...] = acc_b * inv_spp
        out_seg[...] = seg          # per-pixel traced-segment count

    return kernel


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "samples_per_pixel", "depth",
                     "block_pixels", "parity_plane_sign", "interpret",
                     "shard_rows"))
def render_linear_pallas(sph_table, tri_table, cam_vec, *, width, height,
                         samples_per_pixel, depth, seed=0,
                         block_pixels=BLOCK_PIXELS, parity_plane_sign=True,
                         interpret=False, sph_clusters=None, tri_clusters=None,
                         shard_rows=None, row_offset=0, row_stride=1):
    """Mean linear radiance [rows, W, 3] + segment count, fused kernel.

    sph_table: (SPH_ROWS, S) from pack_spheres; tri_table: (TRI_ROWS, T)
    from pack_triangles; cam_vec: (12,) f32 [origin, llc, horizontal,
    vertical].  sph_clusters/tri_clusters: optional (bounds (6, C) f32,
    ranges (2, C) i32) from cluster_spheres/cluster_triangles — the TABLES
    MUST then be packed with the matching perm; enables cluster culling.

    shard_rows/row_offset/row_stride render a ROW SUBSET of the full image:
    ``shard_rows`` (static; default = height) rows at global rows
    ``row_offset + k * row_stride`` (both traced, so a shard_map body can
    pass ``axis_index`` / the device count).  Pixel ids — and therefore RNG
    streams and every per-pixel float — depend only on global (row, col),
    so any banded or interleaved render is bitwise identical to the
    matching rows of a whole-image render.

    interpret=True runs the kernel on the CPU through the Pallas
    interpreter (tests); otherwise it is compiled by Triton for the GPU.

    tri_clusters requires parity_plane_sign=False: the reference's
    wrong-sign plane equation (common.rs:140-141) registers hits at t values
    unrelated to triangle geometry for origins != 0, so vertex-derived
    bounds cannot contain them.
    """
    if tri_clusters is not None and parity_plane_sign:
        raise ValueError(
            "tri_clusters culling is unsound with parity_plane_sign=True "
            "(bounce-ray hits escape vertex-derived bounds)")
    if block_pixels & (block_pixels - 1):
        raise ValueError(f"block_pixels={block_pixels} is not a power of 2")
    if shard_rows is None:
        shard_rows = height
    npix = shard_rows * width
    nblocks = pl.cdiv(npix, block_pixels)
    npad = nblocks * block_pixels

    if sph_clusters is None:
        sph_clusters = (jnp.zeros((6, 1), jnp.float32),
                        jnp.zeros((2, 1), jnp.int32))
        n_sph_clusters = 0
    else:
        n_sph_clusters = sph_clusters[0].shape[1]
    if tri_clusters is None:
        tri_clusters = (jnp.zeros((6, 1), jnp.float32),
                        jnp.zeros((2, 1), jnp.int32))
        n_tri_clusters = 0
    else:
        n_tri_clusters = tri_clusters[0].shape[1]

    kernel = _make_kernel(width, height, samples_per_pixel, depth,
                          sph_table.shape[1], tri_table.shape[1],
                          block_pixels, parity_plane_sign, n_sph_clusters,
                          n_tri_clusters, shard_rows)
    seed_arr = jnp.stack([
        jnp.uint32(seed) * _SEED_MIX,
        jnp.asarray(row_offset, jnp.int32).astype(jnp.uint32),
        jnp.asarray(row_stride, jnp.int32).astype(jnp.uint32)])
    whole = pl.BlockSpec()
    out_block = pl.BlockSpec((block_pixels,), lambda i: (i,))
    planes = pl.pallas_call(
        kernel,
        grid=(nblocks,),
        in_specs=[whole] * 8,
        out_specs=[out_block] * 4,
        out_shape=[jax.ShapeDtypeStruct((npad,), jnp.float32)] * 4,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="path_trace",
    )(cam_vec, seed_arr, sph_table, *sph_clusters, tri_table,
      *tri_clusters)
    rgb = jnp.stack(planes[:3], axis=-1)[:npix]
    # per-pixel counts are small ints (<= spp*depth, exact in f32); summed
    # as int32, since an f32 total rounds past 2^24 segments
    segments = jnp.sum(planes[3].astype(jnp.int32))
    return rgb.reshape(shard_rows, width, 3), segments


def camera_vec(camera: Camera) -> jax.Array:
    return jnp.concatenate([
        camera.origin, camera.lower_left_corner,
        camera.horizontal, camera.vertical]).astype(jnp.float32)
