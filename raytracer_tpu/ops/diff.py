"""Differentiable fast path: kernel forward, custom VJP backward.

The fused kernel (ops/pallas/wavefront.py) is forward-only — Pallas
kernels have no automatic transpose.  This module gives the renderer a
``jax.custom_vjp``:

  * **forward** — the scene tables are packed with *traceable* jnp ops (so
    scene parameters stay live under ``jit``/``grad``) and rendered by the
    fused kernel;
  * **backward** — the XLA wavefront renderer (render.py) is re-linearized
    at the same inputs and its VJP maps the image cotangent to scene/camera
    cotangents.  Both paths implement the identical algorithm
    (common.rs:263-285 bounce rules with the same pcg3d RNG streams), so the
    Jacobian is the same up to float rounding.

The backward recomputes the forward on XLA, so ``value_and_grad`` through
this path costs one kernel forward more than plain AD; it pays where the
forward alone is called often (line searches, preview frames).

Cluster culling: the cull TOPOLOGY (median-split permutation + leaf
ranges, ``build_tri_cull``) is frozen host-side, but the BOUNDS are
recomputed traceably from the live vertices every call
(``tri_cluster_bounds_jnp``) — culling stays sound as the optimizer moves
geometry (a wandering vertex inflates its leaf's bound).
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import jax.numpy as jnp

from .. import render as render_mod
from ..camera import Camera
from ..scene import Scene
from .pallas import wavefront as wf


def pack_spheres_jnp(scene: Scene) -> jax.Array:
    """Traceable (SPH_ROWS, S) sphere table — jnp mirror of
    ``wavefront.pack_spheres`` (no permutation)."""
    c = scene.sphere_center.astype(jnp.float32)
    r = scene.sphere_radius.astype(jnp.float32)
    valid = scene.sphere_valid
    mat = scene.sphere_mat
    kind = scene.materials.kind.astype(jnp.float32)[mat]
    alb = scene.materials.color.astype(jnp.float32)[mat]
    fuzz = scene.materials.fuzz.astype(jnp.float32)[mat]
    ir = scene.materials.ir.astype(jnp.float32)[mat]
    # negative radius flips the geometric normal ((p-c)/r, common.rs:94-95):
    # encoded as kind+4 so the kernel recovers the sign without an extra
    # select plane in the intersection loop
    kind = kind + jnp.where(valid & (r < 0.0), 4.0, 0.0)
    cx = jnp.where(valid, c[:, 0], 1e9)
    return jnp.stack([
        cx, c[:, 1], c[:, 2], r,
        jnp.where(valid, r * r, -1.0),
        kind, alb[:, 0], alb[:, 1], alb[:, 2], fuzz, ir,
    ])


def pack_triangles_jnp(scene: Scene, perm=None) -> jax.Array:
    """Traceable (TRI_ROWS, T) triangle table — jnp mirror of
    ``wavefront.pack_triangles``.  ``perm`` (static int array) reorders
    the columns for cluster culling; gradients flow back through the
    gather automatically.

    Note: the host packer precomputes in f64; this traceable version is f32
    end-to-end (gradients flow in the scene's dtype), costing ~1 ulp on the
    edge-test constants.
    """
    v0 = scene.tri_v0.astype(jnp.float32)
    v1 = scene.tri_v1.astype(jnp.float32)
    v2 = scene.tri_v2.astype(jnp.float32)
    valid = scene.tri_valid
    mat = scene.tri_mat
    if perm is not None:
        v0, v1, v2 = v0[perm], v1[perm], v2[perm]
        valid, mat = valid[perm], mat[perm]
    kind = scene.materials.kind.astype(jnp.float32)[mat]
    alb = scene.materials.color.astype(jnp.float32)[mat]
    fuzz = scene.materials.fuzz.astype(jnp.float32)[mat]
    ir = scene.materials.ir.astype(jnp.float32)[mat]
    n = jnp.cross(v1 - v0, v2 - v0)
    d = jnp.einsum("ij,ij->i", n, v0)
    g0 = jnp.cross(n, v1 - v0)
    g1 = jnp.cross(n, v2 - v1)
    g2 = jnp.cross(n, v0 - v2)
    w0 = jnp.einsum("ij,ij->i", v0, g0)
    w1 = jnp.einsum("ij,ij->i", v1, g1)
    w2 = jnp.einsum("ij,ij->i", v2, g2)
    extra = jnp.where(kind == 1.0, fuzz, jnp.where(kind == 2.0, ir, 0.0))
    rows = jnp.stack([
        n[:, 0], n[:, 1], n[:, 2], d,
        g0[:, 0], g0[:, 1], g0[:, 2], w0,
        g1[:, 0], g1[:, 1], g1[:, 2], w1,
        g2[:, 0], g2[:, 1], g2[:, 2], w2,
        kind, extra, alb[:, 0], alb[:, 1], alb[:, 2],
    ])
    return jnp.where(valid[None, :], rows, 0.0)


class TriCull:
    """STATIC triangle-cluster topology for the differentiable kernels.

    The grouping (median-split permutation + leaf ranges) is frozen from
    the scene geometry at build time; the BOUNDS are recomputed traceably
    from the live vertices every call (``tri_cluster_bounds_jnp``), so
    culling stays sound as the optimizer moves vertices — a wandering
    vertex merely inflates its leaf's bound.  Hashable by identity so it
    can ride the nondiff ``statics`` tuple under jit caching.
    """

    def __init__(self, perm, ranges, leaf_ids):
        self.perm = perm            # (T,) int64: packed column -> tri
        self.ranges = ranges        # (2, C) int32 leaf [start, end)
        self.leaf_ids = leaf_ids    # (T,) int32 leaf id per packed column

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


_CULL_CACHE: dict = {}


def build_tri_cull(scene: Scene, leaf_target: int = 64):
    """Host-side static cull topology for ``scene`` (cached on identity);
    None when the scene has too few triangles to benefit."""
    import weakref
    key = id(scene)
    hit = _CULL_CACHE.get(key)
    if hit is not None and hit[0]() is scene:
        return hit[1]
    scene_h = jax.device_get(scene)
    valid = np.asarray(scene_h.tri_valid)
    if int(valid.sum()) < 64:
        return None
    v0 = np.asarray(scene_h.tri_v0, np.float64)
    v1 = np.asarray(scene_h.tri_v1, np.float64)
    v2 = np.asarray(scene_h.tri_v2, np.float64)
    cen = (v0 + v1 + v2) / 3.0
    vidx = np.nonzero(valid)[0]
    perm_v, slices = wf._median_split_order(cen[vidx], leaf_target)
    perm = np.concatenate([vidx[perm_v],
                           np.nonzero(~valid)[0]]).astype(np.int64)
    C = max(len(slices), 1)
    ranges = np.zeros((2, C), np.int32)
    leaf_ids = np.full(len(perm), C, np.int32)   # C = dump id (invalid)
    for k, (s, e) in enumerate(slices or [(0, 0)]):
        ranges[0, k], ranges[1, k] = s, e
        leaf_ids[s:e] = k
    cull = TriCull(perm, ranges, leaf_ids)
    dead = [k for k, v in _CULL_CACHE.items() if v[0]() is None]
    for k in dead:
        del _CULL_CACHE[k]
    _CULL_CACHE[key] = (weakref.ref(scene), cull)
    return cull


def tri_cluster_bounds_jnp(scene: Scene, cull: TriCull) -> jax.Array:
    """Traceable (6, C) leaf AABBs [lo.xyz; hi.xyz], recomputed from the
    LIVE vertices (segment reductions over the static leaf ids).  Empty
    leaves get lo > hi (every slab test misses)."""
    C = cull.ranges.shape[1]
    ids = jnp.asarray(cull.leaf_ids)
    perm = jnp.asarray(cull.perm)
    v0 = scene.tri_v0.astype(jnp.float32)[perm]
    v1 = scene.tri_v1.astype(jnp.float32)[perm]
    v2 = scene.tri_v2.astype(jnp.float32)[perm]
    valid = scene.tri_valid[perm]
    big = jnp.float32(1e30)
    vmin = jnp.minimum(jnp.minimum(v0, v1), v2)
    vmax = jnp.maximum(jnp.maximum(v0, v1), v2)
    vmin = jnp.where(valid[:, None], vmin, big)
    vmax = jnp.where(valid[:, None], vmax, -big)
    lo = jax.ops.segment_min(vmin, ids, num_segments=C + 1)[:C]
    hi = jax.ops.segment_max(vmax, ids, num_segments=C + 1)[:C]
    # the bounds only gate work (piecewise-constant decision): their
    # cotangent is zero, so stop the gradient explicitly
    lo = jax.lax.stop_gradient(lo)
    hi = jax.lax.stop_gradient(hi)
    pad = 1e-4 + 1e-5 * jnp.maximum(jnp.abs(lo), jnp.abs(hi))
    empty = lo[:, 0] > hi[:, 0]
    lo_p = jnp.where(empty[:, None], 1.0, lo - pad)
    hi_p = jnp.where(empty[:, None], -1.0, hi + pad)
    return jnp.concatenate([lo_p.T, hi_p.T]).astype(jnp.float32)


def make_statics(*, width, height, samples_per_pixel, depth, seed=0,
                 parity_plane_sign=True, interpret=False, shard_rows=None,
                 tri_cull=None):
    """The hashable ``statics`` tuple of ``render_linear_diff``."""
    return (width, height, samples_per_pixel, depth, seed,
            parity_plane_sign, interpret, shard_rows, tri_cull)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def render_linear_diff(scene: Scene, camera: Camera, statics,
                       row_offset=0, row_stride=1):
    """Differentiable mean linear radiance [rows, W, 3], kernel forward.

    statics: ``make_statics(...)`` — (width, height, samples_per_pixel,
      depth, seed, parity_plane_sign, interpret, shard_rows, tri_cull);
      shard_rows=None renders every row, tri_cull (``build_tri_cull``)
      enables triangle culling under the corrected plane equation.

    row_offset/row_stride (traced ints) select the global rows
    ``row_offset + k * row_stride`` — a shard_map body passes
    ``axis_index`` / the device count, composing the kernel forward and
    the recompute backward with sharding.
    """
    return _pallas_forward(scene, camera, statics, row_offset, row_stride)


def _pallas_forward(scene, camera, statics, row_offset, row_stride):
    (width, height, spp, depth, seed, pps, interpret, shard_rows,
     cull) = statics
    # cluster culling is only sound under the corrected plane equation
    # (same rule as the forward engines)
    if pps:
        cull = None
    tri = pack_triangles_jnp(scene,
                             perm=None if cull is None else cull.perm)
    tri_cl = None
    if cull is not None:
        tri_cl = (tri_cluster_bounds_jnp(scene, cull),
                  jnp.asarray(cull.ranges))
    mean, _segs = wf.render_linear_pallas(
        pack_spheres_jnp(scene), tri, wf.camera_vec(camera), width=width,
        height=height, samples_per_pixel=spp, depth=depth, seed=seed,
        parity_plane_sign=pps, interpret=interpret, tri_clusters=tri_cl,
        shard_rows=shard_rows, row_offset=row_offset, row_stride=row_stride)
    return mean


def _fwd(scene, camera, statics, row_offset=0, row_stride=1):
    return (_pallas_forward(scene, camera, statics, row_offset,
                            row_stride),
            (scene, camera, row_offset, row_stride))


def _int_ct(x):
    return np.zeros(jnp.shape(x), jax.dtypes.float0)


def _bwd(statics, residuals, g):
    width, height, spp, depth, seed, pps, _interpret, shard_rows, _ = statics
    scene, camera, row_offset, row_stride = residuals
    rows_here = height if shard_rows is None else shard_rows
    seed_word = jnp.uint32(seed) * render_mod._SEED_MIX

    def xla_render(s, c):
        # recompute-backward on the XLA renderer over the SAME row subset
        # as the forward shard (global rows offset + k*stride)
        band = row_offset + jnp.arange(rows_here, dtype=jnp.int32) \
            * row_stride
        rows = jnp.repeat(band, width)
        cols = jnp.tile(jnp.arange(width, dtype=jnp.int32), rows_here)
        active = rows < height
        img_sum, _segs = render_mod.accumulate_samples(
            s, c, jnp.minimum(rows, height - 1), cols, width, height,
            spp, depth, pps, seed_word, active=active)
        return (img_sum * (1.0 / spp)).reshape(rows_here, width, 3)

    _, vjp_fn = jax.vjp(xla_render, scene, camera)
    return vjp_fn(g) + (_int_ct(row_offset), _int_ct(row_stride))


render_linear_diff.defvjp(_fwd, _bwd)
