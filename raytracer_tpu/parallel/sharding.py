"""Sharded rendering: rays across the device mesh, scene replicated.

This is the framework's scale-out layer (SURVEY.md §2.4): the reference's
scanline loop becomes a pixel-flat ray batch sharded over a 1-D ``rays``
mesh with ``shard_map``.  The scene pytree is replicated (it is tiny and
read-only), every device traces its pixel chunk independently, and the
only collective in the forward pass is the stats ``psum``.  Under reverse-mode
AD the replicated scene parameters automatically receive a gradient ``psum``
over the same axis, which XLA hands to the collective library (NCCL on GPUs).

Pixel counts that don't divide the device count are padded with dead lanes
(``active=False`` — they trace nothing and are sliced off the result).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .. import render as render_mod
from ..camera import Camera
from ..render import Options, accumulate_samples, finalize_image
from ..scene import Scene
from .mesh import RAYS_AXIS, make_mesh, pad_to_multiple


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "width", "height", "samples_per_pixel", "depth",
                     "parity_plane_sign"))
def render_linear_sharded(scene: Scene, camera: Camera, *, mesh: Mesh,
                          width: int, height: int, samples_per_pixel: int,
                          depth: int, parity_plane_sign: bool = True,
                          seed: jax.Array | int = 0):
    """Sharded ``render_linear``: mean radiance [H, W, 3] + segment count.

    Differentiable w.r.t. scene arrays; the backward pass all-reduces scene
    gradients across the ``rays`` axis automatically.
    """
    n = mesh.shape[RAYS_AXIS]
    npix = height * width
    npad = pad_to_multiple(npix, n)
    # INTERLEAVED pixel assignment: device i owns pixels i, i+n, i+2n, ...
    # Contiguous chunks load-balance badly (sky pixels terminate in 1-2
    # bounces, ground/glass pixels run all 8: measured 0.68 balance on the
    # default world); round-robin gives every device a cross-section of the
    # image (>0.97).  Per-pixel results depend only on the pixel id, so the
    # inverse permutation below restores the exact single-device image.
    pix = jnp.arange(npad, dtype=jnp.int32).reshape(-1, n).T.reshape(-1)
    seed_word = jnp.uint32(seed) * render_mod._SEED_MIX

    # check_vma=False: the scan carries inside accumulate_samples are
    # constant-initialized (zeros), which the varying-manual-axes checker
    # would otherwise require explicit pcasts for
    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(RAYS_AXIS)),
        out_specs=(P(RAYS_AXIS), P()),
        check_vma=False)  # scan carries are constant-initialized zeros
    def run(scene_rep, camera_rep, pix_chunk):
        active = pix_chunk < npix
        safe = jnp.minimum(pix_chunk, npix - 1)
        rows = safe // width
        cols = safe % width
        img_sum, segments = accumulate_samples(
            scene_rep, camera_rep, rows, cols, width, height,
            samples_per_pixel, depth, parity_plane_sign, seed_word,
            active=active)
        return img_sum, jax.lax.psum(segments, RAYS_AXIS)

    img_sum, segments = run(scene, camera, pix)
    # invert the interleave: gathered row k of device i holds pixel k*n+i
    img_sum = img_sum.reshape(n, npad // n, 3).transpose(1, 0, 2).reshape(
        npad, 3)
    mean = img_sum[:npix] * (1.0 / samples_per_pixel)
    return mean.reshape(height, width, 3), segments


@functools.lru_cache(maxsize=None)
def _sharded_pallas_fn(mesh: Mesh, width: int, height: int,
                       samples_per_pixel: int, depth: int,
                       parity_plane_sign: bool, rows_per: int,
                       interpret: bool, has_sph_cl: bool, has_tri_cl: bool):
    """Build (once per static config) the jitted shard_map'd fused kernel.

    Each device runs the fused Pallas kernel on an INTERLEAVED row subset:
    device i owns global rows ``i, i+n, i+2n, ...`` (``row_offset=i``,
    ``row_stride=n``).  Contiguous bands load-balance badly — sky rows
    retire in 1-2 bounces while ground/glass rows run all 8 (measured 0.68
    work balance on the default world vs >0.97 interleaved) — and under
    strong scaling the step time is ``max_i T(band_i)``, so balance IS
    efficiency.  Per-pixel math depends only on global (row, col), so the
    gathered-and-deinterleaved image is bitwise identical to a
    single-device kernel render.  The only collective is the segment psum —
    multi-chip inherits single-chip kernel speed.
    """
    from ..ops.pallas import wavefront as wf

    n = mesh.shape[RAYS_AXIS]
    cl_spec = (P(), P()) if has_sph_cl else None
    tcl_spec = (P(), P()) if has_tri_cl else None

    @jax.jit
    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(), cl_spec, tcl_spec),
        out_specs=(P(RAYS_AXIS), P()),
        check_vma=False)  # kernel body is per-device; manual replication
    def run(sph, tri, cv, seed, sph_cl, tri_cl):
        row0 = jax.lax.axis_index(RAYS_AXIS).astype(jnp.int32)
        mean, segs = wf.render_linear_pallas(
            sph, tri, cv, width=width, height=height,
            samples_per_pixel=samples_per_pixel, depth=depth, seed=seed,
            parity_plane_sign=parity_plane_sign, sph_clusters=sph_cl,
            tri_clusters=tri_cl, shard_rows=rows_per, row_offset=row0,
            row_stride=n, interpret=interpret)
        return mean, jax.lax.psum(segs, RAYS_AXIS)

    return run


def render_linear_sharded_fast(scene: Scene, camera: Camera, *, mesh: Mesh,
                               width: int, height: int,
                               samples_per_pixel: int, depth: int,
                               parity_plane_sign: bool | None = None,
                               seed: int = 0, engine: str = "auto",
                               interpret: bool = False):
    """Sharded render through the dispatched engine (ops.resolve_dispatch):
    the fused kernel per device on the GPU, else the XLA wavefront path.
    ``parity_plane_sign=None`` resolves per scene.  Returns (mean radiance
    [H, W, 3], segment count).  The kernel path is forward-only; for
    gradients use ``render_linear_sharded`` or
    ``render_linear_diff_sharded``.
    """
    from .. import ops as ops_mod
    engine, parity_plane_sign, warning = ops_mod.resolve_dispatch(
        scene, parity_plane_sign, engine, interpret=interpret)
    if warning is not None:
        import warnings
        warnings.warn(warning, stacklevel=2)
    if engine == "xla":
        return render_linear_sharded(
            scene, camera, mesh=mesh, width=width, height=height,
            samples_per_pixel=samples_per_pixel, depth=depth,
            parity_plane_sign=parity_plane_sign, seed=seed)
    from ..ops.pallas import wavefront as wf
    n = mesh.shape[RAYS_AXIS]
    rows_per = pad_to_multiple(height, n) // n
    sph, tri, sph_cl, tri_cl = ops_mod.scene_tables(scene, parity_plane_sign)
    run = _sharded_pallas_fn(mesh, width, height, samples_per_pixel,
                             depth, parity_plane_sign, rows_per,
                             interpret, sph_cl is not None,
                             tri_cl is not None)
    mean, segs = run(sph, tri, wf.camera_vec(camera), jnp.uint32(seed),
                     sph_cl, tri_cl)
    # deinterleave: gathered row i*rows_per + k holds global row k*n + i
    mean = mean.reshape(n, rows_per, width, 3).transpose(1, 0, 2, 3)
    return mean.reshape(n * rows_per, width, 3)[:height], segs


@functools.lru_cache(maxsize=None)
def _sharded_diff_fn(mesh: Mesh, statics):
    """Build (once per static config) the shard_map'd DIFFERENTIABLE
    kernel renderer: fused kernel forward + XLA recompute backward per
    device, with the same interleaved row assignment as
    ``_sharded_pallas_fn`` (device i owns global rows i, i+n, ...).

    Because the scene/camera enter replicated (in_specs P()), reverse-mode
    AD through the shard_map automatically psums their cotangents over the
    rays axis.
    """
    from ..ops import diff as diff_mod

    n = mesh.shape[RAYS_AXIS]

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(P(), P()),
        out_specs=P(RAYS_AXIS), check_vma=False)
    def run(scene_rep, camera_rep):
        row0 = jax.lax.axis_index(RAYS_AXIS).astype(jnp.int32)
        return diff_mod.render_linear_diff(scene_rep, camera_rep, statics,
                                           row0, jnp.int32(n))

    return run


def render_linear_diff_sharded(scene: Scene, camera: Camera, *, mesh: Mesh,
                               width: int, height: int,
                               samples_per_pixel: int, depth: int,
                               seed: int = 0,
                               parity_plane_sign: bool = True,
                               interpret: bool = False, tri_cull=None):
    """Differentiable sharded render through the kernel forward.

    Returns the mean linear radiance [H, W, 3]; differentiable w.r.t.
    scene arrays and camera with automatic gradient psum over the mesh.
    """
    from ..ops import diff as diff_mod
    n = mesh.shape[RAYS_AXIS]
    rows_per = pad_to_multiple(height, n) // n
    statics = diff_mod.make_statics(
        width=width, height=height, samples_per_pixel=samples_per_pixel,
        depth=depth, seed=seed, parity_plane_sign=parity_plane_sign,
        interpret=interpret, shard_rows=rows_per, tri_cull=tri_cull)
    mean = _sharded_diff_fn(mesh, statics)(scene, camera)
    # deinterleave: gathered row i*rows_per + k holds global row k*n + i
    mean = mean.reshape(n, rows_per, width, 3).transpose(1, 0, 2, 3)
    return mean.reshape(n * rows_per, width, 3)[:height]


def ray_trace_sharded(scene: Scene, camera: Camera, width: int, height: int,
                      options: Options | None = None,
                      mesh: Mesh | None = None) -> Tuple[np.ndarray, int]:
    """Sharded equivalent of ``render.ray_trace`` (u8 RGBA output), routed
    through the same engine dispatch as the single-device path."""
    options = options or Options()
    mesh = mesh or make_mesh()
    mean, segments = render_linear_sharded_fast(
        scene, camera, mesh=mesh, width=width, height=height,
        samples_per_pixel=options.samples_per_pixel,
        depth=options.max_ray_bounces,
        parity_plane_sign=options.parity_plane_sign, seed=options.seed,
        engine=options.engine)
    return np.asarray(finalize_image(mean)), int(segments)
