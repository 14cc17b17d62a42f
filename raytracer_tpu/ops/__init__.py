"""Custom ops: the fused GPU render kernel + engine dispatch.

``render_linear_fast`` renders through one of two engines
(``resolve_dispatch``):

  * ``pallas`` — the fused path-trace kernel (pallas/wavefront.py, Pallas
    on the Triton route): one program per block of pixels, ray state in
    registers for every sample and bounce.  Compiled for the GPU; on the
    CPU it runs only when the caller asks for the Pallas interpreter
    (``interpret=True``, the tests);
  * ``xla`` — the wavefront renderer (render.py).

Differentiable rendering through the kernel rides
``ops.diff.render_linear_diff`` (custom VJP: kernel forward, XLA
recompute backward).
"""

from __future__ import annotations

import weakref

import jax
import numpy as np
import jax.numpy as jnp

from .. import render as render_mod
from ..camera import Camera
from ..scene import Scene

ENGINES = ("auto", "pallas", "xla")

# primitive counts at which the kernel switches from the flat scan to
# cluster culling (median-split leaves + block-level bound tests)
CLUSTER_MIN_SPHERES = 64
CLUSTER_MIN_TRIS = 64


def backend_is_gpu() -> bool:
    return jax.default_backend() == "gpu"


# Host-side scene packing is O(S + T log T) numpy work per call; interactive
# camera moves and bench loops render the SAME scene object every frame, so
# the packed tables are memoized on scene identity (lib.rs:60-63 interactive
# path).  ``pack_events`` counts actual packing work for tests/profiling.
_TABLE_CACHE: dict = {}
pack_events = 0


def scene_tables(scene: Scene, parity_plane_sign: bool):
    """Packed kernel scene tables (+ cluster structures), cached on the
    identity of ``scene``.  Returns (sph, tri, sph_clusters, tri_clusters)
    ready for ``render_linear_pallas``."""
    global pack_events
    key = (id(scene), parity_plane_sign)
    hit = _TABLE_CACHE.get(key)
    if hit is not None and hit[0]() is scene:
        return hit[1]
    from .pallas import wavefront as wf
    pack_events += 1
    # one batched device->host pull: the packers read every field
    scene_h = jax.device_get(scene)
    sph_perm = tri_perm = None
    sph_cl = tri_cl = None
    if int(np.sum(scene_h.sphere_valid)) >= CLUSTER_MIN_SPHERES:
        sph_perm, b, rg = wf.cluster_spheres(scene_h)
        sph_cl = (jnp.asarray(b), jnp.asarray(rg))
    # Triangle culling is only sound with the CORRECT plane equation:
    # under parity_plane_sign (the reference's wrong-sign formula,
    # common.rs:140-141) bounce rays with origin != 0 register hits at
    # t values unrelated to the triangle's actual geometry, so no
    # vertex-derived bound contains them.
    if (not parity_plane_sign
            and int(np.sum(scene_h.tri_valid)) >= CLUSTER_MIN_TRIS):
        tri_perm, b, rg = wf.cluster_triangles(scene_h)
        tri_cl = (jnp.asarray(b), jnp.asarray(rg))
    sph = jnp.asarray(wf.pack_spheres(scene_h, perm=sph_perm))
    tri = jnp.asarray(wf.pack_triangles(scene_h, perm=tri_perm))
    tables = (sph, tri, sph_cl, tri_cl)
    # prune entries whose scene died (cheap: the cache stays tiny)
    dead = [k for k, v in _TABLE_CACHE.items() if v[0]() is None]
    for k in dead:
        del _TABLE_CACHE[k]
    _TABLE_CACHE[key] = (weakref.ref(scene), tables)
    return tables


def resolve_dispatch(scene: Scene, parity_plane_sign, engine: str = "auto",
                     gpu: bool | None = None, interpret: bool = False):
    """Resolve (engine, parity_plane_sign, warning) for a render request.

    ``parity_plane_sign=None`` means "per scene": reference-parity scenes
    (``exact_planes=False``) get the reference's wrong-sign plane equation
    (common.rs:140-141); OBJ/procedural scenes get the correct one — which
    also lets the kernel cull triangles.  An EXPLICIT ``True`` on a mesh
    is honored but returns a warning: every ray then tests every triangle.
    ``gpu`` overrides backend detection (for testing the decision table).

    "auto" picks the kernel on the GPU and the XLA wavefront elsewhere.
    The kernel asked for by name off the GPU raises unless ``interpret``
    (the Pallas interpreter) is requested: nothing falls back silently.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{ENGINES}")
    if gpu is None:
        gpu = backend_is_gpu()
    if parity_plane_sign is None:
        parity_plane_sign = not scene.exact_planes
    if engine == "auto":
        engine = "pallas" if gpu else "xla"
    warning = None
    if engine == "pallas":
        if not (gpu or interpret):
            raise ValueError(
                "engine='pallas' is compiled for the GPU; on another "
                "backend pass interpret=True (Pallas interpreter) or use "
                "engine='xla'")
        if (parity_plane_sign and int(np.sum(np.asarray(scene.tri_valid)))
                >= CLUSTER_MIN_TRIS):
            warning = (
                "parity_plane_sign=True disables triangle culling in the "
                "kernel: every ray tests every triangle.  Pass "
                "parity_plane_sign=False (or build the scene with "
                "exact_planes=True) unless reference plane-sign parity is "
                "required.")
    return engine, parity_plane_sign, warning


def render_linear_fast(scene: Scene, camera: Camera, *, width: int,
                       height: int, samples_per_pixel: int, depth: int,
                       seed: int = 0, parity_plane_sign: bool | None = None,
                       engine: str = "auto", progress=None,
                       interpret: bool = False):
    """Mean linear radiance [H, W, 3] + segment count.

    engine: "auto" | "pallas" | "xla" (see ``resolve_dispatch``).

    parity_plane_sign: None (default) resolves per scene — see
    ``resolve_dispatch``.

    progress: optional ``progress(rows_done, height)`` callback — the
    reference's scanline logger hook (common.rs:328-330).  When set, the
    image is rendered in row bands with the callback fired per band; every
    pixel depends only on its global (row, col), so the banded image is
    bitwise identical to the unbanded one.
    """
    engine, parity_plane_sign, warning = resolve_dispatch(
        scene, parity_plane_sign, engine, interpret=interpret)
    if warning is not None:
        import warnings
        warnings.warn(warning, stacklevel=2)
    if progress is not None and height > 1:
        return _render_banded(scene, camera, width=width, height=height,
                              samples_per_pixel=samples_per_pixel,
                              depth=depth, seed=seed,
                              parity_plane_sign=parity_plane_sign,
                              engine=engine, progress=progress,
                              interpret=interpret)
    if engine == "pallas":
        from .pallas import wavefront as wf
        sph, tri, sph_cl, tri_cl = scene_tables(scene, parity_plane_sign)
        return wf.render_linear_pallas(
            sph, tri, wf.camera_vec(camera), width=width, height=height,
            samples_per_pixel=samples_per_pixel, depth=depth, seed=seed,
            parity_plane_sign=parity_plane_sign, interpret=interpret,
            sph_clusters=sph_cl, tri_clusters=tri_cl)
    return render_mod.render_linear(
        scene, camera, width=width, height=height,
        samples_per_pixel=samples_per_pixel, depth=depth,
        parity_plane_sign=parity_plane_sign, seed=seed)


def _render_banded(scene, camera, *, width, height, samples_per_pixel,
                   depth, seed, parity_plane_sign, engine, progress,
                   interpret):
    """Row-banded render for progress reporting (max 16 equal bands; the
    tail band reuses the same compiled shape via dead-pixel padding)."""
    band = max(1, -(-height // 16))
    if engine == "pallas":
        from .pallas import wavefront as wf
        sph, tri, sph_cl, tri_cl = scene_tables(scene, parity_plane_sign)
        cv = wf.camera_vec(camera)
    else:
        rows_full = jnp.repeat(jnp.arange(band, dtype=jnp.int32), width)
        cols_full = jnp.tile(jnp.arange(width, dtype=jnp.int32), band)
        seed_word = jnp.uint32(seed) * render_mod._SEED_MIX
    pieces = []
    segments = 0
    for r0 in range(0, height, band):
        rows_here = min(band, height - r0)
        if engine == "pallas":
            # shard_rows stays `band` for every piece (one compile); rows
            # past the image are dead pixels inside the kernel
            mean, segs = wf.render_linear_pallas(
                sph, tri, cv, width=width, height=height,
                samples_per_pixel=samples_per_pixel, depth=depth, seed=seed,
                parity_plane_sign=parity_plane_sign, interpret=interpret,
                sph_clusters=sph_cl, tri_clusters=tri_cl, shard_rows=band,
                row_offset=r0)
            mean = mean[:rows_here]
        else:
            rows = rows_full + r0
            active = rows < height
            img_sum, segs = render_mod.accumulate_samples(
                scene, camera, jnp.minimum(rows, height - 1), cols_full,
                width, height, samples_per_pixel, depth, parity_plane_sign,
                seed_word, active=active)
            mean = (img_sum * (1.0 / samples_per_pixel)).reshape(
                band, width, 3)[:rows_here]
        pieces.append(mean)
        segments += int(segs)
        progress(r0 + rows_here, height)
    return jnp.concatenate(pieces, axis=0), segments
