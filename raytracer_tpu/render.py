"""Render core: wavefront path tracer + sequential parity renderer.

The reference's render core is four nested scalar loops — scanline, column,
sample, bounce (``/root/reference/raytracer/src/common.rs:320-361``) with the
per-ray bounce loop in ``ray_color`` (common.rs:263-285).  The array
redesign inverts the nesting: ALL pixels' rays for one sample form a single
wavefront batch, the bounce loop is a fixed-depth ``lax.scan`` over that
batch's live state, and the sample loop is an outer ``lax.scan`` that
accumulates the running image.  Dead rays are masked, not compacted — the
wavefront stays dense and static-shaped for XLA.

``ray_color`` semantics preserved exactly (common.rs:263-285):
  * throughput starts at (1,1,1); a scattering hit multiplies it by the
    material color and continues;
  * a terminal hit (emission, absorbed metal) contributes
    ``throughput * color`` and stops;
  * a miss contributes ``throughput * sky`` with the sky gradient
    ``lerp((1,1,1), (0.5,0.7,1.0), 0.5*(dir.y+1))`` (common.rs:277-280);
  * bounce-exhausted rays contribute BLACK (common.rs:284) — they simply
    never add to the accumulator;
  * per-sample alpha is always 1.0 (Color::new sets a=1.0, color.rs:21-23,
    and products of alphas stay 1), so alpha is not materialized.

Pixel accumulation (common.rs:334-356): mean over samples, sqrt gamma,
x255.999, truncating u8 cast, vertical row flip.

Two entry paths:
  * ``render_linear`` / ``ray_trace`` — fast wavefront renderer with
    counter-based pcg3d RNG streams (one per pixel/sample/bounce).
  * ``ray_trace_parity`` — bit-faithful sequential renderer consuming the
    reference's single xorshift32 stream in raster order (common.rs:321,
    random.rs:8-30) for golden-image tests against the NumPy oracle.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import jax
import numpy as np
import jax.numpy as jnp

from . import intersect, materials as materials_mod, maths, rng
from .camera import Camera
from .scene import Scene

SKY_A = (1.0, 1.0, 1.0)
SKY_B = (0.5, 0.7, 1.0)

# draw-site codes for the counter-based RNG (see rng.pcg3d)
_SITE_JITTER = jnp.uint32(0)
_SEED_MIX = np.uint32(0x85EBCA6B)


@dataclasses.dataclass(frozen=True)
class Options:
    """Render options (common.rs:288-317).

    ``positive_is_up`` is stored but never read by the reference — the
    vertical flip at common.rs:351 is unconditional — and is kept here for
    API parity with the same non-behavior.

    ``logger`` is the reference's progress hook (common.rs:292,328-330):
    a callable ``logger(rows_done, height)`` invoked as row bands complete.
    With a logger set the render is split into row bands — per-pixel results
    depend only on global (row, col), so output is bitwise identical to an
    unbanded render (see ops.render_linear_fast).
    """
    samples_per_pixel: int = 32     # default, common.rs:311
    max_ray_bounces: int = 8        # default, common.rs:312
    positive_is_up: bool = True
    # None = resolve per scene (ops.resolve_dispatch): reference scenes
    # reproduce common.rs:140-141, OBJ/procedural scenes use the correct
    # plane equation (and so stay on the fast culling engines)
    parity_plane_sign: Optional[bool] = None
    seed: int = rng.DEFAULT_SEED
    engine: str = "auto"            # "auto" | "pallas" | "xla"
    logger: Optional[Callable[[int, int], None]] = None


def _sky_color(direction):
    """Background gradient (common.rs:277-280); renormalizes the direction
    as the reference does (``ray.direction.normalize().y()``)."""
    t = 0.5 * (maths.normalize(direction)[..., 1] + 1.0)
    a = jnp.asarray(SKY_A, jnp.float32)
    b = jnp.asarray(SKY_B, jnp.float32)
    return maths.lerp(a, b, t)


def _bounce_step(scene: Scene, pack: intersect.ScenePack, pix_id, sample_id,
                 parity_plane_sign: bool, carry, bounce_idx):
    """One wavefront bounce: intersect -> scatter -> mask update.

    carry: (origin [B,3], direction [B,3], throughput [B,3], result [B,3],
            alive [B], segments []).
    """
    origin, direction, throughput, result, alive, segments = carry
    segments = segments + jnp.sum(alive.astype(jnp.int32))

    hit = intersect.closest_hit_batch(
        origin, direction, scene, pack,
        parity_plane_sign=parity_plane_sign)

    bx, by, bz = rng.uniform_bilateral3(
        pix_id, sample_id, jnp.uint32(1) + bounce_idx.astype(jnp.uint32))
    rand_unit = materials_mod.random_unit_sphere(bx, by, bz)

    sc = materials_mod.scatter(scene.materials, hit.mat, direction,
                               hit.normal, rand_unit)

    miss = alive & ~hit.hit
    terminal = alive & hit.hit & sc.terminal
    bounce = alive & hit.hit & ~sc.terminal

    sky = _sky_color(direction)
    result = result + jnp.where(miss[:, None], throughput * sky, 0.0)
    result = result + jnp.where(terminal[:, None], throughput * sc.color, 0.0)
    throughput = jnp.where(bounce[:, None], throughput * sc.color, throughput)
    origin = jnp.where(bounce[:, None], hit.position, origin)
    direction = jnp.where(bounce[:, None], sc.direction, direction)
    alive = bounce
    return (origin, direction, throughput, result, alive, segments), None


def trace_rays(scene: Scene, pack: intersect.ScenePack, origin, direction,
               pix_id, sample_id, depth: int, parity_plane_sign: bool = True,
               active=None):
    """ray_color (common.rs:263-285) for a whole wavefront.

    ``active``: optional [B] bool — rays that should trace at all (padding
    lanes in the sharded path start dead and contribute nothing).

    Returns (radiance [B, 3], segments [] int32 — rays traced, for rays/s
    accounting).
    """
    B = origin.shape[0]
    if active is None:
        active = jnp.ones((B,), bool)
    init = (
        origin, direction,
        jnp.ones((B, 3), jnp.float32),          # throughput
        jnp.zeros((B, 3), jnp.float32),         # result
        active,                                 # alive
        jnp.int32(0),                           # segments
    )
    step = functools.partial(_bounce_step, scene, pack, pix_id, sample_id,
                             parity_plane_sign)
    (o, d, tp, result, alive, segments), _ = jax.lax.scan(
        step, init, jnp.arange(depth, dtype=jnp.int32))
    # exhausted rays contribute black (common.rs:284): nothing to add
    return result, segments


def _sample_wavefront(scene: Scene, pack: intersect.ScenePack, camera: Camera,
                      rows, cols, width: int, height: int, depth: int,
                      parity_plane_sign: bool, seed_word, sample_idx,
                      active=None):
    """Generate and trace one sample's wavefront over the given pixels.

    Jitter matches common.rs:335-336: u=(col+rand)/(width-1),
    v=(row+rand)/(height-1), with rows in render (not flipped) order.
    """
    pix_id = (rows * width + cols).astype(jnp.uint32) + seed_word
    s_id = sample_idx.astype(jnp.uint32)

    ur, vr = rng.uniform2(pix_id, s_id, _SITE_JITTER)
    u = (cols.astype(jnp.float32) + ur) / jnp.float32(width - 1)
    v = (rows.astype(jnp.float32) + vr) / jnp.float32(height - 1)
    origin, direction = camera.cast_rays(u, v)
    return trace_rays(scene, pack, origin, direction, pix_id, s_id, depth,
                      parity_plane_sign, active=active)


def accumulate_samples(scene: Scene, camera: Camera, rows, cols,
                       width: int, height: int, samples_per_pixel: int,
                       depth: int, parity_plane_sign: bool, seed_word,
                       active=None):
    """Sum per-sample radiance over the sample axis for an arbitrary pixel
    subset — the shared core of the single-device and sharded renderers.

    Returns (radiance_sum [B, 3], segments [] int32).
    """
    pack = intersect.pack_scene(scene)

    def body(acc, sample_idx):
        img_sum, segments = acc
        radiance, segs = _sample_wavefront(
            scene, pack, camera, rows, cols, width, height, depth,
            parity_plane_sign, seed_word, sample_idx, active=active)
        return (img_sum + radiance, segments + segs), None

    B = rows.shape[0]
    init = (jnp.zeros((B, 3), jnp.float32), jnp.int32(0))
    (img_sum, segments), _ = jax.lax.scan(
        body, init, jnp.arange(samples_per_pixel, dtype=jnp.int32))
    return img_sum, segments


@functools.partial(jax.jit, static_argnames=("width", "height",
                                             "samples_per_pixel", "depth",
                                             "parity_plane_sign"))
def render_linear(scene: Scene, camera: Camera, *, width: int, height: int,
                  samples_per_pixel: int, depth: int,
                  parity_plane_sign: bool = True,
                  seed: jax.Array | int = 0):
    """Mean linear radiance image [height, width, 3] (render row order, i.e.
    NOT yet vertically flipped) + traced-segment count.

    This is the differentiable quantity: gamma / u8 quantization live in
    ``finalize_image``.
    """
    seed_word = (jnp.uint32(seed) * _SEED_MIX)
    rows = jnp.repeat(jnp.arange(height, dtype=jnp.int32), width)
    cols = jnp.tile(jnp.arange(width, dtype=jnp.int32), height)
    img_sum, segments = accumulate_samples(
        scene, camera, rows, cols, width, height, samples_per_pixel, depth,
        parity_plane_sign, seed_word)
    mean = img_sum * (1.0 / samples_per_pixel)
    return mean.reshape(height, width, 3), segments


def finalize_image(mean_linear, flip: bool = True) -> jax.Array:
    """sqrt gamma, x255.999, truncating u8, vertical flip, alpha=255
    (common.rs:343-356).  Input [H, W, 3] mean radiance in render row order;
    output [H, W, 4] u8."""
    rgb = jnp.sqrt(jnp.maximum(mean_linear, 0.0)) * jnp.float32(255.999)
    # Rust's saturating `as u8` cast: clamp AND NaN -> 0 (common.rs:352-355)
    rgb = jnp.where(jnp.isnan(rgb), 0.0, jnp.clip(rgb, 0.0, 255.0))
    rgb = rgb.astype(jnp.uint8)
    a = jnp.full(rgb.shape[:-1] + (1,), 255, jnp.uint8)
    img = jnp.concatenate([rgb, a], axis=-1)
    if flip:
        img = img[::-1]
    return img


def ray_trace(scene: Scene, camera: Camera, width: int, height: int,
              options: Options | None = None) -> Tuple[np.ndarray, int]:
    """The reference's ``ray_trace`` entry point (common.rs:320): returns a
    u8 RGBA framebuffer [height, width, 4] (flipped, ready to write) and the
    traced-segment count."""
    options = options or Options()
    from . import ops as ops_mod
    mean, segments = ops_mod.render_linear_fast(
        scene, camera, width=width, height=height,
        samples_per_pixel=options.samples_per_pixel,
        depth=options.max_ray_bounces,
        parity_plane_sign=options.parity_plane_sign,
        seed=options.seed, engine=options.engine,
        progress=options.logger)
    img = finalize_image(mean)
    return np.asarray(img), int(segments)


# ---------------------------------------------------------------------------
# Sequential parity renderer — exact xorshift32 stream, raster order
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("width", "height",
                                             "samples_per_pixel", "depth",
                                             "parity_plane_sign"))
def render_parity(scene: Scene, camera: Camera, *, width: int, height: int,
                  samples_per_pixel: int, depth: int,
                  seed: int = rng.DEFAULT_SEED,
                  parity_plane_sign: bool = True):
    """Replicates the reference render bit-for-bit: ONE xorshift32 stream
    (seed 2547549, random.rs:8-9) consumed in raster order — u jitter, v
    jitter (common.rs:335-336), then 3 bilateral draws per diffuse/metal
    scatter (common.rs:32-38, materials.rs:44,56), nothing for dielectric /
    emission / miss.  Fully sequential by construction; use tiny configs.

    Returns the per-sample radiance array [height, width, spp, 3].
    """
    n = height * width * samples_per_pixel
    mats = scene.materials

    def sample_step(state, i):
        # raster order: row -> column -> sample (common.rs:327-334)
        per_row = width * samples_per_pixel
        row = i // per_row
        rem = i % per_row
        col = rem // samples_per_pixel

        state = rng.xorshift32(state)
        u = (col.astype(jnp.float32) + rng.random_f32_from_bits(state)) \
            / jnp.float32(width - 1)
        state = rng.xorshift32(state)
        v = (row.astype(jnp.float32) + rng.random_f32_from_bits(state)) \
            / jnp.float32(height - 1)
        origin, direction = camera.cast_rays(u, v)

        def bounce(carry, _):
            o, d, throughput, result, done, st = carry
            hit = intersect.closest_hit_exact(
                o, d, scene, parity_plane_sign=parity_plane_sign)

            will_draw = (~done) & hit.hit & \
                materials_mod.draws_random(mats, hit.mat)
            s1 = rng.xorshift32(st)
            s2 = rng.xorshift32(s1)
            s3 = rng.xorshift32(s2)
            two, one = jnp.float32(2.0), jnp.float32(1.0)
            bx = rng.random_f32_from_bits(s1) * two - one
            by = rng.random_f32_from_bits(s2) * two - one
            bz = rng.random_f32_from_bits(s3) * two - one
            st = jnp.where(will_draw, s3, st)
            raw = jnp.stack([bx, by, bz])
            rsq = jnp.sum(raw * raw)
            rln = jnp.sqrt(jnp.where(rsq == 0.0, 1.0, rsq))
            rand_unit = raw / rln

            sc = materials_mod.scatter_exact(mats, hit.mat, d, hit.normal,
                                             rand_unit)

            miss = (~done) & ~hit.hit
            terminal = (~done) & hit.hit & sc.terminal
            cont = (~done) & hit.hit & ~sc.terminal

            sky = _sky_color(d)
            result = jnp.where(miss, throughput * sky, result)
            result = jnp.where(terminal, throughput * sc.color, result)
            throughput = jnp.where(cont, throughput * sc.color, throughput)
            o = jnp.where(cont, hit.position, o)
            d = jnp.where(cont, sc.direction, d)
            done = done | miss | terminal
            return (o, d, throughput, result, done, st), None

        init = (origin, direction, jnp.ones(3, jnp.float32),
                jnp.zeros(3, jnp.float32), jnp.array(False), state)
        (o, d, tp, result, done, state), _ = jax.lax.scan(
            bounce, init, None, length=depth)
        # exhausted -> result stayed 0 (black), common.rs:284
        return state, result

    state0 = jnp.uint32(seed)
    _, colors = jax.lax.scan(sample_step, state0,
                             jnp.arange(n, dtype=jnp.int32))
    return colors.reshape(height, width, samples_per_pixel, 3)


def ray_trace_parity(scene: Scene, camera: Camera, width: int, height: int,
                     samples_per_pixel: int, depth: int,
                     seed: int = rng.DEFAULT_SEED,
                     parity_plane_sign: bool = True) -> np.ndarray:
    """Full parity render to a u8 RGBA framebuffer (flipped), mirroring the
    reference accumulation arithmetic (common.rs:334-356) exactly: f32 sum
    in sample order, * (1/spp), sqrt, *255.999, truncate."""
    colors = render_parity(
        scene, camera, width=width, height=height,
        samples_per_pixel=samples_per_pixel, depth=depth, seed=seed,
        parity_plane_sign=parity_plane_sign)
    colors = np.asarray(colors)  # [H, W, spp, 3]
    h, w, spp, _ = colors.shape
    inv = np.float32(1.0) / np.float32(spp)
    # sequential f32 accumulation in sample order, like the reference
    acc = np.zeros((h, w, 3), np.float32)
    for s in range(spp):
        acc = acc + colors[:, :, s, :]
    rgb = np.sqrt(acc * inv) * np.float32(255.999)
    # Rust's saturating `as u8` cast: clamp AND NaN -> 0 (common.rs:352-355)
    rgb = np.where(np.isnan(rgb), 0.0, np.clip(rgb, 0.0, 255.0))
    rgb = rgb.astype(np.uint8)
    a = np.full((h, w, 1), 255, np.uint8)
    img = np.concatenate([rgb, a], axis=-1)
    return img[::-1]
