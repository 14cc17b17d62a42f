"""Branchless material dispatch over the wavefront.

The reference dispatches per-ray through a 4-way enum match
(``/root/reference/raytracer/src/materials.rs:30-40`` — the winner of its own
dynamic-vs-enum dispatch benchmark, benches/dynamic_vs_enum_dispatch).  In an
array program the idiomatic equivalent is to evaluate all four scatter rules
on the whole batch and select with masks: the rules are a handful of fused
elementwise ops each, and select is cheap compared to divergence.

Scatter semantics preserved exactly (see each function):
  * diffuse  — normal + random_unit_sphere, degenerate catch (materials.rs:42-52)
  * metal    — reflect + fuzz * random_unit_sphere, absorb when the scattered
               direction leaves through the surface (materials.rs:54-63)
  * dielectric — ALWAYS refracts; Schlick reflectance is commented out in the
               reference (materials.rs:74-96); the front-face test is
               ``dot(dir, normal) >= 0`` selecting (-n, 1/ir) vs (n, ir)
               (materials.rs:26-28, 65-71)
  * emission — terminal (materials.rs:100-102)

The random draw (one unit-sphere sample per bounce) is taken unconditionally —
with counter-based RNG streams there is no sequential stream to preserve, so
materials that don't consume randomness simply ignore it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from . import maths
from .scene import DIFFUSE, METAL, DIELECTRIC, EMISSION, Materials


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ScatterData:
    """Batched ScatterData (materials.rs:14-17)."""
    color: jax.Array      # [B, 3] attenuation (or emission) color
    direction: jax.Array  # [B, 3] unit next-ray direction (valid if ~terminal)
    terminal: jax.Array   # [B] bool — True where next_ray would be None


def _safe_normalize(v, fallback):
    """normalize(v), falling back where |v| == 0 to keep NaNs out of both the
    primal and the gradient (double-where pattern)."""
    sq = jnp.sum(v * v, axis=-1, keepdims=True)
    zero = sq == 0.0
    inv = jax.lax.rsqrt(jnp.where(zero, 1.0, sq))
    return jnp.where(zero, fallback, v * inv)


def random_unit_sphere(bx, by, bz):
    """common.rs:32-38 — a cube sample in [-1,1]^3 normalized to the sphere
    SURFACE (cube-corner biased, not rejection-sampled).  This exact
    distribution is part of image parity; do not 'fix' it."""
    v = jnp.stack([bx, by, bz], axis=-1)
    return maths.normalize(v)


def scatter(materials: Materials, mat_idx, ray_direction, normal, rand_unit
            ) -> ScatterData:
    """Evaluate MaterialType::scatter for the whole batch.

    mat_idx: [B] int32 rows into the material table.
    ray_direction: [B, 3] unit incoming directions.
    normal: [B, 3] unit outward surface normals at the hit points.
    rand_unit: [B, 3] unit-sphere samples (one per ray for this bounce).
    """
    kind = materials.kind[mat_idx]          # [B]
    albedo = materials.color[mat_idx]       # [B, 3]
    fuzz = materials.fuzz[mat_idx][:, None]
    ir = materials.ir[mat_idx]

    # ---- diffuse (materials.rs:42-52)
    dif_raw = normal + rand_unit
    degenerate = maths.near_zero(dif_raw)[:, None]
    dif_dir = jnp.where(degenerate, normal, _safe_normalize(dif_raw, normal))

    # ---- metal (materials.rs:54-63)
    reflected = maths.reflect(ray_direction, normal)
    met_raw = reflected + fuzz * rand_unit
    # hit_front_face(direction, normal): dot >= 0 keeps the ray
    met_keep = maths.dot(met_raw, normal) >= 0.0
    met_dir = _safe_normalize(met_raw, normal)

    # ---- dielectric (materials.rs:65-97): always refracts
    inside = maths.dot(ray_direction, normal) >= 0.0
    n_eff = jnp.where(inside[:, None], -normal, normal)
    ratio = jnp.where(inside, 1.0 / ir, ir)
    refracted = maths.refract(ray_direction, n_eff, ratio)
    die_dir = _safe_normalize(refracted, n_eff)

    # ---- select
    is_dif = kind == DIFFUSE
    is_met = kind == METAL
    is_die = kind == DIELECTRIC
    is_emi = kind == EMISSION

    color = jnp.where(is_die[:, None], jnp.ones_like(albedo), albedo)
    direction = jnp.where(
        is_dif[:, None], dif_dir,
        jnp.where(is_met[:, None], met_dir,
                  jnp.where(is_die[:, None], die_dir, normal)),
    )
    terminal = is_emi | (is_met & ~met_keep)
    return ScatterData(color=color, direction=direction, terminal=terminal)


def scatter_exact(materials: Materials, mat_idx, ray_direction, normal,
                  rand_unit) -> ScatterData:
    """Single-ray variant (shapes [3] / []) with identical semantics, used by
    the sequential parity renderer.  Arithmetic matches the reference's
    per-scalar op order (the vector ops here are per-lane identical)."""
    kind = materials.kind[mat_idx]
    albedo = materials.color[mat_idx]
    fuzz = materials.fuzz[mat_idx]
    ir = materials.ir[mat_idx]

    dif_raw = normal + rand_unit
    degenerate = maths.near_zero(dif_raw)
    sq = jnp.sum(dif_raw * dif_raw)
    # reference normalizes via x / sqrt(len^2) (maths.rs:111-118); use the
    # same form (not rsqrt) for bit parity
    ln = maths.safe_sqrt(jnp.where(sq == 0.0, 1.0, sq))
    dif_dir = jnp.where(degenerate, normal, dif_raw / ln)

    reflected = maths.reflect(ray_direction, normal)
    met_raw = reflected + fuzz * rand_unit
    met_keep = jnp.sum(met_raw * normal) >= 0.0
    msq = jnp.sum(met_raw * met_raw)
    mln = maths.safe_sqrt(jnp.where(msq == 0.0, 1.0, msq))
    met_dir = jnp.where(msq == 0.0, normal, met_raw / mln)

    inside = jnp.sum(ray_direction * normal) >= 0.0
    n_eff = jnp.where(inside, -normal, normal)
    ratio = jnp.where(inside, 1.0 / ir, ir)
    refracted = maths.refract(ray_direction, n_eff, ratio)
    rsq = jnp.sum(refracted * refracted)
    rln = maths.safe_sqrt(jnp.where(rsq == 0.0, 1.0, rsq))
    die_dir = jnp.where(rsq == 0.0, n_eff, refracted / rln)

    is_dif = kind == DIFFUSE
    is_met = kind == METAL
    is_die = kind == DIELECTRIC
    is_emi = kind == EMISSION

    color = jnp.where(is_die, jnp.ones_like(albedo), albedo)
    direction = jnp.where(is_dif, dif_dir,
                          jnp.where(is_met, met_dir,
                                    jnp.where(is_die, die_dir, normal)))
    terminal = is_emi | (is_met & ~met_keep)
    return ScatterData(color=color, direction=direction, terminal=terminal)


def draws_random(materials: Materials, mat_idx):
    """True where the reference's scatter consumes 3 RNG draws: diffuse and
    metal sample random_unit_sphere (materials.rs:44,56); dielectric and
    emission draw nothing.  Used for lockstep stream accounting in the
    parity renderer."""
    kind = materials.kind[mat_idx]
    return (kind == DIFFUSE) | (kind == METAL)
