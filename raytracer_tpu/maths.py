"""Vectorized 3-vector math on ``[..., 3]`` JAX arrays.

Array re-design of the reference's scalar vector library
(``/root/reference/raytracer/src/maths.rs``): instead of a ``Vec3`` struct with
operator overloads (maths.rs:60-95) and a type-state ``NVec3`` "normalized"
wrapper (maths.rs:98-138), everything here operates on arrays whose last axis
has length 3, so a whole wavefront of rays is one array and every op is a
fused elementwise kernel.

Semantics preserved from the reference (needed for allclose parity):
  * ``reflect(v, n) = v - 2 (v.n) n``                     (maths.rs:26-28)
  * ``refract`` clamps via ``abs`` under the sqrt          (maths.rs:31-36)
  * ``project(v, onto) = ((v.onto)/(onto.onto)) onto``     (maths.rs:21-23)
  * ``normalize`` divides by sqrt(|v|^2) with NO epsilon    (maths.rs:111-118)
  * ``near_zero`` = all(|c| < 1e-8) componentwise          (maths.rs:46-49)
  * NVec3::cross is NOT renormalized (new_unchecked,        maths.rs:131-137)
    — so camera basis vectors u, v stay unnormalized; we simply never
    renormalize cross products unless the reference does.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "dot", "cross", "length", "length_squared", "normalize", "near_zero",
    "reflect", "refract", "project", "lerp", "vec3", "safe_sqrt",
    "X_AXIS", "Y_AXIS", "Z_AXIS",
]


@jax.custom_jvp
def safe_sqrt(x):
    """sqrt with derivative 0 at x == 0 (instead of inf).

    The PRIMAL is bit-identical to jnp.sqrt — only the tangent rule changes,
    so parity-mode renders are unaffected.  Needed because sqrt shows up on
    exactly-zero inputs on masked/grazing lanes (e.g. refract's
    ``sqrt(abs(1 - |r_perp|^2))`` when 1 - cos^2 rounds to 1.0 in f32), and
    inf * 0 cotangents become NaN inside ``lax.scan`` transposes, where
    structurally-zero cotangents are materialized numeric zeros rather than
    being DCE'd as they are in unrolled code.
    """
    return jnp.sqrt(x)


@safe_sqrt.defjvp
def _safe_sqrt_jvp(primals, tangents):
    (x,), (t,) = primals, tangents
    y = jnp.sqrt(x)
    positive = x > 0
    dydx = jnp.where(positive, 0.5 / jnp.where(positive, y, 1.0), 0.0)
    return y, dydx * t


def vec3(x, y, z, dtype=jnp.float32):
    """Build a [3] vector (or stacked [..., 3] when args are arrays)."""
    return jnp.stack(
        [jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype)],
        axis=-1,
    )


X_AXIS = (1.0, 0.0, 0.0)
Y_AXIS = (0.0, 1.0, 0.0)
Z_AXIS = (0.0, 0.0, 1.0)


def dot(a, b):
    """Row-wise dot product over the last axis. maths.rs:82,125."""
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    """Cross product over the last axis.

    Written in the reference's exact arithmetic form (maths.rs:88-94):
    ``(ay*bz - az*by, -(ax*bz - az*bx), ax*by - ay*bx)`` — note the middle
    component is negated-subtraction, bit-identical to the usual form.
    """
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, -(ax * bz - az * bx), ax * by - ay * bx],
        axis=-1,
    )


def length_squared(v):
    return dot(v, v)


def length(v):
    return jnp.sqrt(length_squared(v))


def normalize(v):
    """x / sqrt(|v|^2), no epsilon — matches NVec3::new (maths.rs:111-118)."""
    return v / length(v)[..., None]


def near_zero(v, s=1e-8):
    """All components < 1e-8 in magnitude (maths.rs:46-49)."""
    return jnp.all(jnp.abs(v) < s, axis=-1)


def reflect(v, n):
    """v - 2 (v.n) n (maths.rs:26-28)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv, n, etai_over_etat):
    """Snell refraction, reference form (maths.rs:31-36).

    ``cos_theta = (-uv).n`` (no clamp to 1), ``r_perp = eta*(uv + cos*n)``,
    ``r_par = -sqrt(abs(1 - |r_perp|^2)) * n`` — the ``abs`` silently handles
    total internal reflection by reflecting the sign, exactly as the reference
    does (it never branches on TIR; Schlick is commented out,
    materials.rs:74-92).
    """
    eta = jnp.asarray(etai_over_etat)[..., None]
    cos_theta = dot(-uv, n)[..., None]
    r_out_perp = eta * (uv + cos_theta * n)
    r_out_parallel = (
        -safe_sqrt(jnp.abs(1.0 - length_squared(r_out_perp)))[..., None] * n
    )
    return r_out_perp + r_out_parallel


def project(v, onto):
    """Project v onto the line spanned by ``onto`` (maths.rs:21-23)."""
    return (dot(onto, v) / length_squared(onto))[..., None] * onto


def lerp(a, b, t):
    """a*(1-t) + b*t with t broadcast over the vector axis (common.rs:26-29)."""
    t = jnp.asarray(t)[..., None]
    return a * (1.0 - t) + b * t
