"""3x3 matrix ops on ``[..., 3, 3]`` arrays (row-major, rows = last-but-one axis).

Batched equivalent of the reference's scalar ``Mat3``
(``/root/reference/raytracer/src/mat3.rs:7-131``): mul, transpose, determinant,
cofactor, adjugate, and Cramer-rule inverse, all batched over leading axes.

The reference's ``mul_vec3`` is a stub bug that returns its argument unchanged
(mat3.rs:52-54); here ``mul_vec3`` is implemented correctly (the stub only
backed a commented-out triangle path, common.rs:195-219, so nothing in the
render pipeline depends on the buggy behavior).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "identity", "mat3", "mul", "mul_vec3", "mul_scalar", "transpose",
    "det", "cofactor", "adjugate", "inverse",
]


def mat3(r1, r2, r3):
    """Stack three [..., 3] row vectors into a [..., 3, 3] matrix."""
    return jnp.stack([jnp.asarray(r1), jnp.asarray(r2), jnp.asarray(r3)], axis=-2)


def identity(dtype=jnp.float32):
    return jnp.eye(3, dtype=dtype)


def mul(a, b):
    """Matrix product (mat3.rs:31-51)."""
    return jnp.matmul(a, b)


def mul_vec3(a, v):
    """Matrix-vector product — the *corrected* semantics (see module doc)."""
    return jnp.matmul(a, v[..., None])[..., 0]


def mul_scalar(a, s):
    return a * s


def transpose(a):
    """mat3.rs:125-131."""
    return jnp.swapaxes(a, -1, -2)


def _cof_entries(a):
    r1, r2, r3 = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    x, y, z = 0, 1, 2
    c11 = r2[..., y] * r3[..., z] - r3[..., y] * r2[..., z]
    c12 = -(r2[..., x] * r3[..., z] - r3[..., x] * r2[..., z])
    c13 = r2[..., x] * r3[..., y] - r3[..., x] * r2[..., y]
    c21 = -(r1[..., y] * r3[..., z] - r3[..., y] * r1[..., z])
    c22 = r1[..., x] * r3[..., z] - r3[..., x] * r1[..., z]
    c23 = -(r1[..., x] * r3[..., y] - r3[..., x] * r1[..., y])
    c31 = r1[..., y] * r2[..., z] - r2[..., y] * r1[..., z]
    c32 = -(r1[..., x] * r2[..., z] - r2[..., x] * r1[..., z])
    c33 = r1[..., x] * r2[..., y] - r2[..., x] * r1[..., y]
    return c11, c12, c13, c21, c22, c23, c31, c32, c33


def cofactor(a):
    """Cofactor matrix (mat3.rs:57-77)."""
    c11, c12, c13, c21, c22, c23, c31, c32, c33 = _cof_entries(a)
    return mat3(
        jnp.stack([c11, c12, c13], axis=-1),
        jnp.stack([c21, c22, c23], axis=-1),
        jnp.stack([c31, c32, c33], axis=-1),
    )


def adjugate(a):
    """Transposed cofactor matrix (mat3.rs:78-80)."""
    return transpose(cofactor(a))


def det(a):
    """Determinant by first-row expansion (mat3.rs:118-122)."""
    c11, c12, c13, *_ = _cof_entries(a)
    r1 = a[..., 0, :]
    return r1[..., 0] * c11 + r1[..., 1] * c12 + r1[..., 2] * c13


def inverse(a, *, default=None):
    """Cramer-rule inverse (mat3.rs:82-116).

    The reference returns ``None`` when det == 0; here singular inputs yield
    ``default`` (identity unless given) plus a boolean validity mask, keeping
    the op usable under vmap/jit.

    Returns: (inv [...,3,3], valid [...]).
    """
    adj = adjugate(a)
    d = det(a)
    valid = d != 0.0
    safe_d = jnp.where(valid, d, 1.0)
    inv = adj * (1.0 / safe_d)[..., None, None]
    if default is None:
        default = identity(a.dtype)
    inv = jnp.where(valid[..., None, None], inv, default)
    return inv, valid
