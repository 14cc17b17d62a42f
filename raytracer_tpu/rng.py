"""Deterministic random numbers, two ways.

The reference uses ONE sequential xorshift32 stream (seed 2547549) consumed in
raster order (``/root/reference/raytracer/src/random.rs:8-30``, instantiated
once per render at ``common.rs:321``).  A sequential stream is the opposite of
what a data-parallel device wants, so this framework has two generators:

1. ``xorshift32`` / ``XorShift32`` — an exact uint32 port of the reference
   stream.  Used by the NumPy oracle and by the sequential *parity renderer*
   (`render.ray_trace_parity`) for golden-image tests: same seed, same draw
   order, same ``u32 / u32::MAX`` float mapping (random.rs:15-17).

2. ``pcg3d`` — a counter-based hash RNG for the fast wavefront path: each
   (pixel, sample, bounce) gets an independent stream with NO sequential
   dependency, so a million rays draw in parallel.  This replaces
   the *mechanism* of random.rs while keeping its contract (deterministic,
   seedable, uniform in [0, 1]).  pcg3d is the public-domain hash of
   Jarzynski & Olano, "Hash Functions for GPU Rendering", JCGT 2020.
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

__all__ = [
    "DEFAULT_SEED", "U32_MAX_F32",
    "xorshift32", "random_f32_from_bits", "random_f32_from_bits24", "XorShift32",
    "pcg3d", "uniform3", "uniform_bilateral3", "uniform2",
]

# random.rs:9 — NonZeroU32::new(2547549)
DEFAULT_SEED = 2547549

# ``x as f32 / u32::MAX as f32`` — u32::MAX rounds to 4.2949673e9 in f32.
U32_MAX_F32 = np.float32(np.uint32(0xFFFFFFFF))


def xorshift32(state):
    """One xorshift32 step on uint32 array(s): random.rs:22-30.

    Returns the new state (which is also the output value).
    """
    x = jnp.asarray(state, jnp.uint32)
    x = x ^ (x << 13)
    x = x ^ (x >> 17)
    x = x ^ (x << 5)
    return x


def random_f32_from_bits(bits):
    """Map uint32 bits to f32 in [0, 1] exactly as random.rs:15-17.

    Rust's ``u32 as f32`` rounds to nearest; so does float32 conversion here.
    """
    return bits.astype(jnp.float32) / U32_MAX_F32


class XorShift32:
    """Stateful host-side clone of the reference ``Random`` (NumPy scalars).

    For oracle / test use only — the device path never threads state.
    """

    def __init__(self, seed: int = DEFAULT_SEED):
        assert seed != 0
        self.state = np.uint32(seed)

    def next_u32(self) -> np.uint32:
        x = self.state
        # np.uint32 ops wrap like Rust's Wrapping<u32>; silence numpy's
        # overflow-on-shift warnings by working in Python ints mod 2^32.
        v = int(x)
        v ^= (v << 13) & 0xFFFFFFFF
        v ^= v >> 17
        v ^= (v << 5) & 0xFFFFFFFF
        self.state = np.uint32(v)
        return self.state

    def random_f32(self) -> np.float32:
        """[0, 1] — random.rs:15-17."""
        return np.float32(np.float32(self.next_u32()) / U32_MAX_F32)

    def random_bilateral_f32(self) -> np.float32:
        """[-1, 1] — random.rs:19-21."""
        return np.float32(self.random_f32() * np.float32(2.0) - np.float32(1.0))


# ---------------------------------------------------------------------------
# Counter-based parallel RNG (fast wavefront path)
# ---------------------------------------------------------------------------

def pcg3d(v0, v1, v2):
    """pcg3d hash: 3x uint32 counters -> 3x uint32 random words.

    Pure elementwise uint32 ops, no cross-ray dependencies.
    """
    x = jnp.asarray(v0, jnp.uint32)
    y = jnp.asarray(v1, jnp.uint32)
    z = jnp.asarray(v2, jnp.uint32)
    mul = jnp.uint32(1664525)
    add = jnp.uint32(1013904223)
    x = x * mul + add
    y = y * mul + add
    z = z * mul + add
    x = x + y * z
    y = y + z * x
    z = z + x * y
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = x + y * z
    y = y + z * x
    z = z + x * y
    return x, y, z


def random_f32_from_bits24(bits):
    """[0, 1] from the TOP 24 bits: (bits >> 8) / (2^24 - 1).

    Used by the counter-based fast path (not the parity path) in both the
    XLA renderer and the fused kernel, which keeps their streams
    bit-identical.  The 24-bit value fits int32 exactly.
    """
    b24 = jax.lax.shift_right_logical(jnp.asarray(bits, jnp.uint32),
                                      jnp.uint32(8))
    i = jax.lax.bitcast_convert_type(b24, jnp.int32)
    return i.astype(jnp.float32) * jnp.float32(1.0 / 16777215.0)


def uniform3(v0, v1, v2):
    """Three independent uniforms in [0, 1] from three uint32 counters."""
    a, b, c = pcg3d(v0, v1, v2)
    return (
        random_f32_from_bits24(a),
        random_f32_from_bits24(b),
        random_f32_from_bits24(c),
    )


def uniform_bilateral3(v0, v1, v2):
    """Three independent uniforms in [-1, 1] (random.rs:19-21 mapping)."""
    a, b, c = uniform3(v0, v1, v2)
    two = jnp.float32(2.0)
    one = jnp.float32(1.0)
    return (a * two - one, b * two - one, c * two - one)


def uniform2(v0, v1, v2):
    """Two uniforms in [0, 1] (third word discarded)."""
    a, b, _ = pcg3d(v0, v1, v2)
    return random_f32_from_bits24(a), random_f32_from_bits24(b)
