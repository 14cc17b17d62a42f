"""Scene model: structure-of-arrays pytrees.

The reference stores an array-of-structs world — ``Vec<Sphere>`` each carrying
its material (``/root/reference/raytracer/src/common.rs:53-58,227-230``).  The
layout here is the SoA split the reference author sketched in
``raytracer/TODO.txt:24-41``: primitive geometry in dense arrays (one array per
field) with integer material ids into a separate material table, so the
intersect inner loop streams contiguous f32 planes and the whole scene is one
replicated pytree in device memory.

Materials are a 4-way enum in the reference (materials.rs:7-12); here a
material is a row in a table: kind code + rgb color + fuzz + ir.

Primitive counts are static under jit.  ``sphere_valid`` / ``tri_valid`` masks
let scenes be padded (to lane multiples, or to represent "no triangles")
without recompilation or dummy-geometry hacks.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import jax
import numpy as np
import jax.numpy as jnp

from . import maths

# Material kind codes (materials.rs:7-12 enum order)
DIFFUSE, METAL, DIELECTRIC, EMISSION = 0, 1, 2, 3

MATERIAL_NAMES = {
    DIFFUSE: "Diffuse", METAL: "Metal", DIELECTRIC: "Dielectric",
    EMISSION: "Emission",
}


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Materials:
    """Material table, one row per named material (materials.rs:7-12)."""
    kind: jax.Array    # [M] int32 — DIFFUSE/METAL/DIELECTRIC/EMISSION
    color: jax.Array   # [M, 3] f32 — albedo / emission color (unused for dielectric)
    fuzz: jax.Array    # [M] f32 — metal only
    ir: jax.Array      # [M] f32 — dielectric only

    @property
    def count(self) -> int:
        return self.kind.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Scene:
    """Full world: spheres + triangles + material table (common.rs:227-230).

    Triangles are a single concatenated list — the reference's ``Vec<Mesh>``
    nesting only affects closest-hit tie-breaking on exactly-equal t values
    (measure zero), so meshes are flattened at build time.
    """
    sphere_center: jax.Array   # [S, 3] f32
    sphere_radius: jax.Array   # [S] f32
    sphere_mat: jax.Array      # [S] int32
    sphere_valid: jax.Array    # [S] bool

    tri_v0: jax.Array          # [T, 3] f32
    tri_v1: jax.Array          # [T, 3] f32
    tri_v2: jax.Array          # [T, 3] f32
    tri_mat: jax.Array         # [T] int32
    tri_valid: jax.Array       # [T] bool

    materials: Materials

    # Static metadata: True for scenes with NO reference-parity claim (OBJ /
    # procedural meshes), where the CORRECT triangle plane equation is the
    # right default.  Reference scenes keep False so parity renders keep the
    # wrong-sign formula (common.rs:140-141).  Engine dispatch reads this
    # when ``parity_plane_sign=None`` (ops.resolve_dispatch).
    exact_planes: bool = dataclasses.field(
        default=False, metadata=dict(static=True))

    @property
    def num_spheres(self) -> int:
        return self.sphere_center.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]


def build_materials(rows: Sequence[Tuple[int, Sequence[float], float, float]]) -> Materials:
    """rows: (kind, rgb, fuzz, ir) per material."""
    if not rows:
        rows = [(DIFFUSE, (0.0, 0.0, 0.0), 0.0, 1.0)]
    kind = np.array([r[0] for r in rows], np.int32)
    color = np.array([r[1] for r in rows], np.float32).reshape(len(rows), 3)
    fuzz = np.array([r[2] for r in rows], np.float32)
    ir = np.array([r[3] for r in rows], np.float32)
    return Materials(jnp.asarray(kind), jnp.asarray(color),
                     jnp.asarray(fuzz), jnp.asarray(ir))


def build_scene(
    spheres: Sequence[Tuple[Sequence[float], float, int]],
    triangles: Sequence[Tuple[Sequence[float], Sequence[float], Sequence[float], int]],
    materials: Materials,
    *,
    pad_spheres_to: int | None = None,
    pad_triangles_to: int | None = None,
    exact_planes: bool = False,
) -> Scene:
    """Build a Scene from host-side primitive lists.

    spheres: (center, radius, material_index) triples (parser.rs:237-269).
    triangles: (v0, v1, v2, material_index) (parser.rs:272-310).
    Padding rows are marked invalid and never hit.
    ``exact_planes``: mark the scene as having no reference-parity claim
    (see Scene.exact_planes).
    """
    ns = len(spheres)
    nt = len(triangles)
    ps = max(pad_spheres_to or ns, ns, 1)
    pt = max(pad_triangles_to or nt, nt, 1)

    sc = np.zeros((ps, 3), np.float32)
    sr = np.ones((ps,), np.float32)
    sm = np.zeros((ps,), np.int32)
    sv = np.zeros((ps,), bool)
    for i, (c, r, m) in enumerate(spheres):
        sc[i] = c
        sr[i] = r
        sm[i] = m
        sv[i] = True

    t0 = np.zeros((pt, 3), np.float32)
    t1 = np.zeros((pt, 3), np.float32)
    t2 = np.zeros((pt, 3), np.float32)
    tm = np.zeros((pt,), np.int32)
    tv = np.zeros((pt,), bool)
    for i, (v0, v1, v2, m) in enumerate(triangles):
        t0[i], t1[i], t2[i] = v0, v1, v2
        tm[i] = m
        tv[i] = True

    return Scene(
        sphere_center=jnp.asarray(sc), sphere_radius=jnp.asarray(sr),
        sphere_mat=jnp.asarray(sm), sphere_valid=jnp.asarray(sv),
        tri_v0=jnp.asarray(t0), tri_v1=jnp.asarray(t1), tri_v2=jnp.asarray(t2),
        tri_mat=jnp.asarray(tm), tri_valid=jnp.asarray(tv),
        materials=materials,
        exact_planes=exact_planes,
    )


def triangle_normals(scene: Scene) -> jax.Array:
    """Unit normals per triangle, Triangle::new semantics (common.rs:116-123)."""
    a = scene.tri_v1 - scene.tri_v0
    b = scene.tri_v2 - scene.tri_v0
    n = maths.cross(a, b)
    ln = maths.safe_sqrt(jnp.sum(n * n, axis=-1, keepdims=True))
    return n / jnp.where(ln == 0.0, 1.0, ln)
