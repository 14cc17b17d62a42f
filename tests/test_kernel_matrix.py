"""The fused kernel (Pallas interpreter on the CPU) against the XLA
wavefront renderer over scenes x depths x image shapes.

Both implement the same algorithm with the same pcg3d streams, so images
agree to float rounding and segment counts agree exactly.  XLA fuses and
contracts the two programs' float ops differently, and a path amplifies a
last-bit difference: the sphere quadratic's |oc|^2 - r^2 against the
r = 100..1000 ground and wall spheres, and refraction near grazing
incidence, grow it to ~2e-4 on single pixels after four bounces (observed
on random_spheres).  Tolerance: mean |diff| <= 2e-6 over the image, which
a wrong branch on one pixel in ~300 would break, and max |diff| <= 1e-3
(relative to max(1, radiance), for the emissive box).  Shapes cover a
pixel count that is not a multiple of the block and a row band (``shard_rows`` rows from ``row_offset``), the form
the CLI's progress banding and the sharded path use.
"""

import numpy as np
import pytest

import raytracer_tpu as rt
from raytracer_tpu import ops
from raytracer_tpu.ops.pallas import wavefront as wf
from raytracer_tpu.scene import DIFFUSE, build_materials, build_scene

BLOCK = 32


def _scene(name):
    if name == "default_world":
        w = rt.models.default_world()
        return w.to_scene(), w.to_camera()
    if name == "random_spheres":
        return rt.models.random_spheres(n=96, seed=5)
    if name == "ffi_triangles":
        w = rt.models.ffi_example_world()
        return w.to_scene(), w.to_camera()
    if name == "icosphere_1292":
        return rt.models.mesh_scene(subdivisions=3)
    if name == "empty":
        scene = build_scene([], [], build_materials(
            [(DIFFUSE, (0.5, 0.5, 0.5), 0.0, 1.0)]))
        return scene, rt.Camera.new_at((0.0, 0.0, 0.0), 1.5)
    return rt.models.cornell_spheres()


_CACHE = {}


def assert_rounding_close(img, ref):
    img, ref = np.asarray(img), np.asarray(ref)
    diff = np.abs(img - ref)
    assert diff.mean() <= 2e-6, diff.mean()
    assert (diff <= 1e-3 * np.maximum(1.0, np.abs(ref))).all(), diff.max()


def scene_and_camera(name):
    if name not in _CACHE:
        _CACHE[name] = _scene(name)
    return _CACHE[name]


SCENES = ["default_world", "random_spheres", "ffi_triangles",
          "icosphere_1292", "empty", "cornell_emissive"]


@pytest.mark.parametrize("depth", [0, 1, 4])
@pytest.mark.parametrize("name", SCENES)
class TestKernelMatchesXla:
    def _check(self, img, segs, ref, seg_ref):
        assert_rounding_close(img, ref)
        assert float(segs) == float(seg_ref)

    def test_pixel_count_not_multiple_of_block(self, name, depth):
        scene, cam = scene_and_camera(name)
        pps = not scene.exact_planes
        W, H = 13, 7                       # 91 pixels: 3 blocks of 32
        sph, tri, scl, tcl = ops.scene_tables(scene, pps)
        img, segs = wf.render_linear_pallas(
            sph, tri, wf.camera_vec(cam), width=W, height=H,
            samples_per_pixel=2, depth=depth, seed=9, block_pixels=BLOCK,
            parity_plane_sign=pps, interpret=True, sph_clusters=scl,
            tri_clusters=tcl)
        ref, seg_ref = rt.render_linear(
            scene, cam, width=W, height=H, samples_per_pixel=2, depth=depth,
            seed=9, parity_plane_sign=pps)
        assert img.shape == (H, W, 3)
        self._check(img, segs, ref, seg_ref)

    def test_row_band(self, name, depth):
        scene, cam = scene_and_camera(name)
        pps = not scene.exact_planes
        W, H, rows, r0 = 20, 9, 4, 3
        sph, tri, scl, tcl = ops.scene_tables(scene, pps)
        img, _ = wf.render_linear_pallas(
            sph, tri, wf.camera_vec(cam), width=W, height=H,
            samples_per_pixel=1, depth=depth, seed=2, block_pixels=BLOCK,
            parity_plane_sign=pps, interpret=True, sph_clusters=scl,
            tri_clusters=tcl, shard_rows=rows, row_offset=r0)
        ref, _ = rt.render_linear(
            scene, cam, width=W, height=H, samples_per_pixel=1, depth=depth,
            seed=2, parity_plane_sign=pps)
        assert img.shape == (rows, W, 3)
        assert_rounding_close(img, np.asarray(ref)[r0:r0 + rows])
