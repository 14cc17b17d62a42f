"""Engine-dispatch decision table (ops.resolve_dispatch).

``gpu=True`` / ``gpu=False`` force the backend branch so the table is
testable on the CPU backend.  Auto dispatch never falls back silently: the
kernel asked for by name off the GPU raises unless the Pallas interpreter
is requested.
"""

import warnings

import numpy as np
import pytest

import raytracer_tpu as rt
from raytracer_tpu import ops
from raytracer_tpu.models.builders import icosphere_mesh
from raytracer_tpu.scene import DIFFUSE, METAL, build_materials, build_scene


def big_mesh_scene(exact_planes=True):
    """20480-tri icosphere on a ground sphere."""
    tris = icosphere_mesh((0.0, 0.0, -1.2), 0.5, 0, 5)
    mats = build_materials([(DIFFUSE, (0.7, 0.3, 0.3), 0.0, 1.0),
                            (METAL, (0.8, 0.8, 0.8), 0.1, 1.0)])
    return build_scene([((0.0, -100.5, -1.0), 100.0, 1)], tris, mats,
                       exact_planes=exact_planes)


def _scene(name):
    if name == "default_world":
        return rt.models.default_world().to_scene()
    if name == "random_spheres":
        return rt.models.random_spheres(n=96, seed=2)[0]
    if name == "mesh":
        return rt.models.mesh_scene(subdivisions=2)[0]
    if name == "empty":
        return build_scene([], [], build_materials(
            [(DIFFUSE, (0.5, 0.5, 0.5), 0.0, 1.0)]))
    return big_mesh_scene()


SCENES = ["default_world", "random_spheres", "mesh", "empty", "big_mesh"]


class TestResolveDispatch:
    def test_reference_scene_keeps_parity_sign(self, default_world):
        scene = default_world.to_scene()
        assert not scene.exact_planes
        engine, pps, warn = ops.resolve_dispatch(scene, None, gpu=True)
        assert (engine, pps, warn) == ("pallas", True, None)

    def test_procedural_scene_resolves_exact_planes(self):
        scene, _ = rt.models.mesh_scene(subdivisions=2)
        assert scene.exact_planes
        engine, pps, warn = ops.resolve_dispatch(scene, None, gpu=True)
        assert (engine, pps, warn) == ("pallas", False, None)

    @pytest.mark.parametrize("gpu", [True, False])
    @pytest.mark.parametrize("name", SCENES)
    def test_auto_picks_kernel_exactly_on_gpu(self, name, gpu):
        engine, _, warn = ops.resolve_dispatch(_scene(name), None, gpu=gpu)
        assert engine == ("pallas" if gpu else "xla")
        assert warn is None

    @pytest.mark.parametrize("name", ["default_world", "mesh"])
    def test_explicit_kernel_off_gpu_raises(self, name):
        with pytest.raises(ValueError, match="interpret=True"):
            ops.resolve_dispatch(_scene(name), None, engine="pallas",
                                 gpu=False)

    def test_explicit_kernel_off_gpu_with_interpreter(self):
        scene, _ = rt.models.mesh_scene(subdivisions=2)
        engine, pps, warn = ops.resolve_dispatch(
            scene, None, engine="pallas", gpu=False, interpret=True)
        assert (engine, pps, warn) == ("pallas", False, None)

    @pytest.mark.parametrize("engine", ["pallas_binned", "pallas_sorted",
                                        "pallas_stream", "mosaic"])
    def test_unknown_engine_raises(self, default_world, engine):
        with pytest.raises(ValueError, match="unknown engine"):
            ops.resolve_dispatch(default_world.to_scene(), None,
                                 engine=engine, gpu=True)

    def test_big_mesh_explicit_parity_warns_loudly(self):
        # honoring an explicit parity_plane_sign=True switches triangle
        # culling off: the dispatch must say so
        scene = big_mesh_scene(exact_planes=False)
        engine, pps, warn = ops.resolve_dispatch(scene, True, gpu=True)
        assert engine == "pallas" and pps is True
        assert warn is not None and "parity_plane_sign" in warn

    def test_small_mesh_parity_below_cull_threshold_is_quiet(self, ffi_world):
        scene = ffi_world.to_scene()
        assert scene.num_triangles < ops.CLUSTER_MIN_TRIS
        engine, pps, warn = ops.resolve_dispatch(scene, True, gpu=True)
        assert (engine, pps, warn) == ("pallas", True, None)

    def test_cpu_backend_uses_xla_without_warning(self):
        scene = big_mesh_scene()
        engine, pps, warn = ops.resolve_dispatch(scene, None, gpu=False)
        assert (engine, pps, warn) == ("xla", False, None)

    def test_explicit_engine_is_respected(self):
        scene, _ = rt.models.mesh_scene(subdivisions=2)
        engine, pps, _ = ops.resolve_dispatch(scene, None, engine="xla",
                                              gpu=True)
        assert engine == "xla" and pps is False

    def test_options_default_is_auto(self):
        assert rt.Options().parity_plane_sign is None
        assert rt.Options().engine == "auto"

    def test_backend_detection_on_cpu(self):
        assert not ops.backend_is_gpu()


class TestRenderLinearFastDispatch:
    def test_kernel_by_name_on_cpu_raises(self, default_world):
        with pytest.raises(ValueError, match="interpret=True"):
            ops.render_linear_fast(
                default_world.to_scene(), default_world.to_camera(),
                width=8, height=4, samples_per_pixel=1, depth=1,
                engine="pallas")

    def test_kernel_by_name_interpreted_matches_xla(self, default_world):
        scene, cam = default_world.to_scene(), default_world.to_camera()
        kw = dict(width=12, height=6, samples_per_pixel=1, depth=2, seed=4)
        k, ks = ops.render_linear_fast(scene, cam, engine="pallas",
                                       interpret=True, **kw)
        x, xs = ops.render_linear_fast(scene, cam, **kw)
        np.testing.assert_allclose(np.asarray(k), np.asarray(x), atol=1e-5)
        assert float(ks) == float(xs)

    def test_parity_warning_surfaces_as_python_warning(self):
        scene, cam = rt.models.mesh_scene(subdivisions=2)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ops.render_linear_fast(scene, cam, width=4, height=2,
                                   samples_per_pixel=1, depth=1,
                                   parity_plane_sign=True, engine="pallas",
                                   interpret=True)
        assert any("parity_plane_sign" in str(w.message) for w in caught)
