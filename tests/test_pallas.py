"""Fused kernel tests (interpreter mode — runs on the CPU test harness;
the compiled GPU kernel is exercised by tests/test_gpu.py and
chip_smoke.py on the card)."""

import numpy as np
import jax.numpy as jnp
import pytest

import raytracer_tpu as rt
from raytracer_tpu.ops.pallas import wavefront as wf


def _tables(world):
    scene = world.to_scene()
    cam = world.to_camera()
    return (scene, cam, jnp.asarray(wf.pack_spheres(scene)),
            jnp.asarray(wf.pack_triangles(scene)), wf.camera_vec(cam))


class TestKernelInterpret:
    def test_matches_xla_path_spheres(self, default_world):
        scene, cam, sph, tri, cv = _tables(default_world)
        img, segs = wf.render_linear_pallas(
            sph, tri, cv, width=16, height=8, samples_per_pixel=2, depth=3,
            block_pixels=32, interpret=True)
        ref, segr = rt.render_linear(scene, cam, width=16, height=8,
                                     samples_per_pixel=2, depth=3)
        np.testing.assert_allclose(np.asarray(img), np.asarray(ref),
                                   atol=1e-5)
        assert float(segs) == float(segr)

    def test_matches_xla_path_triangles(self, ffi_world):
        scene, cam, sph, tri, cv = _tables(ffi_world)
        img, segs = wf.render_linear_pallas(
            sph, tri, cv, width=16, height=16, samples_per_pixel=1, depth=3,
            block_pixels=32, interpret=True)
        ref, segr = rt.render_linear(scene, cam, width=16, height=16,
                                     samples_per_pixel=1, depth=3)
        np.testing.assert_allclose(np.asarray(img), np.asarray(ref),
                                   atol=1e-5)
        assert float(segs) == float(segr)

    def test_nondivisible_pixels_padded(self, default_world):
        # 13x7 = 91 pixels < one 128-pixel block: padding pixels are inert
        scene, cam, sph, tri, cv = _tables(default_world)
        img, _ = wf.render_linear_pallas(
            sph, tri, cv, width=13, height=7, samples_per_pixel=1, depth=2,
            block_pixels=128, interpret=True)
        ref, _ = rt.render_linear(scene, cam, width=13, height=7,
                                  samples_per_pixel=1, depth=2)
        np.testing.assert_allclose(np.asarray(img), np.asarray(ref),
                                   atol=1e-5)


class TestClusterCulling:
    """Block-level bounding-sphere culling must be a pure optimization:
    bit-identical to the flat primitive scan."""

    def test_sphere_clusters_exact(self):
        scene, cam = rt.models.random_spheres(n=96, seed=11)
        cv = wf.camera_vec(cam)
        sph = jnp.asarray(wf.pack_spheres(scene))
        tri = jnp.asarray(wf.pack_triangles(scene))
        flat, segf = wf.render_linear_pallas(
            sph, tri, cv, width=24, height=16, samples_per_pixel=1, depth=3,
            block_pixels=32, interpret=True)
        perm, b, rg = wf.cluster_spheres(scene, leaf_target=16)
        sph_p = jnp.asarray(wf.pack_spheres(scene, perm=perm))
        clus, segc = wf.render_linear_pallas(
            sph_p, tri, cv, width=24, height=16, samples_per_pixel=1,
            depth=3, block_pixels=32, interpret=True,
            sph_clusters=(jnp.asarray(b), jnp.asarray(rg)))
        np.testing.assert_array_equal(np.asarray(flat), np.asarray(clus))
        assert float(segf) == float(segc)

    def test_tri_clusters_exact_correct_plane_sign(self):
        scene, cam = rt.models.mesh_scene(subdivisions=2)
        cv = wf.camera_vec(cam)
        sph = jnp.asarray(wf.pack_spheres(scene))
        tri = jnp.asarray(wf.pack_triangles(scene))
        flat, _ = wf.render_linear_pallas(
            sph, tri, cv, width=24, height=16, samples_per_pixel=1, depth=3,
            block_pixels=32, interpret=True, parity_plane_sign=False)
        perm, b, rg = wf.cluster_triangles(scene, leaf_target=24)
        tri_p = jnp.asarray(wf.pack_triangles(scene, perm=perm))
        clus, _ = wf.render_linear_pallas(
            sph, tri_p, cv, width=24, height=16, samples_per_pixel=1,
            depth=3, block_pixels=32, interpret=True, parity_plane_sign=False,
            tri_clusters=(jnp.asarray(b), jnp.asarray(rg)))
        np.testing.assert_array_equal(np.asarray(flat), np.asarray(clus))

    def test_tri_clusters_rejected_in_parity_mode(self):
        scene, cam = rt.models.mesh_scene(subdivisions=1)
        cv = wf.camera_vec(cam)
        sph = jnp.asarray(wf.pack_spheres(scene))
        perm, b, rg = wf.cluster_triangles(scene)
        tri_p = jnp.asarray(wf.pack_triangles(scene, perm=perm))
        with pytest.raises(ValueError, match="parity_plane_sign"):
            wf.render_linear_pallas(
                sph, tri_p, cv, width=8, height=8, samples_per_pixel=1,
                depth=2, block_pixels=32, interpret=True,
                parity_plane_sign=True,
                tri_clusters=(jnp.asarray(b), jnp.asarray(rg)))

    def test_cluster_perm_covers_all_columns(self):
        scene, cam = rt.models.random_spheres(n=70, seed=3)
        perm, b, rg = wf.cluster_spheres(scene, leaf_target=16)
        assert sorted(perm.tolist()) == list(range(scene.num_spheres))
        # every range lies inside the valid prefix and they tile it
        n_valid = int(np.asarray(scene.sphere_valid).sum())
        starts = sorted(rg[0].tolist())
        ends = sorted(rg[1].tolist())
        assert starts[0] == 0 and ends[-1] == n_valid
        assert starts[1:] == ends[:-1]


class TestSceneTables:
    def test_pack_spheres_layout(self, default_world):
        scene = default_world.to_scene()
        t = wf.pack_spheres(scene)
        assert t.shape == (wf.SPH_ROWS, scene.num_spheres)
        # ground sphere first: r^2 = 10000
        assert t[wf._SPH_R2, 0] == pytest.approx(10000.0)
        # all valid -> r2 > 0
        assert (t[wf._SPH_R2] > 0).all()

    def test_pack_spheres_invalid_rows(self, default_world):
        scene = default_world.to_scene(pad_spheres_to=12)
        t = wf.pack_spheres(scene)
        assert (t[wf._SPH_R2, 8:] < 0).all()   # padding can never hit

    def test_pack_triangles_zero_normal_padding(self, default_world):
        scene = default_world.to_scene()  # no triangles -> 1 padded row
        t = wf.pack_triangles(scene)
        assert t.shape == (wf.TRI_ROWS, 1)
        assert (t[:3, 0] == 0).all()      # zero plane normal -> parallel

    def test_camera_vec(self, default_world):
        cv = np.asarray(wf.camera_vec(default_world.to_camera()))
        assert cv.shape == (12,)
        np.testing.assert_allclose(cv[0:3], [0, 0, 0], atol=1e-7)


class TestEngineDispatch:
    def test_auto_on_cpu_uses_xla(self, default_world):
        from raytracer_tpu import ops as ops_mod
        assert not ops_mod.backend_is_gpu()
        scene = default_world.to_scene()
        cam = default_world.to_camera()
        img, segs = ops_mod.render_linear_fast(
            scene, cam, width=16, height=8, samples_per_pixel=1, depth=2)
        ref, _ = rt.render_linear(scene, cam, width=16, height=8,
                                  samples_per_pixel=1, depth=2)
        assert np.array_equal(np.asarray(img), np.asarray(ref))

    def test_explicit_xla_engine(self, default_world):
        scene = default_world.to_scene()
        cam = default_world.to_camera()
        fb, segs = rt.ray_trace(scene, cam, 16, 8,
                                rt.Options(samples_per_pixel=1,
                                           max_ray_bounces=2, engine="xla"))
        assert fb.shape == (8, 16, 4)


class TestNegativeRadius:
    """(p-c)/r normal semantics (common.rs:94-95): a negative radius flips
    the normal — the RTiOW hollow-glass trick — and must behave identically
    in the scan path and the fused kernel."""

    def _scene(self, rin):
        from raytracer_tpu import scene as scene_mod
        mats = scene_mod.build_materials([
            (scene_mod.DIFFUSE, (0.8, 0.8, 0.0), 0.0, 1.0),
            (scene_mod.DIELECTRIC, (1.0, 1.0, 1.0), 0.0, 1.5),
        ])
        return scene_mod.build_scene(
            [((0.0, -100.5, -1.0), 100.0, 0),
             ((0.0, 0.0, -1.0), 0.5, 1),
             ((0.0, 0.0, -1.0), rin, 1)], [], mats)

    def test_hollow_glass_kernel_matches_scan(self):
        from raytracer_tpu.camera import Camera
        from raytracer_tpu import ops as ops_mod
        cam = Camera.new_at((0.0, 0.0, 0.0), 16 / 9)
        kw = dict(width=32, height=18, samples_per_pixel=2, depth=8, seed=1)
        img_scan, _ = rt.render_linear(self._scene(-0.4), cam, **kw)
        sph, tri, scl, tcl = ops_mod.scene_tables(self._scene(-0.4), True)
        img_k, _ = wf.render_linear_pallas(
            sph, tri, wf.camera_vec(cam), interpret=True, **kw)
        np.testing.assert_allclose(np.asarray(img_scan), np.asarray(img_k),
                                   atol=1e-4)
        # the sign must actually matter: +0.4 inner sphere renders differently
        img_pos, _ = rt.render_linear(self._scene(0.4), cam, **kw)
        assert float(np.abs(np.asarray(img_scan)
                            - np.asarray(img_pos)).max()) > 0.1

    def test_matches_oracle_exact_engines(self):
        # scan path vs the argmin formulation (which divides by r directly)
        from raytracer_tpu import intersect
        from raytracer_tpu.camera import Camera
        scene = self._scene(-0.4)
        cam = Camera.new_at((0.0, 0.0, 0.0), 16 / 9)
        import jax.numpy as jnp
        origin = jnp.zeros((64, 3), jnp.float32)
        u = jnp.linspace(0.05, 0.95, 64)
        o, d = cam.cast_rays(u, jnp.full((64,), 0.5))
        pack = intersect.pack_scene(scene)
        h1 = intersect.closest_hit_batch(o, d, scene, pack)
        h2 = intersect.closest_hit_batch_argmin(o, d, scene, pack)
        hit = np.asarray(h1.hit)
        assert hit.any()
        np.testing.assert_array_equal(hit, np.asarray(h2.hit))
        np.testing.assert_allclose(np.asarray(h1.normal)[hit],
                                   np.asarray(h2.normal)[hit], atol=1e-5)


class TestCudaLowering:
    """The kernel lowers through Pallas's Triton route for the GPU on the
    CPU harness (cross-platform lowering): every primitive the kernel uses
    must have a Triton lowering rule.  Compiling the Triton IR to PTX needs
    the card (tests/test_gpu.py)."""

    @pytest.mark.parametrize("name,pps", [("default_world", True),
                                          ("random_spheres", False),
                                          ("mesh", False), ("mesh", True)])
    def test_lowers_to_one_triton_call(self, name, pps):
        import jax
        from raytracer_tpu import ops as ops_mod
        if name == "default_world":
            w = rt.models.default_world()
            scene, cam = w.to_scene(), w.to_camera()
        elif name == "random_spheres":
            scene, cam = rt.models.random_spheres(n=96, seed=1)
        else:
            scene, cam = rt.models.mesh_scene(subdivisions=2)
        sph, tri, scl, tcl = ops_mod.scene_tables(scene, pps)
        assert (scl is not None) == (name == "random_spheres")
        assert (tcl is not None) == (name == "mesh" and not pps)

        def render(s, t, c, sc, tc):
            return wf.render_linear_pallas(
                s, t, c, width=40, height=20, samples_per_pixel=2, depth=3,
                block_pixels=128, parity_plane_sign=pps, sph_clusters=sc,
                tri_clusters=tc)

        text = jax.jit(render).trace(
            sph, tri, wf.camera_vec(cam), scl, tcl).lower(
                lowering_platforms=("cuda",)).as_text()
        assert text.count("custom_call @__gpu$xla.gpu.triton") == 1
        assert "grid_x = 7 : i32" in text      # ceil(40 * 20 / 128)
