"""Multi-device tests on the 8-device virtual CPU mesh (conftest forces
--xla_force_host_platform_device_count=8): the JAX-native fake backend for
distributed testing (SURVEY.md §4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import raytracer_tpu as rt
from raytracer_tpu import grad as gradmod, parallel


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest should expose 8 CPU devices"
    return parallel.make_mesh(8)


class TestShardedRender:
    def test_bitwise_equal_to_single_device(self, default_world, mesh8):
        scene = default_world.to_scene()
        cam = default_world.to_camera()
        img1, seg1 = rt.render_linear(scene, cam, width=48, height=24,
                                      samples_per_pixel=4, depth=4)
        img2, seg2 = parallel.render_linear_sharded(
            scene, cam, mesh=mesh8, width=48, height=24,
            samples_per_pixel=4, depth=4)
        assert np.array_equal(np.asarray(img1), np.asarray(img2))
        assert int(seg1) == int(seg2)

    def test_non_divisible_pixel_count_padded(self, default_world, mesh8):
        scene = default_world.to_scene()
        cam = default_world.to_camera()
        # 35 * 13 = 455 pixels, not a multiple of 8
        img1, _ = rt.render_linear(scene, cam, width=35, height=13,
                                   samples_per_pixel=2, depth=3)
        img2, _ = parallel.render_linear_sharded(
            scene, cam, mesh=mesh8, width=35, height=13,
            samples_per_pixel=2, depth=3)
        assert np.array_equal(np.asarray(img1), np.asarray(img2))

    def test_output_actually_sharded(self, default_world, mesh8):
        scene = default_world.to_scene()
        cam = default_world.to_camera()
        img, _ = parallel.render_linear_sharded(
            scene, cam, mesh=mesh8, width=32, height=16,
            samples_per_pixel=1, depth=2)
        # result must be addressable and correct on the host
        assert np.asarray(img).shape == (16, 32, 3)

    def test_subset_mesh(self, default_world):
        scene = default_world.to_scene()
        cam = default_world.to_camera()
        mesh2 = parallel.make_mesh(2)
        img1, _ = rt.render_linear(scene, cam, width=16, height=8,
                                   samples_per_pixel=2, depth=2)
        img2, _ = parallel.render_linear_sharded(
            scene, cam, mesh=mesh2, width=16, height=8,
            samples_per_pixel=2, depth=2)
        assert np.array_equal(np.asarray(img1), np.asarray(img2))

    def test_ray_trace_sharded_u8(self, default_world, mesh8):
        scene = default_world.to_scene()
        cam = default_world.to_camera()
        fb, segs = parallel.ray_trace_sharded(
            scene, cam, 32, 16,
            rt.Options(samples_per_pixel=2, max_ray_bounces=3), mesh=mesh8)
        fb1, _ = rt.ray_trace(scene, cam, 32, 16,
                              rt.Options(samples_per_pixel=2, max_ray_bounces=3))
        assert np.array_equal(fb, fb1)
        assert segs > 0


class TestShardedPallas:
    """The fused kernel under shard_map: every device runs the kernel
    (interpret mode on CPU) on its own interleaved rows; the gathered image
    must be bitwise identical to the single-device kernel render and the
    segment psum must match exactly."""

    def test_sharded_kernel_bitwise_equal(self, default_world, mesh8):
        from raytracer_tpu import ops as ops_mod
        from raytracer_tpu.ops.pallas import wavefront as wf
        scene = default_world.to_scene()
        cam = default_world.to_camera()
        W, H = 64, 48
        sph, tri, scl, tcl = ops_mod.scene_tables(scene, True)
        cv = wf.camera_vec(cam)
        ref, seg_ref = wf.render_linear_pallas(
            sph, tri, cv, width=W, height=H, samples_per_pixel=2, depth=4,
            seed=3, interpret=True, sph_clusters=scl, tri_clusters=tcl)
        out, seg = parallel.render_linear_sharded_fast(
            scene, cam, mesh=mesh8, width=W, height=H, samples_per_pixel=2,
            depth=4, seed=3, engine="pallas", interpret=True)
        assert np.array_equal(np.asarray(ref), np.asarray(out))
        assert int(seg_ref) == int(seg)

    def test_sharded_kernel_non_divisible_rows(self, default_world, mesh8):
        # 13 rows over 8 devices: rows_per=2, last shards get padding lanes
        scene = default_world.to_scene()
        cam = default_world.to_camera()
        from raytracer_tpu import ops as ops_mod
        from raytracer_tpu.ops.pallas import wavefront as wf
        W, H = 32, 13
        sph, tri, scl, tcl = ops_mod.scene_tables(scene, True)
        ref, seg_ref = wf.render_linear_pallas(
            sph, tri, wf.camera_vec(cam), width=W, height=H,
            samples_per_pixel=2, depth=3, seed=1, interpret=True,
            sph_clusters=scl, tri_clusters=tcl)
        out, seg = parallel.render_linear_sharded_fast(
            scene, cam, mesh=mesh8, width=W, height=H, samples_per_pixel=2,
            depth=3, seed=1, engine="pallas", interpret=True)
        assert np.array_equal(np.asarray(ref), np.asarray(out))
        assert int(seg_ref) == int(seg)

    @pytest.mark.parametrize("W,H", [(64, 48), (48, 37)])
    def test_sharded_kernel_mesh_culling_bitwise_equal(self, mesh8, W, H):
        # exact-plane mesh: triangle cluster culling on every device;
        # heights that don't divide the device count pad with dead rows
        from raytracer_tpu import ops as ops_mod
        from raytracer_tpu.ops.pallas import wavefront as wf
        scene, cam = rt.models.mesh_scene(subdivisions=2)
        sph, tri, scl, tcl = ops_mod.scene_tables(scene, False)
        assert tcl is not None
        ref, seg_ref = wf.render_linear_pallas(
            sph, tri, wf.camera_vec(cam), width=W, height=H,
            samples_per_pixel=2, depth=3, interpret=True,
            parity_plane_sign=False, sph_clusters=scl, tri_clusters=tcl)
        out, seg = parallel.render_linear_sharded_fast(
            scene, cam, mesh=mesh8, width=W, height=H, samples_per_pixel=2,
            depth=3, engine="pallas", interpret=True)
        assert np.array_equal(np.asarray(ref), np.asarray(out))
        assert int(seg_ref) == int(seg)

    def test_row_band_render_matches_full(self, default_world):
        # banded kernel render (shard_rows/row_offset) == matching rows of a
        # full render — the property the sharded path is built on
        from raytracer_tpu import ops as ops_mod
        from raytracer_tpu.ops.pallas import wavefront as wf
        scene = default_world.to_scene()
        cam = default_world.to_camera()
        W, H = 32, 24
        sph, tri, scl, tcl = ops_mod.scene_tables(scene, True)
        cv = wf.camera_vec(cam)
        full, _ = wf.render_linear_pallas(
            sph, tri, cv, width=W, height=H, samples_per_pixel=2, depth=3,
            interpret=True, sph_clusters=scl, tri_clusters=tcl)
        band, _ = wf.render_linear_pallas(
            sph, tri, cv, width=W, height=H, samples_per_pixel=2, depth=3,
            interpret=True, sph_clusters=scl, tri_clusters=tcl,
            shard_rows=8, row_offset=10)
        assert np.array_equal(np.asarray(full)[10:18], np.asarray(band))

    def test_xla_fallback_engine(self, default_world, mesh8):
        scene = default_world.to_scene()
        cam = default_world.to_camera()
        img1, _ = rt.render_linear(scene, cam, width=16, height=8,
                                   samples_per_pixel=2, depth=2)
        img2, _ = parallel.render_linear_sharded_fast(
            scene, cam, mesh=mesh8, width=16, height=8,
            samples_per_pixel=2, depth=2, engine="xla")
        assert np.array_equal(np.asarray(img1), np.asarray(img2))


class TestPackCache:
    def test_scene_tables_cached_on_identity(self, default_world):
        from raytracer_tpu import ops as ops_mod
        scene = default_world.to_scene()
        t1 = ops_mod.scene_tables(scene, True)
        n = ops_mod.pack_events
        t2 = ops_mod.scene_tables(scene, True)
        assert ops_mod.pack_events == n          # no repack
        assert t1[0] is t2[0] and t1[1] is t2[1]
        scene2 = default_world.to_scene()        # new object -> repack
        ops_mod.scene_tables(scene2, True)
        assert ops_mod.pack_events == n + 1


class TestShardedGradients:
    def test_sharded_grad_matches_single_device(self, mesh8):
        w = rt.models.sphere_and_ground()
        scene, cam = w.to_scene(), w.to_camera()
        W, H = 24, 16
        target, _ = rt.render_linear(scene, cam, width=W, height=H,
                                     samples_per_pixel=2, depth=2, seed=3)
        params = gradmod.extract_params(scene, ["sphere_center", "mat_color"])
        params["sphere_center"] = params["sphere_center"] + 0.02

        loss_single = gradmod.make_loss_fn(
            scene, cam, target, width=W, height=H, samples_per_pixel=2,
            depth=2, seed=3)
        loss_sharded = gradmod.make_loss_fn(
            scene, cam, target, width=W, height=H, samples_per_pixel=2,
            depth=2, seed=3, mesh=mesh8)

        g1 = jax.grad(loss_single)(params)
        g2 = jax.grad(loss_sharded)(params)
        for k in params:
            np.testing.assert_allclose(np.asarray(g1[k]), np.asarray(g2[k]),
                                       rtol=1e-5, atol=1e-8)

    def test_sharded_train_step_runs(self, mesh8):
        # the full sharded training step: forward + backward + psum + adam
        import optax
        w = rt.models.sphere_and_ground()
        scene, cam = w.to_scene(), w.to_camera()
        W, H = 16, 16
        target, _ = rt.render_linear(scene, cam, width=W, height=H,
                                     samples_per_pixel=1, depth=2, seed=0)
        params = gradmod.extract_params(scene, ["mat_color"])
        params["mat_color"] = params["mat_color"] * 0.7
        loss_fn = gradmod.make_loss_fn(scene, cam, target, width=W, height=H,
                                       samples_per_pixel=1, depth=2, seed=0,
                                       mesh=mesh8)
        opt = optax.adam(1e-2)
        step = gradmod.make_train_step(loss_fn, opt)
        state = opt.init(params)
        p, state, l0 = step(params, state)
        p, state, l1 = step(p, state)
        assert np.isfinite(float(l0)) and np.isfinite(float(l1))
        assert float(l1) <= float(l0)


class TestShardedDiff:
    """Sharded + differentiable + fast composition: kernel forward and
    recompute backward under shard_map must match single-device."""

    W, H, SPP, D = 32, 24, 2, 3

    def test_grads_match_single_device(self, default_world, mesh8):
        from raytracer_tpu.ops import diff as diff_mod
        from raytracer_tpu.parallel.sharding import (
            render_linear_diff_sharded)
        scene = default_world.to_scene()
        cam = default_world.to_camera()
        statics = diff_mod.make_statics(
            width=self.W, height=self.H, samples_per_pixel=self.SPP,
            depth=self.D, seed=5, parity_plane_sign=True, interpret=True)

        def loss_single(s):
            img = diff_mod.render_linear_diff(s, cam, statics)
            return jnp.sum(img * img)

        def loss_sharded(s):
            img = render_linear_diff_sharded(
                s, cam, mesh=mesh8, width=self.W, height=self.H,
                samples_per_pixel=self.SPP, depth=self.D, seed=5,
                interpret=True)
            return jnp.sum(img * img)

        v1, g1 = jax.value_and_grad(loss_single, allow_int=True)(scene)
        v2, g2 = jax.jit(
            jax.value_and_grad(loss_sharded, allow_int=True))(scene)
        assert abs(float(v1) - float(v2)) < 1e-4 * max(abs(float(v1)), 1.0)
        for name in ("sphere_center", "sphere_radius"):
            a = np.asarray(getattr(g1, name))
            b = np.asarray(getattr(g2, name))
            scale = max(np.abs(a).max(), 1e-8)
            assert np.abs(a - b).max() <= 1e-3 * scale + 1e-7, name
        a = np.asarray(g1.materials.color)
        b = np.asarray(g2.materials.color)
        assert np.abs(a - b).max() <= 1e-3 * max(np.abs(a).max(), 1e-8)

    def test_sharded_fit_step_through_kernel(self, default_world, mesh8):
        # one optimizer step of the sharded kernel-diff loss decreases it
        scene = default_world.to_scene()
        cam = default_world.to_camera()
        target, _ = rt.render_linear(scene, cam, width=16, height=12,
                                     samples_per_pixel=1, depth=2, seed=3)
        params = gradmod.extract_params(scene, ["mat_color"])
        params["mat_color"] = params["mat_color"] * 0.7
        loss = gradmod.make_loss_fn(
            scene, cam, target, width=16, height=12, samples_per_pixel=1,
            depth=2, seed=3, mesh=mesh8, engine="pallas", interpret=True)
        import optax
        opt = optax.adam(5e-2)
        step = gradmod.make_train_step(loss, opt)
        state = opt.init(params)
        p, state, l0 = step(params, state)
        for _ in range(3):
            p, state, l1 = step(p, state)
        assert float(l1) < float(l0)
