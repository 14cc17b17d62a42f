"""Gradient correctness (BASELINE: AD vs finite differences) and inverse
rendering.

Methodology: AD through the renderer yields almost-everywhere gradients that
exclude visibility-boundary (silhouette) terms, so finite-difference
comparisons mask the loss to silhouette-interior pixels where shading is a
smooth function of geometry.  Albedo/color gradients have no visibility
dependence and are validated unmasked.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import raytracer_tpu as rt
from raytracer_tpu import grad as gradmod, intersect


def interior_mask(scene, cam, W, H, erode=2):
    """Pixels whose center ray hits, eroded to stay off silhouettes."""
    rows = np.repeat(np.arange(H), W)
    cols = np.tile(np.arange(W), H)
    u = (cols + 0.5) / np.float32(W - 1)
    v = (rows + 0.5) / np.float32(H - 1)
    o, d = cam.cast_rays(jnp.asarray(u, jnp.float32), jnp.asarray(v, jnp.float32))
    hit = np.asarray(
        intersect.closest_hit_batch(o, d, scene, intersect.pack_scene(scene)).hit
    ).reshape(H, W)
    m = hit.copy()
    for _ in range(erode):
        m = (m & np.roll(m, 1, 0) & np.roll(m, -1, 0)
             & np.roll(m, 1, 1) & np.roll(m, -1, 1))
    return jnp.asarray(m)


def masked_loss_fn(scene, cam, target, mask, W, H, spp, depth, seed):
    def loss(params):
        s = gradmod.apply_params(scene, params)
        img, _ = rt.render_linear(s, cam, width=W, height=H,
                                  samples_per_pixel=spp, depth=depth,
                                  seed=seed)
        diff = (img - target) * mask[:, :, None]
        return jnp.mean(diff * diff)
    return loss


def _cos(a, b):
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


MIRROR_SRC = """camera origin 0.0 0.0 0.0 aspect 1.0;
material MIRROR : Metal color 0.9 0.8 0.7 fuzz 0.0;
sphere center 0.0 0.0 -2.0 radius 0.9 material MIRROR;
"""


class TestFiniteDifferences:
    def test_geometry_grads_match_fd(self):
        # mirror-on-sky: shading smooth in the silhouette interior
        w = rt.parse_input(MIRROR_SRC)
        scene, cam = w.to_scene(), w.to_camera()
        W = H = 24
        mask = interior_mask(scene, cam, W, H)
        assert int(mask.sum()) > 20
        target, _ = rt.render_linear(scene, cam, width=W, height=H,
                                     samples_per_pixel=2, depth=2, seed=5)
        loss = masked_loss_fn(scene, cam, target, mask, W, H, 2, 2, 5)
        params = gradmod.extract_params(scene, ["sphere_center",
                                                "sphere_radius"])
        params["sphere_center"] = params["sphere_center"] + \
            jnp.asarray([[0.03, -0.02, 0.04]])
        params["sphere_radius"] = params["sphere_radius"] * 1.05
        ad = jax.grad(loss)(params)
        fd = gradmod.finite_diff_grad(loss, params, eps=1e-3)
        assert all(bool(jnp.isfinite(g).all()) for g in jax.tree.leaves(ad))
        assert _cos(ad["sphere_center"], fd["sphere_center"]) > 0.999
        assert _cos(ad["sphere_radius"], fd["sphere_radius"]) > 0.999

    def test_albedo_grads_match_fd_unmasked(self, default_world):
        scene = default_world.to_scene()
        cam = default_world.to_camera()
        W = H = 16
        target, _ = rt.render_linear(scene, cam, width=W, height=H,
                                     samples_per_pixel=2, depth=3, seed=7)
        loss = gradmod.make_loss_fn(scene, cam, target, width=W, height=H,
                                    samples_per_pixel=2, depth=3, seed=7)
        params = gradmod.extract_params(scene, ["mat_color"])
        params["mat_color"] = params["mat_color"] * 0.8
        ad = jax.grad(loss)(params)
        fd = gradmod.finite_diff_grad(loss, params, eps=1e-3)
        assert bool(jnp.isfinite(ad["mat_color"]).all())
        assert _cos(ad["mat_color"], fd["mat_color"]) > 0.999

    def test_grads_finite_full_default_world(self, default_world):
        # all four material types present; grads must be NaN-free
        scene = default_world.to_scene()
        cam = default_world.to_camera()
        W = H = 16
        target, _ = rt.render_linear(scene, cam, width=W, height=H,
                                     samples_per_pixel=2, depth=6, seed=0)
        loss = gradmod.make_loss_fn(scene, cam, target, width=W, height=H,
                                    samples_per_pixel=2, depth=6, seed=0)
        params = gradmod.extract_params(
            scene, ["sphere_center", "sphere_radius", "mat_color",
                    "mat_fuzz", "mat_ir"])
        params = jax.tree.map(lambda x: x * 1.01, params)
        ad = jax.grad(loss)(params)
        for k, g in ad.items():
            assert bool(jnp.isfinite(g).all()), f"non-finite grad in {k}"

    def test_triangle_vertex_grads_finite(self, ffi_world):
        scene = ffi_world.to_scene()
        cam = ffi_world.to_camera()
        W = H = 12
        target, _ = rt.render_linear(scene, cam, width=W, height=H,
                                     samples_per_pixel=1, depth=3, seed=1)
        loss = gradmod.make_loss_fn(scene, cam, target, width=W, height=H,
                                    samples_per_pixel=1, depth=3, seed=1)
        params = gradmod.extract_params(scene, ["tri_v0", "tri_v1", "tri_v2"])
        params = jax.tree.map(lambda x: x + 0.01, params)
        ad = jax.grad(loss)(params)
        for k, g in ad.items():
            assert bool(jnp.isfinite(g).all()), f"non-finite grad in {k}"


class TestInverseRendering:
    def test_fit_recovers_albedo(self):
        # BASELINE config 4 (albedo recovery slice): perturb albedo, descend
        w = rt.models.sphere_and_ground()
        scene, cam = w.to_scene(), w.to_camera()
        W = H = 16
        target, _ = rt.render_linear(scene, cam, width=W, height=H,
                                     samples_per_pixel=2, depth=2, seed=2)
        params0 = gradmod.extract_params(scene, ["mat_color"])
        true_color = np.asarray(params0["mat_color"])
        params0["mat_color"] = params0["mat_color"] * 0.5
        result = gradmod.fit(scene, cam, target, params0, width=W, height=H,
                             samples_per_pixel=2, depth=2, steps=60,
                             learning_rate=5e-2, seed=2)
        assert result.losses[-1] < result.losses[0] * 0.05
        got = np.asarray(result.params["mat_color"])
        assert np.abs(got - true_color).max() < 0.12

    def test_fit_reduces_center_error(self):
        w = rt.parse_input(MIRROR_SRC)
        scene, cam = w.to_scene(), w.to_camera()
        W = H = 16
        target, _ = rt.render_linear(scene, cam, width=W, height=H,
                                     samples_per_pixel=2, depth=2, seed=4)
        params0 = gradmod.extract_params(scene, ["sphere_center"])
        true_c = np.asarray(params0["sphere_center"])
        params0["sphere_center"] = params0["sphere_center"] + \
            jnp.asarray([[0.05, -0.04, 0.0]])
        err0 = float(np.abs(np.asarray(params0["sphere_center"]) - true_c).max())
        result = gradmod.fit(scene, cam, target, params0, width=W, height=H,
                             samples_per_pixel=2, depth=2, steps=80,
                             learning_rate=1e-2, seed=4)
        err1 = float(np.abs(np.asarray(result.params["sphere_center"]) - true_c).max())
        assert result.losses[-1] < result.losses[0]
        assert err1 < err0

    def test_checkpoint_resume(self, tmp_path):
        w = rt.models.sphere_and_ground()
        scene, cam = w.to_scene(), w.to_camera()
        W = H = 8
        target, _ = rt.render_linear(scene, cam, width=W, height=H,
                                     samples_per_pixel=1, depth=2, seed=9)
        params0 = gradmod.extract_params(scene, ["mat_color"])
        params0["mat_color"] = params0["mat_color"] * 0.6
        ck = str(tmp_path / "ck.npz")
        r1 = gradmod.fit(scene, cam, target, params0, width=W, height=H,
                         samples_per_pixel=1, depth=2, steps=10,
                         checkpoint_path=ck, checkpoint_every=5, seed=9)
        # resume from step 10 to 15
        r2 = gradmod.fit(scene, cam, target, params0, width=W, height=H,
                         samples_per_pixel=1, depth=2, steps=15,
                         checkpoint_path=ck, checkpoint_every=5, seed=9)
        assert r2.steps_run == 5  # resumed, not restarted
        assert len(r2.losses) == 15


class TestDiffPallasPath:
    """render_linear_diff: Pallas forward via custom VJP, XLA recompute
    backward (VERDICT round-1 item 2, stepping stone)."""

    def test_value_and_grads_match_xla(self):
        w = rt.models.sphere_and_ground()
        scene, cam = w.to_scene(), w.to_camera()
        W, H = 24, 16
        target, _ = rt.render_linear(scene, cam, width=W, height=H,
                                     samples_per_pixel=2, depth=2, seed=3)
        params = gradmod.extract_params(scene, ["sphere_center", "mat_color"])
        params["sphere_center"] = params["sphere_center"] + 0.02
        loss_x = gradmod.make_loss_fn(scene, cam, target, width=W, height=H,
                                      samples_per_pixel=2, depth=2, seed=3)
        loss_p = gradmod.make_loss_fn(scene, cam, target, width=W, height=H,
                                      samples_per_pixel=2, depth=2, seed=3,
                                      engine="pallas", interpret=True)
        v1, g1 = jax.value_and_grad(loss_x)(params)
        v2, g2 = jax.jit(jax.value_and_grad(loss_p))(params)
        assert abs(float(v1) - float(v2)) < 1e-5
        for k in params:
            np.testing.assert_allclose(np.asarray(g1[k]), np.asarray(g2[k]),
                                       rtol=1e-4, atol=1e-7)

    def test_fit_loop_through_kernel_forward(self):
        w = rt.models.sphere_and_ground()
        scene, cam = w.to_scene(), w.to_camera()
        W = H = 12
        target, _ = rt.render_linear(scene, cam, width=W, height=H,
                                     samples_per_pixel=1, depth=2, seed=5)
        params = gradmod.extract_params(scene, ["mat_color"])
        params["mat_color"] = params["mat_color"] * 0.7
        loss_p = gradmod.make_loss_fn(scene, cam, target, width=W, height=H,
                                      samples_per_pixel=1, depth=2, seed=5,
                                      engine="pallas", interpret=True)
        import optax
        opt = optax.adam(1e-2)
        step = gradmod.make_train_step(loss_p, opt)
        state = opt.init(params)
        p, state, l0 = step(params, state)
        for _ in range(4):
            p, state, l1 = step(p, state)
        assert float(l1) < float(l0)


class TestBackwardKernel:
    """The kernel path's custom VJP (kernel forward, XLA recompute
    backward, ops/diff.py) must match plain XLA reverse-mode AD on every
    parameter class (interior gradients; both share the follow-the-
    selected-branch semantics)."""

    def test_grads_match_xla_ad_all_materials(self):
        # the default world covers diffuse/metal/dielectric + ground sphere
        world = rt.models.default_world()
        scene, cam = world.to_scene(), world.to_camera()
        W, H = 32, 24
        target, _ = rt.render_linear(scene, cam, width=W, height=H,
                                     samples_per_pixel=2, depth=4, seed=3)
        params = gradmod.extract_params(
            scene, ["sphere_center", "sphere_radius", "mat_color",
                    "mat_fuzz", "mat_ir"])
        params["sphere_center"] = params["sphere_center"] + 0.02
        loss_x = gradmod.make_loss_fn(scene, cam, target, width=W, height=H,
                                      samples_per_pixel=2, depth=4, seed=3)
        loss_k = gradmod.make_loss_fn(scene, cam, target, width=W, height=H,
                                      samples_per_pixel=2, depth=4, seed=3,
                                      engine="pallas", interpret=True)
        v1, g1 = jax.value_and_grad(loss_x)(params)
        v2, g2 = jax.jit(jax.value_and_grad(loss_k))(params)
        assert abs(float(v1) - float(v2)) < 1e-5
        for k in params:
            a, b = np.asarray(g1[k]), np.asarray(g2[k])
            scale = max(np.abs(a).max(), 1e-8)
            assert np.abs(a - b).max() <= 5e-3 * scale + 1e-7, k

    def test_camera_cotangent(self):
        # differentiate THROUGH the camera (origin) — covers the ray-gen
        # adjoint and the cam_vec mapping
        world = rt.models.sphere_and_ground()
        scene, cam = world.to_scene(), world.to_camera()
        W, H = 16, 12
        from raytracer_tpu.ops import diff as diff_mod
        statics = diff_mod.make_statics(width=W, height=H,
                                        samples_per_pixel=2, depth=3, seed=7,
                                        parity_plane_sign=True,
                                        interpret=True)

        def loss_k(c):
            img = diff_mod.render_linear_diff(scene, c, statics)
            return jnp.sum(img * img)

        def loss_x(c):
            img, _ = rt.render_linear(scene, c, width=W, height=H,
                                      samples_per_pixel=2, depth=3, seed=7)
            return jnp.sum(img * img)

        g_k = jax.grad(loss_k)(cam)
        g_x = jax.grad(loss_x)(cam)
        for f in ("origin", "lower_left_corner", "horizontal", "vertical"):
            a = np.asarray(getattr(g_x, f))
            b = np.asarray(getattr(g_k, f))
            scale = max(np.abs(a).max(), 1e-8)
            assert np.abs(a - b).max() <= 5e-3 * scale + 1e-7, f

    def test_triangle_grads_match_xla_ad(self, ffi_world):
        # vertex gradients through the kernel path's custom VJP on a
        # triangle scene
        scene, cam = ffi_world.to_scene(), ffi_world.to_camera()
        W, H = 24, 16
        target, _ = rt.render_linear(scene, cam, width=W, height=H,
                                     samples_per_pixel=2, depth=3, seed=11)
        params = gradmod.extract_params(
            scene, ["tri_v0", "tri_v1", "tri_v2", "sphere_center",
                    "mat_color"])
        params = jax.tree.map(lambda x: x + 0.015, params)
        loss_x = gradmod.make_loss_fn(scene, cam, target, width=W, height=H,
                                      samples_per_pixel=2, depth=3, seed=11)
        loss_k = gradmod.make_loss_fn(scene, cam, target, width=W, height=H,
                                      samples_per_pixel=2, depth=3, seed=11,
                                      engine="pallas", interpret=True)
        v1, g1 = jax.value_and_grad(loss_x)(params)
        v2, g2 = jax.jit(jax.value_and_grad(loss_k))(params)
        assert abs(float(v1) - float(v2)) < 1e-5
        for k in params:
            a, b = np.asarray(g1[k]), np.asarray(g2[k])
            scale = max(np.abs(a).max(), 1e-8)
            assert np.abs(a - b).max() <= 5e-3 * scale + 1e-7, k

    def test_triangle_grads_parity_plane_sign_false(self):
        # same comparison under the CORRECT plane equation (the OBJ /
        # procedural-mesh configuration) — exercises the other t-adjoint
        scene, cam = rt.models.mesh_scene(subdivisions=0)
        W, H = 16, 12
        target, _ = rt.render_linear(scene, cam, width=W, height=H,
                                     samples_per_pixel=1, depth=2, seed=2,
                                     parity_plane_sign=False)
        params = gradmod.extract_params(scene, ["tri_v0", "tri_v1",
                                                "tri_v2"])
        params = jax.tree.map(lambda x: x + 0.01, params)
        loss_x = gradmod.make_loss_fn(scene, cam, target, width=W, height=H,
                                      samples_per_pixel=1, depth=2, seed=2,
                                      parity_plane_sign=False)
        loss_k = gradmod.make_loss_fn(scene, cam, target, width=W, height=H,
                                      samples_per_pixel=1, depth=2, seed=2,
                                      parity_plane_sign=False,
                                      engine="pallas", interpret=True)
        v1, g1 = jax.value_and_grad(loss_x)(params)
        v2, g2 = jax.jit(jax.value_and_grad(loss_k))(params)
        assert abs(float(v1) - float(v2)) < 1e-5
        for k in params:
            a, b = np.asarray(g1[k]), np.asarray(g2[k])
            scale = max(np.abs(a).max(), 1e-8)
            assert np.abs(a - b).max() <= 5e-3 * scale + 1e-7, k

    def test_clustered_kernel_grads_match_xla_ad(self):
        # the differentiable kernel path culls: static cluster topology
        # with bounds recomputed traceably from the live vertices.  Gradients must match XLA AD and the
        # unclustered kernel on a mesh scene big enough to trigger
        # clustering (>= 64 triangles).
        scene, cam = rt.models.mesh_scene(subdivisions=2)
        assert scene.exact_planes
        from raytracer_tpu.ops import diff as diff_mod
        cull = diff_mod.build_tri_cull(scene)
        assert cull is not None and cull.ranges.shape[1] > 1
        W, H = 24, 16
        target, _ = rt.render_linear(scene, cam, width=W, height=H,
                                     samples_per_pixel=2, depth=3, seed=5,
                                     parity_plane_sign=False)
        params = gradmod.extract_params(scene, ["tri_v0", "mat_color"])
        params["tri_v0"] = params["tri_v0"] + 0.004
        loss_x = gradmod.make_loss_fn(scene, cam, target, width=W,
                                      height=H, samples_per_pixel=2,
                                      depth=3, seed=5,
                                      parity_plane_sign=False)
        loss_k = gradmod.make_loss_fn(scene, cam, target, width=W,
                                      height=H, samples_per_pixel=2,
                                      depth=3, seed=5,
                                      parity_plane_sign=False,
                                      engine="pallas", interpret=True)
        v1, g1 = jax.value_and_grad(loss_x)(params)
        v2, g2 = jax.jit(jax.value_and_grad(loss_k))(params)
        assert abs(float(v1) - float(v2)) < 1e-5
        for k in params:
            a, b = np.asarray(g1[k]), np.asarray(g2[k])
            scale = max(np.abs(a).max(), 1e-8)
            assert np.abs(a - b).max() <= 5e-3 * scale + 1e-7, k

    def test_cull_bounds_follow_moved_vertices(self):
        # the cull topology is static but the bounds are traceable: moving
        # a vertex far away must inflate its leaf bound (stay sound)
        scene, _ = rt.models.mesh_scene(subdivisions=2)
        from raytracer_tpu.ops import diff as diff_mod
        import dataclasses
        cull = diff_mod.build_tri_cull(scene)
        b0 = np.asarray(diff_mod.tri_cluster_bounds_jnp(scene, cull))
        moved = dataclasses.replace(
            scene, tri_v0=scene.tri_v0.at[0].add(
                jnp.asarray([10.0, 0.0, 0.0])))
        b1 = np.asarray(diff_mod.tri_cluster_bounds_jnp(moved, cull))
        leaf = int(cull.leaf_ids[np.nonzero(
            np.asarray(cull.perm) == 0)[0][0]])
        assert b1[3, leaf] > b0[3, leaf] + 1.0   # r^2 grew to cover it


class TestSilhouetteGradients:
    """Visibility-boundary gradients by analytic sphere edge sampling
    (grad/silhouette.py) — VERDICT r1 item 4 / r2 item 3.  The loss is
    UNMASKED: no interior_mask anywhere in this class."""

    def _setup(self, W=32, H=32, spp=4, depth=2, seed=5):
        w = rt.parse_input(MIRROR_SRC)
        scene, cam = w.to_scene(), w.to_camera()
        target, _ = rt.render_linear(scene, cam, width=W, height=H,
                                     samples_per_pixel=spp, depth=depth,
                                     seed=seed)
        params = gradmod.extract_params(scene, ["sphere_center",
                                                "sphere_radius"])
        params["sphere_center"] = params["sphere_center"] + \
            jnp.asarray([[0.04, -0.03, 0.05]])
        params["sphere_radius"] = params["sphere_radius"] * 1.06
        return scene, cam, target, params, (W, H, spp, depth, seed)

    def test_unmasked_fd_match(self):
        scene, cam, target, params, (W, H, spp, depth, seed) = self._setup()
        loss = gradmod.make_loss_fn(scene, cam, target, width=W, height=H,
                                    samples_per_pixel=spp, depth=depth,
                                    seed=seed)
        _, ad = gradmod.value_and_grad_with_silhouette(
            scene, cam, target, params, width=W, height=H,
            samples_per_pixel=spp, depth=depth, seed=seed, n_edge=2048)
        # eps large enough that the FD of the fixed-RNG loss averages many
        # visibility flips (small eps sees quantized jumps, not the
        # gradient; see silhouette.py docstring)
        fd = gradmod.finite_diff_grad(loss, params, eps=3e-2)
        assert _cos(ad["sphere_center"], fd["sphere_center"]) > 0.98
        r_ad = float(np.asarray(ad["sphere_radius"]).ravel()[0])
        r_fd = float(np.asarray(fd["sphere_radius"]).ravel()[0])
        assert abs(r_ad - r_fd) < 0.25 * abs(r_fd)
        # and the boundary term is what makes it work: interior-only AD
        # points the wrong way on this unmasked loss
        plain = jax.grad(loss)(params)
        assert _cos(plain["sphere_center"], fd["sphere_center"]) < 0.9
        assert abs(float(np.asarray(plain["sphere_radius"]).ravel()[0])) \
            < 0.1 * abs(r_fd)

    def test_boundary_term_zero_when_occluded(self):
        # a big front sphere fully covers the mirror sphere: both edge
        # probes hit the occluder, the radiance jump vanishes, and the
        # boundary gradient for the hidden sphere is ~0
        src = """camera origin 0.0 0.0 0.0 aspect 1.0;
material MIRROR : Metal color 0.9 0.8 0.7 fuzz 0.0;
material FRONT : Diffuse color 0.2 0.4 0.6;
sphere center 0.0 0.0 -4.0 radius 0.9 material MIRROR;
sphere center 0.0 0.0 -1.2 radius 0.8 material FRONT;
"""
        w = rt.parse_input(src)
        scene, cam = w.to_scene(), w.to_camera()
        W = H = 24
        img, _ = rt.render_linear(scene, cam, width=W, height=H,
                                  samples_per_pixel=2, depth=2, seed=3)
        g = jnp.ones_like(img)
        d_c, d_r = gradmod.silhouette_grad(scene, cam, g, width=W,
                                           height=H, depth=2, seed=3,
                                           n_edge=512)
        # hidden sphere index 0: boundary grads vanish under occlusion
        # (up to the O(delta) positional bias of the paired probes),
        # while the visible front sphere's silhouette against the sky
        # carries a real boundary term orders of magnitude larger
        hidden = float(jnp.abs(d_c[0]).max()) \
            + abs(float(np.asarray(d_r).ravel()[0]))
        visible = float(jnp.abs(d_c[1]).max()) \
            + abs(float(np.asarray(d_r).ravel()[1]))
        assert visible > 0.05
        assert hidden < 0.02 * visible, (hidden, visible)

    def test_triangle_edge_gradients_unmasked(self):
        # a diffuse triangle against the sky: the unmasked loss gradient
        # is boundary-dominated; per-edge sampling must recover it.
        # FD reference at spp=16: the fixed-seed spp=4 FD carries a
        # correlated-noise bias ~1/spp (the target shares the render's
        # RNG) that swamps the small components; at spp=16 it converges
        # to the estimator's values.
        src = """camera origin 0.0 0.0 0.0 aspect 1.0;
material RED : Diffuse color 0.8 0.2 0.2;
triangle v0 -0.5 -0.3 -1.5  v1 0.6 -0.2 -1.6  v2 0.0 0.55 -1.4 material RED;
"""
        w = rt.parse_input(src)
        scene, cam = w.to_scene(), w.to_camera()
        W = H = 32
        SPP = 16
        params = gradmod.extract_params(scene, ["tri_v0", "tri_v1",
                                                "tri_v2"])
        params = jax.tree.map(
            lambda x: x + jnp.asarray([[0.03, -0.02, 0.04]]), params)
        cat = lambda g: np.concatenate(
            [np.asarray(g[k]).ravel() for k in sorted(params)])
        fd_sum, ad_sum, plain_sum = 0.0, 0.0, 0.0
        for seed in (9, 33):
            target, _ = rt.render_linear(scene, cam, width=W, height=H,
                                         samples_per_pixel=SPP, depth=2,
                                         seed=seed, parity_plane_sign=False)
            loss = gradmod.make_loss_fn(
                scene, cam, target, width=W, height=H,
                samples_per_pixel=SPP, depth=2, seed=seed,
                parity_plane_sign=False)
            _, ad = gradmod.value_and_grad_with_silhouette(
                scene, cam, target, params, width=W, height=H,
                samples_per_pixel=SPP, depth=2, seed=seed,
                parity_plane_sign=False, samples_per_edge=32)
            fd = gradmod.finite_diff_grad(loss, params, eps=1e-2)
            fd_sum = fd_sum + cat(fd)
            ad_sum = ad_sum + cat(ad)
            plain_sum = plain_sum + cat(jax.grad(loss)(params))
        assert _cos(ad_sum, fd_sum) > 0.9, _cos(ad_sum, fd_sum)
        # interior-only AD misses the boundary term entirely here
        assert _cos(plain_sum, fd_sum) < 0.6

    def test_silhouette_fit_recovers_large_offset(self):
        # start with the mirror sphere displaced by ~0.2 laterally: the
        # overlap region is small and interior-only gradients barely see
        # the target; the boundary term pulls the silhouette across
        w = rt.parse_input(MIRROR_SRC)
        scene, cam = w.to_scene(), w.to_camera()
        W = H = 24
        target, _ = rt.render_linear(scene, cam, width=W, height=H,
                                     samples_per_pixel=2, depth=2, seed=4)
        params0 = gradmod.extract_params(scene, ["sphere_center"])
        true_c = np.asarray(params0["sphere_center"])
        params0["sphere_center"] = params0["sphere_center"] + \
            jnp.asarray([[0.22, -0.18, 0.0]])
        err0 = float(np.abs(np.asarray(params0["sphere_center"])
                            - true_c).max())
        result = gradmod.fit(scene, cam, target, params0, width=W,
                             height=H, samples_per_pixel=2, depth=2,
                             steps=40, learning_rate=2e-2, seed=4,
                             silhouette=True)
        err1 = float(np.abs(np.asarray(result.params["sphere_center"])
                            - true_c).max())
        assert result.losses[-1] < result.losses[0] * 0.6
        assert err1 < 0.5 * err0, (err0, err1)


class TestMirrorSilhouette:
    """VERDICT r3 item 5: ONE-BOUNCE specular silhouette gradients — a
    sphere visible ONLY in a mirror must get a usable unmasked gradient
    (interior AD misses the reflected boundary term)."""

    SRC = """camera origin 0.0 0.0 0.0 aspect 1.0;
material MIRROR : Metal color 0.95 0.95 0.95 fuzz 0.0;
material BALL : Diffuse color 0.8 0.2 0.1;
sphere center 0.0 0.0 -102.0 radius 100.0 material MIRROR;
sphere center 0.7 0.1 1.6 radius 0.45 material BALL;
"""

    def test_mirror_only_sphere_fd_match(self):
        # the ball sits BEHIND the camera: no primary ray sees it; its
        # image appears only in the near-planar mirror ahead
        w = rt.parse_input(self.SRC)
        scene, cam = w.to_scene(), w.to_camera()
        W = H = 32
        target, _ = rt.render_linear(scene, cam, width=W, height=H,
                                     samples_per_pixel=4, depth=3, seed=11)
        params = gradmod.extract_params(scene, ["sphere_center"])
        params["sphere_center"] = params["sphere_center"] + \
            jnp.asarray([[0.0, 0.0, 0.0], [0.05, -0.04, 0.0]])
        loss = gradmod.make_loss_fn(scene, cam, target, width=W, height=H,
                                    samples_per_pixel=4, depth=3, seed=11)
        _, ad = gradmod.value_and_grad_with_silhouette(
            scene, cam, target, params, width=W, height=H,
            samples_per_pixel=4, depth=3, seed=11, n_edge=1024)
        fd = gradmod.finite_diff_grad(loss, params, eps=3e-2)
        # compare the BALL row (index 1) of the center gradient, UNMASKED
        a = np.asarray(ad["sphere_center"])[1, :2]
        f = np.asarray(fd["sphere_center"])[1, :2]
        cos = float(np.dot(a, f)
                    / max(np.linalg.norm(a) * np.linalg.norm(f), 1e-12))
        assert cos > 0.9, (a, f, cos)
        # magnitude within 2x (edge-sampled vs finite-difference)
        assert 0.4 < np.linalg.norm(a) / max(np.linalg.norm(f), 1e-12) < 2.5

    def test_mirror_term_zero_without_mirrors(self):
        # no fuzz=0 metal in the scene: the pair sweep contributes nothing
        w = rt.parse_input("""camera origin 0.0 0.0 0.0 aspect 1.0;
material A : Diffuse color 0.5 0.5 0.5;
sphere center 0.0 0.0 -2.0 radius 0.5 material A;
""")
        scene, cam = w.to_scene(), w.to_camera()
        W = H = 16
        img, _ = rt.render_linear(scene, cam, width=W, height=H,
                                  samples_per_pixel=2, depth=2, seed=1)
        g = jnp.ones_like(img)
        d_c, d_r = gradmod.mirror_silhouette_grad(
            scene, cam, g, width=W, height=H, depth=2, seed=1, n_edge=64)
        assert float(jnp.abs(d_c).max()) == 0.0
        assert float(jnp.abs(d_r).max()) == 0.0


class TestGlassSilhouette:
    """VERDICT r5 item 6b: a sphere visible ONLY through the always-
    refract glass ball must get a usable unmasked gradient — the
    implicit-boundary estimator differentiates the analytic
    camera->glass->target refraction chain."""

    SRC = """camera origin 0.0 0.0 0.0 aspect 1.0;
material GLASS : Dielectric ir 1.15;
material BALL : Diffuse color 0.8 0.2 0.1;
sphere center 0.0 0.0 -1.0 radius 0.45 material GLASS;
sphere center 0.0 0.0 -1.8 radius 0.35 material BALL;
"""

    def test_glass_only_sphere_fd_match(self):
        # the ball hides entirely behind the glass ball's disk (angular
        # radius 0.19 vs 0.45): no unrefracted camera ray reaches it, so
        # interior AD sees only the lens-interior shading and the
        # boundary term must come from the through-glass estimator.
        # depth 5 gives the chain entry/exit/diffuse/sky bounces
        w = rt.parse_input(self.SRC)
        scene, cam = w.to_scene(), w.to_camera()
        W = H = 48
        target, _ = rt.render_linear(scene, cam, width=W, height=H,
                                     samples_per_pixel=4, depth=5,
                                     seed=13)
        params = gradmod.extract_params(scene, ["sphere_center"])
        params["sphere_center"] = params["sphere_center"] + \
            jnp.asarray([[0.0, 0.0, 0.0], [0.03, -0.02, 0.0]])
        loss = gradmod.make_loss_fn(scene, cam, target, width=W, height=H,
                                    samples_per_pixel=4, depth=5, seed=13)
        _, ad = gradmod.value_and_grad_with_silhouette(
            scene, cam, target, params, width=W, height=H,
            samples_per_pixel=4, depth=5, seed=13, n_edge=512)
        fd = gradmod.finite_diff_grad(loss, params, eps=1.5e-2)
        a = np.asarray(ad["sphere_center"])[1, :2]
        f = np.asarray(fd["sphere_center"])[1, :2]
        cos = float(np.dot(a, f)
                    / max(np.linalg.norm(a) * np.linalg.norm(f), 1e-12))
        assert cos > 0.85, (a, f, cos)
        assert 0.3 < np.linalg.norm(a) / max(np.linalg.norm(f), 1e-12) < 3.0

    def test_glass_term_zero_without_dielectric(self):
        w = rt.parse_input("""camera origin 0.0 0.0 0.0 aspect 1.0;
material A : Diffuse color 0.5 0.5 0.5;
sphere center 0.0 0.0 -2.0 radius 0.5 material A;
""")
        scene, cam = w.to_scene(), w.to_camera()
        W = H = 16
        img, _ = rt.render_linear(scene, cam, width=W, height=H,
                                  samples_per_pixel=2, depth=2, seed=1)
        g = jnp.ones_like(img)
        d_c, d_r = gradmod.glass_silhouette_grad(
            scene, cam, g, width=W, height=H, depth=2, seed=1, n_edge=64)
        assert float(jnp.abs(d_c).max()) == 0.0
        assert float(jnp.abs(d_r).max()) == 0.0


class TestMirrorMeshSilhouette:
    """VERDICT r5 item 6a: triangle-mesh edges seen in a fuzz=0 mirror
    get boundary-term vertex gradients via the virtual-viewpoint fold."""

    def _world(self):
        from raytracer_tpu.models.builders import cube_mesh
        from raytracer_tpu.scene import (DIFFUSE, METAL, build_materials,
                                         build_scene)
        mats = build_materials([(METAL, (0.95, 0.95, 0.95), 0.0, 1.0),
                                (DIFFUSE, (0.8, 0.2, 0.1), 0.0, 1.0)])
        # mirror ahead; cube BEHIND the camera: visible only reflected
        tris = cube_mesh((0.4, 0.1, 1.6), 0.3, 1)
        scene = build_scene([((0.0, 0.0, -102.0), 100.0, 0)], tris, mats,
                            exact_planes=True)
        cam = rt.Camera.new_at((0.0, 0.0, 0.0), 1.0)
        return scene, cam

    def test_mirror_mesh_fd_match(self):
        scene, cam = self._world()
        W = H = 32
        target, _ = rt.render_linear(scene, cam, width=W, height=H,
                                     samples_per_pixel=4, depth=3,
                                     seed=17, parity_plane_sign=False)
        params = gradmod.extract_params(scene, ["tri_v0", "tri_v1",
                                                "tri_v2"])
        shift = jnp.asarray([0.04, -0.03, 0.0])
        for k in params:
            params[k] = params[k] + shift
        loss = gradmod.make_loss_fn(scene, cam, target, width=W, height=H,
                                    samples_per_pixel=4, depth=3, seed=17,
                                    parity_plane_sign=False)
        _, ad = gradmod.value_and_grad_with_silhouette(
            scene, cam, target, params, width=W, height=H,
            samples_per_pixel=4, depth=3, seed=17,
            parity_plane_sign=False, samples_per_edge=16)
        # aggregate translation gradient (sum over all vertices) —
        # the FD comparison that moves the whole cube rigidly
        a = sum(np.asarray(ad[k]).sum(axis=0) for k in params)[:2]
        fd = gradmod.finite_diff_grad(loss, params, eps=2e-2)
        f = sum(np.asarray(fd[k]).sum(axis=0) for k in params)[:2]
        cos = float(np.dot(a, f)
                    / max(np.linalg.norm(a) * np.linalg.norm(f), 1e-12))
        assert cos > 0.85, (a, f, cos)
        assert 0.3 < np.linalg.norm(a) / max(np.linalg.norm(f), 1e-12) < 3.0


class TestEdgeSelection:
    """VERDICT r3 item 6: meshes beyond MAX_EDGE_TRIS get boundary terms
    through the importance-selected edge prepass instead of a hard cap."""

    def test_selected_matches_full_sampling(self):
        scene, cam = rt.models.mesh_scene(subdivisions=2)   # 320 tris
        W = H = 24
        img, _ = rt.render_linear(scene, cam, width=W, height=H,
                                  samples_per_pixel=2, depth=2, seed=7,
                                  parity_plane_sign=False)
        g = jnp.ones_like(img)
        full = gradmod.triangle_silhouette_grad(
            scene, cam, g, width=W, height=H, depth=2, seed=7,
            parity_plane_sign=False, samples_per_edge=8)
        # force the selection path with a budget below 3*T
        sel = gradmod.triangle_silhouette_grad(
            scene, cam, g, width=W, height=H, depth=2, seed=7,
            parity_plane_sign=False, samples_per_edge=8, max_edges=512)
        a = np.concatenate([np.asarray(x).ravel() for x in full])
        b = np.concatenate([np.asarray(x).ravel() for x in sel])
        cos = float(np.dot(a, b)
                    / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-12))
        # the dropped edges are the near-zero-score tail
        assert cos > 0.9, cos
        assert np.linalg.norm(b) > 0.5 * np.linalg.norm(a)

    def test_selection_prefers_in_image_edges(self):
        scene, cam = rt.models.mesh_scene(subdivisions=2)
        W = H = 24
        g = jnp.ones((H, W, 3), jnp.float32)
        from raytracer_tpu.grad import silhouette as sil
        tis, es = sil._select_edges(scene, cam, g, W, H, 96)
        assert tis.shape == (96,) and es.shape == (96,)
        assert bool((np.asarray(es) < 3).all())
        assert bool((np.asarray(tis) < scene.num_triangles).all())
