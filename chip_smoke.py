#!/usr/bin/env python3
"""Smoke test: the path tracer's main path on an NVIDIA GPU.

Run from the root of a checkout, on a machine with a GPU:

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded path only

One-card phases, each through the entry points a user calls:

  1. device     — JAX must run on a GPU; prints the card's name and power
                  limit as nvidia-smi reports them.
  2. headline   — ``rt.ray_trace`` of the default world at 512x512 x 64 spp
                  x 8 bounces (auto dispatch must resolve to the fused
                  kernel), compared with ``render.render_linear`` (XLA).
  3. spheres    — ``random_spheres`` (485 spheres), 512x512 x 16 spp.
  4. mesh       — ``mesh_scene(3)`` (1292 triangles), 512x512 x 4 spp x 4.
  5. parity     — ``ray_trace_parity`` against the NumPy oracle, 32x18.
  6. gradient   — ``grad.fit`` steps and ``make_train_step`` on the default
                  world at 256x256 x 8 spp x 4, gradients against XLA AD.
  7. card tests — the test suite's ``gpu``-marked tests (tests/test_gpu.py).

``--four-cards`` renders 1024x1024 x 64 spp x 8 of the default world on a
4-card mesh through ``parallel.render_linear_sharded`` and
``render_linear_sharded_fast``, compares both with one-card renders, and
runs one sharded train step against the one-card gradient.

Each comparison states its bound.  A failed phase raises: the script then
exits nonzero and prints no result line.  On success the last line of
stdout is one JSON object ``{"ok": true, "device": {...}}``.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

# Kernel vs XLA on the card: the same algorithm and pcg3d streams, but the
# two compilers round some float ops differently (likely Triton's
# approximate f32 division and square root), and a path amplifies a
# last-bit difference (grazing refraction; the r = 100 and r = 1000 ground
# spheres' |oc|^2 - r^2) until a borderline branch flips and one sample
# takes another path.  A sample's radiance is at most 1 in
# these scenes, so one flip moves a pixel's mean by at most 1/spp.  Bounds
# on the mean linear image: mean |diff| over all pixels and channels (H100:
# 4e-7 on the default world, 3e-5 on random_spheres), max |diff| of two
# flipped samples, and the relative difference of the traced-segment
# counts (H100: at most 1.4e-6).
KERNEL_MEAN_ABS = 1e-4
KERNEL_MAX_FLIPS = 2
KERNEL_SEGMENTS_REL = 1e-5
# Gradients against XLA AD, as max |diff| / max |grad| per parameter: the
# kernel forward's custom VJP has XLA's backward, so it differs only
# through the forward image above (H100: 9e-6); a sharded step adds the
# order of the gradient all-reduce.
GRAD_RTOL = 1e-3

ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def card_lines():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def timed(fn, reps=3):
    """(result, first-call seconds, best steady-state seconds)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return out, first, best


def compare_images(what, got, ref, mean_abs, max_abs):
    import numpy as np
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), f"{what}: non-finite pixels"
    d = np.abs(got - ref)
    log(f"{what}: mean|diff| {d.mean():.3e} (bound {mean_abs:.0e}), "
        f"max|diff| {d.max():.3e} (bound {max_abs:.0e}), "
        f"bit-identical {bool(d.max() == 0.0)}")
    assert d.mean() <= mean_abs, f"{what}: mean |diff| {d.mean()}"
    assert d.max() <= max_abs, f"{what}: max |diff| {d.max()}"


def compare_segments(what, got, ref, rel):
    got, ref = int(got), int(ref)
    off = abs(got - ref) / max(ref, 1)
    log(f"{what}: segments {got} vs {ref} (rel {off:.2e}, bound {rel:.0e})")
    assert ref > 0 and off <= rel, f"{what}: segment counts disagree"


def forward_phase(name, scene, cam, width, height, spp, depth):
    """Auto-dispatched render (must be the kernel) against XLA's."""
    import jax
    import raytracer_tpu as rt
    from raytracer_tpu import ops, render
    engine, pps, _ = ops.resolve_dispatch(scene, None)
    assert engine == "pallas", f"{name}: auto dispatch chose {engine}"
    seed = rt.Options().seed
    (mean, segs), k_first, k_best = timed(lambda: ops.render_linear_fast(
        scene, cam, width=width, height=height, samples_per_pixel=spp,
        depth=depth, seed=seed))
    with jax.default_matmul_precision("highest"):
        (ref, ref_segs), x_first, x_best = timed(
            lambda: render.render_linear(
                scene, cam, width=width, height=height,
                samples_per_pixel=spp, depth=depth,
                parity_plane_sign=pps, seed=seed))
    log(f"{name} {width}x{height} x {spp} spp x {depth}: engine {engine}; "
        f"kernel {k_best:.4f} s/frame, {int(segs) / k_best:.4e} segments/s, "
        f"compile {k_first - k_best:.2f} s; xla {x_best:.4f} s/frame, "
        f"{int(ref_segs) / x_best:.4e} segments/s, compile "
        f"{x_first - x_best:.2f} s; kernel speedup {x_best / k_best:.2f}x")
    compare_images(f"{name} kernel vs xla", mean, ref, KERNEL_MEAN_ABS,
                   KERNEL_MAX_FLIPS / spp)
    compare_segments(f"{name} kernel vs xla", segs, ref_segs,
                     KERNEL_SEGMENTS_REL)
    return mean, k_best


def phase_headline(size=512, spp=64):
    import numpy as np
    import raytracer_tpu as rt
    world = rt.models.default_world()
    scene, cam = world.to_scene(), world.to_camera()
    opts = rt.Options(samples_per_pixel=spp, max_ray_bounces=8)
    t0 = time.perf_counter()
    fb, segs = rt.ray_trace(scene, cam, size, size, opts)
    first = time.perf_counter() - t0
    assert fb.shape == (size, size, 4) and fb.dtype == np.uint8
    assert 10 < float(fb[..., :3].mean()) < 245, "image is blank"
    mean, frame = forward_phase("headline", scene, cam, size, size, spp, 8)
    log(f"rt.ray_trace {size}x{size} x {spp} spp x 8: first call {first:.2f}"
        f" s, compile {first - frame:.2f} s, {segs} segments")
    from raytracer_tpu.render import finalize_image
    assert np.array_equal(np.asarray(finalize_image(mean)), fb), \
        "ray_trace and render_linear_fast disagree"


def phase_spheres(size=512, spp=16):
    import raytracer_tpu as rt
    scene, cam = rt.models.random_spheres()
    forward_phase(f"random_spheres({scene.num_spheres})", scene, cam,
                  size, size, spp, 8)


def phase_mesh(size=512, spp=4):
    import raytracer_tpu as rt
    scene, cam = rt.models.mesh_scene(subdivisions=3)
    assert scene.num_triangles == 1292
    forward_phase("mesh_scene(1292 tris)", scene, cam, size, size, spp, 4)


def phase_parity():
    import numpy as np
    import raytracer_tpu as rt
    world = rt.models.default_world()
    ocam, oworld = world.to_oracle()
    ref = rt.oracle.ray_trace(oworld, ocam, 32, 18, 2, 4)
    got = rt.ray_trace_parity(world.to_scene(), world.to_camera(),
                              32, 18, 2, 4)
    d = np.abs(np.asarray(got, int) - np.asarray(ref, int))
    log(f"parity 32x18 x 2 spp x 4 vs oracle: {int((d > 0).sum())} u8 "
        f"values differ, max {int(d.max())} (bound: bit-exact)")
    assert (d == 0).all(), "ray_trace_parity is not bit-exact on this card"


def phase_gradient(size=256, spp=8):
    import jax
    import numpy as np
    import raytracer_tpu as rt
    from raytracer_tpu import grad as gradmod
    world = rt.models.default_world()
    scene, cam = world.to_scene(), world.to_camera()
    W = H = size
    depth = 4
    target, _ = rt.render_linear(scene, cam, width=W, height=H,
                                 samples_per_pixel=spp, depth=depth, seed=0)
    keys = ["sphere_center", "sphere_radius", "mat_color"]
    params = jax.tree.map(lambda x: x * 1.02,
                          gradmod.extract_params(scene, keys))
    kw = dict(width=W, height=H, samples_per_pixel=spp, depth=depth, seed=1)

    fit = gradmod.fit(scene, cam, target, params, steps=3,
                      learning_rate=1e-2, **kw)
    assert np.isfinite(fit.losses).all(), fit.losses
    moved = max(float(np.abs(np.asarray(fit.params[k])
                             - np.asarray(params[k])).max()) for k in keys)
    log(f"grad.fit (engine auto), 3 steps: losses {fit.losses}, "
        f"max param move {moved:.3e}")
    assert moved > 0.0, "fit did not move the parameters"

    grads = {}
    for engine in ("auto", "pallas", "xla"):
        loss_fn = gradmod.make_loss_fn(scene, cam, target, engine=engine,
                                       **kw)
        vg = jax.jit(jax.value_and_grad(loss_fn))
        with (jax.default_matmul_precision("highest") if engine == "xla"
              else contextlib.nullcontext()):
            (loss, g), first, best = timed(lambda: vg(params))
        assert np.isfinite(float(loss)), f"{engine}: loss {loss}"
        log(f"value_and_grad engine={engine}: {best:.4f} s/step, "
            f"{W * H * spp / best:.4e} paths/s, compile {first - best:.2f} s")
        grads[engine] = g
    for engine in ("auto", "pallas"):
        for k in keys:
            a = np.asarray(grads["xla"][k], np.float64)
            b = np.asarray(grads[engine][k], np.float64)
            assert np.isfinite(b).all(), f"{engine} {k}: non-finite grad"
            rel = np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)
            log(f"grad {k} engine={engine} vs XLA AD: max rel diff "
                f"{rel:.3e} (bound {GRAD_RTOL:.0e})")
            assert rel <= GRAD_RTOL, f"{engine} {k}: gradient disagrees"


def phase_card_tests():
    import pytest
    os.environ["RAYTRACER_TEST_GPU"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly",
                      os.path.join(ROOT, "tests", "test_gpu.py")])
    assert rc == 0, f"gpu-marked tests failed (pytest exit {rc})"


def phase_four_cards(size=1024, spp=64, depth=8, grad_size=256):
    import jax
    import numpy as np
    import raytracer_tpu as rt
    from raytracer_tpu import grad as gradmod, ops, parallel, render
    assert len(jax.devices()) >= 4, f"need 4 cards, have {jax.devices()}"
    mesh = parallel.make_mesh(4)
    world = rt.models.default_world()
    scene, cam = world.to_scene(), world.to_camera()
    kw = dict(width=size, height=size, samples_per_pixel=spp, depth=depth,
              seed=3)

    (k1, k1_segs), _, k1_t = timed(
        lambda: ops.render_linear_fast(scene, cam, **kw), reps=1)
    with jax.default_matmul_precision("highest"):
        (x1, x1_segs), _, x1_t = timed(
            lambda: render.render_linear(scene, cam, **kw), reps=1)
    (k4, k4_segs), _, k4_t = timed(
        lambda: parallel.render_linear_sharded_fast(scene, cam, mesh=mesh,
                                                    **kw), reps=1)
    with jax.default_matmul_precision("highest"):
        (x4, x4_segs), _, x4_t = timed(
            lambda: parallel.render_linear_sharded(scene, cam, mesh=mesh,
                                                   **kw), reps=1)
    log(f"{size}x{size} x {spp} spp x {depth}: kernel 1 card {k1_t:.4f} s,"
        f" 4 cards {k4_t:.4f} s ({k1_t / k4_t:.2f}x); xla 1 card "
        f"{x1_t:.4f} s, 4 cards {x4_t:.4f} s ({x1_t / x4_t:.2f}x)")
    for what, out in (("render_linear_sharded_fast", k4),
                      ("render_linear_sharded", x4)):
        devs = {s.device for s in out.addressable_shards}
        log(f"{what}: output on {len(devs)} devices")
        assert len(devs) == 4, f"{what}: output on {devs}"
    # per-pixel math depends only on the global (row, col), so a sharded
    # render matches its one-card engine bit for bit unless the compiler
    # contracts differently at the other shape: the kernel bounds apply
    for what, got, got_segs, ref, ref_segs in (
            ("sharded kernel vs one-card kernel", k4, k4_segs, k1, k1_segs),
            ("sharded xla vs one-card xla", x4, x4_segs, x1, x1_segs),
            ("sharded kernel vs one-card xla", k4, k4_segs, x1, x1_segs)):
        compare_images(what, got, ref, KERNEL_MEAN_ABS, KERNEL_MAX_FLIPS / spp)
        compare_segments(what, got_segs, ref_segs, KERNEL_SEGMENTS_REL)

    gw = gh = grad_size
    target, _ = rt.render_linear(scene, cam, width=gw, height=gh,
                                 samples_per_pixel=8, depth=4, seed=0)
    keys = ["sphere_center", "sphere_radius", "mat_color"]
    params = jax.tree.map(lambda x: x * 1.02,
                          gradmod.extract_params(scene, keys))
    gkw = dict(width=gw, height=gh, samples_per_pixel=8, depth=4, seed=1)
    with jax.default_matmul_precision("highest"):
        _, g1 = jax.jit(jax.value_and_grad(gradmod.make_loss_fn(
            scene, cam, target, **gkw)))(params)
    import optax
    opt = optax.adam(1e-2)
    for engine in ("xla", "pallas"):
        step = gradmod.make_train_step(gradmod.make_loss_fn(
            scene, cam, target, mesh=mesh, engine=engine, **gkw), opt)
        new, _, loss = step(params, opt.init(params))
        assert np.isfinite(float(loss))
        _, g4 = jax.jit(jax.value_and_grad(gradmod.make_loss_fn(
            scene, cam, target, mesh=mesh, engine=engine, **gkw)))(params)
        for k in keys:
            a = np.asarray(g1[k], np.float64)
            b = np.asarray(g4[k], np.float64)
            rel = np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)
            log(f"sharded train step engine={engine} grad {k} vs one-card "
                f"XLA AD: max rel diff {rel:.3e} (bound {GRAD_RTOL:.0e})")
            assert rel <= GRAD_RTOL, f"sharded {engine} {k} disagrees"
        assert any(not np.array_equal(np.asarray(new[k]),
                                      np.asarray(params[k])) for k in keys)


def main():
    ap = argparse.ArgumentParser(description="Path-tracer smoke test on "
                                 "the GPU.")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on a 4-card mesh")
    args = ap.parse_args()
    if not args.four_cards:
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    # fails outside a checkout: the script alone is not the program
    from raytracer_tpu.utils.compile_cache import enable_compile_cache
    log(f"jax {jax.__version__}, devices {jax.devices()}, compile cache "
        f"{enable_compile_cache()}")
    for line in card_lines():
        print(line, flush=True)

    if args.four_cards:
        phases = [("four cards", phase_four_cards)]
    else:
        phases = [("headline", phase_headline), ("spheres", phase_spheres),
                  ("mesh", phase_mesh), ("parity", phase_parity),
                  ("gradient", phase_gradient),
                  ("card tests", phase_card_tests)]
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"phase {name} ...")
        fn()
        log(f"phase {name} passed in {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
