"""Benchmark: traced segments per second on the headline config.

Default: renders the reference's bundled 8-sphere world at 512x512 / 64 spp
/ 8 bounces through auto dispatch and prints ONE JSON line:
  {"metric": ..., "value": segments/s, "unit": "segments/s", "device": ...}

"Segments" = rays actually submitted to the intersector (live rays per
bounce summed over all samples), counted on the device by the renderer.

``--all`` additionally benchmarks the other configurations (random
spheres, triangle meshes, gradient passes), one JSON line each.  A row
with no GPU path yet prints "not measured" with the reason.

Refuses to run without a GPU: a CPU number is not a device metric.
"""

import json
import statistics
import sys
import time

WIDTH = 512
HEIGHT = 512
SPP = 64
DEPTH = 8


def _device():
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _time_steady(fn, n=5):
    """Median seconds per call over ``n`` calls after one warm-up call
    (which compiles); each call ends in ``block_until_ready``."""
    import jax
    out = jax.block_until_ready(fn(0))
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(i + 1))
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def _row(metric, value, unit):
    return {"metric": metric, "value": value, "unit": unit,
            "device": _device()}


def _not_measured(metric, reason):
    return {"metric": metric, "value": "not measured", "reason": reason,
            "device": _device()}


def bench_headline():
    import raytracer_tpu as rt
    from raytracer_tpu import ops as ops_mod

    world = rt.models.default_world()
    scene = world.to_scene()
    camera = world.to_camera()

    def run(seed):
        return ops_mod.render_linear_fast(
            scene, camera, width=WIDTH, height=HEIGHT,
            samples_per_pixel=SPP, depth=DEPTH, seed=seed)

    dt, (_, segments) = _time_steady(run)
    segments = int(segments)
    return _row(f"segments_per_sec_{WIDTH}x{HEIGHT}_{SPP}spp",
                segments / dt, "segments/s"), dt, segments


def _forward_row(metric, scene, cam, spp, depth):
    from raytracer_tpu import ops as ops_mod

    def run(seed):
        return ops_mod.render_linear_fast(
            scene, cam, width=512, height=512, samples_per_pixel=spp,
            depth=depth, seed=seed)

    dt, (_, segs) = _time_steady(run)
    return _row(metric, int(segs) / dt, "segments/s")


def bench_all():
    import jax
    import raytracer_tpu as rt
    from raytracer_tpu import grad as gradmod

    results = []
    scene, cam = rt.models.random_spheres()
    results.append(_forward_row(
        f"random_spheres_{scene.num_spheres}sph_512x512_16spp",
        scene, cam, 16, DEPTH))

    mscene, mcam = rt.models.mesh_scene(subdivisions=3)
    results.append(_forward_row(
        f"mesh_{mscene.num_triangles}tri_512x512_4spp", mscene, mcam, 4, 4))

    oscene, ocam = rt.models.obj_mesh_scene()
    results.append(_forward_row(
        f"obj_mesh_{oscene.num_triangles}tri_512x512_4spp", oscene, ocam,
        4, 4))

    from raytracer_tpu.models.builders import icosphere_mesh
    from raytracer_tpu.scene import DIFFUSE, METAL, build_materials, \
        build_scene
    btris = (icosphere_mesh((-0.6, 0.0, -1.4), 0.45, 0, 6)
             + icosphere_mesh((0.6, 0.0, -1.2), 0.45, 2, 6))
    bmats = build_materials([(DIFFUSE, (0.7, 0.3, 0.3), 0.0, 1.0),
                             (DIFFUSE, (0.8, 0.8, 0.0), 0.0, 1.0),
                             (METAL, (0.85, 0.85, 0.9), 0.05, 1.0)])
    bscene = build_scene([((0.0, -100.5, -1.0), 100.0, 1)], btris, bmats,
                         exact_planes=True)
    bcam = rt.Camera.new_at((0.0, 0.0, 0.0), 1.77778)
    results.append(_forward_row(
        f"mesh_{bscene.num_triangles}tri_512x512_4spp_depth4", bscene, bcam,
        4, 4))

    # gradient pass (inverse-rendering step): forward+backward paths/s
    world = rt.models.default_world()
    dscene, dcam = world.to_scene(), world.to_camera()
    W = H = 256
    gspp, gd = 8, 4
    target, _ = rt.render_linear(dscene, dcam, width=W, height=H,
                                 samples_per_pixel=gspp, depth=gd, seed=0)
    loss_fn = gradmod.make_loss_fn(dscene, dcam, target, width=W, height=H,
                                   samples_per_pixel=gspp, depth=gd, seed=1,
                                   engine="auto")
    params = gradmod.extract_params(
        dscene, ["sphere_center", "sphere_radius", "mat_color"])
    vg = jax.jit(jax.value_and_grad(loss_fn))
    dt, _ = _time_steady(lambda _: vg(params))
    results.append(_row(f"grad_pass_paths_per_sec_{W}x{H}_{gspp}spp",
                        W * H * gspp / dt, "paths/s"))

    # mesh gradients: XLA AD through the per-triangle scan keeps at least
    # one float per (sample, bounce, triangle, pixel) — 8*4*10240*65536*4
    # bytes = 86 GB for the OBJ mesh, 4*4*163840*65536*4 = 687 GB for the
    # 164k mesh, computed from the shapes — past one card's memory; the
    # GPU backward that replays the winner's index and t is not written
    for metric in (f"grad_pass_obj{oscene.num_triangles}tri_paths_per_sec_"
                   f"{W}x{H}_{gspp}spp",
                   f"grad_pass_mesh{bscene.num_triangles}tri_paths_per_sec_"
                   f"{W}x{H}_4spp"):
        results.append(_not_measured(
            metric, "no GPU gradient path: XLA AD residuals exceed device "
                    "memory (ROADMAP: GPU backward kernel)"))
    return results


def main() -> int:
    import jax

    if jax.devices()[0].platform != "gpu":
        print("bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from raytracer_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    headline, dt, segments = bench_headline()
    print(json.dumps(headline))
    print(f"[bench] segments/run={segments} median={dt:.4f}s "
          f"paths/s={WIDTH * HEIGHT * SPP / dt:.4e}", file=sys.stderr)
    if "--all" in sys.argv[1:]:
        for r in bench_all():
            print(json.dumps(r), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
