"""CLI driver — the reference binary's entry point.

Mirrors ``/root/reference/raytracer/src/main.rs``:
  * args ``samples=N`` / ``ray_depth=N`` parsed with the same combinator
    style, defaults 50 / 8 (main.rs:23-45); unknown arguments abort
    (main.rs:40).
  * the scene file's parsed camera is DISCARDED and a hardcoded look-at
    camera used instead: origin (0,0,0) -> (0,0,-1), up Y, vfov pi/2,
    aspect 1.77778 (main.rs:57, 86-88).
  * image width 400, height = width / aspect (main.rs:91-92); output
    ``image.ppm`` (main.rs:99).

Extensions beyond the reference (all optional, keyword=value style):
  ``scene=PATH`` (the reference hardcodes an absolute path, parser.rs:47-52),
  ``obj=PATH`` (render a Wavefront OBJ mesh, auto-framed into the view —
  the reference has no mesh file format), ``width=N``, ``out=PATH``
  (.ppm or .png), ``seed=N``, ``parity=0|1`` (bit-exact sequential mode),
  ``use_scene_camera=1`` (honor the DSL camera like the FFI path does).
"""

from __future__ import annotations

import math
import sys
import time

from . import parser as parser_mod
from .camera import Camera
from .image import write_png, write_ppm
from .models import default_world_source
from .render import Options, ray_trace, ray_trace_parity


def get_arguments(argv):
    """main.rs:23-45 — samples=N / ray_depth=N (+ extensions)."""
    samples_per_pixel = 50
    max_ray_bounces = 8
    extras = {}
    for argument in argv:
        matched = False
        for key in ("samples", "ray_depth", "width", "seed", "parity",
                    "use_scene_camera"):
            try:
                rest = parser_mod.starts_with(argument, key)
                rest = parser_mod.starts_with(rest, "=")
            except parser_mod.ParseError:
                continue
            _, value = parser_mod.parse_int(rest)
            if key == "samples":
                samples_per_pixel = value
            elif key == "ray_depth":
                max_ray_bounces = value
            else:
                extras[key] = value
            matched = True
            break
        if matched:
            continue
        for key in ("scene", "out", "obj"):
            try:
                rest = parser_mod.starts_with(argument, key)
                rest = parser_mod.starts_with(rest, "=")
                extras[key] = rest
                matched = True
                break
            except parser_mod.ParseError:
                continue
        if not matched:
            # main.rs:40 panics on unknown arguments
            raise SystemExit(f"Unknown argument '{argument}'")
    return samples_per_pixel, max_ray_bounces, extras


def _obj_scene(path: str):
    """Load an OBJ mesh auto-framed into the CLI camera's view (unit-ish
    size at z = -1.5 over a ground sphere; corrected plane equation — OBJ
    scenes have no reference-parity claim)."""
    from .models import obj as obj_mod
    from .scene import DIFFUSE, METAL, build_materials, build_scene
    with open(path) as f:
        src = f.read()
    raw = obj_mod.parse_obj(src, 0)
    lo, hi = obj_mod.obj_bounds(raw)
    extent = float(max(max(h - l for h, l in zip(hi, lo)), 1e-6))
    s = 0.9 / extent
    c = [(h + l) * 0.5 * s for h, l in zip(hi, lo)]
    tris = obj_mod.parse_obj(src, 0, scale=s,
                             translate=(-c[0], -c[1] + 0.05, -c[2] - 1.5))
    mats = build_materials([(DIFFUSE, (0.75, 0.45, 0.3), 0.0, 1.0),
                            (DIFFUSE, (0.8, 0.8, 0.0), 0.0, 1.0)])
    return build_scene([((0.0, -100.5, -1.0), 100.0, 1)], tris, mats,
                       exact_planes=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    samples, depth, extras = get_arguments(argv)
    print(f"Using:\n* Samples per pixel: {samples}\n* Max ray depth: {depth}",
          file=sys.stderr)

    if "obj" in extras:
        scene = _obj_scene(extras["obj"])
        world = None
    elif "scene" in extras:
        world = parser_mod.parse_world(extras["scene"])
        scene = world.to_scene()
    else:
        world = parser_mod.parse_input(default_world_source())
        scene = world.to_scene()

    if world is not None and extras.get("use_scene_camera"):
        camera = world.to_camera()
        aspect = float(camera.aspect_ratio())
    else:
        # main.rs:86-88 — the CLI ignores the parsed camera
        aspect = 1.77778
        camera = Camera.new_look_at((0.0, 0.0, 0.0), (0.0, 0.0, -1.0),
                                    (0.0, 1.0, 0.0), math.pi / 2.0, aspect)

    image_width = int(extras.get("width", 400))      # main.rs:91
    image_height = int(image_width / aspect)         # main.rs:92

    t0 = time.perf_counter()
    if extras.get("parity"):
        fb = ray_trace_parity(scene, camera, image_width, image_height,
                              samples, depth)
        segments = None
    else:
        # main.rs:51 wires the scanline logger to stderr in the CLI
        from .utils.profiling import ScanlineLogger
        opts = Options(samples_per_pixel=samples, max_ray_bounces=depth,
                       seed=int(extras.get("seed", Options().seed)),
                       logger=ScanlineLogger())
        fb, segments = ray_trace(scene, camera, image_width, image_height, opts)
    dt = time.perf_counter() - t0

    out = extras.get("out", "image.ppm")
    print(" Done!\nWriting image...", file=sys.stderr, end="")
    if out.endswith(".png"):
        write_png(fb, out)
    else:
        write_ppm(fb, out)
    print("          Done!", file=sys.stderr)
    if segments is not None:
        print(f"[stats] {segments} ray segments in {dt:.3f}s "
              f"({segments / dt / 1e6:.1f} Mrays/s incl. compile)",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    from .utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    raise SystemExit(main())
