"""raytracer_tpu — a differentiable path tracer built from scratch
in JAX/XLA/Pallas with the capabilities of the reference Rust+Swift raytracer
(Naxaes/Rust-Swift-Raytracer; survey in /root/repo/SURVEY.md).

Layer map (mirrors SURVEY.md §1, redesigned for wide data-parallel devices):
  L1  maths / mat3 / rng / image   — array math, counter-based + parity RNG
  L2  scene / materials / camera / parser — SoA pytrees, branchless dispatch
  L3  intersect / render           — wavefront lax.scan path tracer
  L4  cli / api                    — CLI driver and embedding (render-service) API
  L5  parallel                     — mesh/sharding (multi-device)
  aux grad / models / oracle       — inverse rendering, scene zoo, golden oracle
"""

from . import maths, mat3, rng, color, image
from . import scene, materials, camera, parser
from . import intersect, render
from . import oracle
from . import models

from .camera import Camera
from .render import Options, ray_trace, ray_trace_parity, render_linear, finalize_image
from .scene import Scene, Materials, build_scene, build_materials
from .scene import DIFFUSE, METAL, DIELECTRIC, EMISSION
from .parser import parse_input, parse_world, ParseError

__version__ = "0.1.0"
