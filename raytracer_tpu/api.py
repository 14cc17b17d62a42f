"""Embedding (render-service) API.

Mirror of the reference's C ABI surface (``/root/reference/raytracer/src/
lib.rs``): ``load_world`` (lib.rs:38-46), ``render`` (lib.rs:50-57, which
hardcodes 16 spp / 8 bounces for the interactive path) and
``move_camera_position`` (lib.rs:60-63).  This is the layer the Swift GUI
talks to in the reference; here it is the layer any Python host (or the C ABI
shim in native/) talks to.

Because the camera and scene are traced pytree arguments of the jitted
renderer, a camera move re-renders WITHOUT recompilation — the array-program
answer to the reference's per-keypress synchronous re-render
(GameView.swift:198-219).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from . import image as image_mod
from .camera import Camera
from .parser import ParsedWorld, parse_input
from .render import Options, ray_trace
from .scene import Scene


@dataclasses.dataclass
class WorldHandle:
    """Opaque world handle (lib.rs:29-33): scene + the DSL's camera.

    Note the reference asymmetry (SURVEY.md §3.3): the FFI path uses the
    camera parsed from the DSL (lib.rs:40-44) while the CLI builds its own
    (main.rs:86-88).  This handle carries the DSL camera.
    """
    scene: Scene
    camera: Camera
    parsed: Optional[ParsedWorld] = None


def load_world(source: str | bytes) -> WorldHandle:
    """lib.rs:38-46 — parse a (possibly NUL-terminated) DSL source into an
    opaque handle."""
    if isinstance(source, bytes):
        source = source.split(b"\x00", 1)[0].decode("utf-8")
    parsed = parse_input(source)
    return WorldHandle(scene=parsed.to_scene(), camera=parsed.to_camera(),
                       parsed=parsed)


# lib.rs:51 hardcodes Options::new(16, 8, None, true) for the FFI render
FFI_DEFAULT_OPTIONS = Options(samples_per_pixel=16, max_ray_bounces=8)


def render(handle: WorldHandle, width: int, height: int,
           options: Options | None = None) -> np.ndarray:
    """lib.rs:50-57 — render into a fresh RGBA8 framebuffer [H, W, 4].

    The reference signature takes a caller-allocated CFramebuffer purely to
    communicate width/height (its contents are overwritten); here the
    dimensions are explicit arguments.
    """
    opts = options or FFI_DEFAULT_OPTIONS
    fb, _segments = ray_trace(handle.scene, handle.camera, width, height, opts)
    return fb


def move_camera_position(handle: WorldHandle, x: float, y: float, z: float
                         ) -> WorldHandle:
    """lib.rs:60-63 — rebuild a ``new_at`` camera at the offset origin with
    the same aspect ratio.  Returns an updated handle (functional style; the
    reference mutates through a Box)."""
    return dataclasses.replace(handle, camera=handle.camera.moved_by((x, y, z)))


class RenderSession:
    """Interactive render loop helper: the equivalent of the
    Swift GUI's keypress -> move_camera_position -> render cycle
    (GameView.swift:198-219, 323-334).

    The first render compiles; subsequent renders at the same (width,
    height, spp, depth) reuse the compiled executable with the moved camera
    passed as data.

    ``progressive=True`` goes beyond the reference's fixed-16-spp
    interactive loop (lib.rs:51): after a camera move the first frame is
    the base spp, and every subsequent ``frame()`` call while the camera
    is still ACCUMULATES another batch of samples (fresh RNG streams via
    the seed) up to ``max_samples``, so a polling frontend displays
    progressive refinement.  A move resets the accumulator.
    """

    def __init__(self, source: Optional[str], width: int, height: int,
                 options: Options | None = None, *,
                 progressive: bool = False,
                 max_samples: Optional[int] = None,
                 handle: Optional[WorldHandle] = None):
        self.handle = handle if handle is not None else load_world(source)
        self.width = width
        self.height = height
        self.options = options or FFI_DEFAULT_OPTIONS
        self.progressive = progressive
        self.max_samples = (max_samples if max_samples is not None
                            else self.options.samples_per_pixel * 16)
        self._dirty = True
        self._frame: Optional[np.ndarray] = None
        self._accum: Optional[np.ndarray] = None
        self._accum_spp = 0

    @classmethod
    def from_world(cls, scene, camera, width: int, height: int,
                   options: Options | None = None, *,
                   progressive: bool = False,
                   max_samples: Optional[int] = None) -> "RenderSession":
        """Interactive session over a prebuilt scene (OBJ meshes,
        procedural geometry) instead of DSL source — the browser viewer's
        path onto the auto-dispatched big-mesh engines."""
        return cls(None, width, height, options, progressive=progressive,
                   max_samples=max_samples,
                   handle=WorldHandle(scene=scene, camera=camera,
                                      parsed=None))

    def resolved_engine(self, gpu: bool | None = None) -> str:
        """The engine auto-dispatch picks for this session's renders
        (ops.resolve_dispatch over the live scene) — surfaced so
        frontends/tests can confirm a mesh scene rides the fused kernel on
        the GPU rather than silently falling back."""
        from . import ops as ops_mod
        engine, _, _ = ops_mod.resolve_dispatch(
            self.handle.scene, self.options.parity_plane_sign,
            self.options.engine, gpu=gpu)
        return engine

    @property
    def samples_accumulated(self) -> int:
        """spp represented by the current frame (base spp when not
        progressive)."""
        if not self.progressive:
            return self.options.samples_per_pixel
        return self._accum_spp

    def move_camera(self, dx: float, dy: float, dz: float) -> None:
        self.handle = move_camera_position(self.handle, dx, dy, dz)
        self._dirty = True

    def _accumulate_batch(self) -> None:
        import jax.numpy as jnp
        from . import ops as ops_mod
        from .render import finalize_image
        spp = self.options.samples_per_pixel
        batch = self._accum_spp // spp
        mean, _segs = ops_mod.render_linear_fast(
            self.handle.scene, self.handle.camera, width=self.width,
            height=self.height, samples_per_pixel=spp,
            depth=self.options.max_ray_bounces,
            parity_plane_sign=self.options.parity_plane_sign,
            seed=self.options.seed + batch, engine=self.options.engine)
        mean = np.asarray(mean, np.float64)
        self._accum = mean * spp if self._accum is None \
            else self._accum + mean * spp
        self._accum_spp += spp
        self._frame = np.asarray(finalize_image(
            jnp.asarray(self._accum / self._accum_spp, jnp.float32)))

    def frame(self) -> np.ndarray:
        """Dirty-flag render (GameView.swift:323-334
        updateFramebufferIfDirty); in progressive mode each clean-camera
        call refines the image by one sample batch up to max_samples."""
        if self._dirty or self._frame is None:
            self._accum = None
            self._accum_spp = 0
            if self.progressive:
                self._accumulate_batch()
            else:
                self._frame = render(self.handle, self.width, self.height,
                                     self.options)
            self._dirty = False
        elif self.progressive and self._accum_spp < self.max_samples:
            self._accumulate_batch()
        return self._frame

    def save(self, path: str) -> None:
        if path.endswith(".png"):
            image_mod.write_png(self.frame(), path)
        else:
            image_mod.write_ppm(self.frame(), path)
