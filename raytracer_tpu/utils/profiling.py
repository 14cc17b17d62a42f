"""Profiling / observability.

The reference's only instrumentation is a scanline progress line behind
``Options.logger`` (common.rs:292,328-330) and an offline criterion bench.
For a renderer whose headline metric is traced segments per second, profiling is
first-class (SURVEY.md §5): jax.profiler trace capture plus rays/s counters
derived from the renderer's on-device segment counts.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Iterator, Optional

import jax


@dataclasses.dataclass
class RenderStats:
    """Throughput accounting for one or more renders."""
    seconds: float = 0.0
    segments: int = 0          # rays actually traced (live lanes per bounce)
    paths: int = 0             # camera samples (W*H*spp)
    renders: int = 0

    @property
    def rays_per_sec(self) -> float:
        return self.segments / self.seconds if self.seconds else 0.0

    @property
    def paths_per_sec(self) -> float:
        return self.paths / self.seconds if self.seconds else 0.0

    def merge(self, other: "RenderStats") -> "RenderStats":
        return RenderStats(self.seconds + other.seconds,
                           self.segments + other.segments,
                           self.paths + other.paths,
                           self.renders + other.renders)

    def __str__(self) -> str:
        return (f"{self.renders} render(s): {self.seconds:.3f}s, "
                f"{self.segments/1e6:.1f}M segments "
                f"({self.rays_per_sec/1e6:.1f} Mrays/s, "
                f"{self.paths_per_sec/1e6:.2f} Mpaths/s)")


@contextlib.contextmanager
def timed_render(width: int, height: int, samples_per_pixel: int
                 ) -> Iterator[RenderStats]:
    """Measure one render: fill ``stats.segments`` from the renderer's
    return value inside the block; timing and paths are filled here.

        with timed_render(W, H, spp) as stats:
            img, segs = render_linear_fast(...)
            jax.block_until_ready(img)
            stats.segments = int(segs)
    """
    stats = RenderStats(paths=width * height * samples_per_pixel, renders=1)
    t0 = time.perf_counter()
    yield stats
    stats.seconds = time.perf_counter() - t0


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/raytracer_tpu_trace"):
    """jax.profiler trace capture around a block (view with TensorBoard or
    xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


class ScanlineLogger:
    """The reference's progress logger (common.rs:328-330): writes
    ``\\rScanline: {:<4}`` counting DOWN (``height - rows_done``, matching
    the reference's ``height - row - 1`` at the most recent completed row)
    as row bands complete.  Assign to ``Options.logger``; ``ray_trace``
    then renders in row bands (bitwise identical output) and calls
    ``logger(rows_done, height)`` per band."""

    def __init__(self, stream=None):
        import sys
        self.stream = stream if stream is not None else sys.stderr

    def __call__(self, rows_done: int, height: int) -> None:
        self.stream.write(f"\rScanline: {height - rows_done:<4}")
        self.stream.flush()
