"""Card-only tests: the fused kernel as Triton compiles it for the GPU.

Marked ``gpu`` and gated by the ``gpu`` fixture, so they skip on the CPU
harness; ``python chip_smoke.py`` runs them on the card (``RAYTRACER_TEST_GPU=1
pytest -m gpu tests/test_gpu.py`` does the same by hand).  Bounds are the
smoke test's: the two compilers round some float ops differently, so
images agree to float rounding plus rare branch flips.
"""

import numpy as np
import pytest

import raytracer_tpu as rt
from raytracer_tpu import ops, parallel
from raytracer_tpu.ops.pallas import wavefront as wf

pytestmark = pytest.mark.gpu

# one sample taking another path moves a pixel's mean by at most 1/spp;
# on these small images a flip weighs more in the mean than at 512x512
MEAN_ABS = 2e-4
MAX_FLIPS = 2


def _close(a, b, spp):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert np.isfinite(np.asarray(a)).all()
    assert d.mean() <= MEAN_ABS, d.mean()
    assert d.max() <= MAX_FLIPS / spp, d.max()


@pytest.mark.parametrize("name", ["default_world", "mesh"])
def test_compiled_kernel_matches_xla(gpu, name):
    if name == "mesh":
        scene, cam = rt.models.mesh_scene(subdivisions=2)
    else:
        w = rt.models.default_world()
        scene, cam = w.to_scene(), w.to_camera()
    kw = dict(width=96, height=64, samples_per_pixel=4, depth=4, seed=2)
    k, ks = ops.render_linear_fast(scene, cam, engine="pallas", **kw)
    x, xs = ops.render_linear_fast(scene, cam, engine="xla", **kw)
    _close(k, x, kw["samples_per_pixel"])
    assert abs(int(ks) - int(xs)) <= max(2, int(xs) // 1000)


def test_auto_dispatch_picks_kernel(gpu, default_world):
    engine, _, _ = ops.resolve_dispatch(default_world.to_scene(), None)
    assert engine == "pallas"


@pytest.mark.parametrize("block_pixels", [64, 128, 256])
def test_block_size_does_not_change_the_image(gpu, default_world, block_pixels):
    scene, cam = default_world.to_scene(), default_world.to_camera()
    sph, tri, scl, tcl = ops.scene_tables(scene, True)
    kw = dict(width=50, height=30, samples_per_pixel=2, depth=4, seed=1)
    ref, _ = wf.render_linear_pallas(sph, tri, wf.camera_vec(cam), **kw)
    img, _ = wf.render_linear_pallas(sph, tri, wf.camera_vec(cam),
                                     block_pixels=block_pixels, **kw)
    assert np.array_equal(np.asarray(ref), np.asarray(img))


def test_banded_progress_render_is_bitwise_unbanded(gpu, default_world):
    scene, cam = default_world.to_scene(), default_world.to_camera()
    kw = dict(width=40, height=37, samples_per_pixel=2, depth=3, seed=5)
    full, _ = ops.render_linear_fast(scene, cam, **kw)
    rows = []
    banded, _ = ops.render_linear_fast(
        scene, cam, progress=lambda done, h: rows.append(done), **kw)
    assert rows[-1] == 37
    assert np.array_equal(np.asarray(full), np.asarray(banded))


def test_sharded_kernel_on_one_card_mesh(gpu, default_world):
    scene, cam = default_world.to_scene(), default_world.to_camera()
    kw = dict(width=48, height=20, samples_per_pixel=2, depth=3, seed=4)
    ref, rs = ops.render_linear_fast(scene, cam, **kw)
    out, s = parallel.render_linear_sharded_fast(
        scene, cam, mesh=parallel.make_mesh(1), **kw)
    assert np.array_equal(np.asarray(ref), np.asarray(out))
    assert int(rs) == int(s)
