"""chip_smoke.py refuses to run without a GPU or outside a checkout, and
its comparison helpers enforce their bounds."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "chip_smoke.py"


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _assert_refused(proc):
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        try:
            doc = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(doc, dict) and "ok" in doc), line


@pytest.mark.parametrize("args", [[], ["--four-cards"]])
def test_refuses_on_cpu(args):
    proc = _run([str(SCRIPT), *args], cwd=ROOT)
    _assert_refused(proc)
    assert "needs an NVIDIA GPU" in proc.stderr


def test_refuses_alone_in_a_directory(tmp_path):
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    _assert_refused(_run(["chip_smoke.py"], cwd=tmp_path))


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_compare_images_enforces_bounds(smoke):
    ref = np.zeros((4, 4, 3), np.float32)
    smoke.compare_images("same", ref, ref, 1e-4, 0.1)
    smoke.compare_images("near", ref + np.float32(5e-5), ref, 1e-4, 0.1)
    with pytest.raises(AssertionError, match="mean"):
        smoke.compare_images("far", ref + 1.0, ref, 1e-4, 0.1)
    spike = ref.copy()
    spike[0, 0, 0] = 0.2
    with pytest.raises(AssertionError, match="max"):
        smoke.compare_images("spike", spike, ref, 1.0, 0.1)
    with pytest.raises(AssertionError, match="non-finite"):
        smoke.compare_images("nan", ref + np.nan, ref, 1e-4, 0.1)


def test_kernel_bounds_allow_two_flipped_samples(smoke):
    # one sample of unit radiance taking another path moves a pixel's mean
    # by 1/spp: two such flips pass, three do not
    spp = 64
    ref = np.zeros((64, 64, 3), np.float32)
    two = ref.copy()
    two[0, 0, 0] = 2.0 / spp
    smoke.compare_images("two flips", two, ref, smoke.KERNEL_MEAN_ABS,
                         smoke.KERNEL_MAX_FLIPS / spp)
    three = ref.copy()
    three[0, 0, 0] = 3.0 / spp
    with pytest.raises(AssertionError):
        smoke.compare_images("three flips", three, ref, 1.0,
                             smoke.KERNEL_MAX_FLIPS / spp)


def test_compare_segments_enforces_bounds(smoke):
    rel = smoke.KERNEL_SEGMENTS_REL
    smoke.compare_segments("same", 1000, 1000, rel)
    smoke.compare_segments("close", 1_000_005, 1_000_000, rel)
    with pytest.raises(AssertionError):
        smoke.compare_segments("off", 1100, 1000, rel)
    with pytest.raises(AssertionError):
        smoke.compare_segments("none", 0, 0, rel)


@pytest.fixture
def rehearsal(smoke, monkeypatch):
    """Run chip_smoke's phases on the CPU at tiny sizes: the dispatch
    believes it is on a GPU and the kernel runs in the Pallas interpreter.
    On 16x16 images one flipped sample dominates the image mean, so the
    mean and segment bounds are widened; the max bound (flips / spp) and
    the gradient bound stay."""
    from raytracer_tpu import ops
    from raytracer_tpu.ops.pallas import wavefront as wf
    render = wf.render_linear_pallas
    monkeypatch.setattr(ops, "backend_is_gpu", lambda: True)
    monkeypatch.setattr(wf, "render_linear_pallas",
                        lambda *a, **k: render(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(smoke, "KERNEL_MEAN_ABS", 1e-2)
    monkeypatch.setattr(smoke, "KERNEL_SEGMENTS_REL", 1e-2)
    return smoke


def test_one_card_phases_rehearse_on_cpu(rehearsal):
    rehearsal.phase_headline(size=16, spp=2)
    rehearsal.phase_spheres(size=16, spp=2)
    rehearsal.phase_mesh(size=16, spp=2)
    rehearsal.phase_parity()
    rehearsal.phase_gradient(size=16, spp=2)


def test_four_card_phase_rehearses_on_cpu(rehearsal):
    rehearsal.phase_four_cards(size=16, spp=2, depth=3, grad_size=16)
