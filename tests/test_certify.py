"""Full-scale BASELINE certification pins.

The committed CERTIFY.json records the agreement of the native C++
parity engine and the GPU fast path on the BASELINE target config
(512x512, 64 spp, 8 bounces) — scripts/certify_fullscale.py regenerates
it on the card.  These tests (a) pin the committed artifact's
acceptance thresholds and (b) re-verify a DOWNSAMPLED tile of the same
workload shape (depth 8, reference world) bit-exactly across all three
independent implementations: NumPy oracle, sequential-parity JAX
renderer, and the native C++ engine.
"""
import json
from pathlib import Path

import numpy as np
import pytest

import raytracer_tpu as rt
from raytracer_tpu import native

ROOT = Path(__file__).resolve().parent.parent

try:
    native.load_library()
    HAVE_NATIVE = True
except Exception:
    HAVE_NATIVE = False


def test_certify_artifact_within_thresholds():
    report = json.loads((ROOT / "CERTIFY.json").read_text())
    assert report["config"] == {
        "width": 512, "height": 512, "spp": 64, "depth": 8,
        "scene": "default_world (reference world.txt)"}
    assert report["psnr_db"] > 30.0
    assert report["mean_abs_diff_u8"] < 4.0
    assert len(report["native_parity_sha256"]) == 64
    # regenerated on the card, which it names
    assert report["device"]["platform"] == "gpu"
    assert report["card"].startswith(report["device"]["kind"])


@pytest.mark.skipif(not HAVE_NATIVE, reason="native library unavailable")
def test_downsampled_tile_bit_exact_all_three(default_world):
    # the certification workload at 48x27 / 2 spp keeps the full depth-8
    # bounce budget; all three implementations must agree bit-for-bit
    W, H, SPP, D = 48, 27, 2, 8
    src = rt.models.default_world_source()
    nat = native.NativeWorld(src).render(W, H, samples_per_pixel=SPP,
                                         max_ray_bounces=D)
    ocam, oworld = default_world.to_oracle()
    ref = rt.oracle.ray_trace(oworld, ocam, W, H, SPP, D)
    assert np.array_equal(np.asarray(nat), np.asarray(ref))
    scene, cam = default_world.to_scene(), default_world.to_camera()
    got = rt.ray_trace_parity(scene, cam, W, H, SPP, D)
    assert np.array_equal(np.asarray(got), np.asarray(ref))
