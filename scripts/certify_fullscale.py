"""Full-scale image certification on the GPU.

Renders the reference's bundled 8-sphere world at 512x512, 64 spp,
8 bounces through BOTH independent implementations:

  * the native C++ parity engine (bit-identical to the NumPy oracle and
    hence to the reference algorithm: exact xorshift32 stream in raster
    order, same f32 op order — tests/test_native.py), and
  * the GPU fast path (``rt.ray_trace`` with auto dispatch: the fused
    kernel, counter-based pcg3d sampler) with the reference's plane-sign
    parity semantics;

and certifies their agreement in u8 output space (per-channel max diff,
mean abs diff, PSNR — the samplers differ, so the comparison is
statistical: Monte-Carlo noise of two unbiased 64-sample estimators).
Writes the report (default CERTIFY.json at the repo root) with the native
image's sha256, the device and the card's name and power limit, plus the
two PNGs beside it for eyeballing.  Refuses to run without a GPU.

Run:  python scripts/certify_fullscale.py [--out PATH]
"""
import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import numpy as np  # noqa: E402

import raytracer_tpu as rt  # noqa: E402
from raytracer_tpu import native, ops  # noqa: E402
from raytracer_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

W, H, SPP, DEPTH = 512, 512, 64, 8


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "CERTIFY.json"))
    out = Path(ap.parse_args().out)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"certify_fullscale: needs a GPU, JAX found {dev.platform}")
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]

    src = rt.models.default_world_source()
    print("native parity render ...", flush=True)
    nat = native.NativeWorld(src).render(
        W, H, samples_per_pixel=SPP, max_ray_bounces=DEPTH, parity=True)
    nat_rgb = np.asarray(nat)[..., :3].astype(np.int32)

    print("gpu fast render ...", flush=True)
    world = rt.parse_input(src)
    scene, cam = world.to_scene(), world.to_camera()
    engine, _, _ = ops.resolve_dispatch(scene, True)
    gpu_img, segs = rt.ray_trace(
        scene, cam, W, H,
        rt.Options(samples_per_pixel=SPP, max_ray_bounces=DEPTH,
                   parity_plane_sign=True))
    gpu_rgb = np.asarray(gpu_img)[..., :3].astype(np.int32)

    diff = np.abs(nat_rgb - gpu_rgb)
    mse = float(np.mean((nat_rgb - gpu_rgb).astype(np.float64) ** 2))
    psnr = 10.0 * np.log10(255.0 ** 2 / max(mse, 1e-12))
    report = {
        "config": {"width": W, "height": H, "spp": SPP, "depth": DEPTH,
                   "scene": "default_world (reference world.txt)"},
        "native_parity_sha256": hashlib.sha256(
            np.ascontiguousarray(nat).tobytes()).hexdigest(),
        "native_engine": "C++ parity (bit-identical to oracle/reference "
                         "algorithm, exact xorshift32 stream)",
        "gpu_engine": f"{engine} (auto dispatch), pcg3d counter sampler, "
                      "parity plane sign",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "per_channel_max_diff_u8": [int(diff[..., c].max())
                                    for c in range(3)],
        "mean_abs_diff_u8": float(diff.mean()),
        "frac_pixels_diff_gt_8": float((diff.max(axis=-1) > 8).mean()),
        "psnr_db": round(psnr, 2),
        "gpu_segments": int(segs),
    }
    out.write_text(json.dumps(report, indent=1) + "\n")
    print(json.dumps(report, indent=1))
    rt.image.write_png(np.asarray(nat), str(out.with_name("certify_native.png")))
    rt.image.write_png(np.asarray(gpu_img), str(out.with_name("certify_gpu.png")))
    # acceptance: two unbiased 64-spp estimators of the same integral -
    # agreement must be sampling noise, not bias
    assert psnr > 30.0, f"PSNR {psnr} too low - engines disagree"
    assert report["mean_abs_diff_u8"] < 4.0
    print("CERTIFIED")


if __name__ == "__main__":
    main()
