"""HTTP viewer tests: serve a real RenderSession over a loopback socket
and drive it the way the browser does (frame poll + key moves), mirroring
the reference GUI's keypress -> move_camera_position -> re-render loop
(GameView.swift:198-219, 323-334)."""

import json
import threading
import urllib.request

import numpy as np
import pytest

from raytracer_tpu import httpviewer
from raytracer_tpu.api import RenderSession
from raytracer_tpu.models import default_world_source
from raytracer_tpu.render import Options


@pytest.fixture(scope="module")
def server():
    session = RenderSession(default_world_source(), 32, 18,
                            Options(samples_per_pixel=1, max_ray_bounces=2))
    httpd = httpviewer.make_server(session, port=0)  # ephemeral port
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, dict(r.headers), r.read()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


class TestViewer:
    def test_index_page(self, server):
        status, _, body = _get(server + "/")
        assert status == 200
        assert b"keydown" in body and b"/frame.png" in body

    def test_frame_is_png(self, server):
        status, headers, body = _get(server + "/frame.png")
        assert status == 200
        assert headers["Content-Type"] == "image/png"
        assert body.startswith(b"\x89PNG\r\n\x1a\n")

    def test_move_changes_camera_and_frame(self, server):
        _, _, before = _get(server + "/frame.png")
        cam0 = json.loads(_get(server + "/camera")[2])
        status, resp = _post(server + "/move",
                             {"dx": 0.0, "dy": 0.0, "dz": -0.5})
        assert status == 200 and resp["generation"] >= 1
        cam1 = json.loads(_get(server + "/camera")[2])
        assert np.allclose(np.array(cam1["origin"]) -
                           np.array(cam0["origin"]), [0.0, 0.0, -0.5])
        _, _, after = _get(server + "/frame.png")
        assert after != before  # dirty-flag re-render happened

    def test_bad_move_rejected(self, server):
        req = urllib.request.Request(server + "/move", data=b"not json",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 400

    def test_unknown_path_404(self, server):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(server + "/nope", timeout=30)
        assert e.value.code == 404


@pytest.fixture(scope="module")
def progressive_server():
    session = RenderSession(default_world_source(), 24, 14,
                            Options(samples_per_pixel=1, max_ray_bounces=2),
                            progressive=True, max_samples=3)
    httpd = httpviewer.make_server(session, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


class TestProgressiveAccumulation:
    """VERDICT r2 item 9: /frame.png returns increasing-spp frames between
    moves; a camera move resets the accumulator."""

    def test_spp_increases_across_polls_and_resets_on_move(
            self, progressive_server):
        s = progressive_server
        _, h1, b1 = _get(s + "/frame.png")
        _, h2, b2 = _get(s + "/frame.png")
        _, h3, b3 = _get(s + "/frame.png")
        assert [h["X-Samples"] for h in (h1, h2, h3)] == ["1", "2", "3"]
        assert h1["X-Samples-Max"] == "3"
        # saturated: further polls stay at max and stop re-rendering
        _, h4, b4 = _get(s + "/frame.png")
        assert h4["X-Samples"] == "3" and b4 == b3
        # refinement actually changed pixels (new RNG streams per batch)
        assert b2 != b1
        # a camera move resets accumulation to the base spp
        _post(s + "/move", {"dx": 0.1, "dy": 0.0, "dz": 0.0})
        _, h5, _ = _get(s + "/frame.png")
        assert h5["X-Samples"] == "1"

    def test_first_batch_matches_plain_render(self):
        opts = Options(samples_per_pixel=2, max_ray_bounces=2)
        plain = RenderSession(default_world_source(), 20, 12, opts)
        prog = RenderSession(default_world_source(), 20, 12, opts,
                             progressive=True, max_samples=4)
        np.testing.assert_array_equal(plain.frame(), prog.frame())
        assert prog.samples_accumulated == 2
        prog.frame()
        assert prog.samples_accumulated == 4


class TestMeshSceneViewer:
    """An OBJ-scale mesh scene in the interactive viewer must ride the
    auto-dispatched fused kernel on the GPU (not silently fall back), with
    progressive refinement over a live socket.  The test keeps its old
    name from when that engine was a binned one."""

    def test_mesh_session_resolves_binned_and_refines(self):
        import raytracer_tpu as rt
        from raytracer_tpu.models.builders import icosphere_mesh
        from raytracer_tpu.scene import DIFFUSE, METAL, build_materials, \
            build_scene
        tris = icosphere_mesh((0.0, 0.0, -1.2), 0.5, 0, 4)   # 5120 tris
        mats = build_materials([(DIFFUSE, (0.7, 0.3, 0.3), 0.0, 1.0),
                                (METAL, (0.8, 0.8, 0.8), 0.1, 1.0)])
        scene = build_scene([((0.0, -100.5, -1.0), 100.0, 1)], tris, mats,
                            exact_planes=True)
        cam = rt.Camera.new_at((0.0, 0.0, 0.0), 1.77778)
        assert scene.num_triangles >= 2048
        session = RenderSession.from_world(
            scene, cam, 32, 18,
            Options(samples_per_pixel=1, max_ray_bounces=2),
            progressive=True, max_samples=3)
        # on a GPU auto-dispatch picks the fused kernel for this scene;
        # elsewhere the XLA wavefront
        assert session.resolved_engine(gpu=True) == "pallas"
        assert session.resolved_engine(gpu=False) == "xla"

        httpd = httpviewer.make_server(session, port=0)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            _, h1, b1 = _get(base + "/frame.png")
            _, h2, b2 = _get(base + "/frame.png")
            assert [h["X-Samples"] for h in (h1, h2)] == ["1", "2"]
            assert b2 != b1          # frames actually refine
            _post(base + "/move", {"dx": 0.05, "dy": 0.0, "dz": 0.0})
            _, h3, _ = _get(base + "/frame.png")
            assert h3["X-Samples"] == "1"
        finally:
            httpd.shutdown()
            httpd.server_close()
