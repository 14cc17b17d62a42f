"""Compile-cache placement: JAX_COMPILATION_CACHE_DIR wins and nothing is
set in code; otherwise the fixed path <checkout>/.jax_cache.  Each case
runs in a fresh interpreter, since the setting is process-wide."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PROBE = ("import jax\n"
         "from raytracer_tpu.utils.compile_cache import enable_compile_cache\n"
         "print(enable_compile_cache())\n"
         "print(jax.config.jax_compilation_cache_dir)\n")


def _probe(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    returned, configured = out.stdout.splitlines()[-2:]
    return returned, configured


def test_env_variable_is_honoured_and_nothing_else_set(tmp_path):
    returned, configured = _probe(str(tmp_path / "cache"))
    assert returned == str(tmp_path / "cache")
    assert configured == str(tmp_path / "cache")


def test_default_is_fixed_path_in_checkout():
    returned, configured = _probe(None)
    assert returned == configured == str(ROOT / ".jax_cache")


def test_default_path_is_gitignored():
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
