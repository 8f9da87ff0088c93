"""Platform plumbing: where Pallas kernels run, where the compile cache
lives, and the image I/O that needs no image library."""

import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

from raytracinginoneweekendincuda_tpu.core import image
from raytracinginoneweekendincuda_tpu.ops.backend import pallas_interpret
from raytracinginoneweekendincuda_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_backend_gpu_compiles_kernels():
    assert pallas_interpret("gpu") is False


def test_backend_cpu_interprets_kernels():
    assert pallas_interpret("cpu") is True
    assert pallas_interpret() is True          # this suite runs on the CPU


@pytest.mark.parametrize("platform", ["tpu", "rocm", "METAL"])
def test_backend_other_platforms_raise(platform):
    with pytest.raises(RuntimeError, match=platform):
        pallas_interpret(platform)


def test_cache_dir_from_env(tmp_path):
    assert cache.cache_dir({cache.ENV_VAR: str(tmp_path)}) == str(tmp_path)


def test_cache_dir_default_is_inside_the_checkout():
    path = cache.cache_dir({})
    assert path == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("with_env", [True, False])
def test_compile_cache_lands_where_configured(tmp_path, with_env):
    """A compile in a fresh process writes its entry under
    JAX_COMPILATION_CACHE_DIR when set; without it, the process's jax
    config points at the in-checkout directory (checked without writing
    there)."""
    env = {k: v for k, v in os.environ.items() if k != cache.ENV_VAR}
    code = (
        "import jax, jax.numpy as jnp\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.config.update('jax_persistent_cache_min_entry_size_bytes', 0)\n"
        "from raytracinginoneweekendincuda_tpu.utils.cache import "
        "enable_compile_cache\n"
    )
    if with_env:
        env[cache.ENV_VAR] = str(tmp_path)
        code += ("print(enable_compile_cache())\n"
                 "jax.jit(lambda x: x * 2 + 1)(jnp.arange(4.0))"
                 ".block_until_ready()\n")
    else:
        code += ("import unittest.mock as m, os\n"
                 "with m.patch('os.makedirs'):\n"
                 "    p = enable_compile_cache()\n"
                 "print(p, jax.config.jax_compilation_cache_dir == p)\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    if with_env:
        assert out.stdout.split()[0] == str(tmp_path)
        assert any(tmp_path.iterdir()), "no cache entry written"
    else:
        path, same = out.stdout.split()
        assert path == os.path.join(REPO, ".jax_cache") and same == "True"


def _read_png(path):
    """Minimal PNG reader for the writer's own output (8-bit RGB, filter 0)."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, dims = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc = int.from_bytes(data[pos + 8 + n:pos + 12 + n], "big")
        assert zlib.crc32(tag + body) & 0xFFFFFFFF == crc
        if tag == b"IHDR":
            dims = (int.from_bytes(body[0:4], "big"),
                    int.from_bytes(body[4:8], "big"))
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = dims
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def test_png_writer_round_trips(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.random((9, 13, 3))
    path = str(tmp_path / "x.png")
    image.write_png(path, img)
    np.testing.assert_array_equal(_read_png(path),
                                  image.framebuffer_to_bytes(img))


def test_committed_earth_texels_match_the_jpeg_decode():
    """assets/earthmap.npy is the RtwImage-pipeline decode of
    assets/earthmap.jpg; pinned to Pillow's decode where Pillow exists."""
    pytest.importorskip("PIL")
    npy = image.decode_texture_bytes(image.default_asset("earthmap.npy"))
    jpg = image.decode_texture_bytes(image.default_asset("earthmap.jpg"))
    assert npy.dtype == np.uint8 and npy.shape == (512, 1024, 3)
    np.testing.assert_array_equal(npy, jpg)


def test_texture_missing_is_none_undecodable_raises(tmp_path):
    assert image.load_texture_image(str(tmp_path / "absent.npy")) is None
    bad = tmp_path / "bad.npy"
    bad.write_bytes(b"not an array")
    with pytest.raises(Exception):
        image.load_texture_image(str(bad))
    img = image.load_texture_image(image.default_asset("earthmap.npy"))
    assert img.shape == (512, 1024, 3) and 0.0 <= img.min() < img.max() <= 1.0
