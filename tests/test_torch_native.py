"""The port's native host library against the JAX package's, on the CPU.

``semseg_tpu_torch/native`` keeps a verbatim copy of
``semseg_tpu/native/preprocess.cpp`` and bindings of the same names, built
under ``build/semseg_tpu_torch_native/``. Each function here gets the same
seeded numpy arrays, or JPEGs written by PIL, on both sides, and the outputs
must be equal bit for bit: the resizes with and without the fused flip,
``normalize_pad``, ``preprocess``, the decode at every DCT scale, its dims,
grayscale and non-JPEG input, the decompression-bomb guard, and the
per-process oracle that turns the decode off at a mismatch with PIL.
Where the host has libjpeg's header, the port's library must have been
built with it: a build without it fails here instead of skipping.
"""

import io
import os

import numpy as np
import pytest
from PIL import Image

import semseg_tpu.native as jax_native
import semseg_tpu_torch.native as native
from semseg_tpu_torch.data import dataset as port_dataset
from semseg_tpu_torch.data.transforms import MEAN, STD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HAS_JPEG_HEADER = os.path.exists("/usr/include/jpeglib.h")
# (source (H, W), target (H, W)): downscale (antialiased), upscale, heavy
# downscale, identity, extreme upscale.
RESIZES = [((123, 87), (60, 45)), ((60, 80), (120, 157)), ((300, 400), (97, 131)),
           ((50, 50), (50, 50)), ((7, 9), (300, 200))]


def _jpeg(arr, quality=90, **kw):
    b = io.BytesIO()
    Image.fromarray(arr).save(b, "JPEG", quality=quality, **kw)
    return b.getvalue()


def _require_jpeg():
    if not HAS_JPEG_HEADER:
        pytest.skip("this host has no jpeglib.h")
    assert native.jpeg_available(), native.build_info()


def test_cpp_copy_is_byte_equal():
    with open(os.path.join(ROOT, "semseg_tpu", "native", "preprocess.cpp"), "rb") as a, \
            open(os.path.join(ROOT, "semseg_tpu_torch", "native", "preprocess.cpp"), "rb") as b:
        assert a.read() == b.read()


def test_library_is_built_under_build_with_libjpeg():
    from semseg_tpu.utils.compile_cache import host_fingerprint as jax_fingerprint
    from semseg_tpu_torch.utils.host import host_fingerprint

    assert native.available()
    info = native.build_info()
    lib = info["library"]
    assert lib.startswith(os.path.join(ROOT, "build", "semseg_tpu_torch_native") + os.sep)
    assert os.path.exists(lib)
    assert os.path.basename(os.path.dirname(lib)).startswith(host_fingerprint() + "-")
    assert host_fingerprint() == jax_fingerprint()
    # Nothing was built inside the package.
    assert not [f for f in os.listdir(os.path.dirname(native.__file__)) if f.endswith(".so")]
    assert info["command"].startswith("g++ -O3 -march=native -shared -fPIC ")
    if HAS_JPEG_HEADER:
        assert info["jpeg"] and info["command"].endswith("-DSSG_HAVE_JPEG=1 -ljpeg"), info


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("src_hw,dst_hw", RESIZES)
def test_resizes_equal_jax(src_hw, dst_hw, flip):
    rng = np.random.RandomState(hash((src_hw, dst_hw)) % 2**31)
    rgb = rng.randint(0, 256, (*src_hw, 3)).astype(np.uint8)
    lab = rng.randint(0, 151, src_hw).astype(np.uint8)
    np.testing.assert_array_equal(native.resize_bilinear_u8(rgb, dst_hw, flip=flip),
                                  jax_native.resize_bilinear_u8(rgb, dst_hw, flip=flip))
    np.testing.assert_array_equal(native.resize_nearest_u8(lab, dst_hw, flip=flip),
                                  jax_native.resize_nearest_u8(lab, dst_hw, flip=flip))
    # And Pillow's own pixels (the point of both copies).
    im = Image.fromarray(rgb).transpose(Image.FLIP_LEFT_RIGHT) if flip else Image.fromarray(rgb)
    np.testing.assert_array_equal(native.resize_bilinear_u8(rgb, dst_hw, flip=flip),
                                  np.asarray(im.resize(dst_hw[::-1], Image.BILINEAR)))


@pytest.mark.parametrize("flip", [False, True])
def test_normalize_pad_and_preprocess_equal_jax(flip):
    rng = np.random.RandomState(3)
    src = rng.randint(0, 256, (100, 130, 3)).astype(np.uint8)
    np.testing.assert_array_equal(native.normalize_pad(src, (112, 136), MEAN, STD),
                                  jax_native.normalize_pad(src, (112, 136), MEAN, STD))
    np.testing.assert_array_equal(
        native.preprocess(src, (64, 96), (64, 128), MEAN, STD, flip=flip),
        jax_native.preprocess(src, (64, 96), (64, 128), MEAN, STD, flip=flip))


@pytest.mark.parametrize("scale_num", range(1, 9))
def test_decode_at_every_scale_equals_jax(scale_num):
    _require_jpeg()
    rng = np.random.RandomState(scale_num)
    data = _jpeg(rng.randint(0, 256, (257, 385, 3)).astype(np.uint8))
    dims = native.decode_jpeg_dims(data, scale_num)
    assert dims == jax_native.decode_jpeg_dims(data, scale_num)
    assert dims == (-(-257 * scale_num // 8), -(-385 * scale_num // 8))
    out = native.decode_jpeg(data, scale_num=scale_num)
    assert out.shape == (*dims, 3)
    np.testing.assert_array_equal(out, jax_native.decode_jpeg(data, scale_num=scale_num))
    if scale_num == 8:
        np.testing.assert_array_equal(out, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


def test_grayscale_and_non_jpeg_input():
    _require_jpeg()
    rng = np.random.RandomState(4)
    b = io.BytesIO()
    Image.fromarray(rng.randint(0, 256, (64, 80)).astype(np.uint8), "L").save(b, "JPEG")
    gray = b.getvalue()
    out = native.decode_jpeg(gray)
    np.testing.assert_array_equal(out, jax_native.decode_jpeg(gray))
    np.testing.assert_array_equal(out, np.asarray(Image.open(io.BytesIO(gray)).convert("RGB")))
    b = io.BytesIO()
    Image.fromarray(rng.randint(0, 256, (16, 16, 3)).astype(np.uint8)).save(b, "PNG")
    for data in (b.getvalue(), b"not an image"):
        assert native.decode_jpeg(data) is None and jax_native.decode_jpeg(data) is None
        assert native.decode_jpeg_dims(data) is None
        assert native.decode_jpeg_verified(data) is None


def test_bomb_guard_defers_to_pil(monkeypatch):
    _require_jpeg()
    data = _jpeg(np.zeros((40, 50, 3), np.uint8))
    monkeypatch.setattr(Image, "MAX_IMAGE_PIXELS", 40 * 50 - 1)
    for mod in (native, jax_native):
        assert mod.decode_jpeg_dims(data) == (40, 50)  # the header parse is not guarded
        assert mod.decode_jpeg(data) is None
        assert mod.decode_jpeg_verified(data) is None
    monkeypatch.setattr(Image, "MAX_IMAGE_PIXELS", None)  # PIL's "no limit"
    assert native.decode_jpeg(data) is not None


class _OffByOne:
    """The library, with a decode whose first byte is one off PIL's."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def ssg_decode_jpeg(self, buf, n, scale_num, dst, h, w):
        rc = self._lib.ssg_decode_jpeg(buf, n, scale_num, dst, h, w)
        dst[0] = (dst[0] + 1) % 256
        return rc


@pytest.mark.parametrize("mod", [native, jax_native], ids=["port", "jax"])
def test_oracle_gates_a_mismatching_decode(mod, monkeypatch):
    _require_jpeg()
    rng = np.random.RandomState(5)
    arr = rng.randint(0, 256, (40, 56, 3)).astype(np.uint8)
    variants = [_jpeg(arr, subsampling=2), _jpeg(arr, subsampling=0),
                _jpeg(arr, subsampling=2, progressive=True)]
    monkeypatch.setattr(mod, "_trusted_classes", set())
    monkeypatch.setattr(mod, "_decode_disabled", False)
    # Each decode class is checked against PIL once, then trusted.
    for i, v in enumerate(variants):
        out = mod.decode_jpeg_verified(v)
        np.testing.assert_array_equal(out, np.asarray(Image.open(io.BytesIO(v)).convert("RGB")))
        assert len(mod._trusted_classes) == i + 1
    # A decode that differs from PIL in one byte turns the decode off for
    # good, even for the real library afterwards.
    monkeypatch.setattr(mod, "_trusted_classes", set())
    lib = mod._load()
    monkeypatch.setattr(mod, "_load", lambda: _OffByOne(lib))
    assert mod.decode_jpeg_verified(variants[0]) is None
    assert mod._decode_disabled
    monkeypatch.setattr(mod, "_load", lambda: lib)
    assert mod.decode_jpeg_verified(variants[0]) is None


def test_no_native_env_turns_the_data_path_to_pil(tmp_path, monkeypatch):
    rng = np.random.RandomState(6)
    path = str(tmp_path / "a.jpg")
    Image.fromarray(rng.randint(0, 256, (30, 41, 3)).astype(np.uint8)).save(path, quality=85)
    pil = np.asarray(Image.open(path).convert("RGB"))
    assert port_dataset._native_ok()
    assert port_dataset._jpeg_bytes_for_native(path) is not None
    np.testing.assert_array_equal(port_dataset._decode_rgb(path), pil)
    monkeypatch.setenv("SEMSEG_NO_NATIVE", "1")
    assert not port_dataset._native_ok()
    assert port_dataset._jpeg_bytes_for_native(path) is None
    np.testing.assert_array_equal(port_dataset._decode_rgb(path), pil)
