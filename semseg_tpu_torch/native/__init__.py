"""ctypes bindings for the native host-preprocessing library
(``semseg_tpu/native``; ``preprocess.cpp`` is a verbatim copy of its source).

The library reimplements Pillow's fixed-point bilinear and nearest
resampling (a horizontal flip fused in), the fused resize + normalise + pad,
and a libjpeg decode, full-size or at a reduced DCT-domain scale
(``scale_num``/8). Host code, not a device kernel: the data layer calls it
from its loader threads, and every call releases the GIL.

Build, at first use (nothing is built at import time):

    g++ -O3 -march=native -shared -fPIC preprocess.cpp -o <lib> -DSSG_HAVE_JPEG=1 -ljpeg

then, if that fails (no ``jpeglib.h`` or ``libjpeg``), the same without the
last two arguments: every entry point but the decode still builds, and the
decode reports no libjpeg. The library goes to
``build/semseg_tpu_torch_native/<CPU fingerprint>-<source hash>/`` of the
checkout (``-march=native`` ties it to the host's CPU,
``utils.host.host_fingerprint``) and is reused from there. The command and
its outcome go to the ``Logger`` log; ``build_info()`` returns them.

``SEMSEG_NO_NATIVE`` set turns the data layer's native path off
(``data.dataset._native_ok``); every function has a PIL fallback there, and
``available()`` / ``jpeg_available()`` report what was built.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

from semseg_tpu_torch.utils.host import host_fingerprint

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "preprocess.cpp")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                          "semseg_tpu_torch_native")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
JPEG_FLAGS = ("-DSSG_HAVE_JPEG=1", "-ljpeg")

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
_load_lock = threading.Lock()
_build_info: dict = {}


def library_path() -> str:
    """Where this host's library for this source lives."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS + JPEG_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_ROOT, f"{host_fingerprint()}-{digest[:12]}", "libssgnative.so")


def _build(so: str) -> bool:
    """Compile ``so``, with libjpeg if the host has it; logs each attempt."""
    log = logging.getLogger("Logger")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    # Compile to a unique temporary name and rename: two processes that
    # both miss the library must not write into one file.
    fd, tmp = tempfile.mkstemp(prefix="libssgnative.", suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    base = ["g++", *FLAGS, _SRC, "-o", tmp]
    try:
        for cmd, jpeg in ((base + list(JPEG_FLAGS), True), (base, False)):
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:  # no g++
                rc, err = None, str(e)
            else:
                rc, err = proc.returncode, proc.stderr
            shown = " ".join(cmd).replace(tmp, so)
            if rc == 0:
                with open(so + ".log", "w") as f:
                    f.write(shown + "\n")
                os.replace(tmp, so)
                log.info(f"native: built {so} ({'with' if jpeg else 'WITHOUT'} libjpeg): {shown}")
                _build_info.update(command=shown, built=True)
                return True
            log.warning(f"native: build failed ({rc}): {shown}\n{err.strip()[-2000:]}")
        _build_info.update(command=" ".join(base).replace(tmp, so), built=False)
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    with _load_lock:
        if _lib is not None or _load_attempted:
            return _lib
        # A failure is remembered too: available() runs once per batch per
        # loader worker, which must not pay a fresh g++ run each time.
        _lib = _load_locked()
        _load_attempted = True
        return _lib


def _load_locked() -> Optional[ctypes.CDLL]:
    so = library_path()
    _build_info.update(library=so)
    if not os.path.exists(so):
        if not _build(so):
            return None
    elif os.path.exists(so + ".log"):  # the command that built it
        with open(so + ".log") as f:
            _build_info.update(command=f.readline().strip(), built=False)
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        logging.getLogger("Logger").warning(f"native: cannot load {so}: {e}")
        return None

    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i = ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    sz = ctypes.c_size_t
    lib.ssg_resize_bilinear_u8.argtypes = [u8p, i, i, i, u8p, i, i, i]
    lib.ssg_resize_nearest_u8.argtypes = [u8p, i, i, i, u8p, i, i, i]
    lib.ssg_normalize_pad.argtypes = [u8p, i, i, f32p, i, i, f32p, f32p]
    lib.ssg_preprocess.argtypes = [u8p, i, i, i, i, i, i, f32p, f32p, f32p, i]
    lib.ssg_jpeg_dims.argtypes = [u8p, sz, i, ip, ip]
    lib.ssg_jpeg_dims.restype = i
    lib.ssg_decode_jpeg.argtypes = [u8p, sz, i, u8p, i, i]
    lib.ssg_decode_jpeg.restype = i
    lib.ssg_jpeg_class.argtypes = [u8p, sz]
    lib.ssg_jpeg_class.restype = i
    lib.ssg_jpeg_meta.argtypes = [u8p, sz, i, ip, ip]
    lib.ssg_jpeg_meta.restype = i
    lib.ssg_has_jpeg.restype = i
    _build_info.update(jpeg=bool(lib.ssg_has_jpeg()))
    return lib


def available() -> bool:
    return _load() is not None


def build_info() -> dict:
    """What the first use found or built: ``library`` (its path),
    ``command`` (the g++ command that built it, None if unknown), ``built``
    (whether this process compiled it) and ``jpeg`` (libjpeg in it)."""
    _load()
    return dict(_build_info)


def _u8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _resize_u8(fn_name: str, src: np.ndarray, size, flip: bool) -> np.ndarray:
    lib = _load()
    th, tw = size
    squeeze = src.ndim == 2
    if squeeze:
        src = src[:, :, None]
    src = np.ascontiguousarray(src, np.uint8)
    sh, sw, ch = src.shape
    dst = np.empty((th, tw, ch), np.uint8)
    getattr(lib, fn_name)(_u8(src), sh, sw, ch, _u8(dst), th, tw, int(flip))
    return dst[:, :, 0] if squeeze else dst


def resize_bilinear_u8(src: np.ndarray, size, *, flip: bool = False) -> np.ndarray:
    """Pillow-parity bilinear resize of (H, W[, C]) uint8 to (th, tw).

    ``flip=True`` resizes the horizontally mirrored source (bit-identical
    to ``FLIP_LEFT_RIGHT`` + resize) without materialising the flipped
    copy: the mirror happens inside the horizontal resampling pass.
    """
    return _resize_u8("ssg_resize_bilinear_u8", src, size, flip)


def resize_nearest_u8(src: np.ndarray, size, *, flip: bool = False) -> np.ndarray:
    """Pillow-parity nearest resize of (H, W[, C]) uint8, flip fused."""
    return _resize_u8("ssg_resize_nearest_u8", src, size, flip)


def normalize_pad(src: np.ndarray, padded_size, mean, std) -> np.ndarray:
    """uint8 (h, w, 3) → f32 (ph, pw, 3): ``(x / 255 - mean) / std``, zero pad."""
    lib = _load()
    src = np.ascontiguousarray(src, np.uint8)
    h, w, _ = src.shape
    ph, pw = padded_size
    dst = np.empty((ph, pw, 3), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    lib.ssg_normalize_pad(_u8(src), h, w, _f32(dst), ph, pw, _f32(mean), _f32(std))
    return dst


def preprocess(src: np.ndarray, target_size, padded_size, mean, std,
               *, flip: bool = False) -> np.ndarray:
    """Fused resize + normalize + pad: uint8 (H, W, 3) -> f32 (ph, pw, 3)."""
    lib = _load()
    src = np.ascontiguousarray(src, np.uint8)
    sh, sw, _ = src.shape
    th, tw = target_size
    ph, pw = padded_size
    dst = np.empty((ph, pw, 3), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    lib.ssg_preprocess(_u8(src), sh, sw, th, tw, ph, pw, _f32(mean), _f32(std), _f32(dst),
                       int(flip))
    return dst


def jpeg_available() -> bool:
    lib = _load()
    return bool(lib is not None and lib.ssg_has_jpeg())


def decode_jpeg_dims(data: bytes, scale_num: int = 8):
    """(H, W) the decoder would produce for ``scale_num``/8, or None.

    A header parse only: it picks the smallest covering DCT-domain scale
    before committing to a decode.
    """
    lib = _load()
    if lib is None or not lib.ssg_has_jpeg():
        return None
    buf = np.frombuffer(data, np.uint8)
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.ssg_jpeg_dims(_u8(buf), buf.size, scale_num, ctypes.byref(h), ctypes.byref(w)):
        return None
    return h.value, w.value


def _bomb_guard_ok(h: int, w: int) -> bool:
    """False for an image Pillow would refuse as a decompression bomb; the
    caller then returns None, which defers it to PIL.

    The native decode allocates ``(h, w, 3)`` from the header's claimed
    dimensions before a pixel is read: a tiny crafted stream declaring
    65500x65500 would allocate ~12.8 GB. Past ``Image.MAX_IMAGE_PIXELS``
    (and a user's override of it) PIL's own policy applies.
    """
    try:
        from PIL import Image

        max_px = Image.MAX_IMAGE_PIXELS
    except Exception:
        max_px = 89478485  # Pillow's default limit
    return max_px is None or h * w <= max_px


def decode_jpeg(data: bytes, scale_num: int = 8) -> Optional[np.ndarray]:
    """libjpeg decode of a JPEG byte stream to RGB uint8 (H, W, 3).

    ``scale_num``/8 is the decoder's DCT-domain output scale (8 = full
    resolution; the output is ``ceil(dim * scale_num / 8)`` per axis, the
    engine of Pillow's ``Image.draft``). None on any decode problem
    (corrupt stream, exotic colour space, no libjpeg in the build): the
    caller falls back to PIL.
    """
    lib = _load()
    if lib is None or not lib.ssg_has_jpeg():
        return None
    buf = np.frombuffer(data, np.uint8)
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.ssg_jpeg_dims(_u8(buf), buf.size, scale_num, ctypes.byref(h), ctypes.byref(w)):
        return None
    if not _bomb_guard_ok(h.value, w.value):
        return None
    dst = np.empty((h.value, w.value, 3), np.uint8)
    if lib.ssg_decode_jpeg(_u8(buf), buf.size, scale_num, _u8(dst), h.value, w.value):
        return None
    return dst


_decode_disabled = False
_trusted_classes: set = set()


def decode_jpeg_verified(data: bytes) -> Optional[np.ndarray]:
    """Full-resolution ``decode_jpeg`` behind a per-decode-class oracle.

    JPEG decoding is not bit-exact by the standard, and Pillow bundles its
    own libjpeg-turbo, which may differ from the system library linked
    here, per decode path (e.g. SIMD chroma upsampling runs only for 4:2:0
    sources). So the first stream of each decode class (``ssg_jpeg_class``:
    progressive flag x colour space x per-component sampling) is decoded by
    both libraries and compared: bit-equal, and that class is trusted for
    the rest of the process; any mismatch, and the native decode is off for
    the rest of the process (None: the caller decodes with PIL).
    """
    global _decode_disabled
    if _decode_disabled:
        return None
    lib = _load()
    if lib is None or not lib.ssg_has_jpeg():
        return None
    buf = np.frombuffer(data, np.uint8)
    # One header parse for the class and the full-resolution dims, then
    # the decode's own.
    h = ctypes.c_int()
    w = ctypes.c_int()
    cls = lib.ssg_jpeg_meta(_u8(buf), buf.size, 8, ctypes.byref(h), ctypes.byref(w))
    if cls < 0:
        return None
    if not _bomb_guard_ok(h.value, w.value):
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.ssg_decode_jpeg(_u8(buf), buf.size, 8, _u8(out), h.value, w.value):
        return None
    if cls not in _trusted_classes:
        import io

        from PIL import Image

        ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        if ref.shape != out.shape or not np.array_equal(ref, out):
            _decode_disabled = True
            logging.getLogger("Logger").warning(
                "native: libjpeg's decode differs from PIL's; decoding with PIL "
                "for the rest of this process")
            return None
        _trusted_classes.add(cls)
    return out
