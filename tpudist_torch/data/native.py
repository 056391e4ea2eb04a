"""The host data-path kernels: ctypes bindings over ``csrc/transforms.cc``
and ``csrc/jpeg.cc``, the port's copy of ``tpudist/data/native.py``.

``transforms.cc`` is a fused crop → bilinear resize → flip → normalize
kernel over a decoded uint8 image; ``jpeg.cc`` decodes a JPEG's bytes
straight into it (header-only dimensions, DCT-scaled and scanline-cropped
partial decode). Both are host code: the loader's worker threads call them
with the GIL released (ctypes drops it around every foreign call), so
batch assembly spreads over the host's cores.

Each library is built with ``g++`` at first use (``native/Makefile``'s
flags) into ``build/tpudist_torch/``, named by a hash of its sources, the
flags, the compiler and the host's CPU (``-march=native`` code runs only
where it was built); a library built from other bytes is never reused.
``transforms.cc`` is built on every host with a ``g++``; ``jpeg.cc``
(linked ``-ljpeg``, with ``transforms.cc``) only where ``jpeglib.h`` is
found. A host without ``g++`` has no native path (``available()`` is
False); a ``g++`` that fails raises with its output.

The functions draw the same numbers from the generator, in the same order,
as tpudist's ``native``: the crop box, then the flip. The box's offset is
drawn x first, where ``transforms.random_resized_crop`` draws y first, so
for one generator the native and the PIL train paths crop different
windows of the same distribution, in tpudist as here.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import re
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

from tpudist_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from tpudist_torch.ops._build import BUILD_DIR

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

CXX_FLAGS = ("-O3", "-march=native", "-ffast-math", "-fPIC", "-std=c++17",
             "-shared")
# Each library: its sources under csrc/ and its link flags.
LIBRARIES = {"transforms": (("transforms.cc",), ()),
             "jpeg": (("jpeg.cc", "transforms.cc"), ("-ljpeg",))}

_MEAN = IMAGENET_MEAN.astype(np.float32)
_STD = IMAGENET_STD.astype(np.float32)
_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_IP = ctypes.POINTER(ctypes.c_int)

_lock = threading.Lock()
_libs: dict[str, Optional[ctypes.CDLL]] = {}


def compiler() -> Optional[str]:
    """The C++ compiler (``$CXX``, else ``g++`` on PATH), or None."""
    return shutil.which(os.environ.get("CXX", "g++"))


def jpeg_header() -> Optional[str]:
    """Where the compiler finds ``jpeglib.h``, or None."""
    cxx = compiler()
    if cxx is None:
        return None
    r = subprocess.run([cxx, "-E", "-x", "c++", "-"],
                       input="#include <jpeglib.h>\n", capture_output=True,
                       text=True)
    if r.returncode != 0:
        return None
    m = re.search(r'^# \d+ "([^"]*jpeglib\.h)"', r.stdout, re.M)
    return m.group(1) if m else "jpeglib.h"


def _host_identity(cxx: str) -> bytes:
    """The compiler's version and the CPU's model and feature flags: what
    ``-march=native`` compiles for."""
    ident = subprocess.run([cxx, "--version"], capture_output=True,
                           text=True).stdout.split("\n")[0]
    try:
        with open("/proc/cpuinfo") as f:
            cpu = [ln for ln in f if ln.startswith(("model name", "flags"))]
        ident += "".join(sorted(set(cpu)))
    except OSError:
        pass
    return ident.encode()


def lib_path(name: str, cxx: str) -> str:
    sources, link = LIBRARIES[name]
    digest = hashlib.sha256(" ".join(CXX_FLAGS + link).encode()
                            + b"\0" + _host_identity(cxx))
    for fname in sources:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR,
                        f"libdata_{name}-{digest.hexdigest()[:16]}.so")


def build(name: str, cxx: str) -> str:
    """Compile library ``name`` unless a build of the same bytes exists;
    returns its path. Raises with the compiler's output on a failure."""
    out = lib_path(name, cxx)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    sources, link = LIBRARIES[name]
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp,
                        *(os.path.join(CSRC_DIR, s) for s in sources),
                        *link], capture_output=True, text=True)
    if r.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{os.path.basename(cxx)} failed for "
                           f"{' '.join(sources)} (exit {r.returncode}):\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    if name == "transforms":
        lib.crop_resize_normalize.argtypes = [
            _U8P, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, _F32P, _F32P, _F32P]
        lib.crop_resize_normalize.restype = None
        lib.val_resize_crop_normalize.argtypes = [
            _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _F32P, _F32P, _F32P]
        lib.val_resize_crop_normalize.restype = None
    else:
        lib.jpeg_header_dims.argtypes = [_U8P, ctypes.c_size_t, _IP, _IP]
        lib.jpeg_header_dims.restype = ctypes.c_int
        lib.jpeg_decode_crop_resize_normalize.argtypes = [
            _U8P, ctypes.c_size_t,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, _F32P, _F32P, _F32P]
        lib.jpeg_decode_crop_resize_normalize.restype = ctypes.c_int
        lib.jpeg_decode_val.argtypes = [
            _U8P, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
            _F32P, _F32P, _F32P]
        lib.jpeg_decode_val.restype = ctypes.c_int
    return lib


def load(name: str) -> Optional[ctypes.CDLL]:
    """Library ``name`` ("transforms" or "jpeg"), built on first use; None
    where this host cannot build it (no ``g++``; for "jpeg", no
    ``jpeglib.h``)."""
    with _lock:
        if name not in _libs:
            cxx = compiler()
            if cxx is None or (name == "jpeg" and jpeg_header() is None):
                _libs[name] = None
            else:
                _libs[name] = _bind(ctypes.CDLL(build(name, cxx)), name)
        return _libs[name]


def available() -> bool:
    return load("transforms") is not None


def jpeg_available() -> bool:
    return load("jpeg") is not None


def _lib(name: str) -> ctypes.CDLL:
    lib = load(name)
    if lib is None:
        raise RuntimeError(f"the native {name} library cannot be built on "
                           f"this host (no g++"
                           + (" or no jpeglib.h)" if name == "jpeg" else ")"))
    return lib


def _as_u8_hwc(img) -> np.ndarray:
    arr = np.asarray(img, dtype=np.uint8)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.shape[-1] == 4:
        arr = arr[..., :3]
    if arr.ndim != 3 or arr.shape[-1] != 3 or 0 in arr.shape:
        raise ValueError(f"expected an HxWx3 image, got shape {arr.shape}")
    return np.ascontiguousarray(arr)


def crop_resize_normalize(img, box, out_size: int, flip: bool) -> np.ndarray:
    """Fused crop → resize(out_size) → flip → normalize. ``box`` = (x0, y0,
    w, h) in source pixels (samples outside the image are clamped to its
    edge)."""
    lib = _lib("transforms")
    arr = _as_u8_hwc(img)
    h, w = arr.shape[:2]
    x0, y0, cw, ch = (int(v) for v in box)
    if out_size <= 0 or cw <= 0 or ch <= 0:
        raise ValueError(f"bad crop box {box} or out_size {out_size}")
    out = np.empty((out_size, out_size, 3), np.float32)
    lib.crop_resize_normalize(
        arr.ctypes.data_as(_U8P), h, w, x0, y0, cw, ch,
        out_size, int(flip),
        _MEAN.ctypes.data_as(_F32P), _STD.ctypes.data_as(_F32P),
        out.ctypes.data_as(_F32P))
    return out


def val_transform(img, size: int, resize: int) -> np.ndarray:
    """Fused val stack (Resize(shorter) → CenterCrop → Normalize)."""
    lib = _lib("transforms")
    arr = _as_u8_hwc(img)
    h, w = arr.shape[:2]
    if size <= 0 or resize <= 0:
        raise ValueError(f"bad size {size} or resize {resize}")
    out = np.empty((size, size, 3), np.float32)
    lib.val_resize_crop_normalize(
        arr.ctypes.data_as(_U8P), h, w, resize, size,
        _MEAN.ctypes.data_as(_F32P), _STD.ctypes.data_as(_F32P),
        out.ctypes.data_as(_F32P))
    return out


def sample_rrc_box(src_w: int, src_h: int, rng: np.random.Generator,
                   scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """RandomResizedCrop's box sampling, returned as (x0, y0, w, h); the
    offset is drawn x first (``transforms.random_resized_crop``: y
    first)."""
    area = src_w * src_h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= src_w and 0 < ch <= src_h:
            x0 = int(rng.integers(0, src_w - cw + 1))
            y0 = int(rng.integers(0, src_h - ch + 1))
            return x0, y0, cw, ch
    in_ratio = src_w / src_h
    if in_ratio < ratio[0]:
        cw, ch = src_w, int(round(src_w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = src_h, int(round(src_h * ratio[1]))
    else:
        cw, ch = src_w, src_h
    return (src_w - cw) // 2, (src_h - ch) // 2, cw, ch


def train_transform(img, size: int, rng: np.random.Generator) -> np.ndarray:
    """Fused train stack (RandomResizedCrop → flip → Normalize)."""
    arr = _as_u8_hwc(img)
    h, w = arr.shape[:2]
    box = sample_rrc_box(w, h, rng)
    return crop_resize_normalize(arr, box, size, bool(rng.random() < 0.5))


def decode_train_transform(data, size: int,
                           rng: np.random.Generator) -> Optional[np.ndarray]:
    """The train stack from a JPEG's bytes: header-only dimensions → the
    RandomResizedCrop box at full resolution → partial decode → fused
    crop → resize → flip → normalize. None when the bytes are not a JPEG
    the fast path decodes (the caller decodes them with PIL)."""
    lib = _lib("jpeg")
    buf = np.frombuffer(data, dtype=np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.jpeg_header_dims(buf.ctypes.data_as(_U8P), buf.size,
                            ctypes.byref(h), ctypes.byref(w)):
        return None
    box = sample_rrc_box(w.value, h.value, rng)
    flip = bool(rng.random() < 0.5)
    out = np.empty((size, size, 3), np.float32)
    rc = lib.jpeg_decode_crop_resize_normalize(
        buf.ctypes.data_as(_U8P), buf.size, *(int(v) for v in box),
        size, int(flip),
        _MEAN.ctypes.data_as(_F32P), _STD.ctypes.data_as(_F32P),
        out.ctypes.data_as(_F32P))
    return out if rc == 0 else None


def decode_val_transform(data, size: int,
                         resize: int) -> Optional[np.ndarray]:
    """The val stack from a JPEG's bytes (decode at the largest 1/2^k scale
    covering Resize(shorter=resize), then the fused resize → center crop →
    normalize). None → the caller decodes with PIL."""
    lib = _lib("jpeg")
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty((size, size, 3), np.float32)
    rc = lib.jpeg_decode_val(
        buf.ctypes.data_as(_U8P), buf.size, resize, size,
        _MEAN.ctypes.data_as(_F32P), _STD.ctypes.data_as(_F32P),
        out.ctypes.data_as(_F32P))
    return out if rc == 0 else None
