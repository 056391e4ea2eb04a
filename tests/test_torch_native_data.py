"""The port's native host kernels (``tpudist_torch/data/csrc``, built by
``tpudist_torch/data/native.py`` with g++) against tpudist's
``native.build()`` of the same sources on this host.

The compiler and flags are the same (``native/Makefile``'s), so every
comparison is bit for bit (tolerance 0):

- ``crop_resize_normalize``, ``val_transform``, ``train_transform`` and
  ``sample_rrc_box`` over 8 seeds and odd boxes;
- ``decode_train_transform`` and ``decode_val_transform`` on JPEG bytes
  (full-size and DCT-scaled decodes, gray and CMYK JPEGs, a truncated
  bitstream), and ``None`` for bytes that are not a JPEG;
- ``build_train_val_loaders`` on the native JPEG path and on native crop
  over PIL decode: two epochs of train batches at world 1 and at world 2
  for both ranks, and the val batches; an unreadable file is skipped as
  tpudist skips it.

And how the libraries are built: a library's name carries a hash of its
sources and flags (editing ``transforms.cc`` renames both builds, editing
``jpeg.cc`` only its own), a failing g++ raises with its output, a host
without g++ takes the PIL stack and one without ``jpeglib.h`` native crop
over PIL decode, each with its reason.
"""

import ctypes
import io
import os
import shutil

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401

pytest.importorskip("jax")
from PIL import Image

from tpudist.config import Config as JaxConfig
from tpudist.data import native as jax_native
from tpudist.data import pipeline as jax_pipeline

from tpudist_torch.config import Config
from tpudist_torch.data import CROP, JPEG, PIL_STACK
from tpudist_torch.data import build_train_val_loaders, choose_paths
from tpudist_torch.data import native
from tpudist_torch.data.imagefolder import ImageFolder

from test_torch_data import make_tree

pytestmark = pytest.mark.torch_port

SEEDS = range(8)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """tpudist's ``native.build()`` (``make`` with ``native/Makefile``) in a
    private copy of ``native/``, so no other test process sees a
    half-written library."""
    copy = tmp_path_factory.mktemp("native")
    for f in ("Makefile", "transforms.cc", "jpeg.cc"):
        shutil.copy(os.path.join(REPO, "native", f), copy / f)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_NATIVE_DIR", str(copy))
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_load_attempted", False)
        mp.delenv("TPUDIST_DISABLE_NATIVE", raising=False)
        assert jax_native.build(), "tpudist's native build failed"
        assert jax_native.jpeg_available()
        yield jax_native


@pytest.fixture(scope="module")
def port_lib():
    assert native.available() and native.jpeg_available()
    return native


def _smooth(h, w, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    r = 127 + 100 * np.sin(x / (5 + seed) + rng.uniform(0, 6)) \
        * np.cos(y / 7)
    return np.stack([r, 255 - r, np.full_like(r, 40 + 10 * seed)],
                    axis=-1).clip(0, 255).astype(np.uint8)


def _jpeg(arr, mode=None, quality=90):
    b = io.BytesIO()
    img = Image.fromarray(arr)
    if mode:
        img = img.convert(mode)
    img.save(b, format="JPEG", quality=quality)
    return b.getvalue()


def test_libraries_build_into_the_ignored_build_dir(port_lib):
    cxx = native.compiler()
    for name in native.LIBRARIES:
        path = native.lib_path(name, cxx)
        assert os.path.exists(path)
        assert os.path.dirname(path) == native.BUILD_DIR
        assert os.path.relpath(path, REPO).startswith("build" + os.sep)
    assert native.jpeg_header().endswith("jpeglib.h")
    for flag in ("-O3", "-march=native", "-ffast-math", "-fPIC",
                 "-std=c++17"):
        assert flag in native.CXX_FLAGS


def test_crop_resize_normalize_equals_tpudists(port_lib, jax_lib):
    src = np.random.default_rng(1).integers(0, 256, (61, 83, 3), np.uint8)
    boxes = [(0, 0, 83, 61), (5, 7, 40, 30), (80, 58, 3, 3), (-4, -2, 20, 9),
             (10, 3, 73, 58)]
    for box in boxes:
        for size, flip in ((32, False), (17, True), (96, True)):
            got = port_lib.crop_resize_normalize(src, box, size, flip)
            want = jax_lib.crop_resize_normalize(src, box, size, flip)
            assert np.array_equal(got, want), (box, size, flip)


def test_val_and_train_transform_equal_tpudists(port_lib, jax_lib):
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        h, w = (int(v) for v in rng.integers(30, 120, size=2))
        src = rng.integers(0, 256, (h, w, 3), np.uint8)
        assert np.array_equal(port_lib.val_transform(src, 24, 28),
                              jax_lib.val_transform(src, 24, 28))
        assert np.array_equal(
            port_lib.train_transform(src, 32, np.random.default_rng(seed)),
            jax_lib.train_transform(src, 32, np.random.default_rng(seed)))
        gray = Image.fromarray(src).convert("L")
        assert np.array_equal(port_lib.val_transform(gray, 16, 20),
                              jax_lib.val_transform(gray, 16, 20))


def test_sample_rrc_box_draws_equal_tpudists():
    for seed in SEEDS:
        for w, h, scale in ((224, 160, (0.08, 1.0)), (10, 300, (0.9, 1.0)),
                            (64, 64, (2.0, 3.0))):
            a, b = np.random.default_rng(seed), np.random.default_rng(seed)
            assert native.sample_rrc_box(w, h, a, scale=scale) == \
                jax_native.sample_rrc_box(w, h, b, scale=scale)
            assert a.random() == b.random()     # the same draws consumed


@pytest.mark.parametrize("h,w,size", [(96, 80, 64), (512, 480, 64),
                                      (300, 200, 32)])
def test_decode_train_transform_equals_tpudists(port_lib, jax_lib, h, w,
                                                size):
    """A crop too small to scale the decode (96 × 80 → 64) and crops that
    decode at 1/2–1/8 (512 × 480 → 64)."""
    for seed in SEEDS:
        data = _jpeg(_smooth(h, w, seed))
        got = port_lib.decode_train_transform(data, size,
                                              np.random.default_rng(seed))
        want = jax_lib.decode_train_transform(data, size,
                                              np.random.default_rng(seed))
        assert got is not None and got.shape == (size, size, 3)
        assert np.array_equal(got, want), seed


@pytest.mark.parametrize("h,w", [(120, 90), (600, 410), (64, 64)])
def test_decode_val_transform_equals_tpudists(port_lib, jax_lib, h, w):
    for seed in SEEDS[:4]:
        data = _jpeg(_smooth(h, w, seed), quality=75 + 5 * seed)
        for size, resize in ((32, 40), (56, 64)):
            got = port_lib.decode_val_transform(data, size, resize)
            want = jax_lib.decode_val_transform(data, size, resize)
            assert got is not None
            assert np.array_equal(got, want), (seed, size)


def test_odd_bytes_decode_as_tpudists(port_lib, jax_lib):
    """Gray JPEGs decode; CMYK ones and bytes that are not a JPEG give
    None (the caller's PIL decode); a truncated bitstream decodes as
    libjpeg pads it, the same bytes in both."""
    arr = _smooth(128, 96)
    png = io.BytesIO()
    Image.fromarray(arr).save(png, format="PNG")
    full = _jpeg(arr)
    cases = {"gray": _jpeg(arr, "L"), "cmyk": _jpeg(arr, "CMYK"),
             "png": png.getvalue(), "garbage": b"\xff\xd8 not a jpeg",
             "half": full[:len(full) // 2], "tail": full[:-10]}
    for name, data in cases.items():
        for _ in range(3):
            got = port_lib.decode_train_transform(
                data, 32, np.random.default_rng(0))
            want = jax_lib.decode_train_transform(
                data, 32, np.random.default_rng(0))
            assert (got is None) == (want is None), name
            assert got is None or np.array_equal(got, want), name
            gv = port_lib.decode_val_transform(data, 32, 40)
            wv = jax_lib.decode_val_transform(data, 32, 40)
            assert (gv is None) == (wv is None), name
            assert gv is None or np.array_equal(gv, wv), name
        if name in ("cmyk", "png", "garbage"):
            assert got is None and gv is None, name


def test_native_input_checks():
    with pytest.raises(ValueError, match="HxWx3"):
        native.crop_resize_normalize(np.zeros((4, 4, 2), np.uint8),
                                     (0, 0, 4, 4), 8, False)
    with pytest.raises(ValueError, match="bad crop box"):
        native.crop_resize_normalize(np.zeros((4, 4, 3), np.uint8),
                                     (0, 0, 0, 4), 8, False)


def _configs(tree, **kw):
    kw = dict(data=str(tree), image_size=32, val_resize=40, batch_size=8,
              workers=3, seed=11, **kw)
    return Config(**kw), JaxConfig(**kw)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("tree"))


@pytest.mark.parametrize("path", [JPEG, CROP])
@pytest.mark.parametrize("world,rank", [(1, 0), (2, 0), (2, 1)])
def test_native_batches_equal_tpudists(tree, jax_lib, port_lib, monkeypatch,
                                       path, world, rank):
    import jax
    monkeypatch.setattr(jax, "local_device_count", lambda: 1)
    if path == CROP:
        monkeypatch.setattr(native, "jpeg_available", lambda: False)
        monkeypatch.setattr(jax_native, "jpeg_available", lambda: False)
    monkeypatch.setenv("TPUDIST_ELASTIC", "1")
    monkeypatch.setenv("TPUDIST_NUM_PROCESSES", str(world))
    monkeypatch.setenv("TPUDIST_PROCESS_ID", str(rank))
    cfg, jcfg = _configs(tree)
    train, val = build_train_val_loaders(cfg.finalize(world), rank, world)
    assert train.data_path[0] == val.data_path[0] == path
    jtrain, jval = jax_pipeline.build_train_val_loaders(jcfg.finalize(1))
    assert (train.dataset.loader is ImageFolder.raw_loader) == (path == JPEG)
    for epoch in range(2):
        train.set_epoch(epoch)
        jtrain.set_epoch(epoch)
        got, want = list(train), list(jtrain)
        assert len(got) == len(want) == 3       # 24 images, 8 a step
        for (a, la), (b, lb) in zip(got, want):
            assert np.array_equal(a, b) and np.array_equal(la, lb)
    for (a, la), (b, lb) in zip(val, jval):
        assert np.array_equal(a, b) and np.array_equal(la, lb)


def test_unreadable_file_is_skipped_as_tpudist_skips_it(tmp_path, jax_lib,
                                                        port_lib,
                                                        monkeypatch):
    """Bytes that are neither a JPEG nor anything PIL reads, on the native
    JPEG path: the same refilled batches and ``samples_skipped`` == 1."""
    import jax
    monkeypatch.setattr(jax, "local_device_count", lambda: 1)
    root = make_tree(tmp_path, classes=2, per_class=8, seed=2)
    (root / "train" / "c0" / "05.jpg").write_bytes(b"\xff\xd8\xff garbage")
    cfg, jcfg = _configs(root, data_skip_budget=1, data_retry_backoff=0.0)
    train, _ = build_train_val_loaders(cfg.finalize(1))
    jtrain, _ = jax_pipeline.build_train_val_loaders(jcfg.finalize(1))
    assert train.data_path[0] == JPEG
    for epoch in range(2):
        train.set_epoch(epoch)
        jtrain.set_epoch(epoch)
        for (a, la), (b, lb) in zip(train, jtrain):
            assert np.array_equal(a, b) and np.array_equal(la, lb)
        assert train.samples_skipped == jtrain.samples_skipped == 1


def test_path_reasons(monkeypatch):
    cfg = Config(data="d", auto_augment="ra")
    assert choose_paths(cfg)["train"] == (
        PIL_STACK, "--auto-augment run on PIL only")
    assert choose_paths(cfg)["val"][0] == JPEG
    monkeypatch.setattr(native, "jpeg_available", lambda: False)
    assert choose_paths(Config(data="d")) == {
        "train": (CROP, "no jpeglib.h on this host"),
        "val": (CROP, "no jpeglib.h on this host")}
    monkeypatch.setattr(native, "available", lambda: False)
    assert choose_paths(Config(data="d"))["train"] == (
        PIL_STACK, "no g++ on this host to build csrc/transforms.cc")
    assert choose_paths(Config(data="d"), use_native=False)["val"][0] == \
        PIL_STACK


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the sources and a build directory of the test's own, with
    nothing loaded yet."""
    copy = tmp_path / "csrc"
    shutil.copytree(native.CSRC_DIR, copy)
    monkeypatch.setattr(native, "CSRC_DIR", str(copy))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_libs", {})
    return copy


def _paths():
    cxx = native.compiler()
    return {name: native.lib_path(name, cxx) for name in native.LIBRARIES}


@pytest.mark.parametrize("fname,renamed", [
    ("transforms.cc", {"transforms", "jpeg"}), ("jpeg.cc", {"jpeg"})])
def test_source_edit_renames_its_builds(csrc, fname, renamed):
    before = _paths()
    src = csrc / fname
    text = src.read_bytes()
    src.write_bytes(text + b"\n// edited\n")
    after = _paths()
    assert {n for n in before if before[n] != after[n]} == renamed
    src.write_bytes(text)
    assert _paths() == before


def test_gxx_failure_raises_with_its_output(csrc):
    (csrc / "transforms.cc").write_text("this is not C++;\n")
    with pytest.raises(RuntimeError, match=r"failed for transforms\.cc") as e:
        native.available()
    assert "error" in str(e.value)
    assert not os.listdir(native.BUILD_DIR)       # no half-written library


def test_build_loads_and_calls_from_a_fresh_directory(csrc):
    assert native.available()
    lib = native.load("transforms")
    assert isinstance(lib, ctypes.CDLL)
    assert os.listdir(native.BUILD_DIR) == [
        os.path.basename(native.lib_path("transforms", native.compiler()))]


def test_host_without_compiler_has_no_native_path(csrc, monkeypatch):
    monkeypatch.setattr(native, "compiler", lambda: None)
    assert not native.available() and not native.jpeg_available()
    assert native.jpeg_header() is None
    with pytest.raises(RuntimeError, match="cannot be built on this host"):
        native.val_transform(np.zeros((8, 8, 3), np.uint8), 4, 4)
