"""The port's ImageFolder input pipeline against tpudist's, on the CPU.

tpudist is the oracle throughout; every comparison is bit for bit (the
same numpy and PIL calls on the same bytes and generators):

- ``ImageFolder``: classes, samples (a nested subdirectory, a PNG, a
  ``.txt`` that is not an image) and the loaded images;
- ``train_transform`` with and without ``ra``, ``ta_wide`` and random
  erasing, ``val_transform``, every auto-augment op, over 8 seeds;
- ``build_train_val_loaders`` on the PIL stack: two epochs of train
  batches (images and labels) at world 1 and at world 2 for both ranks,
  and the val batches (tpudist's val loader built with ``round_up_to=1``,
  the port's one card a rank);
- the retry/skip loader: a sample that fails twice heals (the same
  ``samples_retried``), a truncated JPEG is skipped under a budget of 1
  with the same refilled batch and ``samples_skipped``, and with budget 0
  both loaders raise;
- ``python -m tpudist_torch --device cpu --data DIR`` trains, logs its
  data path and tpudist's ``||==> Data:`` line, and ``tpudist.summarize``
  reads its events.

The native kernels' paths are in ``test_torch_native_data.py``.
"""

import io
import json
import os

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

pytest.importorskip("jax")
from PIL import Image

from tpudist.config import Config as JaxConfig
from tpudist.data import autoaugment as jax_aa
from tpudist.data import native as jax_native
from tpudist.data import pipeline as jax_pipeline
from tpudist.data import transforms as jax_tf
from tpudist.data.imagefolder import ImageFolder as JaxImageFolder
from tpudist.data.loader import DataLoader as JaxLoader

from tpudist_torch import __main__ as cli
from tpudist_torch.config import Config
from tpudist_torch.data import PIL_STACK, build_train_val_loaders
from tpudist_torch.data import autoaugment as port_aa
from tpudist_torch.data import transforms as port_tf
from tpudist_torch.data.imagefolder import ImageFolder
from tpudist_torch.data.loader import DataLoader

pytestmark = pytest.mark.torch_port

SEEDS = range(8)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_tree(root, classes=4, per_class=6, seed=0):
    """A tiny JPEG ImageFolder: ``classes`` × ``per_class`` images of
    48–64 px in train and half as many in val, one of them in a nested
    subdirectory, one a PNG, and a ``.txt`` that is not an image."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", per_class), ("val", per_class // 2)):
        for c in range(classes):
            d = root / split / f"c{c}"
            d.mkdir(parents=True)
            for i in range(n):
                h, w = (int(v) for v in rng.integers(48, 65, size=2))
                arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                img = Image.fromarray(arr)
                if c == 0 and i == 0:
                    img.save(d / f"{i:02d}.png")
                elif c == 1 and i == 0:
                    (d / "nested").mkdir()
                    img.save(d / "nested" / "deep.jpg", quality=90)
                else:
                    img.save(d / f"{i:02d}.jpg", quality=90)
            (d / "notes.txt").write_text("not an image")
    return root


def truncate(path):
    data = path.read_bytes()
    path.write_bytes(data[:len(data) // 2])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("tree"))


def _image(seed, h=56, w=48):
    rng = np.random.default_rng(100 + seed)
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def test_imagefolder_classes_samples_and_images_equal_tpudists(tree):
    for split in ("train", "val"):
        port = ImageFolder(str(tree / split))
        ref = JaxImageFolder(str(tree / split))
        assert port.classes == ref.classes == ["c0", "c1", "c2", "c3"]
        assert port.class_to_idx == ref.class_to_idx
        assert port.samples == ref.samples
        assert not any(p.endswith(".txt") for p, _ in port.samples)
    port = ImageFolder(str(tree / "train"))
    assert any(p.endswith(".png") for p, _ in port.samples)
    assert any("nested" in p for p, _ in port.samples)
    ref = JaxImageFolder(str(tree / "train"))
    for i in (0, 1, len(port) - 1):
        (a, la), (b, lb) = port[i], ref[i]
        assert la == lb and np.array_equal(np.asarray(a), np.asarray(b))
        assert ImageFolder.raw_loader(port.samples[i][0]) == \
            JaxImageFolder.raw_loader(port.samples[i][0])


def test_imagefolder_without_classes_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no class directories"):
        ImageFolder(str(tmp_path))


@pytest.mark.parametrize("aa,erase", [("", 0.0), ("ra", 0.0),
                                      ("ta_wide", 0.0), ("", 0.5),
                                      ("", 1.0), ("ta_wide", 0.25)])
def test_train_transform_equals_tpudists(aa, erase):
    for seed in SEEDS:
        img = _image(seed, 40 + 4 * seed, 64 - 2 * seed)
        got = port_tf.train_transform(img, 32, np.random.default_rng(seed),
                                      aa=port_aa.build(aa),
                                      random_erase=erase)
        want = jax_tf.train_transform(img, 32, np.random.default_rng(seed),
                                      aa=jax_aa.build(aa),
                                      random_erase=erase)
        assert got.dtype == np.float32 and got.shape == (32, 32, 3)
        assert np.array_equal(got, want), (aa, erase, seed)


def test_val_transform_and_normalisation_equal_tpudists():
    assert np.array_equal(port_tf.IMAGENET_MEAN, jax_tf.IMAGENET_MEAN)
    assert np.array_equal(port_tf.IMAGENET_STD, jax_tf.IMAGENET_STD)
    for seed in SEEDS:
        img = _image(seed, 30 + 5 * seed, 70 - 3 * seed)
        assert np.array_equal(port_tf.val_transform(img, 32, 40),
                              jax_tf.val_transform(img, 32, 40))
        gray = img.convert("L")
        assert np.array_equal(port_tf.val_transform(gray, 24, 24),
                              jax_tf.val_transform(gray, 24, 24))


@pytest.mark.parametrize("fallback", [(8, 200), (200, 8), (30, 30)])
def test_random_resized_crop_fallback_equals_tpudists(fallback):
    """A scale range no draw can meet: the clamped center crop."""
    w, h = fallback
    img = _image(0, h, w)
    for seed in SEEDS:
        got = port_tf.random_resized_crop(img, 16, np.random.default_rng(
            seed), scale=(2.0, 3.0))
        want = jax_tf.random_resized_crop(img, 16, np.random.default_rng(
            seed), scale=(2.0, 3.0))
        assert np.array_equal(np.asarray(got), np.asarray(want))


def test_random_erasing_equals_tpudists():
    arr = np.random.default_rng(0).standard_normal((32, 32, 3)).astype(
        np.float32)
    for seed in SEEDS:
        got = port_tf.random_erasing(arr, np.random.default_rng(seed))
        want = jax_tf.random_erasing(arr, np.random.default_rng(seed))
        assert np.array_equal(got, want)
        assert (got == 0).any() and not (arr == 0).any()


@pytest.mark.parametrize("name", list(jax_aa._randaugment_space(32, 32)))
def test_every_augment_op_equals_tpudists(name):
    img = _image(3, 40, 40)
    for space in ("ra", "ta"):
        port = (port_aa._randaugment_space(40, 40) if space == "ra"
                else port_aa._trivial_wide_space(40))
        ref = (jax_aa._randaugment_space(40, 40) if space == "ra"
               else jax_aa._trivial_wide_space(40))
        assert np.array_equal(port[name][0], ref[name][0])
        assert port[name][1] == ref[name][1]
        for b in (0, 9, 30):
            for sign in ((1, -1) if port[name][1] else (1,)):
                mag = sign * float(port[name][0][b])
                assert np.array_equal(
                    np.asarray(port_aa._apply_op(img, name, mag)),
                    np.asarray(jax_aa._apply_op(img, name, mag))), (name, b)


def test_policies_equal_tpudists():
    for seed in SEEDS:
        img = _image(seed, 48, 48)
        for port, ref in ((port_aa.rand_augment, jax_aa.rand_augment),
                          (port_aa.trivial_augment_wide,
                           jax_aa.trivial_augment_wide)):
            a = port(img, np.random.default_rng(seed))
            b = ref(img, np.random.default_rng(seed))
            assert np.array_equal(np.asarray(a), np.asarray(b))
    assert port_aa.build("") is None
    with pytest.raises(ValueError, match="unknown --auto-augment"):
        port_aa.build("autoaugment")


def _configs(tree, **kw):
    kw = dict(data=str(tree), image_size=32, val_resize=40, batch_size=8,
              workers=3, seed=5, **kw)
    return Config(**kw), JaxConfig(**kw)


@pytest.fixture
def tpudist_pil_stack(monkeypatch):
    """tpudist's pipeline on its PIL stack, its val loader rounded up to
    1 (one device a process, as the port's one card a rank)."""
    import jax
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(jax_native, "jpeg_available", lambda: False)
    monkeypatch.setattr(jax, "local_device_count", lambda: 1)


def _jax_loaders(jcfg, monkeypatch, rank, world):
    monkeypatch.setenv("TPUDIST_ELASTIC", "1")
    monkeypatch.setenv("TPUDIST_NUM_PROCESSES", str(world))
    monkeypatch.setenv("TPUDIST_PROCESS_ID", str(rank))
    return jax_pipeline.build_train_val_loaders(jcfg.finalize(1))


def _assert_same_epochs(port, ref, epochs=2):
    n = 0
    for epoch in range(epochs):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port) > 0
        for (a, la), (b, lb) in zip(got, want):
            assert a.dtype == np.float32
            assert np.array_equal(a, b) and np.array_equal(la, lb)
            n += 1
    return n


@pytest.mark.parametrize("world,rank", [(1, 0), (2, 0), (2, 1)])
@pytest.mark.parametrize("aa,erase", [("", 0.0), ("ra", 0.25)])
def test_pil_stack_batches_equal_tpudists(tree, tpudist_pil_stack,
                                          monkeypatch, world, rank, aa,
                                          erase):
    cfg, jcfg = _configs(tree, auto_augment=aa, random_erase=erase)
    train, val = build_train_val_loaders(cfg.finalize(world), rank, world,
                                         use_native=False)
    assert train.data_path[0] == val.data_path[0] == PIL_STACK
    jtrain, jval = _jax_loaders(jcfg, monkeypatch, rank, world)
    assert _assert_same_epochs(train, jtrain) == 2 * 24 // 8
    _assert_same_epochs(val, jval, epochs=1)


def _skip_tree(tmp_path):
    root = make_tree(tmp_path, classes=2, per_class=8, seed=1)
    truncate(root / "train" / "c1" / "03.jpg")
    return root


@pytest.mark.parametrize("budget", [0, 1])
def test_truncated_jpeg_skip_path_equals_tpudists(tmp_path,
                                                  tpudist_pil_stack,
                                                  monkeypatch, budget):
    """PIL refuses the truncated file on every retry: under budget 1 the
    slot is refilled from the next sample of its batch, as in tpudist;
    under budget 0 both loaders raise."""
    root = _skip_tree(tmp_path)
    cfg, jcfg = _configs(root, data_skip_budget=budget,
                         data_retry_backoff=0.0)
    train, _ = build_train_val_loaders(cfg.finalize(1), use_native=False)
    jtrain, _ = _jax_loaders(jcfg, monkeypatch, 0, 1)
    if budget == 0:
        for loader in (train, jtrain):
            with pytest.raises(RuntimeError, match="budget exceeded"):
                list(loader)
        return
    bad = [i for i, (p, _) in enumerate(train.dataset.samples)
           if p.endswith(os.path.join("c1", "03.jpg"))]
    assert _assert_same_epochs(train, jtrain) == 2 * 16 // 8
    assert train.samples_skipped == jtrain.samples_skipped == 1
    assert train.samples_retried == jtrain.samples_retried == 0
    # The corrupt sample's slot holds the next sample of its batch.
    train.set_epoch(0)
    for idx, (images, _) in zip(train._index_batches(), train):
        if bad[0] in idx:
            pos = int(np.flatnonzero(idx == bad[0])[0])
            assert np.array_equal(images[pos], images[(pos + 1) % len(idx)])
            break
    else:
        raise AssertionError("the corrupt sample was in no batch")


class _Flaky:
    """Fails the first ``fails`` loads of each index in ``bad``."""

    def __init__(self, n, bad, fails):
        self.n, self.bad, self.fails = n, set(bad), fails
        self.seen = {}

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.seen[i] = self.seen.get(i, 0) + 1
        if i in self.bad and self.seen[i] <= self.fails:
            raise OSError(f"flaky read of {i}")
        return np.full((4, 4, 3), float(i), np.float32), i % 3


@pytest.mark.parametrize("fails,budget", [(2, 0), (3, 2), (3, 0)])
def test_retry_and_skip_meters_equal_tpudists(fails, budget):
    """Two retries heal a sample that fails twice; one that fails three
    times is skipped (within budget) or raises, in both loaders."""
    out = {}
    for name, cls in (("port", DataLoader), ("jax", JaxLoader)):
        ds = _Flaky(24, bad=(3, 17), fails=fails)
        loader = cls(ds, 8, transform=lambda x, rng: x + rng.random(),
                     num_workers=3, seed=2, retries=2, retry_backoff=0.0,
                     skip_budget=budget)
        try:
            out[name] = ([(a, b) for a, b in loader],
                         loader.samples_skipped, loader.samples_retried)
        except RuntimeError as e:
            out[name] = str(e).split(";")[0]
    if isinstance(out["jax"], str):
        assert out["port"] == out["jax"]
        assert "budget exceeded" in out["port"]
        return
    (pb, ps, pr), (jb, js, jr) = out["port"], out["jax"]
    assert (ps, pr) == (js, jr) == ((0, 2) if fails == 2 else (2, 0))
    for (a, la), (b, lb) in zip(pb, jb):
        assert np.array_equal(a, b) and np.array_equal(la, lb)


class _FlakyAndDead(_Flaky):
    """``_Flaky``, and the indices in ``dead`` never load."""

    def __init__(self, n, bad, fails, dead):
        super().__init__(n, bad, fails)
        self.dead = set(dead)

    def __getitem__(self, i):
        if i in self.dead:
            raise OSError(f"unreadable {i}")
        return super().__getitem__(i)


def test_meters_survive_many_threads():
    """More worker threads than cores and a tiny switch interval: every
    healed load and every skipped sample is counted exactly once."""
    import sys
    import threading
    flaky, dead = set(range(0, 512, 3)), set(range(1, 512, 97))
    loader = DataLoader(_FlakyAndDead(512, flaky, 1, dead), 32,
                        num_workers=4 * (os.cpu_count() or 1), retries=1,
                        retry_backoff=0.0, skip_budget=len(dead))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        done = []
        t = threading.Thread(target=lambda: done.append(list(loader)))
        t.start()
        t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not t.is_alive() and len(done[0]) == 512 // 32
    assert loader.samples_skipped == len(dead)
    assert loader.samples_retried == len(flaky - dead)


def test_train_cli_on_a_jpeg_tree(tmp_path, capsys):
    """The CLI trains from a JPEG tree with one unreadable file: it logs
    the path of each split and, with ``--data-skip-budget 1``, the
    ``||==> Data:`` line; the epoch event carries the meters and
    tpudist's ``summarize`` reads the run."""
    from tpudist import summarize
    from tpudist import telemetry as jax_telemetry
    root = make_tree(tmp_path / "tree")
    (root / "train" / "c2" / "broken.jpg").write_bytes(b"\xff\xd8 no jpeg")
    out = tmp_path / "out"
    rc = cli.main(["--device", "cpu", "--data", str(root), "-a", "resnet18",
                   "--num-classes", "4", "--image-size", "32", "-b", "8",
                   "--epochs", "1", "-j", "2", "--val-resize", "40",
                   "--data-skip-budget", "1", "--data-retry-backoff", "0",
                   "--telemetry", "--outpath", str(out)])
    assert rc in (0, None)
    text = capsys.readouterr().out
    lines = text.splitlines()
    assert any(ln.startswith("=> data path: train ") and "; val " in ln
               for ln in lines), text
    assert "||==> Data: Epoch[0]\tsamples_skipped 1\tsamples_retried 0" \
        in lines, text
    assert lines[-1].startswith("best_acc1=")
    events = [json.loads(ln) for ln in
              (out / "events.0.jsonl").read_text().splitlines()]
    for ev in events:
        jax_telemetry.validate_event(ev)
    epoch = next(e for e in events if e["type"] == "epoch")
    assert (epoch["samples_skipped"], epoch["samples_retried"]) == (1, 0)
    assert [e["type"] for e in events].count("step") == 25 // 8
    assert summarize.main([str(out)]) == 0


def test_data_path_line_names_the_pil_stack_for_augments(tmp_path, capsys):
    root = make_tree(tmp_path / "tree", classes=2, per_class=4)
    rc = cli.main(["--device", "cpu", "--data", str(root), "-a", "resnet18",
                   "--num-classes", "2", "--image-size", "32", "-b", "4",
                   "--epochs", "1", "-j", "2", "--val-resize", "32",
                   "--auto-augment", "ta_wide", "--random-erase", "0.25",
                   "--outpath", str(tmp_path / "out")])
    assert rc in (0, None)
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("=> data path: "))
    assert line.startswith(f"=> data path: train {PIL_STACK} "
                           f"(--auto-augment and --random-erase run on PIL "
                           f"only); val ")


def test_pil_decode_of_png_and_gray_bytes():
    """The raw-bytes transforms decode what is not a JPEG through PIL."""
    from tpudist_torch.data import _pil_decode
    b = io.BytesIO()
    _image(0).convert("L").save(b, format="PNG")
    img = _pil_decode(b.getvalue())
    assert img.mode == "RGB" and img.size == (48, 56)
