"""The port's checkpoints against tpudist's, on the CPU.

- Bytes: for tpudist's ``state_to_dict`` of a tiny resnet18 (SGD) and a
  tiny ViT (AdamW + EMA), a scalar zoo and flax's chunked leaves
  (``MAX_CHUNK_SIZE`` patched small on both sides), the port's
  ``msgpack_serialize`` gives ``flax.serialization.msgpack_serialize``'s
  bytes, and the port reads flax's bytes back to equal values and dtypes.
  The port's own ``state_to_dict`` of the same fresh state is tpudist's
  file byte for byte (the same sha256 sidecar).
- Files: the sidecar, keep-K history, quarantine, fallback walk and the
  doctor's ``suspect`` skip behave as ``tests/test_checkpoint.py`` holds
  tpudist's to, and tpudist's reader takes a port-written outpath.
- Across packages: one side trains 2 steps and saves, the other resumes
  and takes 3 more while the first continues; the resumed state is the
  saved one exactly, and after the 3 steps the two agree to the 5-step
  bounds of ``tests/test_torch_train.py`` (loss within 1e-4, every leaf
  within 1e-3 of its largest update or 1e-6), with the AdamW exception of
  ``tests/test_torch_vit_train.py`` for the entries on the kink at a zero
  gradient. Both directions, for resnet18 with SGD and the ViT with AdamW,
  each with the EMA.
- The CLI: 3 epochs straight through are bit-equal to 2 epochs and a
  ``--resume auto`` for the third; an empty outpath starts fresh and says
  so; a corrupt live file falls back to the history and is quarantined;
  another arch, another optimizer, a ``dynamic_scale`` and a mid-epoch
  ``data_cursor`` counted over the doctor's excised order (its replay
  windows) are refused by name.
- The slow tier runs the launcher's restart: rank 0 of two gloo ranks dies
  after the first epoch's save, the relaunch resumes, and the final file
  equals an uninterrupted run's.
"""

import contextlib
import functools
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from flax import serialization as flax_ser  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from tpudist import checkpoint as jax_ckpt  # noqa: E402
from tpudist import config as jax_config  # noqa: E402
from tpudist import train as jax_train  # noqa: E402
from tpudist.models import create_model as jax_create  # noqa: E402
from tpudist.models.vit import VisionTransformer as JaxViT  # noqa: E402
from tpudist.ops import norm_dispatch  # noqa: E402
from tpudist_torch import __main__ as cli  # noqa: E402
from tpudist_torch import checkpoint as ckpt  # noqa: E402
from tpudist_torch import config as port_config  # noqa: E402
from tpudist_torch import serialization as ser  # noqa: E402
from tpudist_torch import train as port_train  # noqa: E402
from tpudist_torch.compat.jax_params import state_dict_from_jax  # noqa: E402
from tpudist_torch.models import create_model  # noqa: E402
from tpudist_torch.models.vit import VisionTransformer  # noqa: E402

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESNET_TINY = dict(num_classes=10, width=16)
VIT_TINY = dict(patch_size=8, hidden_dim=64, num_layers=2, num_heads=4,
                mlp_dim=128, num_classes=10)
KINDS = {
    "resnet18_sgd": dict(arch="resnet18", batch_size=16, lr=0.005,
                         model_ema_decay=0.9),
    "vit_adamw": dict(arch="vit_b_16", batch_size=8, optimizer="adamw",
                      lr=1e-3, weight_decay=0.05, flash="on",
                      model_ema_decay=0.9),
}
K_STEPS, M_STEPS = 2, 3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tiny shapes gain nothing from more threads, and the suite runs
    several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _drop_run_dirs(tmp_path):
    """A full-width resnet18 checkpoint with its EMA is 134 MB, and the
    CLI cases keep history copies: free the disk as each test ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(autouse=True)
def _plain_jax_epilogue():
    norm_dispatch.set_mode("off")
    yield
    norm_dispatch.set_mode(None)


def _fields(kind):
    return dict(num_classes=10, image_size=32, seed=0, use_amp=False,
                **KINDS[kind])


def _batches(kind, k):
    b = KINDS[kind]["batch_size"]
    rng = np.random.default_rng(0)
    return [(rng.standard_normal((b, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, b).astype(np.int32)) for _ in range(k)]


@functools.lru_cache(maxsize=None)
def _jax_side(kind):
    """tpudist's config, initial host state and jitted step (it donates
    the state)."""
    jcfg = jax_config.Config(**_fields(kind))
    jm = (jax_create("resnet18", **RESNET_TINY) if kind == "resnet18_sgd"
          else JaxViT(**VIT_TINY, flash=True))
    state = jax_train.create_train_state(jax.random.PRNGKey(0), jm, jcfg,
                                         input_shape=(1, 32, 32, 3))
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    return jcfg, jax.device_get(state), jax_train.make_train_step(
        mesh, jm, jcfg)


def _jax_steps(kind, state, batches, lr):
    _, _, jstep = _jax_side(kind)
    state = jax.tree_util.tree_map(jnp.asarray, state)
    losses = []
    for x, y in batches:
        state, met = jstep(state, jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(lr, jnp.float32))
        losses.append(float(met["loss"]))
    return jax.device_get(state), losses


def _port_side(kind):
    """The port's model, optimizer, EMA and train step for ``kind``."""
    pcfg = port_config.Config(**_fields(kind))
    if kind == "resnet18_sgd":
        def build():
            return create_model("resnet18", fused_bn=True, **RESNET_TINY)
    else:
        def build():
            return VisionTransformer(*VIT_TINY.values(), image_size=32,
                                     flash=True)
    pm = build()
    pm.reset_parameters(torch.Generator().manual_seed(1))
    opt = port_train.make_optimizer(pm, pcfg)
    ema = port_train.make_ema(pm, build)
    return pcfg, pm, opt, ema, port_train.make_train_step(pm, opt, pcfg,
                                                          ema=ema)


def _port_steps(step, batches, lr):
    return [float(step(torch.from_numpy(x), torch.from_numpy(y), lr)["loss"])
            for x, y in batches]


def _jax_state_dict(kind, state, epoch=0):
    jcfg = _jax_side(kind)[0]
    return jax_ckpt.state_to_dict(state, jcfg.arch, epoch, 12.5,
                                  topology=ckpt.topology_tag(
                                      1, jcfg.batch_size, jcfg.batch_size))


def _zoo():
    return {"nil": None, "yes": True, "no": False,
            "ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32, 2**64 - 1,
                     -1, -32, -33, -128, -129, -32769, -2**31 - 1, -2**63],
            "float": -2.5, "str": "é" * 40, "long": "x" * 300, "empty": {},
            "f32": np.float32(0.1), "f64": np.float64(1.0 / 3.0),
            "i64": np.int64(-7), "flag": np.bool_(True),
            "i32_0d": np.asarray(17, np.int32),
            "bf16": jnp.arange(12, dtype=jnp.bfloat16).reshape(3, 4) / 7,
            "many": {f"k{i}": i for i in range(20)},
            "list": [1, "two", None, [3.0], {"b": 1, "a": 2}],
            "u8": np.arange(300, dtype=np.uint8), "empty_arr": np.zeros((0, 3))}


def _tree(case):
    if case == "zoo":
        return _zoo()
    if case == "chunked":
        rng = np.random.default_rng(3)
        return {"w": rng.standard_normal((5, 9)).astype(np.float32),
                "small": np.arange(4, dtype=np.int32),
                "bf16": jnp.asarray(rng.standard_normal(40), jnp.bfloat16),
                "in_list": [np.arange(30, dtype=np.float32)]}
    jcfg, host, _ = _jax_side(case)
    return _jax_state_dict(case, host)


def _to_port_leaves(tree):
    """The tree as the port is handed it: numpy leaves (a jax bf16 array
    through numpy keeps its dtype name)."""
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)


CASES = ["resnet18_sgd", "vit_adamw", "zoo", "chunked"]


@pytest.fixture
def small_chunks(request, monkeypatch):
    if request.node.callspec.params["case"] == "chunked":
        monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 32)
        monkeypatch.setattr(ser, "MAX_CHUNK_SIZE", 32)


@pytest.mark.parametrize("case", CASES)
def test_writer_bytes_equal_flax(case, small_chunks):
    tree = _tree(case)
    want = flax_ser.msgpack_serialize(tree)
    got = ser.msgpack_serialize(_to_port_leaves(tree))
    assert got == want
    if case == "chunked":
        assert ser.CHUNKED.encode() in got


def _assert_same(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)) and str(want.dtype) == \
            "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        assert np.array_equal(got.view(torch.int16).numpy(),
                              np.asarray(want).view(np.int16)), path
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("case", CASES)
def test_reader_restores_flax_bytes(case, small_chunks):
    data = flax_ser.msgpack_serialize(_tree(case))
    want = flax_ser.msgpack_restore(data)
    _assert_same(ser.msgpack_restore(data), want)
    _assert_same(ser.msgpack_restore(bytearray(data)), want)


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_state_tree_is_tpudists_file(kind, tmp_path):
    """A port model holding tpudist's fresh state writes tpudist's file."""
    jcfg, host, _ = _jax_side(kind)
    _, pm, opt, ema, _ = _port_side(kind)
    pm.load_state_dict(state_dict_from_jax(jcfg.arch, host.params,
                                           host.batch_stats))
    ema.load_state_dict(pm.state_dict())
    mine = ckpt.state_to_dict(pm, opt, arch=jcfg.arch, epoch=0,
                              best_acc1=12.5, step=0, ema=ema,
                              topology=ckpt.topology_tag(1, jcfg.batch_size,
                                                         jcfg.batch_size))
    os.makedirs(tmp_path / "jax")
    os.makedirs(tmp_path / "port")
    jax_ckpt.save_checkpoint(_jax_state_dict(kind, host), False,
                             str(tmp_path / "jax"))
    ckpt.save_checkpoint(mine, False, str(tmp_path / "port"))
    a, b = (open(tmp_path / d / ckpt.CKPT_NAME, "rb").read()
            for d in ("jax", "port"))
    assert a == b
    assert (open(tmp_path / "jax" / "checkpoint.msgpack.sha256").read()
            == open(tmp_path / "port" / "checkpoint.msgpack.sha256").read())


# -- files ---------------------------------------------------------------------

def _tiny_state_dict(seed, epoch):
    rng = np.random.default_rng(seed)
    return {"epoch": epoch, "arch": "tiny", "best_acc1": 0.0,
            "state": {"w": rng.standard_normal((4, 4)).astype(np.float32),
                      "step": np.int32(epoch * 10)}}


def _flip_bytes(path):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        chunk = f.read(32)
        f.seek(size // 2)
        f.write(bytes(b ^ 0xFF for b in chunk))


def test_sidecar_written_and_verifies_on_both_sides(tmp_path):
    ckpt.save_checkpoint(_tiny_state_dict(0, 1), False, str(tmp_path))
    live = str(tmp_path / ckpt.CKPT_NAME)
    want = hashlib.sha256(open(live, "rb").read()).hexdigest()
    assert open(live + ".sha256").read() == f"{want}  checkpoint.msgpack\n"
    assert ckpt.verify_checkpoint(live) and jax_ckpt.verify_checkpoint(live)
    assert not any(".tmp" in f for f in os.listdir(tmp_path))
    _flip_bytes(live)
    assert not ckpt.verify_checkpoint(live)
    with pytest.raises(ValueError, match=f"checkpoint {live} fails sha256"):
        ckpt.load_checkpoint(live)


def test_legacy_checkpoint_without_sidecar_still_loads(tmp_path):
    ckpt.save_checkpoint(_tiny_state_dict(0, 3), False, str(tmp_path))
    os.remove(tmp_path / (ckpt.CKPT_NAME + ".sha256"))
    assert ckpt.verify_checkpoint(str(tmp_path / ckpt.CKPT_NAME))
    assert ckpt.load_checkpoint(str(tmp_path))["epoch"] == 3


def test_keep_last_k_prunes_history_with_sidecars(tmp_path):
    for ep in range(1, 6):
        ckpt.save_checkpoint(_tiny_state_dict(ep, ep), ep == 2,
                             str(tmp_path), keep=3)
    names = sorted(os.listdir(tmp_path))
    assert [f for f in names if f.startswith("checkpoint-ep")] == [
        f"checkpoint-ep{e:05d}.msgpack{s}" for e in (3, 4, 5)
        for s in ("", ".sha256")]
    best = ckpt.load_checkpoint(str(tmp_path / ckpt.BEST_NAME))
    assert best["epoch"] == 2 and ckpt.verify_checkpoint(
        str(tmp_path / ckpt.BEST_NAME))


def test_corrupt_fallback_newest_valid_wins_and_quarantines(tmp_path):
    for ep in (1, 2, 3):
        ckpt.save_checkpoint(_tiny_state_dict(ep, ep), False, str(tmp_path),
                             keep=3)
    _flip_bytes(str(tmp_path / ckpt.CKPT_NAME))
    _flip_bytes(str(tmp_path / "checkpoint-ep00003.msgpack"))
    msgs = []
    before = set(os.listdir(tmp_path))
    tree, path = ckpt.load_checkpoint_with_fallback(str(tmp_path),
                                                    log=msgs.append)
    assert path.endswith("checkpoint-ep00002.msgpack") and tree["epoch"] == 2
    assert len(msgs) == 2 and all("quarantined" in m for m in msgs)
    after = set(os.listdir(tmp_path))
    assert {"checkpoint.msgpack.corrupt",
            "checkpoint-ep00003.msgpack.corrupt"} <= after
    assert len(after) == len(before)
    assert ckpt.load_checkpoint_with_fallback(str(tmp_path))[1] == path


def test_truncated_sidecar_and_unparsable_payload_are_quarantined(tmp_path):
    for ep in (1, 2, 3):
        ckpt.save_checkpoint(_tiny_state_dict(ep, ep), False, str(tmp_path),
                             keep=3)
    open(tmp_path / (ckpt.CKPT_NAME + ".sha256"), "w").close()
    # Bytes its sidecar attests that are not msgpack.
    bad = str(tmp_path / "checkpoint-ep00003.msgpack")
    with open(bad, "wb") as f:
        f.write(b"\xc1 not msgpack")
    ckpt._write_sidecar(bad, hashlib.sha256(b"\xc1 not msgpack").hexdigest())
    msgs = []
    tree, path = ckpt.load_checkpoint_with_fallback(str(tmp_path),
                                                    log=msgs.append)
    assert path.endswith("checkpoint-ep00002.msgpack") and tree["epoch"] == 2
    assert "unreadable" in msgs[1]
    assert (tmp_path / "checkpoint.msgpack.corrupt").exists()
    assert (tmp_path / "checkpoint-ep00003.msgpack.corrupt").exists()


def test_fallback_raises_when_everything_corrupt(tmp_path):
    ckpt.save_checkpoint(_tiny_state_dict(1, 1), False, str(tmp_path), keep=2)
    _flip_bytes(str(tmp_path / ckpt.CKPT_NAME))
    _flip_bytes(str(tmp_path / "checkpoint-ep00001.msgpack"))
    with pytest.raises(FileNotFoundError, match="no valid checkpoint"):
        ckpt.load_checkpoint_with_fallback(str(tmp_path))
    assert (tmp_path / "checkpoint.msgpack.corrupt").exists()
    assert (tmp_path / "checkpoint-ep00001.msgpack.corrupt").exists()


def test_unattested_and_suspect_candidates_are_skipped(tmp_path):
    """No sidecar (a crash between payload and sidecar) or a doctor
    probe's ``suspect`` verdict for these bytes: skipped, not quarantined."""
    for ep in (1, 2, 3):
        ckpt.save_checkpoint(_tiny_state_dict(ep, ep), False, str(tmp_path),
                             keep=3)
    os.remove(tmp_path / (ckpt.CKPT_NAME + ".sha256"))
    jax_ckpt.stamp_verdict(str(tmp_path / "checkpoint-ep00003.msgpack"),
                           jax_ckpt.VERDICT_SUSPECT, step=30)
    msgs = []
    tree, path = ckpt.load_checkpoint_with_fallback(str(tmp_path),
                                                    log=msgs.append)
    assert path.endswith("checkpoint-ep00002.msgpack") and tree["epoch"] == 2
    assert "no sha256 sidecar" in msgs[0] and "stamped 'suspect'" in msgs[1]
    assert not any(".corrupt" in f for f in os.listdir(tmp_path))
    assert ckpt.read_verdict(str(tmp_path / "checkpoint-ep00003.msgpack"))[
        "verdict"] == "suspect"


def test_quarantine_pool_bounded_to_keep_k(tmp_path):
    import time
    for ep in (1, 2):
        ckpt.save_checkpoint(_tiny_state_dict(ep, ep), False, str(tmp_path),
                             keep=2)
    for n in range(5):
        ckpt.save_checkpoint(_tiny_state_dict(n, 3), False, str(tmp_path))
        q = ckpt.quarantine_checkpoint(str(tmp_path / ckpt.CKPT_NAME))
        assert os.path.exists(q) and os.path.exists(q + ".sha256")
        time.sleep(0.02)

    def corrupt():
        return sorted(f for f in os.listdir(tmp_path)
                      if ".corrupt" in f and not f.endswith(".sha256"))
    assert len(corrupt()) == 5
    newest = sorted(corrupt(), key=lambda f: os.path.getmtime(
        tmp_path / f))[-2:]
    ckpt.save_checkpoint(_tiny_state_dict(9, 4), False, str(tmp_path), keep=2)
    assert corrupt() == sorted(newest)
    ckpt.save_checkpoint(_tiny_state_dict(9, 4), False, str(tmp_path), keep=0)
    assert len(corrupt()) == 2
    ckpt.load_checkpoint_with_fallback(str(tmp_path), keep=0)
    assert corrupt() == [newest[-1]]


def test_tpudist_reads_a_port_outpath(tmp_path):
    for ep in (1, 2):
        ckpt.save_checkpoint(_tiny_state_dict(ep, ep), False, str(tmp_path),
                             keep=2)
    _flip_bytes(str(tmp_path / ckpt.CKPT_NAME))
    assert not jax_ckpt.verify_checkpoint(str(tmp_path / ckpt.CKPT_NAME))
    tree, path = jax_ckpt.load_checkpoint_with_fallback(str(tmp_path))
    assert path.endswith("checkpoint-ep00002.msgpack")
    np.testing.assert_array_equal(tree["state"]["w"],
                                  _tiny_state_dict(2, 2)["state"]["w"])


def test_explicit_path_is_never_substituted(tmp_path):
    ckpt.save_checkpoint(_tiny_state_dict(1, 1), False, str(tmp_path), keep=2)
    with pytest.raises(FileNotFoundError, match="nope.msgpack"):
        ckpt.load_checkpoint(str(tmp_path / "nope.msgpack"))
    with open(tmp_path / "junk.msgpack", "wb") as f:
        f.write(b"\x92\x01")
    with pytest.raises(ValueError, match="junk.msgpack"):
        ckpt.load_checkpoint(str(tmp_path / "junk.msgpack"))


# -- across packages --------------------------------------------------------------

def _kink(kind):
    if kind != "vit_adamw":
        return {}
    from test_torch_vit_train import _adamw_kink
    return _adamw_kink()


def _held(got, want, init, kink, what):
    """Every entry within 1e-3 of its leaf's largest update (or 1e-6);
    entries on AdamW's kink within the leaf's largest update."""
    assert set(got) == set(want), what
    for k in want:
        g, w, i = (t[k].float() for t in (got, want, init))
        held = ~kink.get(k, torch.zeros_like(w, dtype=torch.bool))
        update = float((w - i).abs().max())
        err = float((g - w)[held].abs().max()) if held.any() else 0.0
        assert err <= max(1e-3 * update, 1e-6), (what, k, err, update)
        step = (g - i)[~held].abs()
        assert torch.all(step <= update), (what, k, float(step.max()), update)


def _port_named(arch, tree):
    return state_dict_from_jax(arch, tree.params, tree.batch_stats)


def _ema_named(arch, ema):
    return state_dict_from_jax(arch, ema["params"], ema["batch_stats"])


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("writer", ["tpudist", "port"])
def test_resume_across_packages_continues_within_the_5_step_bounds(
        kind, writer, tmp_path):
    jcfg, host0, _ = _jax_side(kind)
    arch = jcfg.arch
    batches = _batches(kind, K_STEPS + M_STEPS)
    lr = port_train.lr_for_epoch(port_config.Config(**_fields(kind)), 0)
    pcfg, pm, opt, ema, pstep = _port_side(kind)
    if writer == "tpudist":
        # tpudist trains K steps and saves; the port resumes, tpudist goes on.
        state_k, _ = _jax_steps(kind, host0, batches[:K_STEPS], lr)
        jax_ckpt.save_checkpoint(_jax_state_dict(kind, state_k), False,
                                 str(tmp_path))
        tree = ckpt.load_checkpoint(str(tmp_path))
        step = ckpt.restore(tree, pm, opt, ema, arch=arch)
        assert step == K_STEPS
        saved = _port_named(arch, state_k)
        for name, t in pm.state_dict().items():
            assert torch.equal(t, saved[name]), name
        saved_ema = _ema_named(arch, state_k.ema_params)
        for name, t in ema.state_dict().items():
            assert torch.equal(t, saved_ema[name]), name
        got_losses = _port_steps(pstep, batches[K_STEPS:], lr)
        final_j, want_losses = _jax_steps(kind, state_k, batches[K_STEPS:],
                                          lr)
        got = {"model": pm.state_dict(), "ema": ema.state_dict()}
    else:
        # The port trains K steps from tpudist's init and saves; tpudist
        # resumes onto its own template, the port goes on.
        pm.load_state_dict(_port_named(arch, host0))
        ema.load_state_dict(pm.state_dict())
        _port_steps(pstep, batches[:K_STEPS], lr)
        ckpt.save_checkpoint(ckpt.state_to_dict(
            pm, opt, arch=arch, epoch=0, best_acc1=12.5, step=K_STEPS,
            ema=ema, topology=ckpt.topology_tag(1, 8, 8)), False,
            str(tmp_path))
        template = jax_train.create_train_state(
            jax.random.PRNGKey(7), (jax_create("resnet18", **RESNET_TINY)
                                    if kind == "resnet18_sgd"
                                    else JaxViT(**VIT_TINY, flash=True)),
            jcfg, input_shape=(1, 32, 32, 3))
        restored = jax_ckpt.restore_train_state(
            template, jax_ckpt.load_checkpoint(str(tmp_path)),
            target_topology=ckpt.topology_tag(1, 8, 8))
        restored = jax.device_get(restored)
        assert int(restored.step) == K_STEPS
        assert jax.tree_util.tree_structure(restored) == \
            jax.tree_util.tree_structure(host0)
        for name, t in _port_named(arch, restored).items():
            assert torch.equal(t, pm.state_dict()[name]), name
        final_j, want_losses = _jax_steps(kind, restored, batches[K_STEPS:],
                                          lr)
        got_losses = _port_steps(pstep, batches[K_STEPS:], lr)
        got = {"model": pm.state_dict(), "ema": ema.state_dict()}
    for i, (g, w) in enumerate(zip(got_losses, want_losses)):
        assert abs(g - w) <= 1e-4, (i, g, w)
    kink = _kink(kind)
    _held(got["model"], _port_named(arch, final_j), _port_named(arch, host0),
          kink, "model")
    _held(got["ema"], _ema_named(arch, final_j.ema_params),
          _ema_named(arch, host0.ema_params), kink, "ema")
    if kind == "resnet18_sgd":
        # The momentum, read back from the next checkpoint.
        mom = {n: opt.state[p]["momentum_buffer"]
               for n, p in pm.named_parameters()}
        trace = state_dict_from_jax(
            arch, final_j.opt_state.inner_state[1].trace)
        zero = {n: torch.zeros_like(t) for n, t in trace.items()}
        _held(mom, trace, zero, {}, "momentum")


# -- the CLI --------------------------------------------------------------------

CLI = ["--device", "cpu", "--synthetic", "-a", "resnet18", "--num-classes",
       "8", "--image-size", "32", "-b", "16", "--step", "1", "-p", "4",
       "--synthetic-size", "32", "--seed", "0", "--model-ema-decay", "0.5",
       "--telemetry"]


def _cli(*args, out):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(CLI + list(args) + ["--outpath", str(out)]) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def two_epoch_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli") / "two"
    yield out, _cli("--epochs", "2", out=out)
    shutil.rmtree(out.parent, ignore_errors=True)


def _events(out):
    with open(os.path.join(out, "events.0.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def test_cli_resume_auto_is_bit_equal_to_straight_through(two_epoch_run,
                                                          tmp_path):
    straight = tmp_path / "straight"
    _cli("--epochs", "3", out=straight)
    resumed = tmp_path / "resumed"
    shutil.copytree(two_epoch_run[0], resumed)
    text = _cli("--epochs", "3", "--resume", "auto", "--overwrite", "keep",
                out=resumed)
    assert f"=> resumed from '{resumed}/checkpoint.msgpack' (epoch 2, " \
        f"best_acc1 " in text
    assert "Epoch[1]:" not in text and "Epoch[2]:\t[0/2]" in text
    a, b = (open(d / ckpt.CKPT_NAME, "rb").read() for d in (straight,
                                                             resumed))
    assert a == b
    tree = ser.msgpack_restore(a)
    assert tree["epoch"] == 3 and int(tree["state"]["step"]) == 6
    assert tree["state"]["ema_params"] is not None
    events = _events(resumed)
    runs = [i for i, e in enumerate(events) if e["type"] == "run_start"]
    second = events[runs[1]:]
    restore = [e for e in second if e["type"] == "checkpoint_restore"]
    saves = [e for e in second if e["type"] == "checkpoint_save"]
    assert len(restore) == 1 and restore[0]["epoch"] == 2
    assert [e["epoch"] for e in saves] == [2] and saves[0]["kind"] == "epoch"
    end = second[-1]
    assert end["type"] == "run_end" and end["checkpoint_s"] > 0
    assert end["checkpoint_s"] >= round(
        restore[0]["seconds"] + saves[0]["seconds"], 3) - 2e-3


def test_cli_resume_auto_in_an_empty_outpath_starts_fresh(tmp_path):
    text = _cli("--epochs", "1", "--resume", "auto", out=tmp_path / "fresh")
    assert "=> --resume auto: no checkpoint in outpath, starting fresh" in \
        text.splitlines()
    assert ckpt.load_checkpoint(str(tmp_path / "fresh"))["epoch"] == 1
    # The same outpath again in this process: its log reaches this stdout.
    text = _cli("--epochs", "2", "--resume", "auto", "--overwrite", "keep",
                out=tmp_path / "fresh")
    assert "=> resumed from '" in text and "(epoch 1, best_acc1" in text


def test_cli_corrupt_live_file_falls_back_to_history(two_epoch_run,
                                                     tmp_path):
    run = tmp_path / "run"
    shutil.copytree(two_epoch_run[0], run)
    _flip_bytes(str(run / ckpt.CKPT_NAME))
    text = _cli("--epochs", "3", "--resume", "auto", "--overwrite", "keep",
                out=run)
    assert "fails sha256 verification — quarantined to" in text
    assert f"=> resumed from '{run}/checkpoint-ep00002.msgpack' (epoch 2" \
        in text
    assert (run / "checkpoint.msgpack.corrupt").exists()
    assert ckpt.load_checkpoint(str(run))["epoch"] == 3


def _edited(src, dst, edit):
    tree = ckpt.load_checkpoint(str(src))
    edit(tree)
    os.makedirs(dst)
    ckpt.save_checkpoint(tree, False, str(dst))
    return str(dst / ckpt.CKPT_NAME)


@pytest.mark.parametrize("what", ["arch", "optimizer", "dynamic_scale",
                                  "no_dynamic_scale"])
def test_cli_refuses_a_mismatched_checkpoint_by_name(two_epoch_run, tmp_path,
                                                     what):
    src = two_epoch_run[0]
    flags, named = {
        "arch": (["-a", "resnet34"], "trained as 'resnet18' but this run is "
                                     "'resnet34'"),
        "optimizer": (["--optimizer", "adamw"], "different --optimizer"),
        "dynamic_scale": ([], "carries a dynamic_scale (float16 loss "
                              "scaling, --amp-dtype float16), and this run "
                              "does not scale its loss"),
        "no_dynamic_scale": (["--use_amp", "--amp-dtype", "float16"],
                             "checkpoint has no dynamic_scale (it was "
                             "written by a run without float16 loss "
                             "scaling)"),
    }[what]
    path = str(src / ckpt.CKPT_NAME)
    if what == "dynamic_scale":
        # A float16 run's scale in a file this (f32) run resumes: tpudist
        # restores it as a dict its step then fails on.
        path = _edited(src, tmp_path / "ds", lambda t: t["state"].update(
            dynamic_scale={"fin_steps": np.asarray(3, np.int32),
                           "scale": np.asarray(2.0**15, np.float32)}))
    with pytest.raises(ValueError, match="cannot resume from") as e:
        cli.main(CLI + flags + ["--epochs", "3", "--resume", path,
                                "--outpath", str(tmp_path / "o")])
    assert named in str(e.value) and path in str(e.value)


# -- the launcher's restart (slow) ----------------------------------------------

@pytest.mark.slow
def test_launcher_restart_resumes_and_ends_where_a_straight_run_ends(
        tmp_path):
    import chip_smoke
    wrapper = tmp_path / "crash_after_epoch_1.py"
    wrapper.write_text(chip_smoke.CRASH_WRAPPER)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    args = ["--distributed"] + CLI + ["--epochs", "3"]

    def launch(out, cmd, extra=(), resume=()):
        return subprocess.run(
            [sys.executable, "-m", "tpudist_torch.launch", "-n", "2", *extra,
             "--", sys.executable, *cmd, *args, *resume, "--outpath",
             str(out)], cwd=REPO, env=env, capture_output=True, text=True,
            timeout=300)

    straight = launch(tmp_path / "straight", ["-m", "tpudist_torch"])
    assert straight.returncode == 0, straight.stderr[-3000:]
    r = launch(tmp_path / "crashed", [str(wrapper)], ("--max-restarts", "1"),
               ("--resume", "auto", "--overwrite", "keep"))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "restart 1/1" in r.stderr
    crash = json.loads(next(ln for ln in r.stdout.splitlines()
                            if ln.startswith("CRASH ")).split(" ", 1)[1])
    assert crash["step"] == 2
    assert "=> resumed from '" in r.stdout and "(epoch 1, best_acc1" in \
        r.stdout
    a, b = (open(tmp_path / d / ckpt.CKPT_NAME, "rb").read()
            for d in ("straight", "crashed"))
    assert a == b
    events = _events(tmp_path / "crashed")
    assert {e["attempt"] for e in events} == {0, 1}
