"""Checkpoints in tpudist's format: save, verify, fall back, restore.

Counterpart of ``tpudist/checkpoint.py`` (the reference's C15,
``utils.py:114-118``, plus the load path it lacked). The file is the one
tpudist writes, byte for byte for the same state: flax's msgpack
(``serialization``, the port's own codec) of

    {"epoch": e + 1, "arch", "best_acc1", "layout_version": 2,
     "state": {"step", "params", "batch_stats", "opt_state",
               "dynamic_scale", "ema_params", "comm_state": None},
     "topology": {...}, "data_cursor": {...}}

with the weights in flax's layout (``compat.jax_params.jax_tree``) and the
optimizer state in optax's tree: SGD's ``inject_hyperparams(chain(
add_decayed_weights, trace, scale_by_learning_rate))`` holds the momentum
as ``inner_state["1"]["trace"]``, AdamW's ``chain(scale_by_adam,
masked(add_decayed_weights), scale_by_learning_rate)`` its moments as
``inner_state["0"]["mu"/"nu"]`` with their ``count``. A float16 run's
``dynamic_scale`` is flax's ``{"fin_steps": int32, "scale": f32}`` (None
otherwise), and the optimizer ``count`` then counts the steps that landed,
as optax's does under tpudist's overflow skip. So a tpudist run continues
on the card and a port run continues, or is served, in tpudist.

Files, as tpudist writes them: ``checkpoint.msgpack`` every epoch (a
pid-unique temporary renamed into place) and its sha256 sidecar after it;
``checkpoint-ep%05d.msgpack`` history copies pruned to the newest
``--keep-checkpoints``, and the ``.corrupt`` quarantine pool with them;
``model_best.msgpack`` on a new best. The fallback walk skips a payload
with no sidecar or stamped ``suspect`` by tpudist's doctor, quarantines
one that fails its sha256 or does not parse, and takes the newest that
passes; a quarantine is a ``fault`` event (point
``checkpoint_quarantine``) on the trainer's stream. An emergency save
(the preemption drain) carries ``data_cursor``, the interrupted epoch's
global sample cursor, which ``restore`` accepts. The
``checkpoint_corrupt`` fault point flips bytes of a save after its
sidecar is written.

The doctor (``--doctor``) stamps verdicts: after a clean SDC probe
``stamp_outpath_verdicts`` marks every unstamped payload ``good``, after
a divergent one ``suspect``, each ``<file>.verdict`` bound to the
payload's sidecar digest; its rollback walks with ``require_verified``
(the verified-good candidates first). Its replay state (``rollbacks``,
``poison_windows``) rides the saves as ``doctor``; ``restore`` leaves it
to the trainer. Not ported: the orbax backend (there is no orbax on the
card).

The writer streams: each leaf is copied to the host when it is written
and hashed on the way to the disk, so a save holds no copy of the
payload beyond one leaf.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import re
import shutil
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from tpudist_torch import faults, serialization
from tpudist_torch import telemetry as telemetry_lib
from tpudist_torch.compat.jax_params import jax_tree, state_dict_from_jax

CKPT_NAME = "checkpoint.msgpack"
BEST_NAME = "model_best.msgpack"
SIDECAR_SUFFIX = ".sha256"
CORRUPT_SUFFIX = ".corrupt"
# tpudist's doctor stamps a probe verdict beside a payload, bound to its
# sha256; the fallback walk skips bytes a probe judged "suspect".
VERDICT_SUFFIX = ".verdict"
VERDICT_GOOD = "good"
VERDICT_SUSPECT = "suspect"
# Parameter-layout revision (tpudist bumped it to 2 for swin's qkv order).
LAYOUT_VERSION = 2
TOPOLOGY_VERSION = 1
_HISTORY_RE = re.compile(r"checkpoint-ep(\d+)\.msgpack$")
_READ_CHUNK = 1 << 24


def _sidecar_path(path: str) -> str:
    return path + SIDECAR_SUFFIX


def _verdict_path(path: str) -> str:
    return path + VERDICT_SUFFIX


def _write_atomic(path: str, payload: bytes | Iterable) -> str:
    """Write ``payload`` (bytes, or an iterable of byte pieces) to a
    pid-unique temporary and rename it over ``path``: no torn file, and
    ranks sharing an outpath never rename each other's half-written file.
    Returns the sha256 of what was written."""
    tmp = f"{path}.tmp.{os.getpid()}"
    h = hashlib.sha256()
    with open(tmp, "wb") as f:
        for piece in ([payload] if isinstance(payload, bytes) else payload):
            f.write(piece)
            h.update(piece)
    os.replace(tmp, path)
    return h.hexdigest()


def _write_sidecar(path: str, digest: str) -> None:
    # sha256sum's line, written after the payload's rename: a crash between
    # the two leaves a payload without a sidecar, never a sidecar that
    # attests bytes that are not there.
    _write_atomic(_sidecar_path(path),
                  f"{digest}  {os.path.basename(path)}\n".encode())


def _sidecar_digest(path: str) -> Optional[str]:
    """The sha256 a payload's sidecar attests; None if missing or empty."""
    try:
        with open(_sidecar_path(path)) as f:
            parts = f.read().split()
    except OSError:
        return None
    return parts[0] if parts else None


def _read_hashed(path: str) -> tuple[bytearray, str]:
    """The file's bytes (a writable buffer the decoded arrays view) and
    their sha256, in one pass."""
    size = os.path.getsize(path)
    buf = bytearray(size)
    view = memoryview(buf)
    h = hashlib.sha256()
    with open(path, "rb", buffering=0) as f:
        pos = 0
        while pos < size:
            n = f.readinto(view[pos:pos + _READ_CHUNK])
            if not n:
                raise OSError(f"{path} shrank while being read")
            h.update(view[pos:pos + n])
            pos += n
    return buf, h.hexdigest()


def verify_checkpoint(path: str) -> bool:
    """True when ``path``'s bytes match its sha256 sidecar. A missing
    sidecar verifies here (an explicit legacy file stays loadable; the
    fallback walk skips such files before asking); an empty one does
    not."""
    if not os.path.exists(_sidecar_path(path)):
        return True
    want = _sidecar_digest(path)
    if want is None:
        return False
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(_READ_CHUNK), b""):
            h.update(chunk)
    return h.hexdigest() == want


def stamp_verdict(path: str, verdict: str, step: int) -> Optional[str]:
    """Stamp a probe verdict (``good`` or ``suspect``) on a payload,
    bound to its current sidecar digest (the live file is rewritten every
    epoch; a verdict never outlives the bytes it judged). No sidecar, no
    stamp. Returns the verdict's path, or None."""
    digest = _sidecar_digest(path)
    if digest is None or not os.path.exists(path):
        return None
    vp = _verdict_path(path)
    _write_atomic(vp, json.dumps(
        {"verdict": verdict, "step": int(step), "payload_sha256": digest,
         "t": time.time()}).encode())
    return vp


def stamp_outpath_verdicts(outpath: str, verdict: str, step: int
                           ) -> list[str]:
    """Stamp every unstamped payload of ``outpath`` (the live file and
    the history copies) with ``verdict``: a clean probe at step t attests
    everything written up to t, a divergent one makes the same set
    suspect. A payload that carries a verdict for its bytes keeps it.
    Returns the stamped paths."""
    stamped = []
    cands = [os.path.join(outpath, CKPT_NAME)]
    cands.extend(_history_checkpoints(outpath))
    for p in cands:
        if not os.path.exists(p) or read_verdict(p) is not None:
            continue
        if stamp_verdict(p, verdict, step):
            stamped.append(p)
    return stamped


def read_verdict(path: str) -> Optional[dict]:
    """The doctor's verdict bound to ``path``'s current bytes, or None
    when absent, torn, or stamped for other bytes."""
    try:
        with open(_verdict_path(path)) as f:
            v = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(v, dict) or v.get("verdict") not in (VERDICT_GOOD,
                                                           VERDICT_SUSPECT):
        return None
    if v.get("payload_sha256") != _sidecar_digest(path):
        return None
    return v


def quarantine_checkpoint(path: str) -> str:
    """Rename a corrupt payload, its sidecar and verdict aside with a
    ``.corrupt[.N]`` suffix (the bytes are evidence; the pool is pruned to
    keep-last-K). Returns the new path."""
    dest = path + CORRUPT_SUFFIX
    n = 0
    while os.path.exists(dest):
        n += 1
        dest = f"{path}{CORRUPT_SUFFIX}.{n}"
    os.replace(path, dest)
    for side in (_sidecar_path, _verdict_path):
        if os.path.exists(side(path)):
            os.replace(side(path), side(dest))
    tel = telemetry_lib.current()
    if tel is not None:
        try:
            tel.emit("fault", point="checkpoint_quarantine",
                     path=os.path.basename(dest))
        except Exception:   # noqa: BLE001 — telemetry must not change this
            pass
    return dest


def save_checkpoint(state_dict: dict, is_best: bool, outpath: str,
                    keep: int = 0) -> str:
    """Write ``checkpoint.msgpack`` and its sidecar; with ``keep`` > 0
    also the ``checkpoint-ep%05d.msgpack`` history copy, pruning history
    and quarantines beyond the newest ``keep``; on ``is_best`` copy to
    ``model_best.msgpack``. The primary rank alone calls it. An armed
    ``checkpoint_corrupt`` point then flips bytes of the live file and
    the history copy. Returns the live file's path."""
    filename = os.path.join(outpath, CKPT_NAME)
    epoch = int(state_dict.get("epoch", 0))
    written = [filename]
    digest = _write_atomic(filename, serialization.iter_msgpack(state_dict))
    _write_sidecar(filename, digest)
    if keep > 0:
        hist = os.path.join(outpath, f"checkpoint-ep{epoch:05d}.msgpack")
        tmp = f"{hist}.tmp.{os.getpid()}"
        shutil.copyfile(filename, tmp)
        os.replace(tmp, hist)
        _write_sidecar(hist, digest)
        written.append(hist)
        _prune_history(outpath, keep)
    if is_best:
        best = os.path.join(outpath, BEST_NAME)
        shutil.copyfile(filename, best)
        _write_sidecar(best, digest)
    faults.maybe_corrupt_checkpoint(written, epoch=epoch)
    return filename


def _history_checkpoints(outpath: str) -> list[str]:
    """History copies, newest epoch first."""
    hits = []
    for p in glob.glob(os.path.join(outpath, "checkpoint-ep*.msgpack")):
        m = _HISTORY_RE.search(p)
        if m:
            hits.append((int(m.group(1)), p))
    return [p for _, p in sorted(hits, reverse=True)]


def _quarantined_checkpoints(outpath: str) -> list[str]:
    """Quarantined payloads (not their sidecars), newest mtime first."""
    hits = []
    for p in glob.glob(os.path.join(outpath, f"*{CORRUPT_SUFFIX}*")):
        if p.endswith(SIDECAR_SUFFIX) or p.endswith(VERDICT_SUFFIX):
            continue
        try:
            hits.append((os.path.getmtime(p), p))
        except OSError:
            continue
    return [p for _, p in sorted(hits, reverse=True)]


def _remove_with_sides(path: str) -> None:
    for p in (path, _sidecar_path(path), _verdict_path(path)):
        try:
            os.remove(p)
        except FileNotFoundError:
            pass


def _prune_quarantines(outpath: str, keep: int) -> None:
    for p in _quarantined_checkpoints(outpath)[keep:]:
        _remove_with_sides(p)


def _prune_history(outpath: str, keep: int) -> None:
    for p in _history_checkpoints(outpath)[keep:]:
        _remove_with_sides(p)
    _prune_quarantines(outpath, keep)


def load_checkpoint(path: str) -> dict:
    """The raw tree (numpy leaves) of a file, or of a run dir's live
    file. An explicit path is never substituted: a sidecar mismatch or a
    file that does not parse raises, naming the path."""
    if os.path.isdir(path):
        path = os.path.join(path, CKPT_NAME)
    buf, digest = _read_hashed(path)
    want = _sidecar_digest(path)
    if os.path.exists(_sidecar_path(path)) and digest != want:
        raise ValueError(f"checkpoint {path} fails sha256 sidecar "
                         f"verification (torn write or storage corruption)")
    try:
        return serialization.msgpack_restore(buf)
    except (ValueError, TypeError, KeyError) as e:
        raise ValueError(f"checkpoint {path} is not a readable msgpack "
                         f"checkpoint: {e}") from e


def load_checkpoint_with_fallback(
        outpath: str, log: Optional[Callable[[str], None]] = None,
        keep: Optional[int] = None,
        require_verified: bool = False) -> tuple[dict, str]:
    """The newest valid checkpoint of a run dir: the live file, then the
    history newest first. A candidate without a sidecar, or stamped
    ``suspect``, is skipped; one that fails its sha256 or does not parse
    is quarantined and the walk goes on. ``keep`` bounds the quarantine
    pool first (to at least one). ``require_verified`` (the doctor's
    rollback) walks the candidates stamped ``good`` first, and the rest
    only when none of those loads (logged). Raises ``FileNotFoundError``
    when no candidate is left. Returns ``(tree, path)``."""
    emit = log or (lambda m: None)
    if keep is not None:
        _prune_quarantines(outpath, max(1, keep))
    live = os.path.join(outpath, CKPT_NAME)
    candidates = ([live] if os.path.exists(live) else []) \
        + _history_checkpoints(outpath)
    if require_verified:
        verified = [c for c in candidates
                    if (read_verdict(c) or {}).get("verdict") == VERDICT_GOOD]
        got = _walk(verified, emit)
        if got is not None:
            emit(f"=> rollback target: {got[1]} (probe-verified good)")
            return got
        emit("=> no probe-verified-good checkpoint available — falling "
             "back to the newest merely-intact candidate")
    got = _walk(candidates, emit)
    if got is not None:
        return got
    raise FileNotFoundError(
        f"no valid checkpoint in {outpath}: every candidate failed "
        f"integrity verification (quarantined as *{CORRUPT_SUFFIX}) or was "
        f"unverifiable/suspect")


def _walk(candidates: list, emit) -> Optional[tuple[dict, str]]:
    """The first of ``candidates`` that verifies and parses, as
    ``(tree, path)``, quarantining the ones that fail; None if none."""
    for cand in candidates:
        want = _sidecar_digest(cand)
        if not os.path.exists(_sidecar_path(cand)):
            emit(f"=> checkpoint {cand} has no sha256 sidecar (torn save: "
                 f"crash between payload rename and sidecar write?) — "
                 f"unverifiable, skipping")
            continue
        verdict = read_verdict(cand)
        if verdict is not None and verdict["verdict"] != VERDICT_GOOD:
            emit(f"=> checkpoint {cand} stamped '{verdict['verdict']}' by a "
                 f"doctor probe (step {verdict.get('step')}) — skipping")
            continue
        try:
            buf, digest = _read_hashed(cand)
        except OSError:
            continue                  # another rank quarantined it first
        if digest != want:
            try:
                q = quarantine_checkpoint(cand)
            except OSError:
                continue
            emit(f"=> checkpoint {cand} fails sha256 verification — "
                 f"quarantined to {q}, falling back to the next newest")
            continue
        try:
            return serialization.msgpack_restore(buf), cand
        except (ValueError, TypeError, KeyError) as e:
            try:
                q = quarantine_checkpoint(cand)
            except OSError:
                continue
            emit(f"=> checkpoint {cand} unreadable ({e}) — quarantined to "
                 f"{q}, falling back to the next newest")
    return None


def find_resumable(outpath: str) -> Optional[str]:
    """``--resume auto``'s target: the live file when the run dir holds it
    or any history copy (the walk falls back to those), else None."""
    live = os.path.join(outpath, CKPT_NAME)
    if os.path.exists(live) or _history_checkpoints(outpath):
        return live
    return None


# -- the state tree ----------------------------------------------------------------

def topology_tag(world: int, per_device_batch: int,
                 global_batch: int) -> dict:
    """tpudist's ``elastic.reshard.topology_tag`` of a data-parallel run:
    one card a rank, no ZeRO."""
    return {"version": TOPOLOGY_VERSION, "world": int(world),
            "mesh_shape": [int(world)], "mesh_axes": ["data"],
            "n_devices": int(world), "per_device_batch": int(per_device_batch),
            "global_batch": int(global_batch), "zero": "off", "zero1": False,
            "zero1_axis": ""}


def _float_buffers(model: torch.nn.Module) -> list:
    return [(n, b) for n, b in model.named_buffers() if b.is_floating_point()]


def _variables(model: torch.nn.Module) -> dict:
    """``{"params", "batch_stats"}`` in flax's layout (views)."""
    return {"params": jax_tree(model.named_parameters()),
            "batch_stats": jax_tree(_float_buffers(model))}


def _is_sgd(optimizer) -> bool:
    return isinstance(optimizer, torch.optim.SGD)


def _opt_state(model: torch.nn.Module, optimizer, step: int) -> dict:
    # ``step``: the optimizer updates that landed (optax's count).
    """The optimizer's state as optax's ``InjectHyperparamsState`` tree
    (``tpudist/train.py``'s ``sgd_torch`` and ``adamw_torch``)."""
    named = list(model.named_parameters())
    state = optimizer.state
    if _is_sgd(optimizer):
        # No buffer yet (step 0) is optax's zero trace: both make the next
        # step's buffer the gradient.
        trace = [(n, state[p]["momentum_buffer"]
                  if state.get(p, {}).get("momentum_buffer") is not None
                  else torch.zeros_like(p)) for n, p in named]
        inner = {"0": {}, "1": {"trace": jax_tree(trace)}, "2": {}}
    else:
        steps = {float(state[p]["step"]) for _, p in named
                 if "step" in state.get(p, {})}
        if len(steps) > 1:
            raise ValueError(f"AdamW parameters are at different steps "
                             f"{sorted(steps)}; optax keeps one count")

        def moment(key):
            return jax_tree([(n, state[p][key] if key in state.get(p, {})
                              else torch.zeros_like(p)) for n, p in named])
        inner = {"0": {"count": np.asarray(int(steps.pop()) if steps else 0,
                                           np.int32),
                       "mu": moment("exp_avg"), "nu": moment("exp_avg_sq")},
                 "1": {"inner_state": {}}, "2": {}}
    lr = float(optimizer.param_groups[0]["lr"])
    return {"count": np.asarray(step, np.int32),
            "hyperparams": {"learning_rate": np.asarray(lr, np.float32)},
            "hyperparams_states": {}, "inner_state": inner}


def state_to_dict(model: torch.nn.Module, optimizer, *, arch: str,
                  epoch: int, best_acc1: float, step: int,
                  ema: Optional[torch.nn.Module] = None,
                  topology: Optional[dict] = None,
                  data_cursor: Optional[dict] = None,
                  scaler=None, opt_steps: Optional[int] = None,
                  doctor: Optional[dict] = None) -> dict:
    """tpudist's ``state_to_dict`` of the equivalent ``TrainState``:
    ``epoch + 1`` is where a resume starts. ``data_cursor`` (emergency
    saves only) is the interrupted epoch's ``{"epoch", "consumed",
    "samples_skipped", "samples_retried"}``. ``scaler`` (a float16 run's
    ``DynamicScale``) is written as ``dynamic_scale``; ``opt_steps`` is
    the optimizer updates that landed (``step`` less the steps a float16
    run or the doctor skipped; ``step`` when None). ``doctor`` is the
    doctor's replay state (``{"rollbacks", "poison_windows"}``). Leaves are views of the model's and
    optimizer's tensors; ``save_checkpoint`` copies each to the host as
    it writes it."""
    variables = _variables(model)
    landed = step if opt_steps is None else opt_steps
    out = {"epoch": int(epoch) + 1, "arch": arch,
           "best_acc1": float(best_acc1), "layout_version": LAYOUT_VERSION,
           "state": {"step": np.asarray(step, np.int32),
                     "params": variables["params"],
                     "batch_stats": variables["batch_stats"],
                     "opt_state": _opt_state(model, optimizer, landed),
                     "dynamic_scale": (None if scaler is None
                                       else scaler.state_dict()),
                     "ema_params": (_variables(ema) if ema is not None
                                    else None),
                     "comm_state": None}}
    if topology is not None:
        out["topology"] = dict(topology)
    if data_cursor is not None:
        out["data_cursor"] = dict(data_cursor)
    if doctor is not None:
        out["doctor"] = dict(doctor)
    return out


def _optimizer_mismatch(detail: str) -> ValueError:
    # tpudist's text (restore_train_state) for the same mistake.
    return ValueError(
        "checkpoint optimizer state does not match the trainer's optimizer "
        "— was this checkpoint written with a different --optimizer (sgd vs "
        "adamw)? Pass the same --optimizer used for training. Underlying "
        f"error: {detail}")


def _per_param(arch: str, tree, model: torch.nn.Module, what: str) -> dict:
    """A params-shaped optimizer tree as ``{parameter: tensor}``, checked
    name for name and shape for shape."""
    got = state_dict_from_jax(arch, tree)
    params = dict(model.named_parameters())
    if set(got) != set(params):
        raise ValueError(
            f"checkpoint {what} does not match the model's parameters: "
            f"missing {sorted(set(params) - set(got))[:5]}, unexpected "
            f"{sorted(set(got) - set(params))[:5]}")
    for n, t in got.items():
        if t.shape != params[n].shape:
            raise ValueError(f"checkpoint {what} {n} has shape "
                             f"{tuple(t.shape)}; the model's is "
                             f"{tuple(params[n].shape)}")
    return {params[n]: t for n, t in got.items()}


def _like(p: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    # The parameter's strides: a 1x1 conv's buffers stay channels_last,
    # as the ones the optimizer makes from its gradients.
    return torch.empty_like(p).copy_(src)


def _restore_optimizer(arch: str, opt: dict, model: torch.nn.Module,
                       optimizer) -> None:
    inner = opt.get("inner_state") if isinstance(opt, dict) else None
    inner = inner if isinstance(inner, dict) else {}
    sgd_saved = isinstance(inner.get("1"), dict) and "trace" in inner["1"]
    adam_saved = isinstance(inner.get("0"), dict) and "mu" in inner["0"]
    if _is_sgd(optimizer) != sgd_saved or _is_sgd(optimizer) == adam_saved:
        have = "sgd" if sgd_saved else "adamw" if adam_saved else "unknown"
        want = "sgd" if _is_sgd(optimizer) else "adamw"
        raise _optimizer_mismatch(f"the checkpoint holds {have} state, the "
                                  f"trainer runs {want}")
    optimizer.state.clear()
    if sgd_saved:
        for p, t in _per_param(arch, inner["1"]["trace"], model,
                               "momentum trace").items():
            if torch.any(t):
                optimizer.state[p] = {"momentum_buffer": _like(p, t)}
        return
    adam = inner["0"]
    count = int(np.asarray(adam["count"]))
    if count == 0:
        return
    mu = _per_param(arch, adam["mu"], model, "AdamW mu")
    nu = _per_param(arch, adam["nu"], model, "AdamW nu")
    for group in optimizer.param_groups:
        on_device = group.get("capturable") or group.get("fused")
        for p in group["params"]:
            # torch keeps step a host f32 scalar unless capturable or
            # fused (then on the parameter's device).
            step = torch.tensor(float(count), dtype=torch.float32,
                                device=p.device if on_device else "cpu")
            optimizer.state[p] = {"step": step, "exp_avg": _like(p, mu[p]),
                                  "exp_avg_sq": _like(p, nu[p])}


def optimizer_count(ckpt: dict) -> int:
    """The optimizer updates that landed, optax's ``count`` in the
    checkpoint's ``opt_state`` (its ``step`` where the tree has none)."""
    state = ckpt.get("state") or {}
    opt = state.get("opt_state")
    if isinstance(opt, dict) and "count" in opt:
        return int(np.asarray(opt["count"]))
    return int(np.asarray(state.get("step", 0)))


def restore(ckpt: dict, model: torch.nn.Module, optimizer=None,
            ema: Optional[torch.nn.Module] = None, *, arch: str,
            world: int = 1,
            log: Optional[Callable[[str], None]] = None,
            scaler=None, train: bool = True) -> int:
    """Load a checkpoint tree onto the port's model, optimizer, EMA module
    and float16 loss scale (``scaler``), with tpudist's rules
    (``restore_train_state``): a different arch and a different optimizer
    are refused by name; a mid-epoch ``data_cursor`` and the doctor's
    replay state (``doctor``) are the caller's to apply (``Trainer``,
    which applies the windows before the cursor); a different
    world is allowed (every leaf is a full host array); an EMA copy is
    dropped when ``ema`` is None and seeded at the restored weights when
    the checkpoint has none; ``comm_state`` is dropped. The loss scale
    crosses dtypes as it does in tpudist: a float16 run restores the
    file's ``fin_steps`` and ``scale`` exactly, and refuses a file with no
    ``dynamic_scale`` (flax's ``from_state_dict`` raises on it); a run
    that does not scale its loss refuses a float16 file when it trains
    (tpudist restores the scale as a plain dict and its train step fails
    on it) and drops the scale under ``--evaluate`` (``train`` False).
    Returns the optimizer-step count."""
    emit = log or (lambda m: None)
    saved_arch = ckpt.get("arch")
    if saved_arch != arch:
        raise ValueError(f"checkpoint was trained as '{saved_arch}' but this "
                         f"run is '{arch}' — refusing to load mismatched "
                         f"weights")
    state = ckpt.get("state")
    if not isinstance(state, dict) or state.get("params") is None:
        raise ValueError("checkpoint has no state.params — not a tpudist "
                         "training checkpoint")
    saved_ds = state.get("dynamic_scale")
    if scaler is not None and saved_ds is None:
        raise ValueError("checkpoint has no dynamic_scale (it was written by "
                         "a run without float16 loss scaling), and this "
                         "--amp-dtype float16 run needs one: tpudist's "
                         "restore fails on it too; resume with the dtype "
                         "the checkpoint was trained in")
    if scaler is None and saved_ds is not None:
        if train:
            raise ValueError(
                "checkpoint carries a dynamic_scale (float16 loss scaling, "
                "--amp-dtype float16), and this run does not scale its "
                "loss: tpudist's train step fails on it too; resume with "
                "--use_amp --amp-dtype float16")
        emit("=> checkpoint carries a float16 dynamic_scale; an eval-only "
             "run drops it")
    if scaler is not None:
        scaler.load_state_dict(saved_ds)
    topo = ckpt.get("topology") or {}
    if topo.get("world") is not None and int(topo["world"]) != int(world):
        emit(f"=> cross-topology restore: world {topo['world']} -> {world} "
             f"(every leaf is a full host array: nothing to re-cut)")
    model.load_state_dict(state_dict_from_jax(
        arch, state["params"], state.get("batch_stats")), strict=True)
    if optimizer is not None:
        _restore_optimizer(arch, state.get("opt_state"), model, optimizer)
    saved_ema = state.get("ema_params")
    if ema is None:
        if saved_ema is not None:
            emit("=> checkpoint carries an EMA copy; --model-ema-decay is "
                 "off, so it is dropped")
    elif saved_ema is None:
        ema.load_state_dict(model.state_dict())
        emit("=> checkpoint has no EMA copy; the EMA starts at the restored "
             "weights")
    else:
        if "params" not in saved_ema:
            # tpudist's params-only EMA: the statistics half from the live
            # running statistics.
            saved_ema = {"params": saved_ema}
        ema.load_state_dict(state_dict_from_jax(
            arch, saved_ema["params"],
            saved_ema.get("batch_stats") or state.get("batch_stats")),
            strict=True)
    if state.get("comm_state") is not None:
        emit("=> checkpoint carries a gradient-compression residual "
             "(comm_state); the port has no --compress-grads, so it is "
             "dropped")
    return int(np.asarray(state.get("step", 0)))

