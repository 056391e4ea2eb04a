"""Deterministic fault injection: the port's copy of ``tpudist/faults.py``.

Injections are armed by a spec string (``--inject`` on the trainer or the
launcher, or the ``TPUDIST_INJECT`` env var the launcher gives every
rank), a ``;``-joined list of items in tpudist's grammar::

    name[:k=v[,k=v...]][@gate[@gate...]]

with the gates ``step=N``, ``rank=N`` (``TPUDIST_PROCESS_ID``),
``attempt=N`` (``TPUDIST_RESTART_COUNT``) and ``once``. The points the
port has, each called from one place:

    rank_exit[:code=N]      trainer step boundary: os._exit mid-epoch
    slow_peer[:ms=N]        trainer step boundary: a stall
    straggle[:ms=,from=]    trainer step boundary: a stall on every step
                            from step ``from`` on (a persistent straggler)
    init_hang[:ms=N]        dist.initialize_runtime, under its deadline
    checkpoint_corrupt      checkpoint.save_checkpoint: flip bytes after
                            the sidecar (``step`` gates the stored epoch)
    decode_fail[:p=,fails=] data loader: hash-deterministic sample failure
    watchdog_expire         the stall watchdog's poll: fire at once
    nanbomb                 trainer, after the batch is on the card: the
                            whole batch times NaN
    lossbomb[:factor=F]     trainer step boundary: the classifier head
                            (tpudist's last 2-D param leaf) times F
    bitflip[:bit=B]         trainer step boundary: flip bit B (23) of
                            element 0 of tpudist's first f32 param leaf

``lossbomb`` and ``bitflip`` pick their leaf as tpudist does, in the
order ``jax.tree_util`` flattens tpudist's params (dict keys sorted),
through the port's name map (``compat.jax_params.jax_leaves``): for
resnet18 that is ``fc.weight`` and ``bn1.bias``, not torch's module
order. A name that is no point is refused by name (``check_spec``).
Probabilistic faults hash the sample key (no RNG state), so the same
samples fail on every run and every rank, and ``fails=N`` heals a key
after N failures.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Optional

# A preempted trainer drains, writes its emergency checkpoint and exits
# with this code: "resumable, not a crash" (BSD EX_TEMPFAIL).
PREEMPTED_EXIT_CODE = 75
# tpudist's doctor: a rank whose replicated state is minority-divergent.
SDC_EXIT_CODE = 76
# tpudist's stall watchdog (``tpudist/utils/watchdog.py``).
STALL_EXIT_CODE = 117

ENV_SPEC = "TPUDIST_INJECT"
ENV_ATTEMPT = "TPUDIST_RESTART_COUNT"
ENV_RANK = "TPUDIST_PROCESS_ID"

POINTS = ("rank_exit", "slow_peer", "straggle", "init_hang",
          "checkpoint_corrupt", "decode_fail", "watchdog_expire", "nanbomb",
          "lossbomb", "bitflip")


@dataclass
class Injection:
    """One armed fault: a point name, firing gates, and fault params."""
    name: str
    step: Optional[int] = None
    rank: Optional[int] = None
    attempt: Optional[int] = None
    once: bool = False
    params: dict = field(default_factory=dict)
    fired: int = 0
    _attempt_counts: dict = field(default_factory=dict)  # decode heal count

    def param_float(self, key: str, default: float = 0.0) -> float:
        return float(self.params.get(key, default))

    def param_int(self, key: str, default: int = 0) -> int:
        return int(float(self.params.get(key, default)))


def parse_spec(spec: str) -> list[Injection]:
    """Parse a spec (tpudist's grammar and errors). Items separate on
    ``;`` (commas belong to the params); an unknown gate raises."""
    out: list[Injection] = []
    for item in (spec or "").split(";"):
        item = item.strip()
        if not item:
            continue
        head, *gates = item.split("@")
        name, _, paramstr = head.partition(":")
        name = name.strip()
        if not name:
            raise ValueError(f"--inject item has no fault name: {item!r}")
        inj = Injection(name=name)
        for kv in paramstr.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, sep, v = kv.partition("=")
            if not sep:
                raise ValueError(
                    f"--inject param {kv!r} in {item!r} is not key=value")
            inj.params[k.strip()] = v.strip()
        for gate in gates:
            gate = gate.strip()
            if gate == "once":
                inj.once = True
                continue
            k, sep, v = gate.partition("=")
            k = k.strip()
            if not sep or k not in ("step", "rank", "attempt"):
                raise ValueError(
                    f"--inject gate {gate!r} in {item!r} must be one of "
                    f"step=N / rank=N / attempt=N / once")
            setattr(inj, k, int(v))
        out.append(inj)
    return out


def check_spec(spec: str) -> list[Injection]:
    """``parse_spec``, then refuse every item that names no fault point
    (naming the ones there are)."""
    injections = parse_spec(spec)
    bad = []
    for inj in injections:
        if inj.name not in POINTS:
            bad.append(f"{inj.name} (no such fault point; the port's are "
                       f"{', '.join(POINTS)})")
    if bad:
        raise ValueError("unsupported --inject item(s) in tpudist_torch: "
                         + "; ".join(bad))
    return injections


class FaultInjector:
    """Per-process registry of armed injections."""

    def __init__(self, injections: list[Injection]):
        self.injections = injections
        self._by_name: dict[str, list[Injection]] = {}
        for inj in injections:
            self._by_name.setdefault(inj.name, []).append(inj)

    def should_fire(self, point: str, step: Optional[int] = None,
                    consume: bool = True) -> Optional[Injection]:
        """The armed injection for ``point`` whose gates all match, else
        None; marks it fired unless ``consume`` is False (the caller
        filters further and counts an actual firing itself)."""
        for inj in self._by_name.get(point, ()):
            if inj.once and inj.fired:
                continue
            if inj.step is not None and step != inj.step:
                continue
            if inj.rank is not None and _env_int(ENV_RANK, 0) != inj.rank:
                continue
            if inj.attempt is not None \
                    and _env_int(ENV_ATTEMPT, 0) != inj.attempt:
                continue
            if consume:
                inj.fired += 1
            return inj
        return None

    def armed(self, point: str) -> bool:
        return point in self._by_name


def _env_int(key: str, default: int) -> int:
    try:
        return int(os.environ.get(key, default))
    except ValueError:
        return default


_injector: Optional[FaultInjector] = None
_observer = None


def set_observer(fn) -> None:
    """Register ``fn(point, step, info)``, called whenever an injection
    fires (the trainer's ``fault`` events); None clears it. Observer
    errors are swallowed: telemetry must not change fault semantics."""
    global _observer
    _observer = fn


def _notify(point: str, step: Optional[int] = None, **info) -> None:
    if _observer is None:
        return
    try:
        _observer(point, step, info)
    except Exception:   # noqa: BLE001 — see set_observer
        pass


def configure(spec: Optional[str] = None) -> FaultInjector:
    """(Re)arm the process-wide injector. ``None`` reads
    ``TPUDIST_INJECT``; an empty spec disarms everything."""
    global _injector
    if spec is None:
        spec = os.environ.get(ENV_SPEC, "")
    _injector = FaultInjector(check_spec(spec))
    return _injector


def get_injector() -> FaultInjector:
    if _injector is None:
        configure()
    return _injector


def should_fire(point: str, step: Optional[int] = None
                ) -> Optional[Injection]:
    inj = get_injector().should_fire(point, step=step)
    if inj is not None:
        _notify(point, step=step)
    return inj


def armed(point: str) -> bool:
    return get_injector().armed(point)


# -- the fault points ----------------------------------------------------------

def maybe_rank_exit(step: int) -> None:
    """``rank_exit``, at the trainer's step boundary: end this rank at
    once (``os._exit``: no atexit, no teardown), the shape of a killed
    rank."""
    inj = should_fire("rank_exit", step=step)
    if inj is not None:
        code = inj.param_int("code", 41)
        print(f"[tpudist.faults] rank_exit firing at step {step} "
              f"(os._exit({code}))", flush=True)
        os._exit(code)


def maybe_slow_peer(step: int) -> None:
    """``slow_peer``, at the trainer's step boundary: stall ``ms``."""
    inj = should_fire("slow_peer", step=step)
    if inj is not None:
        time.sleep(inj.param_float("ms", 500.0) / 1e3)


def maybe_straggle(step: int) -> None:
    """``straggle``, at the trainer's step boundary: a sustained ``ms``
    stall (default 400) on every step from step ``from`` (default 0) on,
    the persistent-straggler shape the launcher's straggler detection
    flags. ``from=`` takes the place of the ``step=`` gate; rank, attempt
    and once gate as usual, and each firing is notified."""
    inj = get_injector().should_fire("straggle", consume=False)
    if inj is None or step < inj.param_int("from", 0):
        return
    inj.fired += 1
    _notify("straggle", step=step)
    time.sleep(inj.param_float("ms", 400.0) / 1e3)


def maybe_init_hang() -> None:
    """``init_hang``, in ``dist.initialize_runtime`` before the
    rendezvous: sleep ``ms``, so the peers' init deadline is what ends
    the job."""
    inj = should_fire("init_hang")
    if inj is not None:
        ms = inj.param_float("ms", 60_000.0)
        print(f"[tpudist.faults] init_hang firing ({ms:.0f}ms)", flush=True)
        time.sleep(ms / 1e3)


def maybe_corrupt_checkpoint(paths: list[str],
                             epoch: Optional[int] = None) -> bool:
    """``checkpoint_corrupt``, after ``checkpoint.save_checkpoint``: flip
    64 bytes mid-file in every path of the save just written, after its
    sidecar attested the good bytes. The ``step`` gate matches the
    stored epoch. Returns True when it fired."""
    inj = should_fire("checkpoint_corrupt", step=epoch)
    if inj is None:
        return False
    for path in paths:
        try:
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.seek(size // 2)
                chunk = f.read(64)
                f.seek(size // 2)
                f.write(bytes(b ^ 0xFF for b in chunk))
            print(f"[tpudist.faults] checkpoint_corrupt flipped "
                  f"{len(chunk)} bytes in {path}", flush=True)
        except OSError as e:
            print(f"[tpudist.faults] checkpoint_corrupt could not corrupt "
                  f"{path}: {e}", flush=True)
    return True


def decode_should_fail(key: int) -> bool:
    """``decode_fail``, in the loader's retry loop: ``p`` selects a
    stable subset of sample keys (a splitmix64 hash), ``fails=N`` heals a
    key after N failures (0: it fails every time)."""
    inj = get_injector().should_fire("decode_fail", consume=False)
    if inj is None:
        return False
    p = inj.param_float("p", 1.0)
    h = (int(key) + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    h ^= h >> 31
    if (h % 10_000) / 10_000.0 >= p:
        return False
    fails = inj.param_int("fails", 0)
    if fails > 0:
        seen = inj._attempt_counts.get(key, 0)
        if seen >= fails:
            return False
        inj._attempt_counts[key] = seen + 1
    inj.fired += 1
    _notify("decode_fail", key=int(key))
    return True


def maybe_nanbomb(step: int, images):
    """``nanbomb``, after the batch is on the card: the whole batch times
    NaN (a bad record, an overflowed preprocessing). The guarded step's
    sentinel must trip and the step must leave the state as it was."""
    inj = should_fire("nanbomb", step=step)
    if inj is None:
        return images
    print(f"[tpudist.faults] nanbomb firing at step {step}", flush=True)
    return images * float("nan")


def _param_leaves(model):
    """tpudist's ``params`` leaves of ``model`` in jax's flatten order."""
    from tpudist_torch.compat.jax_params import jax_leaves
    return jax_leaves(list(model.named_parameters()))


def maybe_lossbomb(step: int, model) -> Optional[str]:
    """``lossbomb``, at the step boundary: scale the classifier head (the
    last 2-D leaf of tpudist's params) by ``factor`` (100) in place. The
    next loss spikes and stays finite: the EWMA detector, not the
    sentinel, must act. No rank gate: every replica is hit alike. Returns
    the parameter's name when it fired."""
    inj = should_fire("lossbomb", step=step)
    if inj is None:
        return None
    factor = inj.param_float("factor", 100.0)
    hits = [(name, view) for _, name, view in _param_leaves(model)
            if view.ndim == 2]
    if not hits:
        print("[tpudist.faults] lossbomb armed but no 2-D param leaf "
              "found", flush=True)
        return None
    name, view = hits[-1]
    print(f"[tpudist.faults] lossbomb firing at step {step} "
          f"(head kernel x{factor:g})", flush=True)
    import torch
    with torch.no_grad():
        view.mul_(factor)
    return name


def maybe_bitflip(step: int, model) -> Optional[str]:
    """``bitflip``, at the step boundary: flip bit ``bit`` (23, the f32
    exponent's lowest) of element 0 of the first f32 leaf of tpudist's
    params, on this rank (silent data corruption: nothing turns
    non-finite, only the doctor's digest probe sees it). Returns the
    parameter's name when it fired."""
    inj = should_fire("bitflip", step=step)
    if inj is None:
        return None
    import torch
    bit = inj.param_int("bit", 23)
    hits = [(i, name, view) for i, (_, name, view)
            in enumerate(_param_leaves(model))
            if view.numel() > 0 and view.dtype == torch.float32]
    if not hits:
        print("[tpudist.faults] bitflip armed but no f32 param leaf found",
              flush=True)
        return None
    idx, name, view = hits[0]
    mask = 1 << bit
    mask = mask - (1 << 32) if mask >= 1 << 31 else mask   # as int32
    at = (0,) * view.ndim
    with torch.no_grad():
        words = view.view(torch.int32)       # the same bytes, on the device
        words[at] = words[at] ^ mask
    print(f"[tpudist.faults] bitflip firing at step {step} "
          f"(param leaf {idx}, bit {bit})", flush=True)
    return name


def maybe_watchdog_expire() -> bool:
    """``watchdog_expire``, in the watchdog's poll: the budget counts as
    blown, so the stall chain runs in milliseconds."""
    return should_fire("watchdog_expire") is not None


def classify_exit(code: int) -> str:
    """A rank's exit code in words, for the launcher's lines."""
    if code == 0:
        return "clean"
    if code == PREEMPTED_EXIT_CODE:
        return "preempted (emergency checkpoint written; resumable)"
    if code == SDC_EXIT_CODE:
        return ("sdc (doctor probe: replicated state minority-divergent; "
                "rank self-quarantined, no checkpoint written)")
    if code == STALL_EXIT_CODE:
        return "stalled (watchdog abort; peer loss or hung collective)"
    if code < 0:
        return f"killed by signal {-code}"
    return f"crash (exit {code})"
