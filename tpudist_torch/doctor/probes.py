"""Cross-replica SDC probes: the port's counterpart of
``tpudist/doctor/probes.py``.

Data-parallel training replicates its state: every rank of a DDP run
holds bit-identical parameters, BN running statistics, optimizer state
and EMA (DDP averages the gradients, the step averages the buffers). So a
rank whose state digest differs from the majority's is a rank whose card
or host corrupted it. Every ``--doctor-probe-freq`` steps each rank
digests its state (``replicated_digest``, the one fetch to the host, at a
step boundary) and publishes the digest in the run dir
(``write_digest``); ``collect_digests`` gathers the others' for up to 20
s (a dead rank's missing digest must not hang the live ones), and
``divergent_ranks`` takes the majority vote. Two ranks that disagree are
a tie: detected, blamed on neither.

The port keeps no sharded state (one card a rank, no ZeRO or TP), so
every leaf is replicated and compared. The digest hashes each leaf's
name, dtype and shape beside its bytes; it is not tpudist's bytes, but it
is the same on every rank that holds the same state and one flipped bit
changes it.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import time
from typing import Iterable

import torch

DOCTOR_DIRNAME = "doctor"


def state_leaves(model, optimizer=None, ema=None) -> list[tuple[str, object]]:
    """``(name, tensor)`` of a train state: the parameters, the float
    buffers (the BN running statistics), every tensor of the optimizer's
    per-parameter state and the EMA module's parameters and buffers.
    ``model`` is the bare module (not its DDP wrapper)."""
    out = [(f"params/{n}", p) for n, p in model.named_parameters()]
    out += [(f"batch_stats/{n}", b) for n, b in model.named_buffers()
            if b.is_floating_point()]
    if optimizer is not None:
        for n, p in model.named_parameters():
            for key, val in sorted(optimizer.state.get(p, {}).items()):
                if hasattr(val, "dtype"):
                    out.append((f"opt_state/{n}/{key}", val))
    if ema is not None:
        out += [(f"ema/params/{n}", p) for n, p in ema.named_parameters()]
        out += [(f"ema/batch_stats/{n}", b) for n, b in ema.named_buffers()
                if b.is_floating_point()]
    return out


def replicated_digest(leaves: Iterable[tuple[str, object]]) -> str:
    """The sha256 of ``leaves`` (``(name, tensor)``), sorted by name:
    each leaf's name, dtype, shape and bytes. Each tensor is copied to the
    host here, one at a time."""
    h = hashlib.sha256()
    for name, t in sorted(leaves, key=lambda kv: kv[0]):
        t = t.detach()
        h.update(name.encode())
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


# -- the digest exchange through the run dir ----------------------------------

def _probe_dir(outpath: str) -> str:
    return os.path.join(outpath, DOCTOR_DIRNAME)


def _digest_path(outpath: str, step: int, rank: int) -> str:
    return os.path.join(_probe_dir(outpath),
                        f"digest.step{step:08d}.rank{rank}.json")


def write_digest(outpath: str, rank: int, step: int, digest: str) -> str:
    """Publish this rank's digest for ``step`` (a temporary renamed into
    place)."""
    os.makedirs(_probe_dir(outpath), exist_ok=True)
    path = _digest_path(outpath, step, rank)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"rank": rank, "step": step, "digest": digest}, f)
    os.replace(tmp, path)
    return path


def collect_digests(outpath: str, step: int, world: int,
                    timeout_s: float = 60.0,
                    poll_s: float = 0.05) -> dict[int, str]:
    """Every rank's digest for ``step``, waiting up to ``timeout_s`` for
    the late ones; whatever arrived by then."""
    deadline = time.time() + timeout_s
    out: dict[int, str] = {}
    while True:
        for rank in range(world):
            if rank in out:
                continue
            try:
                with open(_digest_path(outpath, step, rank)) as f:
                    d = json.load(f)
                out[int(d["rank"])] = str(d["digest"])
            except (OSError, ValueError, KeyError, TypeError):
                continue
        if len(out) >= world or time.time() >= deadline:
            return out
        time.sleep(poll_s)


def prune_digests(outpath: str, before_step: int) -> None:
    """Remove digest files of steps before ``before_step``."""
    for p in glob.glob(os.path.join(_probe_dir(outpath),
                                    "digest.step*.rank*.json")):
        base = os.path.basename(p)
        try:
            step = int(base.split("step")[1].split(".")[0])
        except (IndexError, ValueError):
            continue
        if step < before_step:
            try:
                os.remove(p)
            except OSError:
                pass


def divergent_ranks(digests: dict[int, str]) -> tuple[list[int], bool]:
    """``(minority ranks, tie)`` by majority vote over the digests; a
    tie for the majority blames nobody: ``([], True)``."""
    if len(digests) < 2:
        return [], False
    counts: dict[str, int] = {}
    for d in digests.values():
        counts[d] = counts.get(d, 0) + 1
    if len(counts) == 1:
        return [], False
    best = max(counts.values())
    winners = [d for d, n in counts.items() if n == best]
    if len(winners) > 1:
        return [], True
    majority = winners[0]
    return sorted(r for r, d in digests.items() if d != majority), False

