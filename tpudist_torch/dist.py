"""The data-parallel runtime: process group, device binding, collectives.

Counterpart of ``tpudist/dist.py``. The reference template does::

    dist.init_process_group(backend='nccl')
    torch.cuda.set_device(local_rank)

and averages its metrics with ``reduce_mean`` (all_reduce SUM / nprocs)
behind ``dist.barrier()``. Here:

- ``initialize_runtime`` calls ``torch.distributed.init_process_group``
  at ``tcp://<TPUDIST_COORDINATOR>`` with the world size and rank from
  the flags or the launcher's env (``TPUDIST_NUM_PROCESSES``,
  ``TPUDIST_PROCESS_ID``), under tpudist's deadline
  (``TPUDIST_INIT_TIMEOUT``) and bounded retries
  (``TPUDIST_INIT_RETRIES``), and returns the seconds it took (the
  telemetry's ``init_s``);
- the backend follows the device: ``nccl`` on the card, ``gloo`` on the
  CPU. Ranks run on one host, one card each: rank r binds ``cuda:r``
  before any CUDA work, and more ranks than cards is refused (NCCL cannot
  share a card, and nothing falls back to gloo);
- ``reduce_mean`` is the metrics' all-reduce, ``all_reduce_sum`` the
  differentiable one of SyncBN's statistics, ``barrier`` a host barrier
  with tpudist's deadline (``TPUDIST_BARRIER_TIMEOUT``), ``shutdown``
  destroys the process group at the end of a run;
- ``any_rank`` agrees on a host flag (a pending preemption) at a step
  boundary, so every rank drains at the same step.

Without an initialised process group every query answers for one process
(rank 0 of 1) and the collectives are identities.
"""

from __future__ import annotations

import datetime
import os
import sys
import threading
import time

import torch
import torch.distributed as dist

from tpudist_torch import faults


def initialize_runtime(coordinator_address: str | None = None,
                       num_processes: int | None = None,
                       process_id: int | None = None,
                       timeout_s: float | None = None,
                       retries: int | None = None, *,
                       device: str = "cuda") -> float:
    """Join the process group; returns the seconds the init phase took.

    A deadline bounds each attempt's rendezvous (``timeout_s``, default
    env ``TPUDIST_INIT_TIMEOUT`` or 300 s): an unreachable coordinator
    raises instead of hanging. ``retries`` (default env
    ``TPUDIST_INIT_RETRIES`` or 0) further attempts follow a failure, with
    a linear backoff of 5 s per attempt, at most 30 s."""
    t0 = time.monotonic()
    coordinator = coordinator_address or os.environ.get("TPUDIST_COORDINATOR")
    if num_processes is None and os.environ.get("TPUDIST_NUM_PROCESSES"):
        num_processes = int(os.environ["TPUDIST_NUM_PROCESSES"])
    if process_id is None and os.environ.get("TPUDIST_PROCESS_ID"):
        process_id = int(os.environ["TPUDIST_PROCESS_ID"])
    if not coordinator or num_processes is None or process_id is None:
        raise ValueError(
            "--distributed needs the coordinator address, the number of "
            "processes and this process's id: pass --coordinator-address, "
            "--num-processes and --process-id, or start the ranks with "
            "python -m tpudist_torch.launch (TPUDIST_COORDINATOR, "
            "TPUDIST_NUM_PROCESSES, TPUDIST_PROCESS_ID)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is outside the world of "
                         f"{num_processes} processes")
    if timeout_s is None:
        timeout_s = float(os.environ.get("TPUDIST_INIT_TIMEOUT", 300.0))
    if retries is None:
        retries = int(os.environ.get("TPUDIST_INIT_RETRIES", 0))

    kwargs = dict(init_method=f"tcp://{coordinator}",
                  world_size=num_processes, rank=process_id)
    if timeout_s > 0:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    if torch.device(device).type == "cuda":
        # Checked before any CUDA call, which would open a context on
        # card 0 in every rank.
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if num_processes > cards:
            raise RuntimeError(
                f"{num_processes} rank(s) on this host but {cards} CUDA "
                f"card(s): NCCL gives each rank a card of its own and "
                f"cannot share one; start at most {cards} rank(s), or pass "
                f"--device cpu to run any number over gloo on the CPU")
        torch.cuda.set_device(process_id)
        kwargs.update(backend="nccl",
                      device_id=torch.device("cuda", process_id))
    else:
        kwargs["backend"] = "gloo"

    # An armed init_hang stalls here, before the rendezvous: the peers'
    # deadline is what ends the job.
    faults.maybe_init_hang()
    for attempt in range(retries + 1):
        try:
            dist.init_process_group(**kwargs)
        except Exception as e:  # noqa: BLE001 — re-raised once retries end
            if attempt >= retries:
                raise RuntimeError(
                    f"distributed runtime init failed after {attempt + 1} "
                    f"attempt(s) (deadline {timeout_s:.0f}s per attempt, "
                    f"coordinator {coordinator}): {e}") from e
            wait = min(5.0 * (attempt + 1), 30.0)
            print(f"[tpudist_torch.dist] init attempt {attempt + 1} failed "
                  f"({e}); retrying in {wait:.0f}s ({retries - attempt} "
                  f"retries left)", file=sys.stderr, flush=True)
            time.sleep(wait)
        else:
            break
    return time.monotonic() - t0


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if is_initialized() else 0


def data_rank_world() -> tuple[int, int]:
    """``(rank, world)`` for the data plane: what ``ShardedSampler`` shards
    over and what ``-b`` is divided by."""
    if is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_primary() -> bool:
    return process_index() == 0


def device_count() -> int:
    """The cards the run trains on: one a rank."""
    return data_rank_world()[1]


def backend() -> str | None:
    return dist.get_backend() if is_initialized() else None


def reduce_mean(tensor: torch.Tensor) -> torch.Tensor:
    """The reference's ``reduce_mean``: clone, all_reduce(SUM), divide by
    the world. On the card the all-reduce is queued on the device stream
    and the host does not wait for it."""
    if not is_initialized():
        return tensor
    out = tensor.detach().clone()
    dist.all_reduce(out)
    return out.div_(dist.get_world_size())


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose gradient is again the sum over the ranks
    of the incoming gradients (every rank's output depends on every
    rank's input)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """Differentiable all-reduce (SUM) across the ranks (SyncBN's
    statistics). A plain ``dist.all_reduce`` would cut the gradient to
    this rank's share."""
    return _AllReduceSum.apply(tensor)


def barrier(tag: str = "tpudist_torch_barrier",
            timeout_s: float | None = None) -> None:
    """Host barrier across the ranks, for host-side coordination (rank 0
    sets up the run directory, the others wait). A no-op for one process.

    A deadline bounds the wait (``timeout_s``, default env
    ``TPUDIST_BARRIER_TIMEOUT`` or 600 s; <= 0 waits without one): a peer
    that died before reaching the barrier raises ``TimeoutError`` here
    instead of hanging the rank. The barrier runs on a daemon thread so
    the deadline can fire while the collective is blocked."""
    if not is_initialized():
        return
    if timeout_s is None:
        timeout_s = float(os.environ.get("TPUDIST_BARRIER_TIMEOUT", 600.0))
    kw = ({"device_ids": [torch.cuda.current_device()]}
          if dist.get_backend() == "nccl" else {})
    if timeout_s <= 0:
        dist.barrier(**kw)
        return
    err: list[BaseException] = []

    def _sync():
        try:
            dist.barrier(**kw)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            err.append(e)

    t = threading.Thread(target=_sync, daemon=True,
                         name=f"tpudist-torch-barrier-{tag}")
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise TimeoutError(
            f"host barrier '{tag}' did not complete within {timeout_s:.0f}s "
            f"— a peer likely died before reaching it; aborting so the "
            f"launcher can tear the job down")
    if err:
        raise err[0]


_host_group = None      # a gloo group for host flags under NCCL


def _host():
    """The group host values travel over: gloo, so the card is never
    waited for (the default group itself when it is gloo)."""
    global _host_group
    if dist.get_backend() != "gloo" and _host_group is None:
        _host_group = dist.new_group(backend="gloo")
    return _host_group


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any: one all-reduce of
    a host integer. Every rank must call it at the same points. One
    process answers ``flag``."""
    if not is_initialized() or dist.get_world_size() == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, group=_host())
    return bool(t.item())


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (a picklable host value; the others
    pass anything). Every rank must call it at the same points. One
    process gets ``obj`` back."""
    if not is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=_host())
    return box[0]


def shutdown() -> None:
    """Destroy the process group (the end of a run, on every exit path)."""
    global _host_group
    _host_group = None
    if is_initialized():
        dist.destroy_process_group()
