"""The replica-consistency check (``--replica-check-freq``): the port's
counterpart of ``tpudist/utils/debug.py``.

In the port a replica is a data-parallel rank: every rank of a DDP run
must hold bit-identical parameters and BN running statistics (DDP
averages the gradients, the step averages the buffers). A divergence is a
non-deterministic op, a bad collective or corrupted memory desyncing the
ranks. ``check_replica_consistency`` compares every rank's leaves with
rank 0's over the process group: rank 0's leaves travel in one broadcast
of their concatenation, each rank takes its largest difference per leaf,
and one all-reduce (max) gives every rank the same verdict. Outside a
process group (or at world 1) there is nothing to compare: ``checked`` is
0, which callers report as skipped, never as passed.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import torch
import torch.distributed as torch_dist


def replica_leaves(model: torch.nn.Module) -> list[tuple[str, torch.Tensor]]:
    """``(name, tensor)`` of the replicated state the check compares: the
    parameters and the float buffers, named as tpudist's tree
    (``params/...``, ``batch_stats/...``)."""
    return ([(f"params/{n}", p) for n, p in model.named_parameters()]
            + [(f"batch_stats/{n}", b) for n, b in model.named_buffers()
               if b.is_floating_point()])


def check_replica_consistency(leaves: Iterable[tuple[str, torch.Tensor]]
                              ) -> Tuple[List[Tuple[str, float]], int]:
    """``(bad, checked)``: ``bad`` lists ``(name, max |Δ|)`` of every leaf
    that differs from rank 0's bit for bit on some rank (a NaN difference
    counts), the same list on every rank;
    ``checked`` counts the leaves compared (0 outside a process group of
    two or more ranks)."""
    leaves = list(leaves)
    if not (torch_dist.is_available() and torch_dist.is_initialized()) \
            or torch_dist.get_world_size() < 2 or not leaves:
        return [], 0
    with torch.no_grad():
        mine = [t.detach().reshape(-1).to(torch.float64) for _, t in leaves]
        flat = torch.cat(mine)
        ref = flat.clone()
        torch_dist.broadcast(ref, src=0)
        diff = (flat - ref).abs()
        # Bit for bit (f32 and bf16 widen to f64 exactly).
        unequal = flat.view(torch.int64).ne(ref.view(torch.int64))
        per_leaf, flags = [], []
        for d, u in zip(diff.split([m.numel() for m in mine]),
                        unequal.split([m.numel() for m in mine])):
            per_leaf.append(d.max() if d.numel() else d.new_zeros(()))
            flags.append(u.any().to(torch.float64) if u.numel()
                         else d.new_zeros(()))
        # NaN → +inf so that max keeps it; one all-reduce for the verdict.
        worst = torch.stack(per_leaf).nan_to_num(nan=float("inf"))
        stats = torch.cat([worst, torch.stack(flags)])
        torch_dist.all_reduce(stats, op=torch_dist.ReduceOp.MAX)
        n = len(leaves)
        worst, flags = stats[:n].tolist(), stats[n:].tolist()
    bad = [(name, w) for (name, _), w, f in zip(leaves, worst, flags) if f]
    return bad, n


def assert_replicas_consistent(leaves: Iterable[tuple[str, torch.Tensor]]
                               ) -> int:
    """Raise ``AssertionError`` naming up to five divergent leaves (the
    same on every rank); return the number of leaves checked (0 is a
    skipped check)."""
    bad, checked = check_replica_consistency(leaves)
    if bad:
        lines = ", ".join(f"{p} (Δ={d:g})" for p, d in bad[:5])
        raise AssertionError(
            f"replica divergence on {len(bad)} state leaves: {lines} — "
            f"replicated SPMD state must be identical on every device")
    return checked
