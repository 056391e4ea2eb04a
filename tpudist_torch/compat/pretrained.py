"""``--pretrained``: torchvision's ImageNet weights, from disk only.

The port's copy of ``tpudist/compat/pretrained.py``. The reference passes
``pretrained=True`` to torchvision, which downloads; the port never
downloads. It loads the same ``.pth`` files from an explicit path
(``--pretrained-path``, a file or a directory) or from where a
torchvision download would have landed: ``$TPUDIST_PRETRAINED_DIR``,
then ``$TORCH_HOME/hub/checkpoints`` (``TORCH_HOME`` defaults to
``~/.cache/torch``). The load is strict (``compat/torch_checkpoint``): a
missing tensor, or a 1000-class head against another ``--num-classes``,
raises.
"""

from __future__ import annotations

import glob
import os

import torch

from tpudist_torch.compat.torch_checkpoint import (family,
                                                   load_reference_checkpoint,
                                                   load_torch_state_dict)


def _candidate_dirs() -> list[str]:
    dirs = []
    if os.environ.get("TPUDIST_PRETRAINED_DIR"):
        dirs.append(os.environ["TPUDIST_PRETRAINED_DIR"])
    torch_home = os.environ.get(
        "TORCH_HOME", os.path.join(os.path.expanduser("~"), ".cache", "torch"))
    dirs.append(os.path.join(torch_home, "hub", "checkpoints"))
    return dirs


def resolve_pretrained_path(arch: str, explicit: str = "") -> str:
    """The weights file for ``arch``: ``explicit`` as a file, or the
    first of ``{arch}-*.pth``, ``{arch}.pth``, ``{arch}-*.pth.tar``,
    ``{arch}.pth.tar`` in ``explicit`` as a directory, else in the
    candidate directories. Raises ``FileNotFoundError`` listing every
    directory searched."""
    family(arch)
    if explicit:
        if os.path.isfile(explicit):
            return explicit
        if not os.path.isdir(explicit):
            raise FileNotFoundError(
                f"--pretrained-path '{explicit}' does not exist")
        search_dirs = [explicit]
    else:
        search_dirs = _candidate_dirs()
    for d in search_dirs:
        for pattern in (f"{arch}-*.pth", f"{arch}.pth", f"{arch}-*.pth.tar",
                        f"{arch}.pth.tar"):
            hits = sorted(glob.glob(os.path.join(d, pattern)))
            if hits:
                return hits[0]
    raise FileNotFoundError(
        f"no pretrained checkpoint for '{arch}' found; searched "
        f"{search_dirs} for '{arch}-*.pth'. Download the torchvision weights "
        f"on a connected machine and place them there, or pass "
        f"--pretrained-path.")


def load_pretrained(model: torch.nn.Module, arch: str, path: str) -> None:
    """Load the torchvision weights at ``path`` into ``model``, strictly
    (the optimizer is built after, fresh, as torch's ``pretrained=True``
    flow has it)."""
    load_torch_state_dict(model, load_reference_checkpoint(path)["state_dict"],
                          arch)
