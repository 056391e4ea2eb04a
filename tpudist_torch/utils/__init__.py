"""Meters, logging and the experiment directory: the port's copies of
``tpudist/utils/meters.py``, ``utils/logging.py`` and
``utils/experiment.py::output_process``."""

from __future__ import annotations

import logging
import os
import shutil
import sys


class AverageMeter:
    """Computes and stores the average and current value:
    ``update(val, n)`` is weighted, ``__str__`` renders
    ``"{name} {val:fmt} ({avg:fmt})"``."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0.0

    def update(self, val: float, n: int = 1) -> None:
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count else 0.0

    def __str__(self) -> str:
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(name=self.name, val=self.val, avg=self.avg)


class ProgressMeter:
    """'Epoch[e]:\\t[i/N]\\tmeter\\tmeter...' console lines."""

    def __init__(self, num_batches: int, meters: list[AverageMeter],
                 prefix: str = ""):
        self.num_batches = num_batches
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int) -> str:
        entries = [f"{self.prefix}[{batch}/{self.num_batches}]"]
        entries += [str(m) for m in self.meters]
        return "\t".join(entries)


def get_logger(save_path: str,
               logger_name: str = "tpudist_torch") -> logging.Logger:
    """``experiment.log`` (timestamped) + bare stdout lines, INFO level;
    rebuilt when the experiment dir changes."""
    logger = logging.getLogger(logger_name)
    target = os.path.abspath(os.path.join(save_path, "experiment.log"))
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler) and h.baseFilename == target:
            return logger
        logger.removeHandler(h)
        h.close()
    logger.setLevel(logging.INFO)
    logger.propagate = False
    fh = logging.FileHandler(target)
    fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s: "
                                      "%(message)s"))
    logger.addHandler(fh)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(sh)
    return logger


def output_process(output_path: str, mode: str = "prompt") -> None:
    """Create the experiment dir; if it exists: ``keep`` reuses it,
    ``delete`` removes it first, ``quit`` raises, and ``prompt`` asks on a
    TTY and raises without one (a headless run must not block)."""
    if os.path.exists(output_path):
        if mode == "keep":
            return
        if mode == "prompt":
            if sys.stdin is None or not sys.stdin.isatty():
                raise OSError(
                    f"Directory {output_path} exists and stdin is not a TTY; "
                    f"refusing to prompt in a headless run. Pass "
                    f"--overwrite delete or --overwrite quit (or remove the "
                    f"directory).")
            print(f"{output_path} file exist!")
            action = input("Select Action: d (delete) / q (quit):")
            action = action.lower().strip()
        else:
            action = "d" if mode == "delete" else "q"
        if action != "d":
            raise OSError(f"Directory {output_path} exists!")
        shutil.rmtree(output_path)
    os.makedirs(output_path)
