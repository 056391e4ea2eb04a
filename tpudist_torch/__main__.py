"""CLI entry point: ``python -m tpudist_torch <flags>``.

Counterpart of ``python -m tpudist``: the same flags (``config.py``) plus
``--device {cuda,cpu}``; trains on one CUDA card, or the CPU when asked,
and prints ``best_acc1=...``::

    python -m tpudist_torch --synthetic -a resnet18 -b 256 --use_amp \\
        --fused-bn on --telemetry --outpath DIR
    python -m tpudist_torch --device cpu --synthetic -a resnet18 \\
        --num-classes 8 --image-size 32 -b 16 --epochs 2 --step 1 -p 2
"""

import sys

from tpudist_torch.config import from_args
from tpudist_torch.trainer import run


def main(argv=None) -> int:
    best = run(from_args(argv))
    print(f"best_acc1={best:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
