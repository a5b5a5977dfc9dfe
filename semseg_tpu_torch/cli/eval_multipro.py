"""Multi-card evaluation (the root ``eval_multipro.py``, reference parity).

    python -m semseg_tpu_torch.cli.eval_multipro [--gpus 0-3] --cfg <yaml> [opts]

``cli.eval`` with ``--devices`` defaulting to every visible card: one
engine per card, the val list dealt out to them in chunks (``cli.eval``).
The reference's ``--gpus 0-3`` device list sizes ``--devices``, as it sized
the worker pool there; an explicit ``--devices`` wins.
"""

from __future__ import annotations

import sys

import torch

from semseg_tpu_torch.cli.eval import main as eval_main
from semseg_tpu_torch.utils import parse_devices


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--gpus" in argv:
        i = argv.index("--gpus")
        gpus = parse_devices(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
        if "--devices" not in argv:
            argv = ["--devices", str(len(gpus))] + argv
    if "--devices" not in argv:
        argv = ["--devices", str(max(1, torch.cuda.device_count()))] + argv
    return eval_main(argv)


if __name__ == "__main__":
    main()
