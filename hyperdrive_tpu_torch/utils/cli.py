"""The ``--device`` option of the port's CLIs.

A subcommand that does device work takes ``--device``: the card by
default, ``cpu`` for the kernels' plain versions (the tests' choice). A
CUDA device on a machine without CUDA ends the command with a message
and a non-zero exit; nothing falls back to the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["add_device_arg", "require_device"]


def add_device_arg(parser) -> None:
    """Add ``--device`` (default ``cuda``) to an argparse parser."""
    parser.add_argument(
        "--device", default="cuda",
        help="torch device of the device work (default: the card); "
             "'cpu' runs the kernels' plain versions",
    )


def require_device(device: str) -> torch.device:
    """``--device`` as a ``torch.device``. Exits (``SystemExit``, code 1,
    the message on stderr) when it names CUDA and CUDA is not available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {device}: CUDA is not available; pass --device cpu to "
            "run the plain versions on the CPU"
        )
    return dev
