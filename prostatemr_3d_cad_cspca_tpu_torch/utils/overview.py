"""Config overview printing, the port's copy of the JAX package's
``utils/overview.py`` (reference misc.py:61-114 print_overview)."""

from __future__ import annotations


def print_overview(args) -> None:
    """Console dump of the training configuration (misc.py:61-114 parity)."""
    bar = "-" * 68
    print(bar)
    print("Training Configuration Overview")
    print(bar)
    for key in sorted(vars(args)):
        print(f"{key:32s}: {getattr(args, key)}")
    print(bar)
