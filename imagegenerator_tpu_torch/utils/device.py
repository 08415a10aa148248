"""Which device an entry point runs on.

The port's entry points (the CLIs, ``Stage1System``, ``Stage2System``,
``GenerateEngine``) run on the card unless the caller asks for another
device; the ``nn.Module`` building blocks keep torch's ``device=None``.
"""

from __future__ import annotations

import torch


def entry_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card. Raises when
    the card is wanted (by default or by name) and CUDA is not
    available: an entry point does not fall back to the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        asked = "by default" if device is None else f"as device={device!r}"
        raise RuntimeError(
            f"CUDA is not available and the card was asked for {asked}; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
