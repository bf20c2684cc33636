"""The port's device rule: entry points run on the card unless asked not to.

``device=None`` means the first CUDA device. Where there is none, the
entry point raises instead of carrying on silently on the CPU; a caller
that wants the CPU (the tests, a reference run) says ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device that is not present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return dev
