"""Device resolution: the port runs on the CUDA device unless asked not to.

There is no silent fallback: asking for ``"cuda"`` (the default) on a
machine without a GPU raises, and the CPU runs only when named.
"""

from typing import Optional, Union

import torch


def resolve_device(name: Optional[Union[str, torch.device]] = "cuda") -> torch.device:
    """``"cuda"`` (default; ``None`` means the same) or ``"cuda:N"`` needs an
    available GPU and raises ``RuntimeError`` otherwise; ``"cpu"`` runs the
    plain PyTorch versions of every kernel."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False; "
                               "pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
