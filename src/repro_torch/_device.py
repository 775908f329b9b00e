"""Where the port's tensors live: the card, unless the caller asks for the CPU.

There is no silent fallback.  Without a Hopper card the default raises; the
CPU is used only when the caller passes ``"cpu"``, and then every kernel
wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device, which must be a
    compute capability (9, 0) card; ``"cpu"`` -> the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise RuntimeError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the kernels need an sm_90 (Hopper) card; pass "
            "device='cpu' to run the plain PyTorch versions instead")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cap = torch.cuda.get_device_capability(dev)
    if cap != (9, 0):
        raise RuntimeError(
            f"{torch.cuda.get_device_name(dev)} has compute capability {cap}; "
            "the kernels are built for sm_90a only")
    return dev
