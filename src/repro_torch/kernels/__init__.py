"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version; ``on_card`` is how every op picks between them."""
from __future__ import annotations


def on_card(what: str, *tensors) -> bool:
    """True for CUDA tensors (the kernel runs), False for CPU tensors (the
    plain version runs); tensors on mixed or other devices raise.  ``None``
    entries are skipped."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{what} inputs on mixed devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs CUDA tensors (kernel) or CPU tensors "
                         f"(plain version), not {device}")
    return device.type == "cuda"
