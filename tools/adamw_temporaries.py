"""Count the bytes of temporaries that ``optim/adamw.py::apply`` holds at
once, per element of the slice it updates, on the CPU.

  PYTHONPATH=src python3 tools/adamw_temporaries.py

A ``TorchDispatchMode`` adds the bytes of every tensor an operator returns
in fresh storage and subtracts them when the tensor is freed, over one
``apply`` on a bf16 leaf with fp32 moments, and prints the largest total
over the leaf's elements.  ``chip_smoke.py``'s peak reckoning
(``ADAMW_BYTES``) takes this count for the update's share of a step's
peak, a function of the code alone, not of the device.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def bytes_per_element(rows: int = 512, cols: int = 256) -> float:
    """The peak of live temporaries in one ``adamw.apply`` over a bf16
    [rows, cols] leaf, per element."""
    from repro_torch.optim import adamw

    live = {"now": 0, "peak": 0}

    def freed(n):
        live["now"] -= n

    class Track(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            inputs = {a.untyped_storage().data_ptr() for a in args if isinstance(a, torch.Tensor)}
            for t in out if isinstance(out, (tuple, list)) else [out]:
                if (isinstance(t, torch.Tensor) and t.numel() > 1
                        and t.untyped_storage().data_ptr() not in inputs):
                    n = t.untyped_storage().nbytes()
                    live["now"] += n
                    live["peak"] = max(live["peak"], live["now"])
                    weakref.finalize(t, freed, n)
            return out

    gen = torch.Generator().manual_seed(0)
    p = {"w": torch.randn((rows, cols), generator=gen).to(torch.bfloat16)}
    g = {"w": torch.randn((rows, cols), generator=gen).to(torch.bfloat16)}
    oc = adamw.OptConfig()
    state = adamw.init(oc, p)
    with Track():
        adamw.apply(oc, p, g, state)
    return live["peak"] / (rows * cols)


if __name__ == "__main__":
    print(f"adamw.apply holds at most {bytes_per_element():.2f} bytes of temporaries an element "
          "of the slice it updates (CPU count, a function of the code)")
