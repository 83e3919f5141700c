"""``remat="offload"`` on the card: each layer cycle's input waits in pinned
host memory between the forward and the backward, its bytes are counted,
and the loss and every gradient equal ``remat="full"``'s bit for bit.
Marked ``cuda``: the test skips, inside its fixture, where there is no
NVIDIA GPU (on the CPU the offload is the identity, and
tests/test_torch_paper_models.py holds the recompute).  Run it on a machine
with the card:  PYTHONPATH=src python -m pytest --noconftest -m cuda \\
    tests/test_torch_remat_cuda.py
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.models import transformer as T
from repro_torch.runtime import train_loop as TL
from repro_torch.runtime.placement import host_offload
from repro_torch.tree import tree_leaves

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_remat_offload_keeps_cycle_inputs_pinned(device):
    b, s = 2, 64
    cfg = dataclasses.replace(reduced(get_config("gpt-2.7b")), fpdt_chunks=4, mlp_chunks=8,
                              fpdt_offload=True)
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    batch = make_batch_fn(cfg, ShapeConfig("t", s, b, "train"))(0)
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    off = host_offload(device)
    out = {}
    for remat in ("full", "offload"):
        off.reset_counts()
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                      lambda t: t):
            loss, _, grads = TL.value_and_grad(dataclasses.replace(cfg, remat=remat), None,
                                               params, batch)
        torch.cuda.synchronize()
        inputs = [t for t in saved if t.device.type == "cpu" and t.dim() == 3]
        out[remat] = ([loss, *tree_leaves(grads)], off.to_host_bytes, off.peak_held_bytes,
                      inputs)
    cycle_bytes = cfg.num_layers * b * s * cfg.d_model * 2  # bf16 [b, s, d] a cycle
    values, host_bytes, peak_held, inputs = out["offload"]
    assert len(inputs) == cfg.num_layers and all(t.is_pinned() for t in inputs)
    assert host_bytes - out["full"][1] == cycle_bytes
    assert peak_held >= cycle_bytes
    assert not out["full"][3]  # remat full keeps the cycle inputs on the card
    assert all(torch.equal(a, c) for a, c in zip(values, out["full"][0]))
