"""The port's placement layer: double_buffered issues the fetch of item k+1
before yielding item k and waits for item k's pending copies only as it
yields it; on the CPU host offload is the identity (as the JAX package's
policy is on a backend with no host pool); a per-cycle checkpoint's first
pass offloads nothing and its recompute does.  The pinned-memory path on
the card is tested in tests/test_torch_flash_bwd_cuda.py."""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import transformer as T
from repro_torch.runtime import placement as PL
from repro_torch.tree import tree_leaves


def test_double_buffered_prefetches_one_ahead():
    events = []

    def fetch(i):
        events.append(("fetch", i))
        return i * 10

    for got in PL.double_buffered([3, 5, 7], fetch):
        events.append(("compute", got))
    assert events == [("fetch", 3), ("fetch", 5), ("compute", 30), ("fetch", 7),
                      ("compute", 50), ("compute", 70)]
    assert list(PL.double_buffered([], fetch)) == []


def test_cpu_offload_is_the_identity():
    off = PL.host_offload("cpu")
    t = torch.randn(3, 4)
    fetched = off.to_device(t)
    assert off.to_host(t) is t and isinstance(fetched, PL.Pending) and fetched.wait() is t
    assert off.to_host_bytes == off.to_device_bytes == 0
    assert PL.host_offload(torch.device("cpu")) is off


def test_offload_refuses_other_devices():
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        PL.HostOffload("meta")


def test_double_buffered_waits_only_as_it_yields():
    events = []

    class Copy(PL.Pending):
        def wait(self):
            events.append(("wait", self.tensor))
            return self.tensor

    def fetch(i):
        events.append(("fetch", i))
        return Copy(i), Copy(-i)

    for got in PL.double_buffered([1, 2], fetch):
        events.append(("compute", got))
    assert events == [("fetch", 1), ("fetch", 2), ("wait", 1), ("wait", -1), ("compute", (1, -1)),
                      ("wait", 2), ("wait", -2), ("compute", (2, -2))]


def test_no_offload_nests_and_restores():
    assert PL.offload_enabled()
    with PL.no_offload():
        assert not PL.offload_enabled()
        with PL.no_offload():
            assert not PL.offload_enabled()
        assert not PL.offload_enabled()
    assert PL.offload_enabled()


@pytest.mark.parametrize("remat,forward_copies", [("full", 0), ("none", 1)])
def test_remat_first_pass_offloads_nothing(monkeypatch, remat, forward_copies):
    """Under remat="full" the checkpoint throws the first pass's saved
    tensors away, so that pass copies no chunk to the host; the recompute in
    the backward does.  Without remat the forward's copies are the ones kept.
    forward_copies: copies per layer and chunk tensor in the forward (0 or 1)."""
    calls = []
    real = PL.HostOffload.to_host
    monkeypatch.setattr(PL.HostOffload, "to_host", lambda self, t: calls.append(1) or real(self, t))
    cfg = dataclasses.replace(reduced(get_config("llama3.2-1b")), param_dtype="float32",
                              fpdt_chunks=2, fpdt_offload=True, remat=remat)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (1, 16), generator=torch.Generator().manual_seed(1))
    loss, _ = T.loss_fn(cfg, None, params, {"tokens": tokens, "labels": tokens})
    per_pass = 3 * cfg.fpdt_chunks * cfg.num_layers  # q, k, v of each chunk, per layer
    assert len(calls) == forward_copies * per_pass
    loss.backward()
    assert len(calls) == per_pass
