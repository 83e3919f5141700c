"""The plain references against the port at a reduced size on the CPU, in
fp32: the same loss and the same gradient of every leaf, for both
families; and the reference's AdamW against the port's over three steps.
The port is only a witness here: the references import nothing of it."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from bench import spec, traffic, weights  # noqa: E402
from bench.harness import skeleton  # noqa: E402
from bench.reference import common as RC  # noqa: E402

SMALL = {
    "gpt-2.7b-l8": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
                        d_ff=128, vocab_size=256),
    "falcon-mamba-7b-l8": dict(num_layers=2, d_model=64, vocab_size=256, ssm_state=4,
                               dt_rank=4),
}


def small_cell(config: str, param_dtype="float32", seq=64, batch=2) -> spec.Cell:
    """The configuration cut to test size (its family and structure kept)."""
    cfg = spec._load(ROOT / "bench" / "configs" / f"{config}.json")
    cfg = {**cfg, "model": {**cfg["model"], **SMALL[config], "param_dtype": param_dtype}}
    return spec.Cell("small", 1, cfg, {"batch": batch, "seq": seq, "zipf_a": 1.2,
                                       "doc_start_p": 0.01},
                     {"fpdt_chunks": 4, "mlp_chunks": 8, "offload": True, "remat": "full",
                      "ref_steps": 3, "trace_steps": 2,
                      "limits": {"grad_gap": 0.1, "change_gap": 0.1}}, [], [])


@pytest.mark.parametrize("config", sorted(SMALL))
def test_reference_loss_and_gradients_equal_the_ports(config):
    from repro_torch.runtime import train_loop as TL

    from bench.harness import program_config

    cell = small_cell(config)
    cfg = program_config(cell)
    tree = weights.make(skeleton(cfg), 1234, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             traffic.batch_fn(cell.traffic, cfg.vocab_size, 1234)(0).items()}
    loss, _, grads = TL.value_and_grad(cfg, None, tree, batch)
    ref = spec.reference(cell.config["reference"])
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.flat(tree).items()}
    with RC.fp32_strict():
        rloss = ref.loss(cell.config["model"], params, batch, RC.Prec("fp32"))
    rgrads = torch.autograd.grad(rloss, list(params.values()))
    assert float(loss) == pytest.approx(float(rloss.detach()), rel=1e-5)
    prog = weights.flat(grads)
    for (k, g) in zip(params, rgrads):
        assert torch.allclose(prog[k], g, rtol=1e-4, atol=1e-4 * float(g.abs().max()) + 1e-9), k


def test_reference_adamw_is_the_ports():
    from repro_torch.optim import adamw

    g = torch.Generator().manual_seed(3)
    params = {"w": torch.randn((8, 16), generator=g), "b": torch.randn((16,), generator=g)}
    opt = {"lr": 1e-2, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "clip_norm": 1.0,
           "warmup_steps": 2, "total_steps": 10, "min_lr_frac": 0.1}
    oc = adamw.OptConfig(**opt)
    prog = {k: v.clone() for k, v in params.items()}
    state = adamw.init(oc, prog)
    ref = RC.AdamW(opt, params, {k: torch.float32 for k in params})
    for step in range(3):
        grads = {k: torch.randn(v.shape, generator=g) * (step + 1) for k, v in params.items()}
        prog, state, _ = adamw.apply(oc, prog, grads, state)
        ref.update(params, grads)
        for k in params:
            assert torch.allclose(prog[k], params[k], rtol=1e-5, atol=1e-6), (step, k)


def test_scan_block_is_the_recurrence():
    g = torch.Generator().manual_seed(5)
    a, b = torch.rand((2, 13, 3), generator=g), torch.randn((2, 13, 3), generator=g)
    h0 = torch.randn((2, 3), generator=g)
    h, want = h0, []
    for t in range(13):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    assert torch.allclose(RC.LinearScan.apply(a, b, h0), torch.stack(want, 1), atol=1e-6)


@pytest.mark.parametrize("scores", [RC.SCORES_PER_BLOCK, 2 * 40 * 16])
def test_blocked_attention_is_softmax_attention(scores, monkeypatch):
    monkeypatch.setattr(RC, "SCORES_PER_BLOCK", scores)  # one block, or rows of 16
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn((1, 2, 40, 8), generator=g, requires_grad=True) for _ in range(3))
    o = RC.CausalAttention.apply(q, k, v, RC.Prec("fp32"))
    s = (q @ k.transpose(-1, -2)) / 8 ** 0.5
    s = s.masked_fill(torch.triu(torch.ones(40, 40, dtype=torch.bool), 1), float("-inf"))
    want = torch.softmax(s, -1) @ v
    assert torch.allclose(o, want, atol=1e-5)
    do = torch.randn(o.shape, generator=g)
    assert all(torch.allclose(x, y, atol=1e-4) for x, y in
               zip(torch.autograd.grad(o, (q, k, v), do), torch.autograd.grad(want, (q, k, v), do)))
