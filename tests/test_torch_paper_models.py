"""The paper's GPT and Llama models in the port against the JAX package.

The registry: ``PAPER_ARCHS`` lists the six paper archs, each config equal
to the reference's field for field.  Reduced gpt-2.7b (layernorm, gelu,
MHA) and reduced llama-8b (rmsnorm, swiglu, GQA): ``loss_fn`` and every
gradient leaf at u in {1, 4} under remat full and remat offload, in fp32
weights, against JAX ``loss_fn`` with remat full (on this backend the JAX
package's offload policy degrades to full remat, and its host-offload
cells are not run here), attention as ``xla_flash`` and host offload off,
as ``tests/test_torch_train.py`` runs it.  A gpt at head_dim 80 (d_model
160, 2 heads, 2 layers, gpt-2.7b's head width): FPDT output and gradients
at u = 4 against the JAX package's (Pallas kernels in interpret mode), and
its 2-layer loss and gradients.  The port's remat offload equals its remat
full bit for bit (on the CPU ``HostOffload`` is the identity, so the
recompute and the gradients are what is held), for falcon-mamba-7b's ssm
cycles too, which are also held against JAX under both remats; and the
CLI trains reduced gpt-2.7b with ``--remat offload``.  Tolerances: loss 2e-4, gradients 5e-4
(tests/test_fpdt.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PAPER_ARCHS as J_PAPER_ARCHS
from repro.configs import ShapeConfig as JShape, get_config as j_get_config, reduced as j_reduced
from repro.core import fpdt as JF
from repro.core.parallel import ParallelContext as JPar
from repro.data.pipeline import make_batch_fn as j_make_batch_fn
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import PAPER_ARCHS, get_config, list_configs, reduced
from repro_torch.convert import from_jax_params
from repro_torch.core import fpdt as F
from repro_torch.launch import train as CLI
from repro_torch.runtime import train_loop as TL
from repro_torch.tree import tree_leaves

B, S = 2, 32
JPAR = JPar(mesh=None, attn_impl="xla_flash", offload_to_host=False)
# gpt-2.7b's head width at a size the CPU runs in seconds
D80 = dict(d_model=160, num_heads=2, num_kv_heads=2, head_dim=80, d_ff=640, num_layers=2)


@pytest.mark.parametrize("arch", J_PAPER_ARCHS)
def test_paper_config_equals_the_reference(arch):
    assert PAPER_ARCHS == J_PAPER_ARCHS and arch in list_configs()
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(j_get_config(arch))


def _cfgs(arch, **kw):
    kw = dict(param_dtype="float32", **kw)
    return (dataclasses.replace(j_reduced(j_get_config(arch)), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


def _torch(tree):
    return from_jax_params(jax.device_get(tree), "cpu")


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


_JAX_RESULTS = {}


def _reference(arch, u, **sizes):
    """(jparams, batch, JAX loss, JAX gradient leaves) of reduced ``arch`` at
    u with remat full, computed once per (arch, u, sizes)."""
    key = (arch, u, tuple(sorted(sizes.items())))
    if key not in _JAX_RESULTS:
        jc, _ = _cfgs(arch, fpdt_chunks=u, mlp_chunks=2 * u, remat="full", **sizes)
        jparams = JT.init_params(jc, jax.random.PRNGKey(0))
        batch = j_make_batch_fn(jc, JShape("t", S, B, "train"))(0)
        (jl, _), jg = jax.jit(jax.value_and_grad(
            lambda p, b: JT.loss_fn(jc, JPAR, p, b), has_aux=True))(
                jparams, {k: jnp.asarray(v) for k, v in batch.items()})
        _JAX_RESULTS[key] = (jparams, batch, float(jl),
                             [np.asarray(g) for g in jax.tree.leaves(jg)])
    return _JAX_RESULTS[key]


def _assert_matches(arch, u, remat, **sizes):
    jparams, batch, jl, jleaves = _reference(arch, u, **sizes)
    _, tc = _cfgs(arch, fpdt_chunks=u, mlp_chunks=2 * u, remat=remat, **sizes)
    tl, tm, tg = TL.value_and_grad(tc, None, _torch(jparams), _tbatch(batch))
    np.testing.assert_allclose(float(tl), jl, rtol=2e-4, atol=2e-4)
    assert float(tm["tokens"]) == B * S
    tleaves = tree_leaves(tg)
    assert [tuple(t.shape) for t in tleaves] == [j.shape for j in jleaves]
    for t, j in zip(tleaves, jleaves):
        np.testing.assert_allclose(t.numpy(), j, rtol=5e-4, atol=5e-4)
    return tg


@pytest.mark.parametrize("remat", ["full", "offload"])
@pytest.mark.parametrize("u", [1, 4])
@pytest.mark.parametrize("arch", ["gpt-2.7b", "llama-8b", "falcon-mamba-7b"])
def test_loss_and_grads_match_jax(arch, u, remat):
    """Every leaf, the layernorm ``w``/``b`` and gelu MLP of gpt included,
    lines up with the JAX pytree and its gradient (falcon-mamba-7b: the
    ssm blocks under both remats; u reaches no attention there)."""
    tg = _assert_matches(arch, u, remat)
    if arch == "gpt-2.7b":
        norm = tg["cycles"]["pos0"]["norm1"]
        assert sorted(norm) == ["b", "w"] and float(norm["b"].abs().sum()) > 0


def test_head_dim_80_loss_and_grads_match_jax():
    _assert_matches("gpt-2.7b", 4, "offload", **D80)


def test_head_dim_80_fpdt_matches_jax():
    """FPDT at u = 4 and head_dim 80: output, dx and the q/k/v projections'
    gradients against the JAX package's (Pallas kernels in interpret mode)."""
    jc, tc = _cfgs("gpt-2.7b", fpdt_chunks=4, **D80)
    jp = {n: w for n, w in JL.init_attn(jc, jax.random.PRNGKey(3), jnp.float32).items()
          if n in ("wq", "wk", "wv")}
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, S, 160)).astype(np.float32)
    do = rng.standard_normal((B, S, 160)).astype(np.float32)

    def f(x, p):
        o = JF.fpdt_attention(jc, JPar(mesh=None, attn_impl="pallas"), p, x, kind="local")
        return (o * do).sum(), o

    (_, jo), (jdx, jdp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jp)
    tp = {n: t.requires_grad_(True) for n, t in _torch(jp).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    to = F.fpdt_attention(tc, None, tp, tx)
    tgrads = torch.autograd.grad((to * torch.from_numpy(do)).sum(), [tx, *(tp[n] for n in jp)])
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), rtol=2e-4, atol=2e-4)
    for t, j in zip(tgrads, [jdx, *(jdp[n] for n in jp)]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("arch", ["gpt-2.7b", "llama-8b", "recurrentgemma-9b",
                                  "falcon-mamba-7b"])
def test_remat_offload_is_remat_full_bit_for_bit(arch):
    """The same forward, recomputed the same way in the backward: the loss
    and every gradient leaf are the same bits (the hybrid's rglru cycles
    and falcon's ssm cycles, whose scan blocks are checkpoints of their
    own, too)."""
    jc, _ = _cfgs(arch)
    params = _torch(JT.init_params(jc, jax.random.PRNGKey(0)))
    tb = _tbatch(j_make_batch_fn(jc, JShape("t", S, B, "train"))(0))
    out = {}
    for remat in ("full", "offload"):
        _, tc = _cfgs(arch, fpdt_chunks=4, mlp_chunks=8, remat=remat)
        loss, _, grads = TL.value_and_grad(tc, None, params, tb)
        out[remat] = [loss, *tree_leaves(grads)]
    assert all(torch.equal(a, b) for a, b in zip(out["full"], out["offload"]))


def test_cli_trains_gpt_with_remat_offload(capsys):
    history = CLI.main(["--arch", "gpt-2.7b", "--reduced", "--device", "cpu", "--steps", "2",
                        "--batch", "2", "--seq", "32", "--chunks", "4", "--offload",
                        "--remat", "offload", "--log-every", "1"])
    assert [r["step"] for r in history] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in history)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "tokens/s" in ln]
    assert len(lines) == 2 and all(ln.endswith("on cpu") for ln in lines)
