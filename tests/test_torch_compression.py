"""The port's int8 gradient compression with error feedback
(``repro_torch/optim/compression.py``) against the JAX package's
``optim/compression.py``, on the CPU.

* The functions: ``compress``, ``decompress``, ``quantize_with_feedback``,
  ``tree_quantize_with_feedback`` and ``init_residuals`` on the same numpy
  inputs, equal bit for bit, over shapes (fewer than one block, whole
  blocks, a padded last block, 3-D), fp32 and bf16 gradients, magnitudes
  from 1e-6 to 1e3 and an all-zero block (scale 1e-12, q 0); the in-place
  slab version (the step's) the same bits across slab boundaries.
* The two properties of tests/test_substrates.py (the error-feedback
  recursion does not drift; the round trip's error is within a step), run
  on the port.
* The step: the JAX ``make_train_step`` with the residuals carried by
  hand, 3 steps, on reduced llama3.2-1b and granite-moe-1b-a400m in fp32
  weights and one ``grad_accum=2`` case, and at each of its states the
  port's ``make_train_step(..., residuals)`` from the same state (a
  quantisation flip would otherwise carry into every later step).  Held:
  the parameters of every leaf within 5e-4 of the leaf's largest
  magnitude, and its residuals within 5e-4 of the largest magnitude of
  the leaf's ``g + residual`` (a residual's error is the gradient's, which
  tests/test_fpdt.py holds at 5e-4 of its largest magnitude; the residual
  itself is at most half a block's step, 1/254 of that); where the two
  quantize an element to neighbouring integers the residual differs by
  that step by construction: such elements are counted, at most FLIPS in
  a case, and held by the next gate instead; every ``g_hat`` element
  within one quantisation step (its block's scale) of JAX's, whose
  ``g_hat`` is ``g + residual - residual'`` of its step; the port's own
  ``g_hat + residual' == g + residual`` to fp32 rounding; and the port's
  own 3-step trajectory's loss and grad norm within 1e-4 of JAX's.
* The loop: ``TrainLoop`` carries residuals only under ``compress_grads``,
  and a checkpoint written with it on has the files and keys of one
  written with it off (the residuals are not checkpointed).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeConfig as JShape, get_config as j_get_config, reduced as j_reduced
from repro.core.parallel import ParallelContext as JPar
from repro.data.pipeline import make_batch_fn as j_make_batch_fn
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.optim import compression as JC
from repro.runtime import train_loop as JTL
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.convert import from_jax_params
from repro_torch.data.pipeline import CheckpointableIterator, make_batch_fn
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A
from repro_torch.optim import compression as C
from repro_torch.runtime import train_loop as TL
from repro_torch.tree import tree_leaves

JPAR = JPar(mesh=None, attn_impl="xla_flash", offload_to_host=False)
B, S = 2, 32
TOL = 5e-4
FLIPS = 8  # elements of a case quantized to neighbouring integers by the two

SHAPES = [(100,), (2048 * 3,), (4097,), (5000,), (3, 1000, 24), (96, 80)]
DTYPES = ["float32", "bfloat16"]
MAGNITUDES = [1e-6, 1.0, 1e3]


def _inputs(shape, dtype, mag, seed=0, zero_block=False):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(shape) * mag).astype(np.float32)
    r = (rng.standard_normal(shape) * mag * 0.01).astype(np.float32)
    if zero_block:
        g.reshape(-1)[:C.BLOCK] = 0.0
        r.reshape(-1)[:C.BLOCK] = 0.0
    jg = jnp.asarray(g).astype(dtype)
    return jg, jnp.asarray(r), torch.from_numpy(np.array(jg.astype(jnp.float32))).to(
        getattr(torch, dtype)), torch.from_numpy(r)


def _bits(x):
    """The raw bits of a jax array or tensor of 2 or 4 bytes an element."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.view(torch.int16).numpy() if x.element_size() == 2 else x.numpy().view(np.int32)
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


def _same_bits(t, j):
    return np.array_equal(_bits(t), _bits(j))


# ---------------------------------------------------------------------------
# the functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mag", MAGNITUDES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_with_feedback_bit_for_bit(shape, dtype, mag):
    jg, jr, tg, tr = _inputs(shape, dtype, mag)
    a, b = JC.quantize_with_feedback(jg, jr)
    c, d = C.quantize_with_feedback(tg, tr)
    assert c.dtype == tg.dtype and d.dtype == torch.float32 and tuple(c.shape) == shape
    assert _same_bits(c, a) and _same_bits(d, b)
    # the inputs are left as they were
    assert torch.equal(tg, torch.from_numpy(np.array(jg.astype(jnp.float32))).to(tg.dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(100,), (4097,), (3, 1000, 24)])
def test_compress_decompress_bit_for_bit(shape, dtype):
    jg, _, tg, _ = _inputs(shape, dtype, 1.0, seed=1)
    jc, tc = JC.compress(jg), C.compress(tg)
    assert tc.q.dtype == torch.int8 and tc.scale.dtype == torch.float32
    assert np.array_equal(tc.q.numpy(), np.asarray(jc.q))
    assert _same_bits(tc.scale, jc.scale)
    assert _same_bits(C.decompress(tc, shape, tg.dtype), JC.decompress(jc, shape, jg.dtype))


def test_all_zero_block():
    """A block of zeros: scale 1e-12 in fp32, q 0, g_hat and residual 0
    (+0, through int8), as in JAX."""
    jg, jr, tg, tr = _inputs((3 * C.BLOCK,), "float32", 1.0, seed=2, zero_block=True)
    c = C.compress(tg)
    assert float(c.scale[0, 0]) == float(np.float32(1e-12))
    assert not c.q[0].any()
    a, b = JC.quantize_with_feedback(jg, jr)
    g_hat, res = C.quantize_with_feedback(tg, tr)
    assert _same_bits(g_hat, a) and _same_bits(res, b)
    assert not np.signbit(g_hat[:C.BLOCK].numpy()).any()


def test_tree_and_init_residuals_bit_for_bit():
    jt, tt, jr_, tr_ = {}, {}, {}, {}
    for i, (k, sh) in enumerate([("a", (5000,)), ("b0", (3, 1000, 24)), ("b1", (96, 80))]):
        jg, jr, tg, tr = _inputs(sh, "bfloat16" if i == 2 else "float32", 1.0, seed=i)
        jt[k], tt[k], jr_[k], tr_[k] = jg, tg, jr, tr
    jh, jres = JC.tree_quantize_with_feedback(jt, jr_)
    th, tres = C.tree_quantize_with_feedback(tt, tr_)
    for k in jt:
        assert _same_bits(th[k], jh[k]) and _same_bits(tres[k], jres[k])
    jz, tz = JC.init_residuals(jt), C.init_residuals(tt)
    for k in jt:
        assert tz[k].dtype == torch.float32 and _same_bits(tz[k], jz[k])


def test_slabs_are_the_whole_leaf(monkeypatch):
    """The in-place version works SLAB elements at a time: the same bits
    as one slab, across a slab boundary that falls inside no block."""
    jg, jr, tg, tr = _inputs((7 * C.BLOCK + 5,), "bfloat16", 1.0, seed=3)
    a, b = JC.quantize_with_feedback(jg, jr)
    monkeypatch.setattr(C, "SLAB", 2 * C.BLOCK)
    g, r = tg.clone(), tr.clone()
    out = C.tree_quantize_with_feedback_({"g": g}, {"g": r})
    assert out[0]["g"] is g and out[1]["g"] is r
    assert _same_bits(g, a) and _same_bits(r, b)


# ---------------------------------------------------------------------------
# the properties (tests/test_substrates.py)
# ---------------------------------------------------------------------------


def test_compression_error_feedback():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal(5000).astype(np.float32))
    res = torch.zeros(5000, dtype=torch.float32)
    tot_hat = np.zeros(5000)
    for _ in range(20):
        g_hat, res = C.quantize_with_feedback(g, res)
        tot_hat += g_hat.numpy()
    drift = np.abs(tot_hat - 20 * g.numpy()).max()
    scale = np.abs(g.numpy()).max() / 127
    assert drift <= 2 * scale + 1e-5  # residual bounded -> no accumulation


def test_compression_roundtrip_small_error():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((333,)).astype(np.float32))
    y = C.decompress(C.compress(x), x.shape, torch.float32)
    assert float((x - y).abs().max()) <= float(x.abs().max()) / 127 + 1e-6


# ---------------------------------------------------------------------------
# the step, against JAX's with the residuals carried by hand
# ---------------------------------------------------------------------------


def _cfgs(arch):
    kw = dict(param_dtype="float32", fpdt_chunks=4, mlp_chunks=8, remat="full")
    return (dataclasses.replace(j_reduced(j_get_config(arch)), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


def _np_leaves(tree):
    return [np.asarray(x, dtype=np.float32) for x in jax.tree.leaves(tree)]


def _port_state(jp, js, jr):
    """The port's (params, AdamW state, residuals) from JAX's."""
    host = jax.device_get((jp, js.m, js.v, jr))
    p, m, v, r = (from_jax_params(x, "cpu") for x in host)
    return p, A.OptState(step=torch.tensor(int(js.step), dtype=torch.int32), m=m, v=v), r


def _run_steps(arch, steps, grad_accum):
    """JAX's compressed steps, the residuals carried by hand, and at each
    of its states the port's step from the same state: per step the two
    residuals and parameters after it, JAX's g_hat, the block scales and
    the largest |g + residual| of each leaf, and the port's (g, residual)
    into and (g_hat, residual') out of its quantizer; and the port's own
    trajectory's (loss, grad_norm) beside JAX's."""
    jc, tc = _cfgs(arch)
    jparams = JT.init_params(jc, jax.random.PRNGKey(0))
    batches = [j_make_batch_fn(jc, JShape("t", S, B, "train"))(s) for s in range(steps)]
    oc = dict(lr=1e-3, warmup_steps=2, total_steps=steps)
    jstep = jax.jit(JTL.make_train_step(jc, JPAR, JA.OptConfig(**oc),
                                        JTL.TrainConfig(grad_accum=grad_accum,
                                                        compress_grads=True)))
    jgrad = jax.jit(jax.grad(lambda p, b: JT.loss_fn(jc, JPAR, p, b)[0]))
    tstep = TL.make_train_step(tc, None, A.OptConfig(**oc),
                               TL.TrainConfig(grad_accum=grad_accum, compress_grads=True))
    jp, js, jr = jparams, JA.init(JA.OptConfig(**oc), jparams), JC.init_residuals(jparams)
    free = _port_state(jp, js, jr)  # the port's own trajectory
    out = []
    for s in range(steps):
        jb = {k: jnp.asarray(v) for k, v in batches[s].items()}
        tb = {k: torch.from_numpy(v) for k, v in batches[s].items()}
        # JAX's summed (averaged) gradient, as its step forms it
        n = grad_accum
        parts = [jgrad(jp, {k: v[i * (B // n):(i + 1) * (B // n)] for k, v in jb.items()})
                 for i in range(n)]
        g = [np.zeros(x.shape, np.float32) for x in _np_leaves(parts[0])]
        for part in parts:
            g = [a + b for a, b in zip(g, _np_leaves(part))]
        if n > 1:
            g = [a / np.float32(n) for a in g]
        r_old = _np_leaves(jr)
        same = _port_state(jp, js, jr)
        jp, js, jm, jr = jstep(jp, js, jb, jr)
        r_new = _np_leaves(jr)
        seen = {}
        real = C.tree_quantize_with_feedback_

        def capture(grads, residuals, par=None, plans=None):
            seen["in"] = ([x.float().clone() for x in tree_leaves(grads)],
                          [x.clone() for x in tree_leaves(residuals)])
            res = real(grads, residuals, par, plans)
            seen["out"] = ([x.float().clone() for x in tree_leaves(grads)],
                           [x.clone() for x in tree_leaves(residuals)])
            return res

        C.tree_quantize_with_feedback_ = capture
        try:
            tp, _, _, tr = tstep(*same[:2], tb, same[2])
        finally:
            C.tree_quantize_with_feedback_ = real
        fp, fs, fm, fr = tstep(*free[:2], tb, free[2])
        free = (fp, fs, fr)
        out.append({
            "j_res": r_new, "t_res": [x.numpy().copy() for x in tree_leaves(tr)],
            "j_par": _np_leaves(jp), "t_par": [x.numpy().copy() for x in tree_leaves(tp)],
            "j_hat": [(a + b) - c for a, b, c in zip(g, r_old, r_new)],
            "scale": [np.repeat(np.asarray(JC.compress(jnp.asarray(a + b)).scale).reshape(-1),
                                C.BLOCK)[:a.size].reshape(a.shape) for a, b in zip(g, r_old)],
            "target_max": [float(np.abs(a + b).max()) for a, b in zip(g, r_old)],
            "seen": seen,
            "free": {k: (float(fm[k]), float(jm[k])) for k in ("loss", "grad_norm", "lr")}})
    return out


STEP_CASES = [("llama3.2-1b", 3, 1), ("granite-moe-1b-a400m", 3, 1), ("llama3.2-1b", 2, 2)]


@pytest.fixture(scope="module", params=STEP_CASES, ids=lambda c: f"{c[0]}-accum{c[2]}")
def stepped(request):
    arch, steps, accum = request.param
    return _run_steps(arch, steps, accum)


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def test_step_matches_jax(stepped):
    """From the same state: the parameters, and the residuals but where
    the two quantized to neighbouring integers (counted)."""
    flips = 0
    for rec in stepped:
        for t, j, th, jh, sc, top in zip(rec["t_res"], rec["j_res"], rec["seen"]["out"][0],
                                         rec["j_hat"], rec["scale"], rec["target_max"]):
            flipped = np.abs(th.numpy() - jh) > 0.5 * sc
            flips += int(flipped.sum())
            assert float(np.abs(np.where(flipped, j, t) - j).max()) <= TOL * max(top, 1e-30)
        for t, j in zip(rec["t_par"], rec["j_par"]):
            assert _rel(t, j) <= TOL
    assert flips <= FLIPS


def test_trajectory_matches_jax(stepped):
    """The port's own compressed trajectory: loss, grad norm and learning
    rate of each step within 1e-4 of JAX's (tests/test_torch_train.py)."""
    for rec in stepped:
        for k, (got, want) in rec["free"].items():
            np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=k)


def test_step_g_hat_within_a_step_of_jax(stepped):
    for rec in stepped:
        for th, jh, sc in zip(rec["seen"]["out"][0], rec["j_hat"], rec["scale"]):
            assert (np.abs(th.numpy() - jh) <= sc * (1 + 1e-5) + 1e-30).all()


def test_step_error_feedback_identity(stepped):
    """The port's own g_hat + residual' == g + residual, to fp32 rounding."""
    for rec in stepped:
        (g, r), (g_hat, r_new) = rec["seen"]["in"], rec["seen"]["out"]
        for a, b, c, d in zip(g, r, g_hat, r_new):
            target = a + b
            slack = 2 * torch.finfo(torch.float32).eps * target.abs().max()
            assert float((c + d - target).abs().max()) <= float(slack)


def test_step_refuses_without_residuals():
    _, tc = _cfgs("llama3.2-1b")
    params = T.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    oc = A.OptConfig()
    step = TL.make_train_step(tc, None, oc, TL.TrainConfig(compress_grads=True))
    batch = {k: torch.from_numpy(v)
             for k, v in make_batch_fn(tc, ShapeConfig("t", S, B, "train"))(0).items()}
    with pytest.raises(ValueError, match="residuals"):
        step(params, A.init(oc, params), batch)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


def _loop(tmp_path, compress):
    _, tc = _cfgs("llama3.2-1b")
    params = T.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    oc = A.OptConfig(lr=1e-3, warmup_steps=2, total_steps=2)
    trc = TL.TrainConfig(steps=2, ckpt_every=1, log_every=3, compress_grads=compress)
    mgr = CheckpointManager(str(tmp_path), cfg=tc)
    loop = TL.TrainLoop(tc, None, oc, trc, TL.make_train_step(tc, None, oc, trc),
                        CheckpointableIterator(make_batch_fn(tc, ShapeConfig("t", S, B,
                                                                             "train"))), mgr)
    assert loop.residuals is None
    loop.run(params, A.init(oc, params))
    mgr.wait()
    return loop, params


def test_loop_carries_residuals_only_when_asked(tmp_path):
    on, params = _loop(tmp_path / "on", True)
    off, _ = _loop(tmp_path / "off", False)
    assert off.residuals is None
    res = tree_leaves(on.residuals)
    assert [tuple(r.shape) for r in res] == [tuple(p.shape) for p in tree_leaves(params)]
    assert all(r.dtype == torch.float32 for r in res) and any(bool(r.any()) for r in res)
    assert [r["step"] for r in on.history] == [1, 2]
    assert on.telemetry.registry.value("train_steps") == 2
    # the checkpoints: the same files and the same keys, compression on or off
    for step in (1, 2):
        a, b = tmp_path / "on" / f"step_{step}", tmp_path / "off" / f"step_{step}"
        assert sorted(os.listdir(a)) == sorted(os.listdir(b))
        ma, mb = (json.loads((d / "MANIFEST.json").read_text()) for d in (a, b))
        assert sorted(ma["index"]) == sorted(mb["index"]) and ma["extra"] == mb["extra"]
