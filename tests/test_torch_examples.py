"""The port's five examples (``src/repro_torch/examples/``) against the JAX
package, on the CPU at small sizes.  The JAX side is built from the
``repro`` calls the JAX scripts (``examples/*.py``) make; the scripts
themselves are not imported (``long_context_fpdt.py`` sets ``XLA_FLAGS``
when it is imported, which would reach later subprocesses).

All in fp32 weights where the two packages are compared step by step:
their bf16 products round differently (the first step's losses 6e-4 apart).

* convergence (Fig. 14): 4 steps of each curve from JAX's initial weights;
  the port's baseline and u=4 curves within 5e-4 of JAX's, and its
  offloaded u=4 curve within 5e-4 of JAX's u=4 curve without offload (the
  JAX offload variant fails on a host without pinned memory, ROADMAP Queue C);
* long context: one 2 x 2 spawn of gloo ranks at seq 256 (JAX's weights,
  shared by every rank as ZeRO-3 shards, and the example's batch): both
  variants' loss within 1e-4 and sum |g| within 1e-3, relative, of JAX's
  single-device ``loss_fn(cfg, None, ...)`` on the same weights and batch;
* fault tolerance: preempted after step 12, resumed to 30, the losses the
  same bits as an uninterrupted port run (the example asserts it), the
  first steps within 5e-4 of JAX's ``TrainLoop`` history;
* quickstart: its config equal to the JAX script's ``quickstart_config()``
  (read from the script's source) field by field, the same parameter
  count, and a 2-step run at seq 32 that writes its checkpoint;
* serve: the workload (prompts, stop token; the tenants, sessions and
  shuffled order) equal to the JAX script's draws; greedy tokens equal to
  the JAX engines' (fused, blocking, paged with a shared prefix) at host KV
  0 in fp32 weights; host-streamed KV the device run's tokens; at
  ``--mesh 1x1 --replicas 2`` each replica's requests and prefix hits, and
  the tokens, equal to JAX's ``ReplicaRouter`` over two paged engines, for
  both routers;
* without ``--device cpu`` and with no card each example stops.
"""
import ast
import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ModelConfig as JModelConfig
from repro.configs import ShapeConfig as JShape, get_config as j_get_config, reduced as j_reduced
from repro.data.pipeline import CheckpointableIterator as JIter, make_batch_fn as j_batch_fn
from repro.launch.router import ReplicaRouter as JRouter
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.runtime import decode_loop as JDL
from repro.runtime import paged as JPG
from repro.runtime import train_loop as JTL
from repro_torch.configs import ShapeConfig
from repro_torch.convert import from_jax_params
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.examples import convergence_fpdt as CV
from repro_torch.examples import fault_tolerance_demo as FT
from repro_torch.examples import long_context_fpdt as LC
from repro_torch.examples import quickstart as QS
from repro_torch.examples import serve_batched as SB

sys.path.insert(0, os.path.dirname(__file__))
import _torch_dist  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
CURVE_TOL = 5e-4
LC_SEQ, LC_CHUNKS = 256, 4
# the parity runs in fp32: bf16 products round differently in the two packages
FP32 = "float32"


def _jax_of(cfg):
    """The JAX package's config with ``cfg``'s fields."""
    return JModelConfig(**dataclasses.asdict(cfg))


def _port_params(jparams):
    return from_jax_params(jax.device_get(jparams), "cpu")


# --- convergence -------------------------------------------------------------


def _jax_curve(cfg, steps, batch_fn):
    """examples/convergence_fpdt.py::run."""
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    oc = JA.OptConfig(lr=1e-3, warmup_steps=5, total_steps=steps)
    opt = JA.init(oc, params)

    @jax.jit
    def step(p, o, b):
        (l, m), g = jax.value_and_grad(lambda p: JT.loss_fn(cfg, None, p, b), has_aux=True)(p)
        p, o, _ = JA.apply(oc, p, g, o)
        return p, o, l

    losses = []
    for i in range(steps):
        params, opt, l = step(params, opt, {k: jnp.asarray(v) for k, v in batch_fn(i).items()})
        losses.append(float(l))
    return losses


def test_convergence_curves_match_jax():
    steps = 4
    jbase = dataclasses.replace(j_reduced(j_get_config("gpt-2.7b")), num_layers=2, block_q=16,
                                block_k=16)
    assert _jax_of(CV.base_config()) == jbase
    base = dataclasses.replace(CV.base_config(), param_dtype=FP32)
    jbase = _jax_of(base)
    cfgs = CV.variant_configs(base)
    jfn = j_batch_fn(jbase, JShape("conv", 64, 4, "train"))
    want = {"baseline": _jax_curve(jbase, steps, jfn),
            "fpdt-u4": _jax_curve(dataclasses.replace(jbase, fpdt_chunks=4), steps, jfn)}
    want["fpdt-u4-offload"] = want["fpdt-u4"]
    jparams = JT.init_params(jbase, jax.random.PRNGKey(0))
    bf = make_batch_fn(base, ShapeConfig("conv", 64, 4, "train"))
    got = {name: CV.run(cfg, steps, bf, _port_params(jparams), CPU) for name, cfg in cfgs.items()}
    for name in cfgs:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=CURVE_TOL, err_msg=name)
    assert all(d < CV.MAX_DEVIATION for d in CV.deviations(got).values())


# --- long context ------------------------------------------------------------


def test_long_context_2x2_matches_jax_single_device(tmp_path):
    base = LC.base_config()
    jbase = _jax_of(base)
    jparams = JT.init_params(jbase, jax.random.PRNGKey(0))
    batch = LC.draw_batch(base, LC_SEQ, CPU)
    assert np.array_equal(batch["tokens"], batch["labels"])  # one key, as JAX draws both
    leaves = jax.tree.leaves(jax.device_get(jparams))
    np.savez(tmp_path / "long_context.npz", tokens=batch["tokens"], chunks=LC_CHUNKS,
             **{f"p{i}": np.asarray(x).view(np.int16) if x.dtype.name == "bfloat16"
                else np.asarray(x) for i, x in enumerate(leaves)})
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(jbase, None, p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True))(jparams)
    want_g = sum(float(jnp.sum(jnp.abs(x.astype(jnp.float32)))) for x in jax.tree.leaves(jg))
    ranks = _torch_dist.run_ranks("long_context", 4, tmp_path)
    assert all(r == ranks[0] for r in ranks)  # every rank checked and holds the same sums
    for name, (loss, gsum) in ranks[0].items():
        np.testing.assert_allclose(loss, float(jl), rtol=LC.LOSS_RTOL, err_msg=name)
        np.testing.assert_allclose(gsum, want_g, rtol=LC.GRAD_RTOL, err_msg=name)


# --- fault tolerance ---------------------------------------------------------


def test_fault_tolerance_resumes_on_the_trajectory(tmp_path):
    jcfg = dataclasses.replace(j_reduced(j_get_config("llama3.2-1b")), num_layers=2)
    assert _jax_of(FT.demo_config()) == jcfg
    cfg = dataclasses.replace(FT.demo_config(), param_dtype=FP32)
    jcfg = _jax_of(cfg)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    out = FT.run(cfg, _port_params(jparams), str(tmp_path / "ckpt"), CPU)
    assert out["reached"] == FT.PREEMPT_AT and out["end"] == 30
    assert out["checkpoints"] == [20, 25, 30]  # keep 3
    assert "persistent outlier" in out["straggler"]
    # JAX's TrainLoop over the script's first steps (its optimizer over 30)
    oc = JA.OptConfig(lr=1e-3, warmup_steps=2, total_steps=30)
    tc = JTL.TrainConfig(steps=3, ckpt_every=5, log_every=5)
    loop = JTL.TrainLoop(jcfg, None, oc, tc, jax.jit(JTL.make_train_step(jcfg, None, oc, tc)),
                         JIter(j_batch_fn(jcfg, JShape("ft", 64, 2, "train"))))
    loop.run(jparams, JA.init(oc, jparams))
    want = [h["loss"] for h in loop.history]
    np.testing.assert_allclose(out["losses"][:len(want)], want, rtol=0, atol=CURVE_TOL)


# --- quickstart --------------------------------------------------------------


def _jax_quickstart_config():
    """``quickstart_config()`` of the JAX script, read from its source and
    built with the JAX package's ModelConfig (the script is not imported)."""
    path = os.path.join(ROOT, "examples", "quickstart.py")
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "quickstart_config")
    scope = {"ModelConfig": JModelConfig}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), scope)
    return scope["quickstart_config"]()


def test_quickstart_config_and_a_short_run(tmp_path, capsys):
    want, got = _jax_quickstart_config(), QS.quickstart_config()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.num_params() == want.num_params()
    out = QS.main(["--device", "cpu", "--steps", "2", "--seq", "32", "--ckpt-dir",
                   str(tmp_path)])
    assert [h["step"] for h in out["history"]] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert out["checkpoints"] == [2]
    assert os.path.exists(tmp_path / "step_2" / "MANIFEST.json")
    assert f"checkpoints: [2] in {tmp_path}" in capsys.readouterr().out


# --- serve -------------------------------------------------------------------

SERVE_FLAGS = ["--slots", "2", "--requests", "5", "--bucket", "16", "--min-prompt", "4",
               "--max-prompt", "24", "--gen", "4", "--segment", "2", "--prefill-chunk", "8",
               "--device", "cpu"]
PAGED_FLAGS = ["--paged", "--shared-prefix", "16", "--page-size", "4"]
MESH_FLAGS = ["--paged", "--mesh", "1x1", "--replicas", "2", "--shared-prefix", "8",
              "--page-size", "4", "--requests", "6"]


@functools.lru_cache(maxsize=None)
def _serve_model():
    """(JAX config, port config, JAX params, port params): the example's
    reduced llama3.2-1b in fp32, where greedy tokens are exact."""
    cfg = dataclasses.replace(SB.serve_config("llama3.2-1b"), param_dtype=FP32)
    jcfg = _jax_of(cfg)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, _port_params(jparams)


def _jax_workload(args, vocab):
    """examples/serve_batched.py's draws for one engine."""
    rng = np.random.default_rng(args.seed)
    shared = rng.integers(0, vocab, size=args.shared_prefix).tolist()
    hi = args.bucket if args.blocking else args.max_prompt
    lens = rng.integers(args.min_prompt, hi + 1, size=args.requests)
    prompts = [shared + rng.integers(0, vocab, size=n).tolist() for n in lens]
    return prompts, int(rng.integers(0, vocab))


def _jax_mesh_workload(args, vocab):
    """examples/serve_batched.py::run_mesh's draws."""
    rng = np.random.default_rng(args.seed)
    npfx = max(args.shared_prefix, 2 * args.page_size)
    tenants = [rng.integers(0, vocab, size=npfx).tolist() for _ in range(max(2, args.replicas))]
    prompts, sessions = [], []
    for i in range(args.requests):
        t = i % len(tenants)
        n = int(rng.integers(args.min_prompt, args.bucket + 1))
        prompts.append(tenants[t] + rng.integers(0, vocab, size=n).tolist())
        sessions.append(f"tenant-{t}")
    order = rng.permutation(len(prompts))
    return [prompts[i] for i in order], [sessions[i] for i in order], npfx


def _jax_engine(args, jcfg, jparams, stop):
    """The JAX script's engine for ``args`` (host KV 0, so no context)."""
    kw = dict(slots=args.slots, bucket=args.bucket + args.shared_prefix,
              max_new_tokens=args.gen, segment=args.segment, n_host_chunks=0,
              sampling=JDL.SamplingConfig(temperature=args.temperature), stop_tokens=(stop,),
              par=None)
    if args.paged:
        return JPG.PagedServeEngine(jcfg, jparams, prefill_chunk=args.prefill_chunk,
                                    page_size=args.page_size, n_pages=args.n_pages, **kw)
    if args.blocking:
        return JDL.BlockingServeEngine(jcfg, jparams, **kw)
    return JDL.ServeEngine(jcfg, jparams, prefill_chunk=args.prefill_chunk, **kw)


@pytest.mark.parametrize("mode", [[], ["--blocking"], PAGED_FLAGS],
                         ids=["fused", "blocking", "paged-shared-prefix"])
def test_serve_matches_jax_engines(mode):
    jcfg, cfg, jparams, tparams = _serve_model()
    args = SB.parse_args(SERVE_FLAGS + mode + ["--host-kv-chunks", "0"])
    prompts, stop = _jax_workload(args, cfg.vocab_size)
    assert SB.workload(args, cfg.vocab_size, np.random.default_rng(args.seed))[0] == prompts
    got = SB.run(args, cfg, tparams, CPU)
    assert got["prompts"] == prompts and got["stop"] == stop
    want = _jax_engine(args, jcfg, jparams, stop).generate(prompts,
                                                           key=jax.random.PRNGKey(args.seed))
    assert got["outs"] == want
    assert all(0 < len(o) <= args.gen for o in want)
    if args.paged:
        assert got["stats"]["prefix_hit_tokens"] > 0
    if not args.blocking:  # host-streamed KV serves the device run's tokens
        host = SB.run(SB.parse_args(SERVE_FLAGS + mode + ["--host-kv-chunks", "4"]), cfg,
                      tparams, CPU)
        assert host["outs"] == got["outs"]
        assert host["stats"]["host_kv_bytes"] > 0


@pytest.mark.parametrize("router", ["affine", "rr"])
def test_serve_mesh_replicas_match_jax_router(router):
    jcfg, cfg, jparams, tparams = _serve_model()
    argv = SERVE_FLAGS + MESH_FLAGS + ["--router", router]
    args = SB.parse_args(argv)
    prompts, sessions, npfx = _jax_mesh_workload(args, cfg.vocab_size)
    got = SB.run_mesh(args, cfg, tparams, CPU, argv)
    assert (got["prompts"], got["sessions"]) == (prompts, sessions)
    engines = [JPG.PagedServeEngine(jcfg, jparams, slots=args.slots, bucket=args.bucket + npfx,
                                    max_new_tokens=args.gen, segment=args.segment,
                                    prefill_chunk=args.prefill_chunk, page_size=args.page_size,
                                    n_pages=args.n_pages, par=None) for _ in range(2)]
    rt = JRouter(engines, policy=router)
    assert got["outs"] == rt.generate(prompts, sessions)
    keys = ("replica", "requests", "prompt_tokens", "prefix_hit_tokens")
    want = [{k: rs.get(k, 0) for k in keys} for rs in rt.last_stats["per_replica"]]
    assert [{k: rs.get(k, 0) for k in keys} for rs in got["per_replica"]] == want
    if router == "affine":  # each tenant's repeats hit its home replica's radix tree
        assert sum(rs["prefix_hit_tokens"] for rs in want) > 0


# --- the card ----------------------------------------------------------------


@pytest.mark.parametrize("mod", [QS, CV, LC, FT, SB], ids=lambda m: m.__name__.split(".")[-1])
def test_examples_refuse_the_cpu_without_the_flag(mod, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.main([])
