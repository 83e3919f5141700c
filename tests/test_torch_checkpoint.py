"""The port's checkpoint manager (``checkpoint/manager.py``) and the train
loop's and CLI's checkpointing, against the JAX package's.

The JAX package's own cases (tests/test_substrates.py: round trip with
garbage collection, async save, atomicity, end-to-end resume) run on the
port, the resume bit for bit.  The two managers read each other's
checkpoints: one written by the port restores through the JAX manager
with the same bits leaf by leaf (bf16 included), and one written by the
JAX manager from a reduced JAX training (reduced llama3.2-1b, fp32, 2
steps) restores into the port, whose next 2 steps match JAX's within 1e-4
relative (tests/test_torch_train.py's trajectory tolerance), on one rank
here and on 2 x 2 in one spawn of 4 gloo ranks, which also restores a
1 x 4 checkpoint onto 2 x 2 (the parameters and moments the saved bits,
the next step within 5e-4 of the 1 x 4 run's) and onto 1 x 4 (the next
step the same bits as the run that went on).  SIGTERM mid-run ends the
loop with a final checkpoint at the step where it stopped; a straggler
stop writes none.  The train CLI saves every ``--ckpt-every`` steps and
``--resume auto`` continues bit for bit."""
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import CKPT_B, CKPT_OPT, CKPT_S, ckpt_cfg, run_ranks
from repro import configs as jconfigs
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import ShapeConfig as JShape
from repro.core.parallel import ParallelContext as JPar
from repro.data.pipeline import make_batch_fn as j_make_batch_fn
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.runtime import train_loop as JTL
from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.data.pipeline import CheckpointableIterator, make_batch_fn
from repro_torch.launch import train as CLI
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A
from repro_torch.runtime import train_loop as TL
from repro_torch.tree import tree_leaves

JPAR = JPar(mesh=None, attn_impl="xla_flash", offload_to_host=False)
TRAJ_TOL = 1e-4  # tests/test_torch_train.py's trajectory tolerance
MESH_TOL = 5e-4  # another mesh: tests/test_fpdt.py's gradient tolerance


# ------------------------------------------------- the JAX package's own cases


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), shards_per_leaf=3, keep=2)
    tree = {"a": torch.arange(10, dtype=torch.float32).reshape(5, 2),
            "b": {"c": torch.ones((7,), dtype=torch.bfloat16)},
            "s": torch.tensor(3, dtype=torch.int32)}
    for step in (1, 2, 3):
        mgr.save(step, tree, extra={"data_step": step * 10}, blocking=True)
    assert mgr.all_steps() == [2, 3]  # gc keeps last 2
    like = {"a": torch.zeros(5, 2), "b": {"c": torch.zeros(7, dtype=torch.bfloat16)},
            "s": torch.tensor(0, dtype=torch.int32)}
    got, extra = mgr.restore(3, like)
    assert extra["data_step"] == 30
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    w = torch.ones((64, 64))
    mgr.save(5, {"w": w})  # async; the snapshot is a copy taken before save returns
    w.add_(1.0)
    mgr.wait()
    assert mgr.latest_step() == 5
    got, _ = mgr.restore(5, {"w": torch.zeros(64, 64)})
    assert torch.equal(got["w"], torch.ones(64, 64))


def test_checkpoint_atomicity(tmp_path):
    """A .tmp dir (simulated crash) must be invisible to restore."""
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / "step_9.tmp")
    assert mgr.latest_step() is None
    mgr.save(1, {"w": torch.zeros(3)}, blocking=True)
    assert mgr.latest_step() == 1


def _loop_setup():
    cfg = ckpt_cfg(configs)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    oc = A.OptConfig(**CKPT_OPT)
    bf = make_batch_fn(cfg, ShapeConfig("t", CKPT_S, CKPT_B, "train"))
    return cfg, params, oc, bf


def test_train_loop_end_to_end(tmp_path):
    """Checkpoint every 3 steps; a resume from step 3 lands on the
    uninterrupted run's parameters and losses bit for bit."""
    cfg, params, oc, bf = _loop_setup()
    tc = TL.TrainConfig(steps=6, ckpt_every=3, log_every=100)
    step_fn = TL.make_train_step(cfg, None, oc, tc)
    mgr = CheckpointManager(str(tmp_path))
    start = {"params": params, "opt": A.init(oc, params)}
    restore_like = {"params": T.init_params(cfg, torch.Generator().manual_seed(1), "cpu")}
    restore_like["opt"] = A.init(oc, restore_like["params"])
    loop = TL.TrainLoop(cfg, None, oc, tc, step_fn, CheckpointableIterator(bf), mgr)
    params_f, _, step = loop.run(start["params"], start["opt"])
    assert step == 6 and mgr.all_steps() == [3, 6]
    losses = [h["loss"] for h in loop.history]
    assert losses[-1] < losses[0]
    restored, extra = mgr.restore(3, restore_like)
    assert extra["data_step"] == 3 and int(restored["opt"].step) == 3
    loop2 = TL.TrainLoop(cfg, None, oc, tc, step_fn, CheckpointableIterator(bf), None)
    params_r, _, step_r = loop2.run(restored["params"], restored["opt"], start_step=3)
    assert step_r == 6
    assert [h["loss"] for h in loop2.history] == losses[3:]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params_r), tree_leaves(params_f)))


# ------------------------------------------------------- the two managers


def test_port_checkpoint_restores_through_jax(tmp_path):
    """bf16 parameters, fp32 moments, the int32 step: the JAX manager reads
    the port's files back to the same bits, leaf by leaf."""
    cfg = reduced(get_config("llama3.2-1b"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    oc = A.OptConfig(**CKPT_OPT)
    opt = A.init(oc, params)
    bf = make_batch_fn(cfg, ShapeConfig("t", CKPT_S, CKPT_B, "train"))
    batch = {k: torch.from_numpy(v) for k, v in bf(0).items()}
    params, opt, _ = TL.make_train_step(cfg, None, oc, TL.TrainConfig())(params, opt, batch)
    CheckpointManager(str(tmp_path)).save(1, {"params": params, "opt": opt}, blocking=True)
    jcfg = jconfigs.reduced(jconfigs.get_config("llama3.2-1b"))
    jp = JT.init_params(jcfg, jax.random.PRNGKey(1))
    target = {"params": jp, "opt": JA.init(JA.OptConfig(**CKPT_OPT), jp)}
    got, _ = JManager(str(tmp_path)).restore(1, target)
    want = [*tree_leaves(params), opt.step, *tree_leaves(opt.m), *tree_leaves(opt.v)]
    got_leaves = (jax.tree.leaves(got["params"]) + [got["opt"].step]
                  + jax.tree.leaves(got["opt"].m) + jax.tree.leaves(got["opt"].v))
    assert len(got_leaves) == len(want)
    n_bf16 = 0
    for g, w in zip(got_leaves, want):
        g = np.asarray(g)
        assert g.dtype.name == str(w.dtype).replace("torch.", "")
        if w.dtype == torch.bfloat16:
            n_bf16 += 1
            assert np.array_equal(g.view(np.uint16), w.view(torch.int16).numpy().view(np.uint16))
        else:
            assert np.array_equal(g, w.numpy())
    assert n_bf16 > 0


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX: 2 steps, its manager's checkpoint of step 2, then steps 3 and
    4 (loss, grad norm)."""
    tmp = tmp_path_factory.mktemp("ckpt")
    cfg = ckpt_cfg(jconfigs)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    oc = JA.OptConfig(**CKPT_OPT)
    opt = JA.init(oc, params)
    step = jax.jit(JTL.make_train_step(cfg, JPAR, oc, JTL.TrainConfig()))
    bf = j_make_batch_fn(cfg, JShape("t", CKPT_S, CKPT_B, "train"))
    after = []
    for s in range(4):
        params, opt, m = step(params, opt, {k: jnp.asarray(v) for k, v in bf(s).items()})
        if s == 1:
            JManager(str(tmp / "jax_ckpt")).save(2, {"params": params, "opt": opt},
                                                 extra={"data_step": 2}, blocking=True)
        if s >= 2:
            after.append([float(m["loss"]), float(m["grad_norm"])])
    return tmp, after


def test_jax_checkpoint_restores_into_the_port(jax_run):
    tmp, want = jax_run
    cfg = ckpt_cfg(configs)
    oc = A.OptConfig(**CKPT_OPT)
    like = T.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    got, extra = CheckpointManager(str(tmp / "jax_ckpt")).restore(
        2, {"params": like, "opt": A.init(oc, like)})
    assert extra == {"data_step": 2} and int(got["opt"].step) == 2
    step = TL.make_train_step(cfg, None, oc, TL.TrainConfig())
    bf = make_batch_fn(cfg, ShapeConfig("t", CKPT_S, CKPT_B, "train"))
    p, st, out = got["params"], got["opt"], []
    for s in (2, 3):
        p, st, m = step(p, st, {k: torch.from_numpy(v) for k, v in bf(s).items()})
        out.append([float(m["loss"]), float(m["grad_norm"])])
    np.testing.assert_allclose(out, want, rtol=TRAJ_TOL)


@pytest.fixture(scope="module")
def ranks(jax_run):
    tmp, _ = jax_run
    return run_ranks("ckpt", 4, tmp)


def test_jax_checkpoint_restores_onto_2x2(jax_run, ranks):
    _, want = jax_run
    for got in ranks:
        assert got["jax_extra"] == {"data_step": 2}
        np.testing.assert_allclose(got["jax_on_2x2"], want, rtol=TRAJ_TOL)


def test_1x4_checkpoint_restores_onto_2x2(ranks):
    for got in ranks:
        assert got["1x4_extra"] == {"data_step": 2}
        assert got["restored_2x2_same_bits"] and got["restored_2x2_local_shapes"]
        np.testing.assert_allclose(got["2x2_step3"], got["1x4_step3"], rtol=MESH_TOL)


def test_resume_on_the_same_mesh_is_bit_for_bit(ranks):
    for got in ranks:
        assert got["1x4_resumed_step3"] == got["1x4_step3"]
        assert got["1x4_resume_same_bits"]


# ------------------------------------------------------- stops, and the CLI


class _Straggles:
    """A heartbeat monitor that reports a straggler at ``at``."""

    def __init__(self, at):
        self.at, self.n = at, 0

    def record(self, dt):
        self.n += 1
        if self.n == self.at:
            raise TL.StragglerAlert("injected")


@pytest.mark.parametrize("cause", ["sigterm", "straggler"])
def test_stop_mid_run(tmp_path, cause):
    """SIGTERM after step 2 of 5: the loop ends there with a final
    checkpoint of step 2 (its data step 2); a straggler at step 2: it ends
    there and writes none (as the JAX loop's break)."""
    cfg, params, oc, bf = _loop_setup()
    tc = TL.TrainConfig(steps=5, ckpt_every=100, log_every=100)
    mgr = CheckpointManager(str(tmp_path))

    def on_step(rec):
        if cause == "sigterm" and rec["step"] == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    loop = TL.TrainLoop(cfg, None, oc, tc, TL.make_train_step(cfg, None, oc, tc),
                        CheckpointableIterator(bf), mgr, on_step=on_step)
    if cause == "straggler":
        loop.monitor = _Straggles(2)
    _, _, step = loop.run(params, A.init(oc, params))
    assert step == 2
    if cause == "sigterm":
        assert mgr.all_steps() == [2]
        _, extra = mgr.restore(2, {"params": params, "opt": A.init(oc, params)})
        assert extra == {"data_step": 2}
    else:
        assert mgr.all_steps() == []


def test_cli_checkpoints_and_resumes(tmp_path):
    """3 steps with --ckpt-every 2 leave steps 2 and 3; a run resumed from
    step 2 (--resume 2) takes step 3 to the same loss and grad norm, and
    --resume auto finds step 3 and has nothing left to do."""
    argv = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--batch", "2", "--seq",
            "32", "--chunks", "2", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    full = CLI.main(argv + ["--steps", "3"])
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 3]
    resumed = CLI.main(argv + ["--steps", "3", "--resume", "2"])
    assert [r["step"] for r in resumed] == [3]
    assert (resumed[0]["loss"], resumed[0]["grad_norm"]) == (full[2]["loss"],
                                                             full[2]["grad_norm"])
    assert CLI.main(argv + ["--steps", "3", "--resume", "auto"]) == []
