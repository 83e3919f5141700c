"""Ranks of the port's distributed tests: gloo on the CPU, torch only.

    python tests/_torch_dist.py <task> <rank> <world> <dir>

A rank joins a world of ``world`` ranks through ``launch/mesh.py::
init_from_env`` (a ``file://`` store in ``dir``), runs ``task`` and writes
what it read to ``dir/<task>-<rank>.json``.  The tasks import torch and the
port only, never JAX: the test files compute the JAX references in their
own process and hand them over as ``dir/<task>.npz``.

``run_ranks`` (for the test files) starts the ranks, joins them within a
timeout and kills every rank when one fails or the time is up, so a hung
collective cannot hold the suite.
"""
from __future__ import annotations

import hashlib
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
JOIN_TIMEOUT = 240  # seconds a spawn may take, its ranks' start included


def _env(**extra) -> dict:
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=str(SRC) + (os.pathsep + path if path else ""),
                OMP_NUM_THREADS="1", **extra)


def _kill_all(procs) -> None:
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
    for p in procs:
        p.wait()


def _tails(logs) -> str:
    return "\n".join(f"--- {log.name}:\n{log.read_text()[-3000:]}" for log in logs)


def wait_all(procs, logs, timeout: float = JOIN_TIMEOUT) -> None:
    """Wait for every process (each the leader of its own session); the
    first to fail, or the deadline, kills them all and raises."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            bad = [p.returncode for p in procs if p.poll() not in (None, 0)]
            if bad:
                raise AssertionError(f"a rank exited with {bad[0]}:\n{_tails(logs)}")
            if time.monotonic() > deadline:
                raise AssertionError(f"ranks still running after {timeout} s:\n{_tails(logs)}")
            time.sleep(0.1)
        bad = [p.returncode for p in procs if p.returncode != 0]
        if bad:
            raise AssertionError(f"a rank exited with {bad[0]}:\n{_tails(logs)}")
    finally:
        _kill_all(procs)


def run_ranks(task: str, world: int, tmp: Path, timeout: float = JOIN_TIMEOUT) -> list:
    """Run ``task`` on ``world`` gloo ranks; returns each rank's readings."""
    procs, logs = [], []
    for r in range(world):
        log = tmp / f"{task}-{r}.log"
        with open(log, "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, task, str(r), str(world), str(tmp)], env=_env(),
                stdout=fh, stderr=subprocess.STDOUT, start_new_session=True))
        logs.append(log)
    wait_all(procs, logs, timeout)
    return [json.loads((tmp / f"{task}-{r}.json").read_text()) for r in range(world)]


def run_cli(argv, tmp: Path, timeout: float = JOIN_TIMEOUT) -> str:
    """The train CLI in a process of its own (it spawns its ranks); returns
    its output.  Its session, ranks included, is killed on a timeout."""
    log = tmp / "cli.log"
    with open(log, "w") as fh:
        proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *argv],
                                env=_env(), stdout=fh, stderr=subprocess.STDOUT,
                                start_new_session=True, cwd=tmp)
    wait_all([proc], [log], timeout)
    return log.read_text()


# ---------------------------------------------------------------------------
# tasks (run in the ranks)
# ---------------------------------------------------------------------------


def _rank_input(torch, rank: int, shape):
    """A tensor any rank can rebuild for any other rank."""
    n = 1
    for s in shape:
        n *= s
    return (torch.arange(n, dtype=torch.float32).reshape(shape) + 1000.0 * rank) / 7.0


def task_parallel(rank: int, world: int, tmp: Path) -> dict:
    """make_mesh(2, 4)'s groups, and each collective on a model group (4
    ranks) and a data group (2 ranks) against what it must give, built
    here from every rank's inputs."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import parallel as P
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(2, 4)
    out = {"ranks": mesh.ranks().tolist(), "data_rank": mesh.data_rank,
           "model_rank": mesh.model_rank,
           "model_group": dist.get_process_group_ranks(mesh.model_group),
           "data_group": dist.get_process_group_ranks(mesh.data_group), "ok": {}}
    b, h, c, d = 2, 8, 3, 5
    for name, group in (("model", mesh.model_group), ("data", mesh.data_group)):
        members = dist.get_process_group_ranks(group)
        sp, me = len(members), members.index(rank)
        xs = [_rank_input(torch, r, (b, h, c, d)) for r in members]
        P.reset_counts()
        heads = P.seq_to_heads(xs[me], group)
        hl = h // sp
        want = torch.cat([x[:, me * hl:(me + 1) * hl] for x in xs], dim=2)
        out["ok"][f"{name} seq_to_heads"] = torch.equal(heads, want) and heads.is_contiguous()
        out["ok"][f"{name} heads_to_seq inverts it"] = torch.equal(
            P.heads_to_seq(heads, group), xs[me])
        gathered = P.gather_seq(xs[me], group)
        out["ok"][f"{name} gather_seq"] = torch.equal(gathered, torch.cat(xs, dim=2))
        full = [_rank_input(torch, r, (b, h, sp * c, d)) for r in members]
        got = P.reduce_scatter_seq(full[me], group)
        out["ok"][f"{name} reduce_scatter_seq"] = torch.allclose(
            got, sum(f[:, :, me * c:(me + 1) * c] for f in full), rtol=1e-6, atol=0)
        y = xs[me].clone()
        out["ok"][f"{name} all_reduce_sum"] = torch.allclose(P.all_reduce_sum(y, group), sum(xs),
                                                             rtol=1e-6, atol=0)
        sent = b * h * c * d * 4
        out["ok"][f"{name} counts"] = (
            P.calls == {"seq_to_heads": 1, "heads_to_seq": 1, "gather_seq": 1,
                        "reduce_scatter_seq": 1, "all_reduce_sum": 1}
            and P.nbytes == {"seq_to_heads": sent, "heads_to_seq": sent, "gather_seq": sent,
                             "reduce_scatter_seq": sp * sent, "all_reduce_sum": sent})
    return out


# kind, hq, hkv; at 12/3 on 4 ranks a rank's 3 q heads straddle 2 kv heads unevenly
FPDT_CASES = (("ulysses", 4, 2), ("ulysses", 8, 4), ("ulysses", 12, 3), ("cp", 6, 6))
FPDT_MESHES = ((1, 4), (2, 2))
FPDT_US = (1, 4)


def fpdt_key(hq: int, hkv: int, u: int) -> str:
    return f"h{hq}-{hkv}-u{u}"


def task_fpdt(rank: int, world: int, tmp: Path) -> dict:
    """fpdt_attention(kind=ulysses | cp) on meshes 1x4 and 2x2 against the
    JAX kind="local" references: this rank's rows and tokens of o and dx,
    and dW summed over the world."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.core import fpdt as F
    from repro_torch.core import parallel as P
    from repro_torch.data.pipeline import token_positions
    from repro_torch.launch.mesh import make_mesh

    ref = np.load(tmp / "fpdt.npz")
    out = {}
    for shape in FPDT_MESHES:
        par = P.ParallelContext(make_mesh(*shape))
        for kind, hq, hkv in FPDT_CASES:
            for u in FPDT_US:
                key = fpdt_key(hq, hkv, u)
                cfg = dataclasses.replace(reduced(get_config("llama3.2-1b")),
                                          param_dtype="float32", num_heads=hq, num_kv_heads=hkv,
                                          fpdt_chunks=u, fpdt_offload=True)
                x, do = ref[f"{key}/x"], ref[f"{key}/do"]
                rows = x.shape[0] // par.dp
                lo = par.dp_rank * rows
                pos = token_positions(x.shape[1], par.sp, par.sp_rank, u)

                def mine(a):
                    return torch.from_numpy(np.ascontiguousarray(a[lo:lo + rows][:, pos]))

                xl = mine(x).requires_grad_(True)
                w = {n: torch.from_numpy(ref[f"{key}/{n}"]).requires_grad_(True)
                     for n in ("wq", "wk", "wv")}
                o = F.fpdt_attention(cfg, par, w, xl, kind=kind)
                (o * mine(do)).sum().backward()
                errs = {"o": float((o.detach() - mine(ref[f"{key}/o"])).abs().max()),
                        "dx": float((xl.grad - mine(ref[f"{key}/dx"])).abs().max())}
                for n, t in w.items():
                    g = P.all_reduce_sum(t.grad.contiguous())
                    errs["d" + n] = float((g - torch.from_numpy(ref[f"{key}/d{n}"])).abs().max())
                out[f"{shape[0]}x{shape[1]} {kind} {key}"] = errs
    return out


TRAIN_CASES = (("llama3.2-1b", "ulysses"), ("llama3.2-1b", "cp"), ("gpt-2.7b", "ulysses"))
TRAIN_B, TRAIN_S, TRAIN_U, TRAIN_STEPS = 2, 32, 2, 2
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)


def train_cfg(cfgs, arch: str, impl: str = "auto"):
    """The config the train cases run, from ``cfgs`` (either package's
    ``configs`` module)."""
    import dataclasses

    return dataclasses.replace(cfgs.reduced(cfgs.get_config(arch)), param_dtype="float32",
                               fpdt_chunks=TRAIN_U, mlp_chunks=2 * TRAIN_U, remat="full",
                               attn_impl=impl)


def _digest(torch, leaves) -> str:
    """sha256 of the leaves' bytes."""
    h = hashlib.sha256()
    for t in leaves:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def task_train(rank: int, world: int, tmp: Path) -> dict:
    """On a 2 x 2 mesh, per case: the world-summed gradients of the first
    batch against JAX's, a TRAIN_STEPS trajectory of make_train_step, and a
    digest of the parameters after it; an rglru arch under sp = 2 raises."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import parallel as P
    from repro_torch.data.pipeline import make_batch_fn, shard_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw as A
    from repro_torch.runtime import train_loop as TL
    from repro_torch.tree import tree_leaves, tree_unflatten

    ref = np.load(tmp / "train.npz")
    par = P.ParallelContext(make_mesh(2, 2))
    out = {}
    for arch, impl in TRAIN_CASES:
        cfg = train_cfg(configs, arch, impl)
        if T.attn_kind(cfg, par) != impl:
            raise AssertionError(f"{arch}: attention kind {T.attn_kind(cfg, par)}, not {impl}")
        like = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        n = len(tree_leaves(like))

        def params():
            return tree_unflatten(like, [torch.from_numpy(ref[f"{arch}/p{i}"].copy())
                                         for i in range(n)])

        batch_fn = make_batch_fn(cfg, ShapeConfig("t", TRAIN_S, TRAIN_B, "train"))

        def local(step):
            return {k: torch.from_numpy(v) for k, v in
                    shard_batch(batch_fn(step), par, cfg.fpdt_chunks).items()}

        loss, _, grads = TL.value_and_grad(cfg, par, params(), local(0))
        grads = tree_leaves(TL.reduce_grads(par, grads))
        rel = 0.0
        for i, g in enumerate(grads):
            want = torch.from_numpy(ref[f"{arch}/g{i}"])
            rel = max(rel, float((g - want).abs().max()) / max(float(want.abs().max()), 1e-30))
        case = f"{arch} {impl}"
        out[case] = {"loss": float(loss), "grad_rel": rel, "steps": []}
        oc = A.OptConfig(**TRAIN_OPT)
        p = params()
        state = A.init(oc, p)
        step = TL.make_train_step(cfg, par, oc, TL.TrainConfig())
        for s in range(TRAIN_STEPS):
            p, state, m = step(p, state, local(s))
            out[case]["steps"].append([float(m["loss"]), float(m["grad_norm"])])
        digests = [None] * world
        dist.all_gather_object(digests, _digest(torch, tree_leaves(p)))
        out[case]["digests"] = digests
    hyb = configs.reduced(configs.get_config("recurrentgemma-9b"))
    zeros = torch.zeros((1, 16), dtype=torch.long)
    try:
        T.loss_fn(hyb, par, T.init_params(hyb, torch.Generator().manual_seed(0), "cpu"),
                  {"tokens": zeros, "labels": zeros})
        out["rglru raises"] = False
    except NotImplementedError as e:
        out["rglru raises"] = "not yet ported" in str(e)
    return out


CUDA_CASES = (("ulysses", 8, 2), ("ulysses", 8, 1), ("cp", 6, 2))  # kind, hq, hkv
CUDA_DTYPES = ("float32", "bfloat16")
CUDA_S, CUDA_U = 1024, 4


def task_fpdt_cuda(rank: int, world: int, tmp: Path) -> dict:
    """On one card that the ranks share (gloo moving CUDA tensors): ulysses
    (KV through the all-to-all, and gathered) and cp on a 1 x world mesh
    against kind="local" on the same card and inputs, with offload on: the
    largest elementwise |got - want| / (1 + |want|) of this rank's o, and
    max |got - want| / max |want| of its dx and of the world-summed dW."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import fpdt as F
    from repro_torch.core import parallel as P
    from repro_torch.data.pipeline import token_positions
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    par = P.ParallelContext(make_mesh(1, world))
    pos = torch.from_numpy(token_positions(CUDA_S, world, rank, CUDA_U)).to(dev)
    out = {}
    for kind, hq, hkv in CUDA_CASES:
        for dtype in CUDA_DTYPES:
            cfg = dataclasses.replace(get_config("llama3.2-1b"), d_model=256, num_heads=hq,
                                      num_kv_heads=hkv, head_dim=64, param_dtype=dtype,
                                      fpdt_chunks=CUDA_U, fpdt_offload=True)
            dt = getattr(torch, dtype)
            g = torch.Generator(device=dev).manual_seed(0)
            w = {n: t for n, t in L.init_attn(cfg, g, dt, dev).items() if n in F.WEIGHTS}
            x = torch.randn((1, CUDA_S, cfg.d_model), generator=g, device=dev).to(dt)
            do = torch.randn((1, CUDA_S, cfg.q_dim), generator=g, device=dev).to(dt)

            def run(par_, kind_, x_, do_):
                xg = x_.clone().requires_grad_(True)
                wg = {n: t.clone().requires_grad_(True) for n, t in w.items()}
                o = F.fpdt_attention(cfg, par_, wg, xg, kind=kind_)
                o.backward(do_)
                return o.detach(), xg.grad, {n: t.grad for n, t in wg.items()}

            o_ref, dx_ref, dw_ref = run(None, "local", x, do)
            o, dx, dw = run(par, kind, x[:, pos].contiguous(), do[:, pos].contiguous())

            def elementwise(a, b):
                return float(((a.float() - b.float()).abs() / (1 + b.float().abs())).max())

            def leaf(a, b):
                return float((a.float() - b.float()).abs().max() / b.float().abs().max())

            errs = {"o": elementwise(o, o_ref[:, pos]), "dx": leaf(dx, dx_ref[:, pos])}
            for n, t in dw.items():
                errs["d" + n] = leaf(P.all_reduce_sum(t.float().contiguous()), dw_ref[n])
            out[f"{kind} h{hq}-{hkv} {dtype}"] = errs
    return out


TASKS = {"parallel": task_parallel, "fpdt": task_fpdt, "train": task_train,
         "fpdt_cuda": task_fpdt_cuda}


def main() -> None:
    task, rank, world, tmp = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      **{mesh.INIT_METHOD_ENV: f"file://{tmp / (task + '.store')}"})
    mesh.init_from_env("gloo")
    try:
        out = TASKS[task](rank, world, tmp)
    finally:
        dist.destroy_process_group()
    (tmp / f"{task}-{rank}.json").write_text(json.dumps(out))


if __name__ == "__main__":
    main()
