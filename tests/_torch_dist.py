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
# the serve mesh's collectives (core/parallel.py), which no training task calls
SERVE_COLLECTIVES = ("gather_heads", "gather_channels", "gather_state", "gather_rows",
                     "gather_harvest", "gather_pages")


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
        y = xs[me].clone()
        out["ok"][f"{name} all_reduce_max"] = torch.equal(P.all_reduce_max(y, group),
                                                          torch.stack(xs).amax(0))
        # spans [b, u=h, c, d]: rank m's span i lands at i*sp + m; the
        # backward sums each rank's block of the gradient over the group
        mine = xs[me].clone().requires_grad_(True)
        spans = P.gather_spans(mine, group)
        out["ok"][f"{name} gather_spans"] = torch.equal(
            spans, torch.stack(xs, dim=2).reshape(b, h * sp, c, d))
        grads = [_rank_input(torch, r, (b, h * sp, c, d)) for r in members]
        spans.backward(grads[me])
        out["ok"][f"{name} gather_spans adjoint"] = torch.allclose(
            mine.grad, sum(g.reshape(b, h, sp, c, d)[:, :, me] for g in grads), rtol=1e-6, atol=0)
        # integer counts [rows, e]: every rank's, stacked in rank order
        counts = [torch.arange(6, dtype=torch.int32).reshape(3, 2) + 10 * r for r in members]
        out["ok"][f"{name} gather_counts"] = torch.equal(P.gather_counts(counts[me], group),
                                                         torch.stack(counts))
        # a weight's shard [b, h, c, d] split along dim 2: the whole weight
        # is every rank's shard in rank order; the adjoint sums this rank's
        # block of the gradient over the group
        w = xs[me].clone().requires_grad_(True)
        whole = P.gather_params(w, [(2, group)])
        out["ok"][f"{name} gather_params"] = torch.equal(whole, torch.cat(xs, dim=2))
        whole.backward(full[me])
        out["ok"][f"{name} gather_params adjoint"] = torch.allclose(
            w.grad, sum(f[:, :, me * c:(me + 1) * c] for f in full), rtol=1e-6, atol=0)
        # MoE slots [sp*b experts, h, c, d] along dim 0, row i written by
        # rank i % sp alone: the dispatch hands this rank its block of b
        # experts, each row its one writer's bits; its adjoint gathers the
        # gradient in rank order
        rows = torch.arange(sp * b).view(-1, 1, 1, 1) % sp
        props = [_rank_input(torch, r, (sp * b, h, c, d)) for r in members]
        mine = torch.where(rows == me, props[me], 0.0).requires_grad_(True)
        got = P.dispatch_slots(mine, group)
        out["ok"][f"{name} dispatch_slots"] = torch.equal(got, torch.stack(
            [props[i % sp][i] for i in range(me * b, (me + 1) * b)]))
        got.backward(xs[me])
        out["ok"][f"{name} dispatch_slots adjoint"] = torch.equal(mine.grad, torch.cat(xs))
        # the combine gathers every rank's experts' outputs in rank order;
        # its adjoint sums this rank's block of the gradient over the group
        w = xs[me].clone().requires_grad_(True)
        comb = P.combine_slots(w, group)
        out["ok"][f"{name} combine_slots"] = torch.equal(comb, torch.cat(xs))
        comb.backward(props[me])
        out["ok"][f"{name} combine_slots adjoint"] = torch.allclose(
            w.grad, sum(f[me * b:(me + 1) * b] for f in props), rtol=1e-6, atol=0)
        sent = b * h * c * d * 4
        out["ok"][f"{name} counts"] = (
            P.calls == {"seq_to_heads": 1, "heads_to_seq": 1, "gather_seq": 1,
                        "reduce_scatter_seq": 1, "all_reduce_sum": 1, "all_reduce_max": 1,
                        "gather_spans": 1,
                        "reduce_scatter_spans": 1, "gather_counts": 1, "gather_params": 1,
                        "reduce_scatter_grads": 1, "dispatch_slots": 2, "combine_slots": 2,
                        **dict.fromkeys(SERVE_COLLECTIVES, 0)}
            and P.nbytes == {"seq_to_heads": sent, "heads_to_seq": sent, "gather_seq": sent,
                             "reduce_scatter_seq": sp * sent, "all_reduce_sum": sent,
                             "all_reduce_max": sent, "gather_spans": sent,
                             "reduce_scatter_spans": sp * sent,
                             "gather_counts": 24, "gather_params": sent,
                             "reduce_scatter_grads": sp * sent,
                             "dispatch_slots": (sp + 1) * sent,
                             "combine_slots": (sp + 1) * sent,
                             **dict.fromkeys(SERVE_COLLECTIVES, 0)})
    return out


# kind, hq, hkv; at 12/3 on 4 ranks a rank's 3 q heads straddle 2 kv heads unevenly
FPDT_CASES = (("ulysses", 4, 2), ("ulysses", 8, 4), ("ulysses", 12, 3), ("cp", 6, 6))
FPDT_MESHES = ((1, 4), (2, 2))
FPDT_US = (1, 4)
FPDT_OFFLOAD_CASES = (("cp", 6, 6), ("ulysses", 12, 3))  # KV gathered on both meshes


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
                P.reset_counts()
                o = F.fpdt_attention(cfg, par, w, xl, kind=kind)
                (o * mine(do)).sum().backward()
                gathers = [P.calls["gather_seq"], P.nbytes["gather_seq"]]
                errs = {"o": float((o.detach() - mine(ref[f"{key}/o"])).abs().max()),
                        "dx": float((xl.grad - mine(ref[f"{key}/dx"])).abs().max())}
                # copies: all_reduce_sum below sums the gradients in place
                local = [o.detach(), xl.grad] + [t.grad.clone() for t in w.values()]
                for n, t in w.items():
                    g = P.all_reduce_sum(t.grad.contiguous())
                    errs["d" + n] = float((g - torch.from_numpy(ref[f"{key}/d{n}"])).abs().max())
                case = f"{shape[0]}x{shape[1]} {kind} {key}"
                out[case] = errs
                if (kind, hq, hkv) in FPDT_OFFLOAD_CASES and u > 1:
                    # the same call with offload off: the same bits on this
                    # rank, and where the gathers go
                    xo = mine(x).requires_grad_(True)
                    wo = {n: t.detach().clone().requires_grad_(True) for n, t in w.items()}
                    P.reset_counts()
                    oo = F.fpdt_attention(dataclasses.replace(cfg, fpdt_offload=False), par, wo,
                                          xo, kind=kind)
                    (oo * mine(do)).sum().backward()
                    off = [oo.detach(), xo.grad] + [t.grad for t in wo.values()]
                    out["offload " + case] = {
                        "same_bits": all(torch.equal(a, b) for a, b in zip(local, off)),
                        "gather_seq": {"on": gathers,
                                       "off": [P.calls["gather_seq"], P.nbytes["gather_seq"]]}}
    return out


# arch, attention kind (through attn_impl; falcon-mamba-7b has no attention)
TRAIN_CASES = (("llama3.2-1b", "ulysses"), ("llama3.2-1b", "cp"), ("gpt-2.7b", "ulysses"),
               ("recurrentgemma-9b", "ulysses"), ("falcon-mamba-7b", "auto"),
               ("musicgen-medium", "cp"), ("internvl2-2b", "ulysses"))
TRAIN_B, TRAIN_S, TRAIN_U, TRAIN_STEPS = 2, 32, 2, 2
# the vision cases' patches: one model rank's span of a chunk (TRAIN_S / TRAIN_U / 2),
# so on 2 x 2 model rank 0 holds a chunk span of patches only and model rank 1 none
TRAIN_PATCHES = 8
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
CKPT_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def train_cfg(cfgs, arch: str, impl: str = "auto"):
    """The config the train cases run, from ``cfgs`` (either package's
    ``configs`` module)."""
    import dataclasses

    cfg = cfgs.reduced(cfgs.get_config(arch))
    patches = {"num_patches": TRAIN_PATCHES} if cfg.frontend == "vision_patches" else {}
    return dataclasses.replace(cfg, param_dtype="float32", fpdt_chunks=TRAIN_U,
                               mlp_chunks=2 * TRAIN_U, remat="full", attn_impl=impl, **patches)


def _digest(torch, leaves) -> str:
    """sha256 of the leaves' bytes."""
    h = hashlib.sha256()
    for t in leaves:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def task_train(rank: int, world: int, tmp: Path) -> dict:
    """On a 2 x 2 mesh, per case: the world-summed gradients of the first
    batch (the rank's ZeRO-3 shards, gathered) against JAX's, the world's
    labelled tokens (and a vision case's patches on this rank), a TRAIN_STEPS
    trajectory of make_train_step, and a digest of the parameters (gathered
    from the rank's shards) after it; for the recurrent archs, the first
    batch's gradients under remat offload against remat full, bit for
    bit."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import parallel as P
    from repro_torch.data.pipeline import make_batch_fn, shard_batch
    from repro_torch.launch import shardings as SH
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
        if T.has_attention(cfg) and T.attn_kind(cfg, par) != impl:
            raise AssertionError(f"{arch}: attention kind {T.attn_kind(cfg, par)}, not {impl}")
        like = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        n = len(tree_leaves(like))

        def params():  # this rank's shards
            return SH.shard_params(cfg, par, tree_unflatten(
                like, [torch.from_numpy(ref[f"{arch}/p{i}"].copy()) for i in range(n)]))

        batch_fn = make_batch_fn(cfg, ShapeConfig("t", TRAIN_S, TRAIN_B, "train"))

        def local(step):
            return {k: torch.from_numpy(v) for k, v in
                    shard_batch(batch_fn(step), par, cfg.fpdt_chunks).items()}

        first = local(0)
        loss, metrics, grads = TL.value_and_grad(cfg, par, params(), first)
        case = f"{arch} {impl}"
        out[case] = {"tokens": float(metrics["tokens"])}
        if "patch_embeds" in first:  # the patch positions this rank holds
            out[case]["patches"] = first["patch_embeds"].shape[1]
        if not T.has_attention(cfg) or "rglru" in cfg.layer_kinds():
            # remat offload recomputes each cycle, its collectives included,
            # in the backward: the same bits as remat full
            off = TL.value_and_grad(dataclasses.replace(cfg, remat="offload"), par, params(),
                                    local(0))[2]
            out[case]["remat_offload_same_bits"] = all(
                torch.equal(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(off)))
        grads = tree_leaves(SH.gather_params_tree(cfg, par, TL.reduce_grads(cfg, par, grads)))
        rel = 0.0
        for i, g in enumerate(grads):
            want = torch.from_numpy(ref[f"{arch}/g{i}"])
            rel = max(rel, float((g - want).abs().max()) / max(float(want.abs().max()), 1e-30))
        out[case].update(loss=float(loss), grad_rel=rel, steps=[])
        oc = A.OptConfig(**TRAIN_OPT)
        p = params()
        state = A.init(oc, p)
        step = TL.make_train_step(cfg, par, oc, TL.TrainConfig())
        for s in range(TRAIN_STEPS):
            p, state, m = step(p, state, local(s))
            out[case]["steps"].append([float(m["loss"]), float(m["grad_norm"])])
        digests = [None] * world
        dist.all_gather_object(digests, _digest(torch, tree_leaves(
            SH.gather_params_tree(cfg, par, p))))
        out[case]["digests"] = digests
    return out


REC_MESHES = ((1, 4), (2, 2))
REC_US = (1, 4)
REC_B, REC_S = 2, 64  # at 1 x 4 and u = 4, spans of 4 tokens: the conv's halo is 3
REC_MIXERS = ("rglru", "mamba")
REC_ARCH = {"rglru": "recurrentgemma-9b", "mamba": "falcon-mamba-7b"}


def rec_cfg(cfgs, mixer: str, u: int = 1):
    """The config of ``mixer``'s cases, from ``cfgs`` (either package's
    ``configs`` module): the arch's reduced config in fp32 at u chunks."""
    import dataclasses

    return dataclasses.replace(cfgs.reduced(cfgs.get_config(REC_ARCH[mixer])),
                               param_dtype="float32", fpdt_chunks=u)


def task_recurrent(rank: int, world: int, tmp: Path) -> dict:
    """The sequence-parallel recurrent mixers on meshes 1 x 4 and 2 x 2 at u
    in {1, 4}, each rank on its rows and tokens, against the JAX references
    in ``recurrent.npz`` (relative to each reference's largest magnitude):
    ``rglru_mixer`` and ``mamba_mixer`` with and without a state (output,
    new state, dx, every dW and the state's gradients summed over the
    world; the collectives' counts at u = 4), pass 1's summaries and the
    two-pass scans at n = u*sp spans, the conv halo (the tokens at span
    starts apart), and the ValueError of a span shorter than the halo."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.core import parallel as P
    from repro_torch.data.pipeline import token_positions
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import mamba as M
    from repro_torch.models import rglru as R

    ref = np.load(tmp / "recurrent.npz")
    out = {}

    def rel(got, want):
        want = torch.as_tensor(want)
        return float((got.detach() - want).abs().max()) / max(float(want.abs().max()), 1e-30)

    for shape in REC_MESHES:
        par = P.ParallelContext(make_mesh(*shape))
        rows, sp, m = REC_B // par.dp, par.sp, par.sp_rank
        lo = par.dp_rank * rows

        def world_sum_rows(g, full_shape):  # a per-row gradient, summed over the world
            full = torch.zeros(full_shape, dtype=g.dtype)
            full[lo:lo + rows] = g
            return P.all_reduce_sum(full)

        for u in REC_US:
            pos = token_positions(REC_S, sp, m, u)

            def mine(a):
                return torch.from_numpy(np.ascontiguousarray(np.asarray(a)[lo:lo + rows][:, pos]))

            mesh = f"{shape[0]}x{shape[1]} u{u}"
            for mixer in REC_MIXERS:
                cfg = rec_cfg(configs, mixer, u)
                fn = R.rglru_mixer if mixer == "rglru" else M.mamba_mixer
                names = [k[len(f"{mixer}/p/"):] for k in ref.files if k.startswith(f"{mixer}/p/")]
                hkey = "h" if mixer == "rglru" else "ssm"
                for st in ("none", "state"):
                    key = f"{mixer}/{st}"
                    p = {n: torch.from_numpy(ref[f"{mixer}/p/{n}"]).requires_grad_(True)
                         for n in names}
                    x = mine(ref[f"{mixer}/x"]).requires_grad_(True)
                    state = None
                    if st == "state":
                        state = {k: torch.from_numpy(ref[f"{mixer}/{k}"][lo:lo + rows].copy()
                                                     ).requires_grad_(True)
                                 for k in ("conv", hkey)}
                    P.reset_counts()
                    y, new = fn(cfg, p, x, state, par)
                    (y * mine(ref[f"{mixer}/dy"])).sum().backward()
                    counts = {k: [P.calls[k], P.nbytes[k]] for k in P.COLLECTIVES if P.calls[k]}
                    errs = {"y": rel(y, mine(ref[f"{key}/y"])),
                            "dx": rel(x.grad, mine(ref[f"{key}/dx"]))}
                    for k in ("conv", hkey):
                        errs["new_" + k] = rel(new[k], ref[f"{key}/new_{k}"][lo:lo + rows])
                    for n, t in p.items():
                        errs["d" + n] = rel(P.all_reduce_sum(t.grad.contiguous()),
                                            ref[f"{key}/d{n}"])
                    if state is not None:
                        for k, t in state.items():
                            g = world_sum_rows(t.grad, ref[f"{mixer}/{k}"].shape)
                            errs["dstate_" + k] = rel(g, ref[f"{key}/dstate_{k}"])
                    out[f"{mesh} {key}"] = {"errs": errs, "counts": counts, "rows": rows}

            # the scans alone at n = u*sp spans: pass 1's summaries of this
            # rank's spans, and the two passes (its tokens, the last state)
            n = u * sp
            a, b = mine(ref["rscan/a"]), mine(ref["rscan/b"])
            summ = R.span_summaries(a, b, torch.log(a), u)
            ch = a.shape[-1]
            errs = {"log_A": rel(summ[..., :ch], ref[f"rscan/n{n}/log_A"][lo:lo + rows, m::sp]),
                    "h_loc": rel(summ[..., ch:], ref[f"rscan/n{n}/h_loc"][lo:lo + rows, m::sp])}
            h0 = torch.from_numpy(ref["rscan/h0"][lo:lo + rows].copy())
            h, h_last = R.dist_linear_scan(a, b, torch.log(a), h0, par, u)
            errs2 = {"h": rel(h, mine(ref[f"rscan/n{n}/h"])),
                     "h_last": rel(h_last, ref[f"rscan/n{n}/h"][lo:lo + rows, -1])}
            out[f"{mesh} rglru summaries"], out[f"{mesh} rglru two-pass"] = errs, errs2
            xc, dt, Bm, Cm = (mine(ref[f"mscan/{k}"]) for k in ("xc", "dt", "B", "C"))
            A_log = torch.from_numpy(ref["mscan/A_log"])
            summ = M.span_summaries(xc, dt, A_log, Bm, u)
            di = xc.shape[-1]
            errs = {"sum_dt": rel(summ[..., :di],
                                  ref[f"mscan/n{n}/sum_dt"][lo:lo + rows, m::sp]),
                    "h_loc": rel(summ[..., di:].reshape(rows, u, di, -1),
                                 ref[f"mscan/n{n}/h_loc"][lo:lo + rows, m::sp])}
            h0 = torch.from_numpy(ref["mscan/h0"][lo:lo + rows].copy())
            y, h_last = M.selective_scan_dist(xc, dt, A_log, Bm, Cm, h0, par, u)
            errs2 = {"y": rel(y, mine(ref[f"mscan/n{n}/y"])),
                     "h_last": rel(h_last, ref[f"mscan/n{n}/h_last"][lo:lo + rows])}
            out[f"{mesh} mamba summaries"], out[f"{mesh} mamba two-pass"] = errs, errs2

            # the conv halo: every token, and the k - 1 at each span's start
            # (whose halo came from the span before, on another rank)
            x = mine(ref["conv/x"]).requires_grad_(True)
            w, bias = torch.from_numpy(ref["conv/w"]), torch.from_numpy(ref["conv/b"])
            state = torch.from_numpy(ref["conv/state"][lo:lo + rows].copy())
            y, new = M.causal_conv1d_spans(x, w, bias, state, par, u)
            y.backward(mine(ref["conv/dy"]))
            k, c = w.shape[0], REC_S // u // sp
            starts = [i * c + t for i in range(u) for t in range(k - 1)]
            want = mine(ref["conv/y"])
            out[f"{mesh} conv"] = {"y": rel(y, want),
                                   "y_span_starts": rel(y[:, starts], want[:, starts]),
                                   "new_state": rel(new, ref["conv/new_state"][lo:lo + rows]),
                                   "dx": rel(x.grad, mine(ref["conv/dx"]))}

    par = P.ParallelContext(make_mesh(1, world))
    cfg = rec_cfg(configs, "rglru", 4)
    p = {k[len("rglru/p/"):]: torch.from_numpy(ref[k]) for k in ref.files
         if k.startswith("rglru/p/")}
    short = torch.zeros((1, 4 * (cfg.d_conv - 2), cfg.d_model))  # spans of d_conv - 2 tokens
    try:
        R.rglru_mixer(cfg, p, short, None, par)
        out["short span"] = ""
    except ValueError as e:
        out["short span"] = str(e)
    dist.barrier()
    return out


# reduced granite-moe-1b-a400m (top-2) at b 2, s 64, u 2: label, mesh,
# mlp_chunks, experts.  At mlp_chunks 2 a MoE chunk is an FPDT chunk (32
# tokens of each row) and its one group of 64 tokens spans the model ranks
# (1x4) or the data and model ranks (2x2); at 8 a MoE chunk is exactly one
# rank's 8-token span of both rows, so every group is local.  4 experts
# split over the model ranks (expert parallelism); 6 do not split over 4,
# so the stacks stay whole on every model rank.
MOE_CASES = (("1x4", (1, 4), 2, 4), ("2x2", (2, 2), 2, 4), ("1x4 local", (1, 4), 8, 4),
             ("1x4 e6", (1, 4), 2, 6))
MOE_B, MOE_S, MOE_U = 2, 64, 2


def moe_cfg(cfgs, mlp_chunks: int, remat: str = "full", experts: int = 4):
    """The config of the MoE cases, from ``cfgs`` (either package's
    ``configs`` module)."""
    import dataclasses

    return dataclasses.replace(cfgs.reduced(cfgs.get_config("granite-moe-1b-a400m")),
                               param_dtype="float32", fpdt_chunks=MOE_U, mlp_chunks=mlp_chunks,
                               remat=remat, num_experts=experts)


def _expert_parallel(cfg, sp: int) -> bool:
    """The expert stacks' e split over sp > 1 model ranks (``param_spec``)."""
    return sp > 1 and cfg.num_experts > 0 and cfg.num_experts % sp == 0


def reckon_zero(cfg, dp: int, sp: int, step: bool = False) -> dict:
    """{name: [calls, bytes]} of gather_params, reduce_scatter_grads and
    all_reduce_sum in one value_and_grad + reduce_grads under remat full on
    a rank of a dp x sp mesh (``step``: a whole train step, with the global
    norm's sums), from the plans.

    A gather sends the rank's shard over data, then what it has over model;
    its adjoint sends the whole gradient over model, then what is left over
    data.  A cycle's leaf is gathered twice a cycle (the checkpoint's pass
    and the recompute, a view of its cycle, or the whole stack where its
    cycles axis is split) and reduce-scattered once; the tied table twice
    (lookup and head), every other leaf once.  Under expert parallelism an
    expert stack (wu, wg, wd of an MoE block) is gathered and
    reduce-scattered over data only: the rank runs its e/sp experts.  Each
    leaf replicated on an axis is all-reduced once (over the world where it
    is split on neither); loss_fn sums (loss, count[, aux]) once; the
    step's global norm sums 8 bytes over data and 4 over model where the
    axis has ranks."""
    import math

    from repro_torch.launch import shardings as SH
    from repro_torch.models import transformer as T

    _, n_cycles, _ = T.layout_of(cfg)
    calls = dict.fromkeys(("gather_params", "reduce_scatter_grads", "all_reduce_sum"), 0)
    nbytes = dict(calls)
    for names, plan in SH.by_path(SH.param_plans(cfg, dp, sp)).items():
        full = math.prod(plan.shape) * plan.dtype.itemsize
        local = plan.local_bytes()
        uses = 1
        if names.startswith("cycles/"):
            uses = n_cycles
            if not plan.splits_cycles:
                full, local = full // n_cycles, local // n_cycles
        elif names == "embed" and cfg.tie_embeddings:
            uses = 2
        passes = 2 if names.startswith("cycles/") else 1
        path = names.split("/")
        expert = "moe" in path and path[-1] in ("wu", "wg", "wd")
        if plan.data_split:
            calls["gather_params"] += passes * uses
            nbytes["gather_params"] += passes * uses * local
            calls["reduce_scatter_grads"] += uses
            nbytes["reduce_scatter_grads"] += uses * (full // sp if plan.model_split else full)
        if plan.model_split and not (expert and _expert_parallel(cfg, sp)):
            calls["gather_params"] += passes * uses
            nbytes["gather_params"] += passes * uses * local * (dp if plan.data_split else 1)
            calls["reduce_scatter_grads"] += uses
            nbytes["reduce_scatter_grads"] += uses * full
        if (dp > 1 and not plan.data_split) or (sp > 1 and not plan.model_split):
            calls["all_reduce_sum"] += 1
            nbytes["all_reduce_sum"] += plan.local_bytes()
    calls["all_reduce_sum"] += 1
    nbytes["all_reduce_sum"] += 12 if cfg.num_experts else 8
    if step:
        calls["all_reduce_sum"] += (dp > 1) + (sp > 1)
        nbytes["all_reduce_sum"] += 8 * (dp > 1) + 4 * (sp > 1)
    return {k: [calls[k], nbytes[k]] for k in calls}


def reckon_slots(cfg, dp: int, sp: int, B: int, S: int, data_rank: int) -> dict:
    """{name: [calls, bytes]} of dispatch_slots and combine_slots in one
    value_and_grad under remat full on a rank of data rank ``data_rank`` of
    a dp x sp mesh, global batch [B, S] (none without expert parallelism).
    Each MoE layer of a cycle runs, on every rank, each chunk's backward
    once and its forward three times (the cycle's pass, the cycle's
    recompute, the chunk's recompute), but the last chunk's twice: the
    cycle's recompute (a non-reentrant checkpoint's, which stops early once
    it has rebuilt what the cycle's pass saved) ends before it.  A forward
    dispatches the slots [e, G, cap, d] of the G groups that the model
    group's rows of the chunk touch (sent whole) and combines e/sp
    experts' (sent: a sp-th); each backward the other way round."""
    import math

    from repro_torch.models import transformer as T

    out = {"dispatch_slots": [0, 0], "combine_slots": [0, 0]}
    if not _expert_parallel(cfg, sp):
        return out
    _, n_cycles, tail = T.layout_of(cfg)
    n = cfg.mlp_chunks if cfg.mlp_chunks > 1 and S % cfg.mlp_chunks == 0 else 1
    L, b = S // n, B // dp
    tg = min(512, B * L)
    first = data_rank * b * L
    groups = (first + b * L - 1) // tg - first // tg + 1
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = max(4, min(math.ceil(tg * k / e * cfg.moe_capacity_factor), tg))
    full = e * groups * cap * cfg.d_model * (4 if cfg.param_dtype == "float32" else 2)
    assert not tail, "a tail layer runs two forwards: not reckoned here"
    fwd = n_cycles * (3 * n - 1)
    out["dispatch_slots"] = [fwd + n_cycles * n, fwd * full + n_cycles * n * full // sp]
    out["combine_slots"] = [fwd + n_cycles * n, fwd * full // sp + n_cycles * n * full]
    return out


def task_moe(rank: int, world: int, tmp: Path) -> dict:
    """Per MOE_CASES case: the first batch's loss, aux and world-summed
    gradients (the rank's ZeRO-3 shards, gathered) against JAX's
    (``moe.npz``), the calls and bytes of that value_and_grad's
    gather_counts, slot collectives, gather_params and
    reduce_scatter_grads, a digest of the parameters (gathered from the
    rank's shards) after one train step; on 1x4, remat offload's gradients
    against remat full's bit for bit (the recompute reruns the counts'
    gather and the slot exchanges)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import parallel as P
    from repro_torch.data.pipeline import make_batch_fn, shard_batch
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw as A
    from repro_torch.runtime import train_loop as TL
    from repro_torch.tree import tree_leaves, tree_unflatten

    ref = np.load(tmp / "moe.npz")
    out = {}
    for label, shape, chunks, experts in MOE_CASES:
        par = P.ParallelContext(make_mesh(*shape))
        cfg = moe_cfg(configs, chunks, experts=experts)
        like = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        n = len(tree_leaves(like))

        def params():  # this rank's shards
            return SH.shard_params(cfg, par, tree_unflatten(
                like, [torch.from_numpy(ref[f"{label}/p{i}"].copy()) for i in range(n)]))

        batch_fn = make_batch_fn(cfg, ShapeConfig("t", MOE_S, MOE_B, "train"))
        batch = {k: torch.from_numpy(v)
                 for k, v in shard_batch(batch_fn(0), par, cfg.fpdt_chunks).items()}
        P.reset_counts()
        loss, metrics, grads = TL.value_and_grad(cfg, par, params(), batch)
        case = {"loss": float(loss), "aux": float(metrics["aux"]),
                **{k: [P.calls[k], P.nbytes[k]] for k in (
                    "gather_counts", "dispatch_slots", "combine_slots", "gather_params",
                    "reduce_scatter_grads")}}
        if label == "1x4":
            off = TL.value_and_grad(dataclasses.replace(cfg, remat="offload"), par, params(),
                                    batch)[2]
            case["remat_offload_same_bits"] = all(
                torch.equal(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(off)))
        rel = 0.0
        for i, g in enumerate(tree_leaves(SH.gather_params_tree(
                cfg, par, TL.reduce_grads(cfg, par, grads)))):
            want = torch.from_numpy(ref[f"{label}/g{i}"])
            rel = max(rel, float((g - want).abs().max()) / max(float(want.abs().max()), 1e-30))
        case["grad_rel"] = rel
        oc = A.OptConfig(**TRAIN_OPT)
        p = params()
        p, _, _ = TL.make_train_step(cfg, par, oc, TL.TrainConfig())(p, A.init(oc, p), batch)
        digests = [None] * world
        dist.all_gather_object(digests, _digest(torch, tree_leaves(
            SH.gather_params_tree(cfg, par, p))))
        case["digests"] = digests
        out[label] = case
    return out


ZERO_CASES = (("llama3.2-1b", (2, 2)), ("llama3.2-1b", (1, 4)),
              ("granite-moe-1b-a400m", (2, 2)), ("granite-moe-1b-a400m", (1, 4)))
# 4 layers: the MoE router's stack [4, d, e] has its cycles axis split over
# model on both meshes (param_spec's expert rule), so it is gathered whole
ZERO_B, ZERO_S, ZERO_U, ZERO_LAYERS, ZERO_STEPS = 2, 64, 2, 4, 2


def zero_cfg(cfgs, arch: str, remat: str = "full"):
    """The config of the ZeRO-3 cases, from ``cfgs`` (either package's
    ``configs`` module)."""
    import dataclasses

    return dataclasses.replace(cfgs.reduced(cfgs.get_config(arch)), num_layers=ZERO_LAYERS,
                               param_dtype="float32", fpdt_chunks=ZERO_U,
                               mlp_chunks=2 * ZERO_U, remat=remat)


def task_zero(rank: int, world: int, tmp: Path) -> dict:
    """Per ZERO_CASES case, on its mesh: what the rank holds after
    init_params and adamw.init (each leaf its plan's local shape, the
    shard of the one-rank initialisation, the bytes the plan reckons); the
    first batch's gradients (gathered) against JAX's (``zero.npz``) and
    the port's one-rank gradients, remat offload's against remat full's bit
    for bit, the gather_params / reduce_scatter_grads / all_reduce_sum
    calls and bytes of the value_and_grad with reduce_grads and of a whole
    train step; a ZERO_STEPS trajectory (loss, grad norm) and the
    parameters after it (gathered) against the port's one-rank run."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import parallel as P
    from repro_torch.data.pipeline import make_batch_fn, shard_batch
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw as A
    from repro_torch.runtime import train_loop as TL
    from repro_torch.tree import tree_leaves, tree_unflatten

    ref = np.load(tmp / "zero.npz")
    counted = ("gather_params", "reduce_scatter_grads", "all_reduce_sum", "dispatch_slots",
               "combine_slots")
    out = {}
    for arch, shape in ZERO_CASES:
        par = P.ParallelContext(make_mesh(*shape))
        cfg = zero_cfg(configs, arch)
        plans = SH.plans_of(cfg, par)
        oc = A.OptConfig(**TRAIN_OPT)
        case = {}
        # what a rank holds
        whole = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        mine = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu", par)
        opt = A.init(oc, mine)
        held = [*tree_leaves(mine), opt.step, *tree_leaves(opt.m), *tree_leaves(opt.v)]
        locals_ = [p.local_shape() for p in tree_leaves(plans)]
        case["state_is_shards"] = (
            [tuple(x.shape) for x in tree_leaves(mine)] == locals_
            and [tuple(x.shape) for x in tree_leaves(opt.m)] == locals_
            and all(torch.equal(a, b) for a, b in zip(
                tree_leaves(mine), tree_leaves(SH.shard_params(cfg, par, whole))))
            and sum(x.numel() * x.element_size() for x in held)
            == SH.state_bytes(plans, torch.float32))
        case["shard_gather_identity"] = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(SH.gather_params_tree(cfg, par, mine)), tree_leaves(whole)))
        n = len(tree_leaves(whole))

        def jax_params():  # whole, fresh: shard() hands an unsplit leaf on as it is
            return tree_unflatten(whole, [torch.from_numpy(ref[f"{arch}/p{i}"].copy())
                                          for i in range(n)])

        full = jax_params()
        batch_fn = make_batch_fn(cfg, ShapeConfig("t", ZERO_S, ZERO_B, "train"))

        def local(step):
            return {k: torch.from_numpy(v) for k, v in
                    shard_batch(batch_fn(step), par, cfg.fpdt_chunks).items()}

        def glob(step):
            return {k: torch.from_numpy(v) for k, v in batch_fn(step).items()}

        # the first batch's gradients
        _, _, one = TL.value_and_grad(cfg, None, full, glob(0))
        P.reset_counts()
        loss, _, grads = TL.value_and_grad(cfg, par, SH.shard_params(cfg, par, full), local(0))
        grads = TL.reduce_grads(cfg, par, grads)
        case["grad_counts"] = {k: [P.calls[k], P.nbytes[k]] for k in counted}
        off = TL.value_and_grad(dataclasses.replace(cfg, remat="offload"), par,
                                SH.shard_params(cfg, par, full), local(0))[2]
        off = TL.reduce_grads(cfg, par, off)
        case["remat_offload_same_bits"] = all(
            torch.equal(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(off)))
        gathered = tree_leaves(SH.gather_params_tree(cfg, par, grads))
        case["loss"] = float(loss)
        case["grad_rel_jax"] = max(
            float((g - torch.from_numpy(ref[f"{arch}/g{i}"])).abs().max())
            / max(float(np.abs(ref[f"{arch}/g{i}"]).max()), 1e-30)
            for i, g in enumerate(gathered))
        case["grad_rel_one_rank"] = max(
            float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for g, w in zip(gathered, tree_leaves(one)))
        # the steps, on the mesh and on one rank
        step = TL.make_train_step(cfg, par, oc, TL.TrainConfig())
        p = SH.shard_params(cfg, par, jax_params())
        state = A.init(oc, p)
        case["steps"] = []
        for s in range(ZERO_STEPS):
            P.reset_counts()
            p, state, m = step(p, state, local(s))
            if s == 0:
                case["step_counts"] = {k: [P.calls[k], P.nbytes[k]] for k in counted}
            case["steps"].append([float(m["loss"]), float(m["grad_norm"])])
        one_step = TL.make_train_step(cfg, None, oc, TL.TrainConfig())
        q = jax_params()
        qs = A.init(oc, q)
        case["one_rank_steps"] = []
        for s in range(ZERO_STEPS):
            q, qs, m = one_step(q, qs, glob(s))
            case["one_rank_steps"].append([float(m["loss"]), float(m["grad_norm"])])
        case["param_rel_one_rank"] = max(
            float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(tree_leaves(SH.gather_params_tree(cfg, par, p)), tree_leaves(q)))
        out[f"{arch} {shape[0]}x{shape[1]}"] = case
    return out


CKPT_B, CKPT_S, CKPT_U = 2, 32, 2


def ckpt_cfg(cfgs):
    """The config of the checkpoint cases, from ``cfgs`` (either package's
    ``configs`` module): reduced llama3.2-1b in fp32."""
    import dataclasses

    return dataclasses.replace(cfgs.reduced(cfgs.get_config("llama3.2-1b")),
                               param_dtype="float32", fpdt_chunks=CKPT_U,
                               mlp_chunks=2 * CKPT_U, remat="full")


def task_ckpt(rank: int, world: int, tmp: Path) -> dict:
    """The checkpoint manager on meshes: the JAX manager's step-2
    checkpoint (``tmp/jax_ckpt``) restored onto 2 x 2, then steps 3 and 4;
    a 1 x 4 run that saves step 2 (async, then takes step 3 before the
    writer is joined) restored onto 2 x 2 (the gathered parameters and
    moments against the ones saved, bit for bit; step 3 against the 1 x 4
    run's) and onto 1 x 4 again (step 3 the same bits as the run that went
    on)."""
    import torch

    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import parallel as P
    from repro_torch.data.pipeline import make_batch_fn, shard_batch
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw as A
    from repro_torch.runtime import train_loop as TL
    from repro_torch.tree import tree_leaves

    cfg = ckpt_cfg(configs)
    oc = A.OptConfig(**CKPT_OPT)
    batch_fn = make_batch_fn(cfg, ShapeConfig("t", CKPT_S, CKPT_B, "train"))
    meshes = {"2x2": P.ParallelContext(make_mesh(2, 2)), "1x4": P.ParallelContext(make_mesh(1, 4))}

    def fresh(par):
        p = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu", par)
        return {"params": p, "opt": A.init(oc, p)}

    def steps(par, state, first, last):
        fn = TL.make_train_step(cfg, par, oc, TL.TrainConfig())
        p, st, out = state["params"], state["opt"], []
        for s in range(first, last):
            b = {k: torch.from_numpy(v) for k, v in
                 shard_batch(batch_fn(s), par, cfg.fpdt_chunks).items()}
            p, st, m = fn(p, st, b)
            out.append([float(m["loss"]), float(m["grad_norm"])])
        return {"params": p, "opt": st}, out

    def whole(par, state):  # every leaf gathered, copies
        g = lambda t: [x.clone() for x in tree_leaves(SH.gather_params_tree(cfg, par, t))]  # noqa
        return g(state["params"]) + [state["opt"].step.clone()] + g(state["opt"].m) + g(
            state["opt"].v)

    out = {}
    par = meshes["2x2"]
    mgr = CheckpointManager(str(tmp / "jax_ckpt"), cfg=cfg, par=par)
    state, extra = mgr.restore(2, fresh(par))
    out["jax_extra"] = extra
    out["jax_on_2x2"] = steps(par, state, 2, 4)[1]

    par = meshes["1x4"]
    state, _ = steps(par, fresh(par), 0, 2)
    saved = whole(par, state)
    mgr = CheckpointManager(str(tmp / "ckpt14"), cfg=cfg, par=par)
    mgr.save(2, state, extra={"data_step": 2})  # async: step 3 updates the tensors in place
    state, out["1x4_step3"] = steps(par, state, 2, 3)
    mgr.wait()
    went_on = whole(par, state)

    par = meshes["2x2"]
    back, extra = CheckpointManager(str(tmp / "ckpt14"), cfg=cfg, par=par).restore(
        2, fresh(par))
    out["1x4_extra"] = extra
    out["restored_2x2_same_bits"] = all(torch.equal(a, b) for a, b in
                                        zip(whole(par, back), saved))
    out["restored_2x2_local_shapes"] = [list(x.shape) for x in tree_leaves(back["params"])] == [
        list(p.local_shape()) for p in tree_leaves(SH.plans_of(cfg, par))]
    out["2x2_step3"] = steps(par, back, 2, 3)[1]

    par = meshes["1x4"]
    back, _ = CheckpointManager(str(tmp / "ckpt14"), cfg=cfg, par=par).restore(2, fresh(par))
    again, out["1x4_resumed_step3"] = steps(par, back, 2, 3)
    out["1x4_resume_same_bits"] = all(torch.equal(a, b) for a, b in
                                      zip(whole(par, again), went_on))
    return out


# The compression cases: the quantizer on every leaf of the ZeRO-3 cases'
# plans (reduced llama3.2-1b and granite at ZERO_LAYERS layers) and on
# hand-made leaves whose blocks straddle a data split, a model split and
# both (and one whose shards hold whole blocks), on 2 x 2; then COMPRESS_STEPS
# compressed steps of reduced llama3.2-1b on 2 x 2.
COMPRESS_ARCHS = ("llama3.2-1b", "granite-moe-1b-a400m")
# name: (shape, dtype, data_dim, model_dim) on 2 x 2
COMPRESS_LEAVES = {"data": ((6, 3002), "bfloat16", 1, None),
                   "model": ((10, 1000), "float32", None, 1),
                   "both": ((8, 12, 300), "float32", 1, 2),
                   "aligned": ((6, 4096), "bfloat16", 1, None)}
COMPRESS_STEPS = 2


def compress_leaves(cfgs, plans_fn):
    """name -> (shape, dtype name, data_dim, model_dim) of every leaf the
    quantizer case runs: the ZeRO-3 cases' parameter leaves (``plans_fn(cfg)``
    their plans' leaves, each with its (shape, data_dim, model_dim)) and
    COMPRESS_LEAVES.  Every other leaf's gradient is bf16."""
    out = {}
    for arch in COMPRESS_ARCHS:
        for i, (shape, ddim, mdim) in enumerate(plans_fn(zero_cfg(cfgs, arch))):
            out[f"{arch}/{i}"] = (tuple(shape), "bfloat16" if i % 2 else "float32", ddim, mdim)
    out.update(COMPRESS_LEAVES)
    return out


def task_compress(rank: int, world: int, tmp: Path) -> dict:
    """On 2 x 2: each leaf of ``compress_leaves`` quantized from this rank's
    shard of the whole gradient and residual (``compress.npz``) by
    ``quantize_with_feedback_sharded``, and all of them at once by
    ``tree_quantize_with_feedback_`` (the step's), each against the shard
    of JAX's whole-leaf ``quantize_with_feedback`` bit for bit, with the
    all_reduce_max calls and bytes of the tree call; then COMPRESS_STEPS
    compressed steps of reduced llama3.2-1b from JAX's weights: (loss,
    grad norm) a step, the all_reduce_max counts of the first, and the
    parameters after them (gathered, on rank 0)."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import parallel as P
    from repro_torch.data.pipeline import make_batch_fn, shard_batch
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw as A
    from repro_torch.optim import compression as C
    from repro_torch.runtime import train_loop as TL
    from repro_torch.tree import tree_leaves, tree_unflatten

    ref = np.load(tmp / "compress.npz")
    par = P.ParallelContext(make_mesh(2, 2))
    leaves = compress_leaves(configs, lambda cfg: [
        (p.shape, p.data_dim, p.model_dim) for p in tree_leaves(SH.param_plans(cfg, 2, 2))])
    names = sorted(leaves)
    plans, g, r, want = [], [], [], []
    for name in names:
        shape, dtype, ddim, mdim = leaves[name]
        plan = SH.LeafPlan(shape, getattr(torch, dtype), 2, 2, ddim, mdim)
        key = name.replace("/", "_")
        plans.append(plan)
        g.append(SH.shard(plan, torch.from_numpy(ref[f"{key}/g"]).to(plan.dtype), par))
        r.append(SH.shard(plan, torch.from_numpy(ref[f"{key}/r"]), par))
        want.append((SH.shard(plan, torch.from_numpy(ref[f"{key}/g_hat"]).to(plan.dtype), par),
                     SH.shard(plan, torch.from_numpy(ref[f"{key}/r_new"]), par)))
    out = {"one_leaf": {}, "straddling": {}}
    for name, plan, a, b, (wa, wb) in zip(names, plans, g, r, want):
        got = C.quantize_with_feedback_sharded(plan, a, b, par)
        out["one_leaf"][name] = (torch.equal(got[0], wa) and torch.equal(got[1], wb)
                                 and got[0].dtype == wa.dtype)
        out["straddling"][name] = SH.straddling_blocks(plan, C.BLOCK)
    P.reset_counts()
    gt, rt = [x.clone() for x in g], [x.clone() for x in r]
    C.tree_quantize_with_feedback_(gt, rt, par, plans)
    out["tree_counts"] = [P.calls["all_reduce_max"], P.nbytes["all_reduce_max"]]
    out["tree"] = all(torch.equal(a, wa) and torch.equal(b, wb)
                      for a, b, (wa, wb) in zip(gt, rt, want))

    cfg = zero_cfg(configs, "llama3.2-1b")
    whole = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    n = len(tree_leaves(whole))
    p = SH.shard_params(cfg, par, tree_unflatten(whole, [
        torch.from_numpy(ref[f"step/p{i}"].copy()) for i in range(n)]))
    oc = A.OptConfig(**TRAIN_OPT)
    state, res = A.init(oc, p), C.init_residuals(p)
    step = TL.make_train_step(cfg, par, oc, TL.TrainConfig(compress_grads=True))
    batch_fn = make_batch_fn(cfg, ShapeConfig("t", ZERO_S, ZERO_B, "train"))
    out["steps"] = []
    for s in range(COMPRESS_STEPS):
        b = {k: torch.from_numpy(v) for k, v in
             shard_batch(batch_fn(s), par, cfg.fpdt_chunks).items()}
        P.reset_counts()
        p, state, m, res = step(p, state, b, res)
        if s == 0:
            out["step_counts"] = [P.calls["all_reduce_max"], P.nbytes["all_reduce_max"]]
        out["steps"].append([float(m["loss"]), float(m["grad_norm"])])
    gathered = tree_leaves(SH.gather_params_tree(cfg, par, p))
    if rank == 0:
        np.savez(tmp / "compress-params.npz", *[x.numpy() for x in gathered])
    return out


CUDA_CASES = (("ulysses", 8, 2), ("ulysses", 8, 1), ("cp", 6, 2))  # kind, hq, hkv
CUDA_DTYPES = ("float32", "bfloat16")
CUDA_S, CUDA_U = 1024, 4


def task_fpdt_cuda(rank: int, world: int, tmp: Path) -> dict:
    """On one card that the ranks share (gloo moving CUDA tensors): ulysses
    (KV through the all-to-all, and gathered) and cp on a 1 x world mesh
    against kind="local" on the same card and inputs, with offload on: the
    largest elementwise |got - want| / (1 + |want|) of this rank's o, and
    max |got - want| / max |want| of its dx and of the world-summed dW; the
    pinned host bytes the distributed call held at most, beside those of
    its q chunks and of its own and of the gathered KV chunks."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import fpdt as F
    from repro_torch.core import parallel as P
    from repro_torch.data.pipeline import token_positions
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.runtime.placement import host_offload

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
            off = host_offload(dev)
            torch.cuda.synchronize()
            off.reset_counts()
            held = off.held_bytes
            o, dx, dw = run(par, kind, x[:, pos].contiguous(), do[:, pos].contiguous())
            torch.cuda.synchronize()
            # per chunk a rank's q (its c tokens, or under ulysses all C
            # tokens of its hq/sp heads: the same bytes) and k, v
            chunk = CUDA_S // CUDA_U // world * cfg.head_dim * (4 if dtype == "float32" else 2)
            host = {"peak": off.peak_held_bytes - held, "q": CUDA_U * cfg.num_heads * chunk,
                    "kv_own": CUDA_U * 2 * cfg.num_kv_heads * chunk,
                    "kv_gathered": CUDA_U * 2 * cfg.num_kv_heads * world * chunk}

            def elementwise(a, b):
                return float(((a.float() - b.float()).abs() / (1 + b.float().abs())).max())

            def leaf(a, b):
                return float((a.float() - b.float()).abs().max() / b.float().abs().max())

            errs = {"o": elementwise(o, o_ref[:, pos]), "dx": leaf(dx, dx_ref[:, pos])}
            for n, t in dw.items():
                errs["d" + n] = leaf(P.all_reduce_sum(t.float().contiguous()), dw_ref[n])
            out[f"{kind} h{hq}-{hkv} {dtype}"] = {"errs": errs, "host": host}
    return out


# ---------------------------------------------------------------------------
# serving over a mesh
# ---------------------------------------------------------------------------

# label, arch, config overrides, engine ("paged" or "dense"), engine keywords,
# workload: the cells of tests/distributed/check_serve_mesh.py on a 2 x 2 mesh
SERVE_CELLS = (
    ("paged-heads", "llama3.2-1b", {}, "paged", {"page_size": 8, "n_pages": 24}, "twice"),
    ("paged-inpage", "llama3.2-1b", {"num_kv_heads": 1}, "paged",
     {"page_size": 4, "n_pages": 48}, "twice"),
    ("dense-heads", "llama3.2-1b", {}, "dense", {}, "once"),
    ("dense-seq", "llama3.2-1b", {"num_kv_heads": 1}, "dense", {}, "once"),
    ("spill", "llama3.2-1b", {}, "paged", {"page_size": 8, "n_pages": 8, "spill_pages": 16},
     "spill"),
    ("granite", "granite-moe-1b-a400m", {}, "paged", {"page_size": 8, "n_pages": 24}, "once"),
    ("sampled", "llama3.2-1b", {}, "paged", {"page_size": 8, "n_pages": 24}, "sampled"),
    # d_inner over model; the hybrid's local_attn ring (hkv 1) by position
    ("ssm-paged", "falcon-mamba-7b", {}, "paged", {"page_size": 8, "n_pages": 24}, "once"),
    ("hybrid-dense", "recurrentgemma-9b", {}, "dense", {}, "once"),
    # the pool parked (kv heads over model), dense host KV by position
    ("paged-host", "llama3.2-1b", {}, "paged", {"page_size": 8, "n_pages": 24, "n_host_chunks": 2},
     "once"),
    ("dense-host", "llama3.2-1b", {"num_kv_heads": 1}, "dense", {"n_host_chunks": 2}, "once"),
)
SERVE_STORES = ("paged-heads", "paged-inpage")  # the cells whose prefix store crosses meshes
SERVE_KW = {"slots": 2, "bucket": 16, "max_new_tokens": 4, "prefill_chunk": 8, "segment": 2}
SERVE_STEP_TOKENS = 8  # the direct steps' prefill chunk a row
SERVE_TEMPERATURE = 0.8
STORE_SPILL = 32  # the spill tier a restored store lands in
# the replica tier on 2 replicas of 1 x 2: tests/test_faults.py's engines
FAULT_KW = {"slots": 2, "bucket": 24, "max_new_tokens": 4, "page_size": 4, "segment": 1,
            "spill_pages": 32}


def serve_cfg(cfgs, arch: str, over=()):
    """A serve cell's config from ``cfgs`` (either package's): reduced, fp32."""
    import dataclasses

    return dataclasses.replace(cfgs.reduced(cfgs.get_config(arch)), param_dtype="float32",
                               remat="none", **dict(over))


def serve_prompts(vocab: int, workload: str = "once"):
    """check_serve_mesh.py's prompts (two sharing a 12-token prefix, one
    apart); for the spill workload also its three evictors."""
    import numpy as np

    rng = np.random.default_rng(0)
    shared = rng.integers(2, vocab - 1, 12).tolist()
    out = [shared + rng.integers(2, vocab - 1, 4).tolist(),
           shared + rng.integers(2, vocab - 1, 4).tolist(),
           rng.integers(2, vocab - 1, 9).tolist()]
    if workload != "spill":
        return out, []
    rng = np.random.default_rng(7)
    return out, [rng.integers(2, vocab - 1, 16).tolist() for _ in range(3)]


def serve_step_inputs(vocab: int, page_size: int):
    """The direct steps' inputs: a chunk of SERVE_STEP_TOKENS tokens a row
    from offset 0, and a page table mapping each row's pages apart."""
    import numpy as np

    k = SERVE_STEP_TOKENS // page_size + 1  # the chunk's pages and the decode token's
    table = np.array([[s * k + j for j in range(k)] + [-1] for s in range(2)], np.int64)
    toks = np.random.default_rng(3).integers(2, vocab - 1, (2, SERVE_STEP_TOKENS))
    return toks, table


def fault_workload(vocab: int, seed: int = 0):
    """tests/test_faults.py's session_workload."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(0, vocab, 8)]
    return ([shared + [int(t) for t in rng.integers(0, vocab, 8)] for _ in range(4)],
            [f"tenant-{s}" for s in range(4)])


def task_serve_mesh(rank: int, world: int, tmp: Path) -> dict:
    """The SERVE_CELLS on a 2 x 2 mesh (weights and JAX's tokens from
    ``serve_mesh.npz``/``serve_mesh.json``): each engine's tokens, its
    cache's leaves (shapes, bytes) on this rank, the serve collectives'
    calls and bytes with the chunk and decode steps taken, the direct
    steps' logits of this rank's rows; the paged cells' store saved on the
    mesh and a JAX-written one restored; then 2 replicas of 1 x 2 with
    rank 0 routing through the CLI's proxies: the seeded crash."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.core import parallel as P
    from repro_torch.launch import faults as F
    from repro_torch.launch import kvstore as KV
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import router as R
    from repro_torch.launch import serve as CLI
    from repro_torch.models import serve as SV
    from repro_torch.models import transformer as T
    from repro_torch.runtime import decode_loop as DL
    from repro_torch.runtime import paged as PG
    from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_unflatten

    ref = np.load(tmp / "serve_mesh.npz")
    want = json.loads((tmp / "serve_mesh.json").read_text())
    steps = {"chunk": 0, "decode": 0}
    chunk_step, decode_step = SV.chunk_step, SV.decode_step
    log = {"on": False, "steps": []}  # the chunk steps' logits of their live rows

    def counted(fn, kind):
        def run(*a, **k):
            steps[kind] += 1
            out = fn(*a, **k)
            if log["on"] and kind == "chunk":
                sh, live = k.get("shard"), a[6]
                r0 = sh.r0 if sh is not None else 0
                log["steps"].append({str(r0 + i): out[0][i].tolist()
                                     for i in range(live.shape[0]) if live[i] > 0})
            return out
        return run

    def logged(fn):
        """``fn()``'s result and its chunk steps' logits, by global row."""
        log.update(on=True, steps=[])
        try:
            res = fn()
        finally:
            log["on"] = False
        return res, log["steps"]

    SV.chunk_step, SV.decode_step = counted(chunk_step, "chunk"), counted(decode_step, "decode")

    def params_of(label, cfg):
        like = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        n = len(tree_leaves(like))
        return tree_unflatten(like, [torch.from_numpy(ref[f"{label}/p{i}"].copy())
                                     for i in range(n)])

    def leaves(cache):
        return {"/".join(p): [list(x.shape), x.numel() * x.element_size()]
                for p, x in tree_leaves_with_path(cache)}

    par = MESH.serve_mesh(2, 2)
    out = {}
    for label, arch, over, kind, ekw, workload in SERVE_CELLS:
        cfg = serve_cfg(configs, arch, over)
        params = params_of(label, cfg)
        prompts, evictors = serve_prompts(cfg.vocab_size, workload)
        kw = dict(SERVE_KW)
        sampled = workload == "sampled"
        if sampled:
            kw["sampling"] = DL.SamplingConfig(temperature=SERVE_TEMPERATURE)

        def engine(p=par, **extra):
            return (PG.PagedServeEngine(cfg, params, par=p, **kw, **ekw, **extra)
                    if kind == "paged" else DL.ServeEngine(cfg, params, par=p, **kw, **ekw))

        def gen():
            return torch.Generator().manual_seed(0) if sampled else None

        eng = engine()
        P.reset_counts()
        steps.update(chunk=0, decode=0)
        work = {"twice": [prompts] * 2, "spill": [prompts, evictors, prompts]}.get(workload,
                                                                                [prompts])

        def serve(e):
            runs, dispatches = [], 0
            for w in work:
                runs.append(e.generate(w, generator=gen()))
                dispatches += e.last_stats["dispatches"]
            return runs, dispatches

        (runs, dispatches), logits = logged(lambda: serve(eng))
        cell = {"tokens": runs, "steps": dict(steps), "dispatches": dispatches,
                "counts": {k: [P.calls[k], P.nbytes[k]] for k in SERVE_COLLECTIVES},
                "stats": {k: v for k, v in eng.last_stats.items() if isinstance(v, (int, float))}}
        if kind == "paged":
            cell["cache"] = leaves(eng._pool)
        else:
            P_, S_ = eng._capacity(prompts)
            cell["cache"] = leaves(eng._begin(SERVE_KW["slots"], P_, S_))
            cell["capacity"] = S_
        if sampled:  # the one-rank port engine from the same generator state
            cell["one_rank"] = engine(None).generate(prompts, generator=gen())
        if label in SERVE_STORES:
            n = eng.save_kv_store(str(tmp / f"{label}-mesh.npz"))
            fresh = engine(spill_pages=STORE_SPILL)
            cell["store"] = {"saved": n,
                             "restored": fresh.restore_kv_store(str(tmp / f"{label}-jax.npz"))}
            cell["store"]["tokens"], restored = logged(lambda: fresh.generate(prompts))
            cell["store"]["hits"] = fresh.last_stats["prefix_hit_tokens"]
            # the runs (the second a full cover) and the restored run beside
            # a one-rank engine's: every chunk step's logits
            one = engine(None, spill_pages=STORE_SPILL)
            one.restore_kv_store(str(tmp / f"{label}-jax.npz"))
            cell["logits"] = {"mesh": [logits, restored],
                              "one": [logged(lambda: serve(engine(None)))[1],
                                      logged(lambda: one.generate(prompts))[1]]}
        # the direct steps, this rank's rows against JAX's at 1e-5
        ps, nh = ekw.get("page_size", 0), ekw.get("n_host_chunks", 0)
        sh = SV.Shard(par, 2, ps)
        toks, table = serve_step_inputs(cfg.vocab_size, ps or SERVE_STEP_TOKENS)
        r0, r1 = sh.r0, sh.r1
        tab = torch.from_numpy(table) if ps else None
        cache = (SV.init_paged_cache(cfg, 2, 8, ps, "cpu", par=par, host=bool(nh)) if ps else
                 SV.init_cache(cfg, 2, SERVE_STEP_TOKENS + 4, "cpu", par=par))
        live = torch.full((r1 - r0,), SERVE_STEP_TOKENS)
        lg, cache = SV.chunk_step(cfg, par, params, cache, torch.from_numpy(toks[r0:r1]),
                                  torch.zeros(r1 - r0, dtype=torch.long), live, n_host_chunks=nh,
                                  table=tab, shard=sh, host_table=table)
        lg2, _ = SV.decode_step(cfg, par, params, cache,
                                {"tokens": lg.argmax(-1, keepdim=True)},
                                torch.full((r1 - r0,), SERVE_STEP_TOKENS), n_host_chunks=nh,
                                table=tab, shard=sh, host_table=table)
        cell["step"] = {"rows": [r0, r1], "chunk": lg.tolist(), "decode": lg2.tolist()}
        out[label] = cell

    # a recurrent layout on the dense engine (ssm-paged's weights and prompts)
    rcfg = serve_cfg(configs, "falcon-mamba-7b")
    out["recurrent"] = DL.ServeEngine(rcfg, params_of("ssm-paged", rcfg), par=par,
                                      **SERVE_KW).generate(serve_prompts(rcfg.vocab_size)[0])

    # the replica tier: 2 replicas of 1 x 2, rank 0 routing
    cfg = serve_cfg(configs, "llama3.2-1b")
    params = params_of("paged-heads", cfg)
    rpar = MESH.serve_mesh(1, 2, replicas=2)
    ctl = [dist.new_group(sorted({0, *range(r * 2, (r + 1) * 2)})) for r in range(2)]
    rep = CLI.MeshReplica(PG.PagedServeEngine(cfg, params, par=rpar, **FAULT_KW))
    me = rank // 2
    if rank != 0:
        CLI._serve_commands(rep, ctl[me], me * 2)
        return out
    prompts, sessions = fault_workload(cfg.vocab_size)
    proxies = [CLI.RankProxy(ctl[r], r * 2, rep if r == 0 else None) for r in range(2)]
    rt = R.ReplicaRouter(proxies, max_retries=1, kv_store=KV.SharedKVStore(str(tmp / "shared")),
                         warn=lambda m: None)
    victim = rt.home_of(prompts[0], sessions[0])
    rt.replicas[victim] = F.FaultyReplica(proxies[victim], [F.Fault("raise", 1)])
    rounds = [rt.generate(prompts, sessions=sessions) for _ in range(2)]
    fo = rt.last_stats["failover"]
    for px in proxies:
        px.stop()
    out["replicas"] = {"victim": victim, "rounds": rounds,
                       "failover": {k: fo[k] for k in ("deaths", "rehomed_requests",
                                                       "rehomed_sessions", "recovered_pages",
                                                       "recovered_prefix_tokens")},
                       "telemetry": [px.telemetry.component for px in proxies]}
    return out


TASKS = {"parallel": task_parallel, "fpdt": task_fpdt, "train": task_train,
         "recurrent": task_recurrent, "fpdt_cuda": task_fpdt_cuda, "moe": task_moe,
         "zero": task_zero, "ckpt": task_ckpt, "compress": task_compress,
         "serve_mesh": task_serve_mesh}


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
