"""Training runtime: the step builder and the loop.

``make_train_step`` returns ``step(params, opt_state, batch, residuals=None)
-> (params, opt_state, metrics[, residuals])``: the loss and its gradient
through ``models/transformer.py::loss_fn`` (FPDT attention with its Fig. 7
backward inside), optionally accumulated over ``grad_accum`` micro-batches
in a Python loop with fp32 gradient sums, then one AdamW update (in place).
Under ``compress_grads`` the summed (and averaged) gradients are quantized
to int8 blocks with error feedback before AdamW (``optim/compression.py``,
as the JAX step does; the reported ``grad_norm`` is that of the
dequantized gradients), and the new residuals are returned; the step
refuses to run without residuals then.
Nothing in a step reads a device value on the host; ``TrainLoop``
synchronises the card once after each step, then reads the loss.  For an
MoE model the metrics also hold ``aux``, the load-balancing loss that
``loss_fn`` adds as ``0.01 * aux`` (``loss`` stays the cross-entropy, as
in the JAX package); under ``grad_accum`` ``loss`` is the micro-batches'
mean total (cross-entropy plus ``0.01 * aux``), as the JAX loop reports
it there, and ``aux`` their mean aux.  The loop's history and log line
carry ``aux``.

Under a mesh (``core/parallel.py``) the parameters and AdamW moments are
ZeRO-3 shards (``launch/shardings.py``): each rank differentiates its own
tokens' loss over the world's token count, the model gathers each weight
at use and reduce-scatters its gradient over the axes the weight is split
on, ``reduce_grads`` sums each shard gradient over the axes its leaf is
replicated on, the global norm counts each element once, and AdamW updates
the shards; ranks that hold the same shard hold the same bits.  Under
``grad_accum`` the fp32 sums are of the shard gradients.  The loop ends on
every rank after the same step: a stop asked for on any rank (a signal, a
straggler) is summed over the world after each step.

``TrainLoop`` keeps the JAX package's fault tolerance: a checkpoint (the
parameters, the AdamW state and the data iterator's step) every
``ckpt_every`` steps, before the straggler check; SIGTERM/SIGINT end the
loop after the current step with a blocking final checkpoint; a straggler
ends it with none, as the JAX loop's ``break`` does.

Under ``compress_grads`` the loop creates fp32 zero residuals shaped like
this rank's parameter shards and carries them from step to step.  (The
JAX loop calls its step without residuals, so its ``--compress-grads``
compresses nothing; the port does what the flag and the JAX step's
comment describe.)  The residuals are not checkpointed, since the
checkpoint keeps the JAX package's layout: after a resume they start
again from zero.  ``TrainLoop.telemetry`` (``runtime/telemetry.py``)
records what the JAX loop records, after each step and before the log,
checkpoint and straggler steps: the ``train_step_ms`` histogram, the
``train_steps`` counter, the ``train_loss`` gauge and one ``train.step``
span (step, ``dur_ms``, loss), over the same host-clock interval as the
history's ``dt``.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.core import parallel as P
from repro_torch.core.parallel import ParallelContext
from repro_torch.launch import shardings as SH
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.optim import compression as comp
from repro_torch.runtime import telemetry as TM
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    grad_accum: int = 1
    compress_grads: bool = False  # int8 + error feedback (optim/compression.py)
    straggler_zscore: float = 4.0
    straggler_patience: int = 3


class StragglerAlert(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# step builder
# ---------------------------------------------------------------------------


def value_and_grad(cfg: ModelConfig, par: Optional[ParallelContext], params,
                   batch: Dict[str, torch.Tensor]):
    """(loss, metrics, grads) of ``loss_fn`` at ``params``: loss is
    ``metrics["loss"]`` (the cross-entropy; the gradients are those of the
    total, with an MoE model's ``0.01 * aux``), grads a tree shaped like
    ``params``, each leaf in its parameter's dtype.

    The stacked cycle parameters are differentiated through one leaf a cycle
    (a view of the stack) whose ``.grad`` is that cycle's slice of a zeroed
    stacked buffer, so the backward adds each cycle's gradients into place
    as it finishes the cycle.  Differentiating the stacks themselves (one
    ``unbind`` a leaf) holds every cycle's gradients until the backward
    reaches the first cycle and then stacks them, a second copy of the layer
    gradients at the end of the backward (4.8 GiB at gpt-2.7b) that the JAX
    package's scan does not make.  The sums are the same bits (0 + g).

    Under a mesh ``params`` holds this rank's shards (``launch/
    shardings.py``): the views are of the local stacked shards, each
    cycle's ``reduce_scatter_grads`` lands in its slice of the stacked
    shard gradient (a stack split along its cycles axis is one leaf that
    every cycle's gather adds into), and grads holds the shard gradients,
    each summed over the axes its leaf is split on; ``reduce_grads`` sums
    them over the rest."""
    _, n_cycles, _ = T.layout_of(cfg)
    stacks = tree_leaves(params["cycles"])
    sums = [torch.zeros_like(x) for x in stacks]
    plans = SH.plans_of(cfg, par)
    whole = ([p.splits_cycles for p in tree_leaves(plans["cycles"])] if plans
             else [False] * len(stacks))

    def leaf(x, g):  # a leaf whose .grad the backward adds into in place
        v = x.detach().requires_grad_(True)
        v.grad = g
        return v

    shared = [leaf(x, g) if w else None for x, g, w in zip(stacks, sums, whole)]
    cycles = [tree_unflatten(params["cycles"], [v if w else leaf(x[c], g[c]) for x, g, v, w in
                                                zip(stacks, sums, shared, whole)])
              for c in range(n_cycles)]
    rest = {k: v for k, v in params.items() if k != "cycles"}
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(rest)]
    total, metrics = T.loss_fn(cfg, par, {**tree_unflatten(rest, leaves), "cycles": cycles}, batch)
    inputs = leaves + [v for v in shared if v is not None] + [
        v for cyc in cycles for v, w in zip(tree_leaves(cyc), whole) if not w]
    total.backward(inputs=inputs)
    if any(p.grad is None for p in leaves):
        raise RuntimeError("a parameter outside the layer cycles got no gradient")
    grads = {**tree_unflatten(rest, [p.grad for p in leaves]),
             "cycles": tree_unflatten(params["cycles"], sums)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return metrics["loss"], metrics, grads


def reduce_grads(cfg: ModelConfig, par: Optional[ParallelContext], grads):
    """Each shard gradient summed in place over the axes its leaf is
    replicated on (``shardings.reduce_axes``: one ``all_reduce_sum`` a leaf
    over the data or the model group, or over the world where it is split
    on neither; none where it is split on both), in ``tree_leaves`` order;
    the identity without a mesh."""
    plans = SH.plans_of(cfg, par)
    if plans is None:
        return grads
    for plan, g in zip(tree_leaves(plans), tree_leaves(grads)):
        group = SH.reduce_axes(plan, par)
        if group is not False:
            P.all_reduce_sum(g, group)
    return grads


def make_train_step(cfg: ModelConfig, par: Optional[ParallelContext],
                    oc: adamw.OptConfig, tc: Optional[TrainConfig] = None):
    """(params, opt_state, batch[, residuals]) -> (params, opt_state,
    metrics[, residuals])."""
    tc = tc or TrainConfig()
    plans = SH.plans_of(cfg, par)

    def step(params, opt_state, batch, residuals=None):
        if tc.grad_accum > 1:
            n = tc.grad_accum
            gsum, lsum, asum = None, None, None
            for i in range(n):
                mb = {k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
                      for k, v in batch.items()}
                lval, m, g = value_and_grad(cfg, par, params, mb)
                gsum = (tree_map(lambda x: x.float(), g) if gsum is None
                        else tree_map(lambda s, x: s.add_(x.float()), gsum, g))
                lval = lval + 0.01 * m["aux"] if cfg.num_experts else lval  # the total
                lsum = lval if lsum is None else lsum + lval
                asum = m["aux"] if asum is None else asum + m["aux"]
            grads = tree_map(lambda s: s / n, gsum)
            metrics = {"loss": lsum / n, "aux": asum / n}
        else:
            lval, metrics, grads = value_and_grad(cfg, par, params, batch)
        grads = reduce_grads(cfg, par, grads)
        if tc.compress_grads:
            if residuals is None:
                raise ValueError("compress_grads: the step needs the residuals "
                                 "(optim/compression.py::init_residuals)")
            grads, residuals = comp.tree_quantize_with_feedback_(grads, residuals, par, plans)
        params, opt_state, om = adamw.apply(oc, params, grads, opt_state, par, plans)
        metrics = dict(metrics)
        metrics.update(om)
        out = (params, opt_state, metrics)
        return out + ((residuals,) if residuals is not None else ())

    return step


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


class HeartbeatMonitor:
    """Detects persistent stragglers from per-step wall time."""

    def __init__(self, zscore: float, patience: int):
        self.times: list = []
        self.z = zscore
        self.patience = patience
        self.bad = 0

    def record(self, dt: float) -> None:
        self.times.append(dt)
        hist = self.times[:-1][-100:]
        if len(hist) >= 10:
            mu, sd = float(np.mean(hist)), float(np.std(hist)) + 1e-9
            if (dt - mu) / sd > self.z:
                self.bad += 1
            else:
                self.bad = 0
        if self.bad >= self.patience:
            raise StragglerAlert(
                f"step time {dt:.3f}s is a persistent outlier (mu={np.mean(hist):.3f})")


class TrainLoop:
    """Runs ``step_fn`` over ``data_iter``, checkpointing through
    ``ckpt_mgr`` (``checkpoint/manager.py``; optional); ``on_step(record)``
    (optional) is called after each step, once the card is synchronised.
    Under ``tc.compress_grads`` ``residuals`` holds the error-feedback
    residuals that ``run`` carries (None before it and without the flag)."""

    def __init__(self, cfg, par, oc, tc, step_fn, data_iter, ckpt_mgr=None,
                 on_step: Optional[Callable[[dict], None]] = None):
        self.cfg, self.par, self.oc, self.tc = cfg, par, oc, tc
        self.step_fn = step_fn
        self.data = data_iter
        self.ckpt = ckpt_mgr
        self.on_step = on_step
        self.monitor = HeartbeatMonitor(tc.straggler_zscore, tc.straggler_patience)
        self._stop = False  # a signal asked the loop to stop
        self._straggler = False  # a straggler stopped it
        self.history: list = []
        self.residuals = None
        self.telemetry = TM.Telemetry(component="train")

    def _install_signals(self) -> dict:
        """Route SIGTERM/SIGINT to a stop flag; returns the handlers replaced."""
        def handler(signum, frame):
            self._stop = True

        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, handler)
            except ValueError:
                pass  # not main thread
        return previous

    def run(self, params, opt_state, start_step: int = 0,
            put_batch: Optional[Callable] = None):
        """``put_batch`` turns a numpy batch into tensors on the device (the
        default: CPU tensors)."""
        if put_batch is None:
            put_batch = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}  # noqa: E731
        previous = self._install_signals()
        try:
            return self._run(params, opt_state, start_step, put_batch)
        finally:
            for sig, h in previous.items():
                signal.signal(sig, h)

    def _save(self, step, params, opt_state, blocking=False):
        self.ckpt.save(step, {"params": params, "opt": opt_state},
                       extra={"data_step": self.data.state()}, blocking=blocking)

    def _run(self, params, opt_state, start_step, put_batch):
        step = start_step
        self.data.restore(start_step)
        if self.tc.compress_grads:  # not checkpointed: zero again after a resume
            self.residuals = comp.init_residuals(params)
        while step < self.tc.steps and not (self._stop or self._straggler):
            t0 = time.perf_counter()
            batch = put_batch(next(self.data))
            if self.tc.compress_grads:
                params, opt_state, metrics, self.residuals = self.step_fn(
                    params, opt_state, batch, self.residuals)
            else:
                params, opt_state, metrics = self.step_fn(params, opt_state, batch)
            device = metrics["loss"].device
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            step += 1
            rec = {"step": step, "loss": float(metrics["loss"]),
                   "grad_norm": float(metrics["grad_norm"]), "dt": dt}
            if self.cfg.num_experts:
                rec["aux"] = float(metrics["aux"])
            self.history.append(rec)
            self.telemetry.registry.histogram("train_step_ms").observe(dt * 1e3)
            self.telemetry.registry.counter("train_steps").inc()
            self.telemetry.registry.gauge("train_loss").set(rec["loss"])
            self.telemetry.event("train.step", step=step, dur_ms=dt * 1e3, loss=rec["loss"])
            rank = self.par.rank if self.par is not None else 0
            if step % self.tc.log_every == 0 and rank == 0:
                aux = f" aux {rec['aux']:.4f}" if "aux" in rec else ""
                print(f"step {step:6d} loss {rec['loss']:.4f}{aux} gnorm "
                      f"{rec['grad_norm']:.3f} {dt * 1000:.0f}ms", flush=True)
            if self.ckpt and step % self.tc.ckpt_every == 0:
                self._save(step, params, opt_state)
            try:
                self.monitor.record(dt)
            except StragglerAlert as e:
                print(f"[ft] straggler detected on rank {rank}: {e}; stopping")
                self._straggler = True
            if P.distributed(self.par):  # every rank stops after the same step, for one cause
                flags = torch.tensor([float(self._stop), float(self._straggler)], device=device)
                flags = P.all_reduce_sum(flags).tolist()
                self._stop, self._straggler = flags[0] > 0, flags[1] > 0
            if self.on_step is not None:
                self.on_step(rec)
        if self.ckpt and (self._stop or step >= self.tc.steps):
            # preemption or completion: blocking final save (none after a straggler)
            self._save(step, params, opt_state, blocking=True)
        return params, opt_state, step
