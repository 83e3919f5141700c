"""One run of one training cell: set-up, the measured window, the traced
steps, and the comparison with the plain reference.

Set-up makes the weights and the batches from the seed, builds AdamW's
state, and drives the port's training step as its train CLI does
(``repro_torch.launch.train.train_steps``: ``TrainLoop`` over
``make_train_step``), one call for the whole run.  Its first
``ref_steps`` steps are the warm-up and the steps the reference follows:
the loss of each, every leaf's first gradient as AdamW took it (its first
moment after one step over 1 - b1) and every leaf's change over the
steps.  The window starts once they are done: the loop's steps are timed
until ``seconds`` have passed (whole steps: the window ends at the step
that crosses it, after the loop's synchronise).  With ``trace`` the loop
takes ``trace_steps`` more steps under torch.profiler, with the kernel
calls recorded.  Then the program's state is freed and the reference
follows the same steps from the same weights and batches.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from bench import traffic, weights
from bench import yardstick as Y
from bench.reference import common as RC
from bench.spec import Cell, reference

MIN_GRAD_SHARE = 1e-3  # a leaf whose first gradient is under this share of the median leaf's


class WindowClosed(Exception):
    """Raised from the loop's ``on_step`` to end the run's steps."""


@dataclasses.dataclass
class Readings:
    """What a side's first steps give: each step's loss, each leaf's first
    gradient norm (as AdamW took it) and its change over the steps."""

    losses: List[float]
    grad: Dict[str, float]
    change: Dict[str, float]


@dataclasses.dataclass
class Trace:
    """What the per-layer readers read: the traced steps' device and host
    events (times in microseconds of the profiler's clock), the kernel
    calls recorded in them, the offload counters over them, and the
    untraced window's step times."""

    cell: Cell
    steps: int  # traced steps
    window_s: float  # their wall time
    kernels: list  # (name, group, start, end) of every device operation
    host_ops: list  # (name, start, end) of every host event traced (CUDA runtime calls)
    calls: Dict[str, list]  # kernel -> recorded argument tuples
    to_host_bytes: int
    to_device_bytes: int
    window_dts: List[float]  # host-clock seconds of each window step
    step_flops: int

    def group_s(self, group: str) -> float:
        return sum(e - s for _, g, s, e in self.kernels if g == group) / 1e6

    def union_s(self, pred: Callable[[str, str], bool]) -> float:
        return Y.length(Y.merged([(s, e) for n, g, s, e in self.kernels if pred(n, g)])) / 1e6


@dataclasses.dataclass
class Result:
    steps: int
    window_s: float
    setup_s: float
    peak_bytes: int
    program: Readings
    gaps: Dict[str, float]  # empty without the reference
    finite: bool
    trace: Optional[Trace]


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# the program's configuration
# ---------------------------------------------------------------------------


def program_config(cell: Cell):
    """The port's ``ModelConfig``: the registered architecture with the
    configuration's sizes and the cell's way of running it."""
    from repro_torch.configs import get_config

    run = cell.run
    cfg = get_config(cell.config["arch"], **cell.config["model"])
    return dataclasses.replace(cfg, fpdt_chunks=run["fpdt_chunks"], mlp_chunks=run["mlp_chunks"],
                               fpdt_offload=run["offload"], remat=run["remat"])


def skeleton(cfg):
    """The program's parameter tree on the meta device: shapes and dtypes."""
    from repro_torch.models import transformer as T

    return T.init_params(cfg, torch.Generator().manual_seed(0), "meta")


def opt_config(cell: Cell):
    from repro_torch.optim import adamw

    return adamw.OptConfig(**cell.config["optimizer"],
                           state_dtype=cell.config["model"]["opt_state_dtype"])


def _norms(tree, scale: float = 1.0) -> Dict[str, float]:
    return {k: float(v.float().norm()) * scale for k, v in weights.flat(tree).items()}


def _changes(tree, start) -> Dict[str, float]:
    a, b = weights.flat(tree), weights.flat(start)
    return {k: float((a[k].float() - b[k].float()).norm()) for k in a}


# ---------------------------------------------------------------------------
# the traced steps' kernel calls
# ---------------------------------------------------------------------------


class KernelCalls:
    """Records every call of the port's CUDA kernels (their modules'
    functions wrapped while active): flash_fwd (b, hq, hkv, sq, sk, d,
    bytes an input, q_offset, k_offset, window, carry), flash_bwd_dq and
    flash_bwd_dkv (the same, no carry), linear_scan and linear_scan_bwd
    (elements, bytes of a, of b or db, elements of h0)."""

    def __init__(self):
        from repro_torch.kernels.flash_attention import kernel as FK
        from repro_torch.kernels.linear_scan import kernel as SK

        self.calls: Dict[str, list] = {k: [] for k in ("flash_fwd", "flash_bwd_dq",
                                                        "flash_bwd_dkv", "linear_scan",
                                                        "linear_scan_bwd")}
        self._saved = []
        self._targets = [(FK, "flash_fwd", self._attn), (FK, "flash_bwd_dq", self._attn),
                         (FK, "flash_bwd_dkv", self._attn), (SK, "linear_scan", self._scan),
                         (SK, "linear_scan_bwd", self._scan_bwd)]

    def _attn(self, name, q, k, v, *rest, causal=True, window=0, q_offset=0, k_offset=0,
              **kw):
        b, hq, sq, d = q.shape
        carry = name == "flash_fwd" and rest and rest[0] is not None
        self.calls[name].append((b, hq, k.shape[1], sq, k.shape[2], d, q.element_size(),
                                 q_offset, k_offset, window, bool(carry)))

    def _scan(self, name, a, b, h0=None, **kw):
        self.calls[name].append((a.numel(), a.element_size(), b.element_size(),
                                 0 if h0 is None else h0.numel()))

    def _scan_bwd(self, name, a, h, h0, dout, b_dtype, **kw):
        self.calls[name].append((a.numel(), a.element_size(), b_dtype.itemsize,
                                 0 if h0 is None else h0.numel()))

    def __enter__(self):
        for mod, name, rec in self._targets:
            orig = getattr(mod, name)

            def wrapped(*args, _orig=orig, _rec=rec, _name=name, **kw):
                _rec(_name, *args, **kw)
                return _orig(*args, **kw)

            self._saved.append((mod, name, orig))
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self._saved:
            setattr(mod, name, orig)
        self._saved.clear()


def _events(prof):
    """(device operations, host operations) of a finished profile."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            dev.append((e.name, Y.group_of(e.name), s, t))
        elif e.device_type == DeviceType.CPU:
            host.append((e.name, s, t))
    return dev, host


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             reference_prec: Optional[str] = "fp32") -> Result:
    """Set-up, window, traced steps and the reference's steps of ``cell``
    (see the module's docstring); ``t_start`` the host clock at the
    process's start.  ``reference_prec`` None skips the reference."""
    from repro_torch.launch.train import train_steps
    from repro_torch.optim import adamw
    from repro_torch.runtime.placement import host_offload
    from repro_torch.runtime.train_loop import TrainConfig

    device = torch.device(device)
    on_card = device.type == "cuda"
    run, m = cell.run, cell.config["model"]
    n_ref, n_trace = run["ref_steps"], run["trace_steps"]
    cfg = program_config(cell)
    shape = skeleton(cfg)
    params = weights.make(shape, seed, device)
    oc = opt_config(cell)
    opt_state = adamw.init(oc, params)
    batch_fn = traffic.batch_fn(cell.traffic, m["vocab_size"], seed)
    off = host_offload(device)
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    st = {"phase": "warm", "dts": [], "traced": 0}
    prog = Readings([], {}, {})

    def on_step(rec):
        n = rec["step"]
        if not math.isfinite(rec["loss"]):
            st["finite"] = False
        if st["phase"] == "warm":
            prog.losses.append(rec["loss"])
            if n == 1:
                prog.grad = _norms(opt_state.m, 1.0 / (1.0 - oc.b1))
            if n == n_ref:
                start = weights.make(shape, seed, device)
                prog.change = _changes(params, start)
                del start
                sync()
                if on_card:
                    torch.cuda.reset_peak_memory_stats(device)
                st["setup_s"] = time.perf_counter() - t_start
                _log(f"set-up {st['setup_s']:.2f} s; first steps' losses {prog.losses}")
                st["phase"], st["t0"] = "window", time.perf_counter()
            return
        if st["phase"] == "window":
            st["dts"].append(rec["dt"])
            now = time.perf_counter()
            if now - st["t0"] < seconds:
                return
            st["t1"] = now
            st["peak"] = torch.cuda.max_memory_allocated(device) if on_card else 0
            if not trace:
                raise WindowClosed
            st["phase"] = "trace"
            from torch.profiler import ProfilerActivity, profile

            # the device's activity alone: recording every host operation
            # as well slows a step of many small launches by half
            acts = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
            st["prof"] = profile(activities=acts)
            st["calls"] = KernelCalls().__enter__() if on_card else None
            off.reset_counts()
            st["prof"].start()
            st["tt0"] = time.perf_counter()
            return
        st["traced"] += 1
        if st["traced"] == n_trace:
            st["tt1"] = time.perf_counter()
            st["prof"].stop()
            if st["calls"] is not None:
                st["calls"].__exit__()
            raise WindowClosed

    tc = TrainConfig(steps=10 ** 9, ckpt_every=10 ** 9, log_every=10 ** 9)
    try:
        train_steps(cfg, params, oc, tc, batch_fn, device, opt_state=opt_state, on_step=on_step)
    except WindowClosed:
        pass
    else:
        raise RuntimeError("the training loop stopped before the window closed (a straggler "
                           "stop): the run is void")
    steps = len(st["dts"])
    dts = sorted(st["dts"])
    _log(f"window: {steps} steps in {st['t1'] - st['t0']:.3f} s; step s min "
         f"{dts[0]:.4f} median {statistics.median(dts):.4f} max {dts[-1]:.4f}")
    tr = None
    if trace:
        t0 = time.perf_counter()
        dev_ops, host_ops = _events(st["prof"])
        _log(f"trace: {len(dev_ops)} device and {len(host_ops)} host events read in "
             f"{time.perf_counter() - t0:.2f} s")
        calls = st["calls"].calls if st["calls"] is not None else {}
        tr = Trace(cell, n_trace, st["tt1"] - st["tt0"], dev_ops, host_ops, calls,
                   off.to_host_bytes, off.to_device_bytes, st["dts"],
                   Y.model_flops(m, cell.traffic["batch"], cell.traffic["seq"]))
        del st["prof"]
    del params, opt_state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = None
    if reference_prec is not None:
        t0 = time.perf_counter()
        ref = follow_reference(cell, seed, device, reference_prec)
        _log(f"reference ({reference_prec}) {time.perf_counter() - t0:.2f} s; losses {ref.losses}")
    return Result(steps, st["t1"] - st["t0"], st["setup_s"], st["peak"], prog,
                  compare(prog, ref) if ref else {}, st.get("finite", True), tr)


def follow_reference(cell: Cell, seed: int, device, prec: str = "fp32") -> Readings:
    """The plain reference from the same weights over the same first
    ``ref_steps`` batches, at ``prec`` ("fp32"; "fp8" the control)."""
    m = cell.config["model"]
    ref = reference(cell.config["reference"])
    tree = weights.make(skeleton(program_config(cell)), seed, device)
    flat = weights.flat(tree)
    dtypes = {k: v.dtype for k, v in flat.items()}
    params = {k: v.float().clone() for k, v in flat.items()}
    del tree, flat
    bf = traffic.batch_fn(cell.traffic, m["vocab_size"], seed)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in bf(i).items()}
               for i in range(cell.run["ref_steps"])]
    p = RC.Prec(prec)
    with RC.fp32_strict():
        out = RC.follow(lambda w, b: ref.loss(m, w, b, p), params, dtypes,
                        cell.config["optimizer"], batches)
    return Readings(out["losses"], out["grad"], out["change"])


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], keys):
    """(gap, leaf): the largest gap between a leaf's norm on the two sides,
    over the reference's norm of that leaf or of the median leaf, whichever
    is larger."""
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    return max((abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30), k) for k in keys)


def compare(prog: Readings, ref: Readings) -> Dict[str, float]:
    """loss_gap: the largest relative gap of a step's loss; grad_gap and
    change_gap: ``worst_leaf`` of the first gradient and of the change,
    the change over the leaves whose first reference gradient is at least
    MIN_GRAD_SHARE of the median leaf's (the others move by round-off).
    A cell compares those its ``limits`` name."""
    if set(prog.grad) != set(ref.grad):
        raise ValueError("the program's leaves are not the reference's")
    losses = [abs(a - b) / abs(b) for a, b in zip(prog.losses, ref.losses)]
    _log(f"each step's loss gap: {losses}")
    med = statistics.median(ref.grad.values())
    moved = [k for k in ref.grad if ref.grad[k] >= MIN_GRAD_SHARE * med]
    grad, change = worst_leaf(prog.grad, ref.grad, ref.grad), worst_leaf(prog.change,
                                                                           ref.change, moved)
    for what, (gap, k), side in (("grad", grad, prog.grad), ("change", change, prog.change)):
        ref_side = ref.grad if what == "grad" else ref.change
        _log(f"worst {what} leaf {k}: program {side[k]!r}, reference {ref_side[k]!r} (gap {gap!r})")
    return {"loss_gap": max(losses), "grad_gap": grad[0], "change_gap": change[0]}
