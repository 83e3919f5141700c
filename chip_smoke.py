#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to account.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:
  1. device   — the card's name and power limit (nvidia-smi) and torch's name;
  2. build    — nvcc builds the hand-written CUDA kernels for sm_90a from the
                checkout's sources, one nvcc per source, started together:
                flash_fwd (flash_attention/csrc/flash_fwd.cu), flash_bwd_dq
                and flash_bwd_dkv (flash_attention/csrc/flash_bwd.cu),
                linear_scan and linear_scan_bwd (linear_scan/csrc/linear_scan.cu);
                ptxas' registers
                and spills, and the count of tensor-core instructions
                (HMMA/HGMMA in cuobjdump -sass) of every flash kernel: each
                bf16 (tensor-core) instantiation (flash_fwd_tc,
                flash_bwd_dq_tc, flash_bwd_dkv_tc) must have some and spill
                nothing;
  3. kernel   — flash_fwd against its plain PyTorch version (ref.attend_chunk)
                on the card: fp32 and bf16, head_dim 16/64/80/128/256, GQA and
                MQA (MHA at 80, gpt-2.7b's), ragged lengths, carry-in with
                offsets, windows, fully
                masked rows, the serve shapes and every (i, j <= i) chunk pair
                of a 2048 prompt at u = 4, those pairs also against the plain
                version rounded where the bf16 kernel rounds (TOL_TC);
  4. backward — flash_bwd_dq and flash_bwd_dkv against their plain versions
                (ref.chunk_bwd_dq / chunk_bwd_dkv) on the same kinds of cases
                (bf16 dq, dk, dv from the tensor-core kernels at the bf16
                tolerance),
                and at the training paths' shapes: every (i, j <= i) pair of an
                8192 prompt at u = 4 for llama3.2-1b (2048 x 2048, b1 hq32 hkv8
                d64) and gpt-2.7b (b1 hq32 hkv32 d80), the 7 live pairs of
                recurrentgemma-9b's (b1 hq16 hkv1 d256, window 2048) and the
                8192 x 8192 pair of u = 1 (held at b1 hq4 hkv1 so that the
                plain version's [sq, sk] fp32 matrices fit), and the
                distributed path's shapes in fp32 and bf16 (cp's 1024 query
                rows against a 2048-token key chunk, the diagonal pair at
                q_offset - k_offset 0 and 1024; ulysses' hq16 hkv4 at
                2048 x 2048), and the head layouts of the archs registered
                last (NEW_LAYOUTS: musicgen-medium hq24 hkv24 d64,
                internvl2-2b hq16 hkv8 d128, qwen1.5-4b hq20 hkv20 d128,
                yi-34b hq56 hkv8 d128, mistral-nemo-12b hq32 hkv8 d128),
                one diagonal 2048 x 2048 pair each in fp32 and bf16 (bf16
                also against the rounding emulations); flash_fwd is held
                against its plain version at those same pairs, with carry and
                offsets; at the u = 4 pairs the bf16 flash_fwd, flash_bwd_dq
                and flash_bwd_dkv are also held against the plain version
                rounded where they round (TOL_TC); two launches of the bf16
                flash_bwd_dq, and two of flash_bwd_dkv, at every training
                pair give the same bits;
  4b. scan    — linear_scan against its plain version (ref.linear_scan):
                fp32 and bf16, h0 given and absent, ragged seq and chan, b > 1,
                a near +1 and -1, seq 1, forward and reverse, the training
                shape [1, 8192, 4096]; the fused linear_scan_bwd against its
                plain version (ref.linear_scan_bwd) at the training shape in
                fp32 and bf16 and a ragged case, and bit for bit against the
                unfused chain it replaces (the forward kernel in reverse mode
                over a copied a_next, then torch's multiply and cast); two
                launches of each kernel bit for bit, and again behind a side
                stream that keeps the SMs busy; the op's backward against
                autograd of the plain version at a reduced length; at the
                selective scan's block [1, 256, 131072] with h0 and a =
                exp(dt A) in (0, 1] (falcon-mamba-7b's d_inner x d_state
                channels), the forward relative to (1 + max |h|), the fused
                backward, and two launches of each bit for bit;
  5. serve    — llama3.2-1b, recurrentgemma-9b (38 layers), falcon-mamba-7b
                (64 layers), granite-moe-1b-a400m (24 layers, the MoE
                FFN), musicgen-medium (48 layers, audio frames: its prompt
                64 frame embeddings, its decode a per-token loop on fresh
                random frames) and internvl2-2b (24 layers, vision
                patches: 256 patch embeddings and 64 tokens), each at full
                size with random weights from a
                seeded generator, through the CLI's own function
                (serve_batch): batch 4, prompt 64, gen 32, greedy; the launch
                counts are reset just before and read just after, and each
                kernel the arch's blocks run (flash_fwd for attention,
                linear_scan for RG-LRU and Mamba) must have launched,
                flash_fwd once a live chunk pair of each attention layer.
                With attention, a 2048-position prompt whose prefill logits at
                fpdt_chunks=4 must equal fpdt_chunks=1.  Then, the bf16
                weights released, decode's first step against a prefill of
                one more token (musicgen: the frame decode is fed) in fp32
                weights (an MoE model at a capacity
                that drops no pair, where routing is per token), and a
                changed first prompt token (frame) must move those logits;
  6. train    — llama3.2-1b at full width (random bf16 weights from a seeded
                generator, fp32 AdamW state): 3 steps at batch 1, seq 8192,
                fpdt_chunks 4, mlp_chunks 8, remat full, host offload on,
                through the CLI's own function (train_steps), the launch
                counts read around each step; then one step each with
                offload on and off under torch.profiler: device time by
                kernel group, idle share, and the share of the offload
                copies that ran under a compute kernel.  Offload on and off give the
                same loss and gradients bit for bit; the offloaded chunks are
                pinned host tensors; in fp32 weights the loss and every
                gradient leaf at u = 4 are within 5e-4 of u = 1;
  6a. CLI     — the train CLI's main in this process on llama3.2-1b as 6
                trains it, with --compress-grads --trace-out --metrics-out:
                the trace's train.step spans (their durations the history's
                dt) and the Prometheus series, B1-B3's launches as 6's,
                step 1's loss 6's bits, the residuals' bytes (4 a
                parameter), the peak beside its reckoning, the quantizer's
                device ms (CUDA events), steps 2-3 beside 6's; the
                quantizer on the card against the CPU, bit for bit, at
                llama's and granite's tables, a norm stack and a short leaf;
  6b. hybrid  — recurrentgemma-9b at full width and 8 layers (two stacked
                (rglru, rglru, local_attn) cycles and a 2-layer rglru tail;
                random bf16 weights from a seeded generator): the same as 6 —
                offload on vs off bit for bit, 3 steps through train_steps with
                the launches of all five kernels read around each step, peak
                memory, one profiled step, u = 4 vs u = 1 in fp32 weights;
                both trainings' losses are held to those of an earlier
                commit (EARLIER_LOSSES);
  6c. gpt     — gpt-2.7b (the paper's GPT) at full width and depth, 32
                layers, B1-B3 at head_dim 80: the same as 6b (u = 4 vs u = 1 at
                all 32 layers), its losses held to EARLIER_LOSSES;
  6d. falcon  — falcon-mamba-7b at full width and 16 of its 64 layers, the
                selective scan on linear_scan in 256-token blocks: remat
                offload == remat full bit for bit, then 3 steps through
                train_steps (remat full, no attention so no FPDT offload) with
                the scan launches held to the count reckoned from the code,
                peak memory, one profiled step; its losses printed, having no
                earlier figure yet; one layer's selective scan timed alone and
                its share of a step reckoned;
  6e. moe     — one granite MoE FFN layer alone at the training shape (b1,
                8192 tokens, mlp_chunks 8, bf16): forward and backward under
                torch.cuda.set_sync_debug_mode("error") (no host read of a
                device value), a second run the same bits, its device time;
  6f. granite — granite-moe-1b-a400m at full width and depth (24 layers, 32
                experts, top-8): as 6b, with two runs of the first step and
                remat offload == remat full bit for bit, the steps' aux
                printed, MFU over the active parameters, and in the u = 4
                vs u = 1 fp32 comparison the routing decisions that differ
                counted from the port's routing of both runs' layer inputs
                (every leaf held at 5e-4 when none differs, else every leaf
                but the expert weights, the worst of those printed);
  6f'. frontends and qwen — musicgen-medium (48 layers) and internvl2-2b
                (24 layers) at full width and depth, qwen1.5-4b at full
                width and 8 layers (the FPDT backward with the qkv bias):
                as 6b without its profiled step (internvl's loss counts b
                (S - 256) tokens, none at a patch; qwen's bq, bk, bv
                gradients printed in the u = 4 vs u = 1 comparison, held
                with every other leaf), their losses held to
                EARLIER_LOSSES;
  6g. long    — gpt-2.7b at full depth, b1, FPDT chunk 4096 (u = s / 4096,
                mlp_chunks 2u) at s = 16384 and 32768 under A (FPDT offload
                off, remat full), B (offload on, remat full) and C (offload
                on, remat offload): 2 AdamW steps each, the second's ms, peak
                device memory, bytes to and from pinned host memory and the
                pinned bytes held; C equals B bit for bit at 16384, moves
                exactly the 32 cycle inputs more to the host and peaks lower;
                each setting's device bytes a token and intercept from the
                two lengths, and the longest context reckoned from them;
  6h. dist    — FPDT's distribution on torch.distributed: ulysses over a
                1-rank NCCL group equal to kind="local" bit for bit
                (llama3.2-1b's attention, bf16, s 8192, u 4, offload on);
                then 2 gloo ranks spawned on the one card (gloo takes the
                CUDA tensors): the attention alone at s 16384, u 8, fp32
                and bf16, ulysses (16 q / 4 kv heads a rank), cp (through
                attn_impl) and ulysses at the hybrid's shape (its one kv
                head gathered), each rank's o and dx and the summed dW
                against local on the same card, its pinned host bytes held
                and fetched against the own-slice KV store's reckoning,
                and offload off bit for bit; the recurrent mixers alone
                at full width (RG-LRU 4096 channels, Mamba d_inner 8192
                d_state 16), fp32 and bf16, two ranks against one;
                llama3.2-1b at full width (4 of its 16 layers), mesh
                1 x 2, b1 s 16384 u 8 remat full offload on, 2 AdamW
                steps under ulysses and 1 under cp, then recurrentgemma-9b
                (3 layers: one rglru, rglru, local_attn cycle) and
                falcon-mamba-7b (4 layers), 1 step each, and
                granite-moe-1b-a400m (6 layers, ulysses), 1 step,
                through train_steps, every weight and AdamW moment a
                ZeRO-3 shard (launch/shardings.py: the tables' d and
                granite's experts and router stack split over model;
                granite expert-parallel, each rank running its 16
                experts on the slots that dispatch_slots hands it):
                the first step against a one-rank
                step run first (the bf16 loss, and in fp32 weights the
                loss, gradient norm, every leaf's norm (gathered) and
                granite's aux, its routing decisions that differ counted
                and gated as in 6f),
                the kernels' launches and each collective's calls and
                bytes a step (gather_params, reduce_scatter_grads and the
                gradient sums among them) against the counts reckoned
                from the code, the parameters (gathered) the same bits on
                both ranks, peak memory beside its reckoning and step ms
                a rank (gloo through the host on one shared card, not a
                multi-card speed); then, on a 2 x 1 mesh of the same
                ranks, ZeRO-3 data-parallel: llama3.2-1b at 4 layers, b2
                (a row a rank) s 8192 u 4, the same checks against a
                one-rank b2 step, and what a rank holds after init (the
                shards' bytes to the byte, about half of one rank's) and
                its peak within a band of the reckoned; and a checkpoint
                (checkpoint/manager.py) of llama3.2-1b at 2 layers saved
                on 2 x 1 after step 1, restored there (step 2 the same
                bits), onto 1 x 2 and in this process onto one rank (the
                saved bits; step 2 as the other bf16 steps on a mesh are
                held), with its bytes and seconds; and on both meshes the
                sharded int8 quantizer on random shard gradients laid out
                by llama3.2-1b's and granite's plans (2 layers each) against
                one rank's quantization of each whole leaf, bit for bit,
                the blocks that straddle shards counted, then one
                compressed step of llama3.2-1b (2 layers, b2) on 2 x 1
                against one rank's (loss, parameter-leaf norms, the
                elements quantized to another integer, all_reduce_max as
                reckoned); last, one llama4-maverick-400b-a17b MoE FFN
                layer at full width (128 experts of d 5120 x d_ff 8192,
                top-1, bf16) on 1 x 2, expert-parallel (64 experts a
                rank, each made from its own seed), b1 s 8192, forward
                and backward against one rank's run in this process
                first: the same routing decisions, y and dx and each
                expert's gradient norms within the bf16 limit, no
                gather_params, the slot collectives as reckoned, each
                rank's peak beside its reckoning and the gathered
                path's;
  7. timing   — each kernel beside its bound, its plain version and a
                library call of PyTorch (scaled_dot_product_attention, causal
                on the diagonal pairs and unmasked off them, and the
                flash-attention backward behind it, timed as yardsticks only:
                the port never calls them; no PyTorch call computes a linear
                recurrence), all as device time from a CUDA graph of repeated
                calls, at the serve shape, the llama3.2-1b, gpt-2.7b and
                recurrentgemma-9b training pairs, the RG-LRU scan shape (forward,
                and the fused backward beside the unfused chain it replaced) and
                the selective scan's block with h0;
                the wrappers also launched from the host back to back
                (wrapper_ms: host dispatch included); the redesigned kernels
                beside the earlier kernels' times (EARLIER_MS); the q-head
                splits of flash_bwd_dkv at each timed pair (n_split);
  8. kernels  — one JSON line per the kernel contract: the attention
                kernels' top-level figures at gpt-2.7b's off-diagonal pair and
                their launches on its training path, the scan kernels' on
                falcon-mamba-7b's, every path's launches beside them
                (launches_by_path: the six serve paths, eight trainings,
                the CLI's compressed training and the distributed
                trainings, per rank), the new head layouts' errors;
  9. last line: {"ok": true, "device": {...}}.

It imports only the port (``src/repro_torch``), torch and the standard
library, and stops if there is no card or no port beside it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import time
import traceback
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
STARTED = time.monotonic()
# The script's own deadline, inside the 1200 s a run may take: the ranks of
# the distributed phase, stuck, write their stacks and fail the phase by
# then, and a run still going writes this process's stacks to stderr.
BUDGET_S = 1100

# published dense peaks of one H100 SXM at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES = 3.35e12

TOL = {"float32": 1e-5, "bfloat16": 3e-2}  # tests/test_kernels_flash.py:34
# kernel gradients: tests/test_kernels_flash.py:54.  dq elementwise (abs +
# rel); dk and dv sum over g * sq rows, so their error is held relative to
# (1 + max |reference|), as acc is held relative to (1 + l).
TOL_BWD = 1e-4
# bf16 flash_bwd_dq and flash_bwd_dkv run on the tensor cores with dO and
# dS (and for dkv P^T) rounded to bf16, which fp32 FMAs did not do: their
# dq, dk and dv are held at the repo's bf16 kernel tolerance
# (tests/test_kernels_flash.py:34), relative to (1 + max |reference|); fp32
# stays at TOL_BWD (dq elementwise).
TOL_BWD_BF16 = 3e-2
# That tolerance is loose beside the values it holds at the main path's
# pairs (the phase prints their rms), so there the bf16 kernels are also
# held to the plain version rounded where they round (ref.attend_chunk_tc,
# ref.chunk_bwd_dq_tc, ref.chunk_bwd_dkv_tc): only the fp32 accumulation
# order and a rare bf16 rounding of P or dS to its other neighbour differ,
# so the relative error ||got - emulation|| / ||emulation|| of acc, l, dq,
# dk and dv is held at TOL_TC, 4.5x the largest reading of flash_fwd and
# flash_bwd_dkv on the H100 (6.7e-5, PERF.md section 6).
TOL_TC = 3e-4
# linear scan: tests/test_kernels_linear_scan.py's 1e-5 forward and 1e-4
# gradients.  Elementwise (atol + rtol) where |a| <= 0.99 or the input is
# RG-LRU-scaled; with a near +-1 and raw inputs h is a random walk whose
# fp32 rounding accumulates with the walk's size, so there the error is held
# relative to (1 + max |h|), as dk/dv are.
TOL_SCAN, TOL_SCAN_GRAD = 1e-5, 1e-4
# FPDT gradients at u = 4 vs u = 1, relative to each leaf's largest
# magnitude: tests/test_fpdt.py:50.
FPDT_GRAD_RTOL = 5e-4
# fp32 logits of decode vs prefill, relative to the logits' largest magnitude:
# other matmul shapes and another softmax order, fp32 rounding through 16 layers.
FP32_LOGIT_RTOL = 1e-4
# Training losses of the three steps from seed 0 at earlier commits, on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6): llama3.2-1b's and
# recurrentgemma-9b's from this script at commit 6a7ca09 (whose bf16
# flash_bwd_dq still ran on the CUDA cores), run from a git archive in one
# chip call with its child; gpt-2.7b's from this script at commit 0fd5e81,
# where it was first trained; musicgen-medium's, internvl2-2b's and
# qwen1.5-4b's (8 layers) from this script's first card run of them, where
# their frontends and registration were added.  Each step is held within
# LOSS_RTOL of them.
EARLIER_LOSSES = {"llama3.2-1b": (12.1212, 10.8319, 14.2329),
                  "recurrentgemma-9b": (12.8542, 10.5876, 9.7271),
                  "gpt-2.7b": (11.5631, 19.6821, 19.4709),
                  "musicgen-medium": (8.0948, 15.8543, 12.9916),
                  "internvl2-2b": (12.1181, 9.8164, 14.4724),
                  "qwen1.5-4b": (12.5033, 12.8573, 16.1957)}
LOSS_RTOL = 0.02
# Device ms of the earlier kernels that the redesigned ones replaced, at the
# timed shapes (same card, same script; the "was" figures of PERF.md
# section 6): the CUDA-core flash_fwd and flash_bwd_dkv at commit d46ed49,
# flash_bwd_dq at 6a7ca09, the three-pass linear_scan at 94fb42e.  Printed
# beside this run's by the timing phase and nowhere else.
EARLIER_MS = {
    ("flash_fwd", "serve prefill b4 s64 (u=1)"): 0.01118,
    ("flash_fwd", "train 8192 u=4 off-diagonal pair cq=2048 b1"): 1.588,
    ("flash_fwd", "train 8192 u=4 diagonal pair cq=2048 b1"): 1.040,
    ("flash_fwd", "recurrentgemma-9b 8192 u=4 off-diagonal pair cq=2048 b1 hq16 hkv1 d256 "
                  "window 2048"): 2.025,
    ("flash_fwd", "recurrentgemma-9b 8192 u=4 diagonal pair cq=2048 b1 hq16 hkv1 d256 "
                  "window 2048"): 2.116,
    ("flash_bwd_dkv", "train 8192 u=4 off-diagonal pair cq=2048 b1"): 2.890,
    ("flash_bwd_dkv", "train 8192 u=4 diagonal pair cq=2048 b1"): 2.829,
    ("flash_bwd_dkv", "recurrentgemma-9b 8192 u=4 off-diagonal pair cq=2048 b1 hq16 hkv1 "
                      "d256 window 2048"): 16.363,
    ("flash_bwd_dkv", "recurrentgemma-9b 8192 u=4 diagonal pair cq=2048 b1 hq16 hkv1 d256 "
                      "window 2048"): 16.092,
    ("flash_bwd_dq", "train 8192 u=4 off-diagonal pair cq=2048 b1"): 2.152,
    ("flash_bwd_dq", "train 8192 u=4 diagonal pair cq=2048 b1"): 1.376,
    ("flash_bwd_dq", "recurrentgemma-9b 8192 u=4 off-diagonal pair cq=2048 b1 hq16 hkv1 "
                     "d256 window 2048"): 4.025,
    ("flash_bwd_dq", "recurrentgemma-9b 8192 u=4 diagonal pair cq=2048 b1 hq16 hkv1 d256 "
                     "window 2048"): 4.181,
    ("linear_scan", "RG-LRU scan [1, 8192, 4096] fp32, no h0"): 0.2430,
}
# Prefill at fpdt_chunks=4 vs 1 is held to bit equality (measured so on the
# H100): 512 is a multiple of the kernel's 64-key tile, so each row meets the
# same tiles in the same order and its fp32 carry passes through memory
# unchanged between the chunk calls; every other product sees the same rows.


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name, fn, *args):
    print(f"== {name}", flush=True)
    # progress on stderr too, so that a run stopped from outside shows where
    print(f"[{time.monotonic() - STARTED:.0f} s] {name}", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    try:
        out = fn(*args)
    except SystemExit:
        raise
    except Exception:  # every phase failure ends the run with its traceback
        traceback.print_exc()
        fail(f"phase {name!r} failed")
    print(f"({name}: {time.perf_counter() - t0:.1f} s)", flush=True)
    return out


def phase_device(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device 0: {name} "
          f"(count {torch.cuda.device_count()})")
    return card, name


def _ptxas_report(log: str) -> dict:
    """kernel -> (registers, spill store bytes, spill load bytes) from ptxas -v."""
    out, cur, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = (int(m.group(1)), *spill)
            cur, spill = None, (0, 0)
    return out


def _mma_counts(lib) -> dict:
    """kernel -> count of HMMA/HGMMA instructions in ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = line.split("Function :", 1)[1].strip()
            counts[cur] = 0
        elif cur and ("HMMA" in line or "HGMMA" in line):
            counts[cur] += 1
    return counts


def phase_build(B, sources):
    t0 = time.perf_counter()
    libs = B.build_all(sources)
    print(f"built {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.1f} s "
          f"(one nvcc per source, in parallel)")
    bad = []
    for lib in libs:
        ptxas = _ptxas_report(lib.with_suffix(".log").read_text())
        mma = _mma_counts(lib) if lib.stem.startswith("libflash") else {}
        for name in sorted(ptxas):  # mangled names; a tensor-core kernel's holds "_tc_"
            regs, st, ld = ptxas[name]
            line = f"  {lib.stem.rsplit('_', 1)[0][3:]}: {name}: {regs} registers, spill " \
                   f"stores {st} B, loads {ld} B"
            if name in mma:
                line += f", HMMA/HGMMA {mma[name]}"
            print(line)
            if "_tc_" in name and (st or ld or not mma.get(name)):
                bad.append(name)
    if bad:
        raise AssertionError(f"tensor-core kernels that spill or run no HMMA: {bad}")


def _max_violation(got, want, tol):
    """(max |got - want|, whether any element leaves atol + rtol*|want|)."""
    diff = (got.float() - want.float()).abs()
    return float(diff.max()), bool((diff > tol + tol * want.float().abs()).any())


def _rel(torch, got, want):
    """||got - want|| / ||want|| over every element."""
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def _rms(torch, x):
    return float(x.float().pow(2).mean().sqrt())


def _fwd_checker(torch, K, R, SoftmaxState, finalize, errs, acc_errs, tc=None):
    """check(label, dtype, q, k, v, carry, **kw): flash_fwd against
    ref.attend_chunk on the same inputs and carry; records the largest
    errors in ``errs`` / ``acc_errs`` by dtype and returns the plain state.
    With ``tc`` (a dict) bf16 cases are also held against
    ref.attend_chunk_tc at TOL_TC, and ``tc`` records the largest relative
    errors of acc and l and the least rms of the plain out."""

    def check(label, dtype, q, k, v, carry, **kw):
        got = K.flash_fwd(q, k, v, None if carry is None else tuple(carry), **kw)
        want = R.attend_chunk(q, k, v, carry=carry, **kw)
        torch.cuda.synchronize()
        tname = str(dtype).split(".")[-1]
        tol = TOL[tname]
        worst = 0.0
        for part, a, b in (("m", got[1], want.m), ("l", got[2], want.l),
                           ("out", finalize(SoftmaxState(*got)), finalize(want))):
            err, bad = _max_violation(a, b, tol)
            if not torch.isfinite(a).all():
                raise AssertionError(f"{label}: non-finite {part}")
            if bad:
                raise AssertionError(f"{label}: {part} max err {err:.3e} beyond tol {tol}")
            worst = max(worst, err)
        # acc is unnormalized, a sum of up to sk terms p*v with p <= 1: its
        # rounding grows with the row's l, not with |acc| (terms cancel), so
        # it is held at tol * (1 + l); out = acc / l above holds it at tol.
        if not torch.isfinite(got[0]).all():
            raise AssertionError(f"{label}: non-finite acc")
        acc_rel = float(((got[0] - want.acc).abs() / (1.0 + want.l[..., None])).max())
        if acc_rel > tol:
            raise AssertionError(f"{label}: acc err / (1 + l) {acc_rel:.3e} beyond tol {tol}")
        errs[tname] = max(errs.get(tname, 0.0), worst)
        acc_errs[tname] = max(acc_errs.get(tname, 0.0), acc_rel)
        if tc is not None and dtype == torch.bfloat16:
            emu = R.attend_chunk_tc(q, k, v, carry=carry, **kw)
            for part, a, b in (("acc", got[0], emu.acc), ("l", got[2], emu.l)):
                rel = _rel(torch, a, b)
                if rel > TOL_TC:
                    raise AssertionError(f"{label}: {part} relative error {rel:.3e} against "
                                         f"the bf16 rounding emulation beyond {TOL_TC}")
                tc[part] = max(tc.get(part, 0.0), rel)
            tc["rms_out"] = min(tc.get("rms_out", math.inf), _rms(torch, finalize(want)))
        return want

    return check


def phase_kernel(torch, K, R, SoftmaxState, finalize):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    errs = {"float32": 0.0, "bfloat16": 0.0}
    acc_errs = dict(errs)
    check = _fwd_checker(torch, K, R, SoftmaxState, finalize, errs, acc_errs)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def carry_of(b, hq, sq, d):
        return SoftmaxState(rnd(b, hq, sq, d), rnd(b, hq, sq), torch.rand(
            (b, hq, sq), generator=g, device=dev) + 0.5)

    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in (16, 64, 80, 128, 256):
            cases = [
                # label, b, hq, hkv, sq, sk, causal, window, q_off, k_off, carry
                ("ragged-diag", 2, 4, 4, 100, 100, True, 0, 0, 0, False),
                ("gqa4-window-carry", 2, 8, 2, 100, 70, True, 33, 90, 40, True),
                ("mqa16-window-carry", 1, 16, 1, 130, 150, True, 64, 200, 60, True),
                ("future-keys-all-masked", 1, 4, 1, 64, 64, True, 33, 0, 200, True),
                ("noncausal-carry", 1, 4, 2, 37, 100, False, 0, 0, 0, True),
            ] if d != 80 else MHA80_CASES
            for label, b, hq, hkv, sq, sk, causal, window, qo, ko, carry in cases:
                q = rnd(b, hq, sq, d).to(dtype)
                k = rnd(b, hkv, sk, d).to(dtype)
                v = rnd(b, hkv, sk, d).to(dtype)
                st = carry_of(b, hq, sq, d) if carry else None
                check(f"{label} d={d} {dtype}", dtype, q, k, v, st, causal=causal,
                      window=window, q_offset=qo, k_offset=ko)
                n += 1
    # the serve shapes of llama3.2-1b (GQA, d 64) and of recurrentgemma-9b's
    # local_attn layers (MQA, d 256, window 2048), one call per layer at u=1:
    # the 64-token prompt, the 65-token prefill of the decode-vs-prefill
    # check, the 2048 prompt; then the u=4 chunks of a 2048 prompt (cq=512):
    # every (i, j <= i) pair, each fed the plain version's running state as
    # its carry
    cq, u = 512, 4
    tcs = {}
    for model, hq, hkv, d, window in SERVE_ATTN:
        for s in (64, 65, 2048):
            for dtype in (torch.float32, torch.bfloat16):
                q = rnd(4, hq, s, d).to(dtype)
                k, v = rnd(4, hkv, s, d).to(dtype), rnd(4, hkv, s, d).to(dtype)
                check(f"serve {model} b4 hq{hq} hkv{hkv} d{d} window {window} s{s} {dtype}",
                      dtype, q, k, v, None, window=window)
                n += 1
        qs = [rnd(4, hq, cq, d).to(torch.bfloat16) for _ in range(u)]
        ks = [rnd(4, hkv, cq, d).to(torch.bfloat16) for _ in range(u)]
        vs = [rnd(4, hkv, cq, d).to(torch.bfloat16) for _ in range(u)]
        tc = tcs[model] = {}
        check_tc = _fwd_checker(torch, K, R, SoftmaxState, finalize, errs, acc_errs, tc)
        for i in range(u):
            st = None
            for j in range(i + 1):
                st = check_tc(f"{model} fpdt pair ({i},{j})", torch.bfloat16, qs[i], ks[j],
                              vs[j], st, causal=True, window=window, q_offset=i * cq,
                              k_offset=j * cq)
                n += 1
        del q, k, v, qs, ks, vs, st
    print(f"kernel vs plain: {n} cases within tolerance; max abs err of out, m, l: "
          f"fp32 {errs['float32']:.3e} bf16 {errs['bfloat16']:.3e}; acc err / (1 + l): "
          f"fp32 {acc_errs['float32']:.3e} bf16 {acc_errs['bfloat16']:.3e}; at the u=4 pairs "
          f"of the 2048 prompt, against the bf16 rounding emulation (limit {TOL_TC}): "
          + "; ".join(f"{m} acc, l relative error {tc['acc']:.3e}, {tc['l']:.3e}, least rms of "
                      f"plain out {tc['rms_out']:.3e}" for m, tc in tcs.items()))
    return errs


# the head layouts of the archs registered last, one training pair each in the
# backward phase: arch, hq, hkv, head_dim (yi-34b's g = 7 is the first odd
# group on flash_bwd_dkv's q-head split)
NEW_LAYOUTS = (("musicgen-medium", 24, 24, 64), ("internvl2-2b", 16, 8, 128),
               ("qwen1.5-4b", 20, 20, 128), ("yi-34b", 56, 8, 128),
               ("mistral-nemo-12b", 32, 8, 128))

# the attention layers each serve path runs: model, hq, hkv, head_dim, window
SERVE_ATTN = (("llama3.2-1b", 32, 8, 64, 0), ("recurrentgemma-9b", 16, 1, 256, 2048))

# head_dim 80 is gpt-2.7b's, whose attention is MHA: its cases keep hq = hkv
# = 32, ragged, windowed and offset as the others are
MHA80_CASES = [
    # label, b, hq, hkv, sq, sk, causal, window, q_off, k_off, carry
    ("mha-ragged-diag", 2, 32, 32, 100, 100, True, 0, 0, 0, False),
    ("mha-window-carry", 2, 32, 32, 100, 70, True, 33, 90, 40, True),
    ("mha-window-carry-ragged", 1, 32, 32, 130, 150, True, 64, 200, 60, True),
    ("mha-future-keys-all-masked", 1, 32, 32, 64, 64, True, 33, 0, 200, True),
    ("mha-noncausal-carry", 1, 32, 32, 37, 100, False, 0, 0, 0, True),
]


def _reset_counts(K, SK):
    K.launches = K.dq_launches = K.dkv_launches = SK.launches = SK.bwd_launches = 0


def _counts(K, SK):
    return {"flash_fwd": K.launches, "flash_bwd_dq": K.dq_launches,
            "flash_bwd_dkv": K.dkv_launches, "linear_scan": SK.launches,
            "linear_scan_bwd": SK.bwd_launches}


def _bwd_inputs(torch, R, lse, finalize, q, k, v, g, states=None, **kw):
    """do, L and delta for q's rows: L and o from ``states`` (the plain
    forward over every key the rows see) or from this pair's forward."""
    st = states if states is not None else R.attend_chunk(q, k, v, **kw)
    do = torch.randn(q.shape, generator=g, device=q.device)
    return do, lse(st), (do * finalize(st)).sum(-1)


def phase_kernel_bwd(torch, K, R, F, SoftmaxState, lse, finalize):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}  # err / (1 + max|ref|)
    worst_abs = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    by_dtype = {"fp32": dict(worst), "bf16": dict(worst)}

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def check(label, q, k, v, do, L, delta, tc=None, **kw):
        """dq, dk, dv against the plain version (fp32 dq elementwise at
        TOL_BWD; bf16 dq and every dk, dv relative to 1 + max|ref|); with
        ``tc`` (a dict) bf16 dq, dk, dv also against ref.chunk_bwd_dq_tc /
        chunk_bwd_dkv_tc at TOL_TC, recording the largest relative errors
        and the least rms of the plain dq, dk, dv."""
        dq = K.flash_bwd_dq(q, k, v, do, L, delta, **kw)
        dk, dv = K.flash_bwd_dkv(q, k, v, do, L, delta, **kw)
        want_dq = R.chunk_bwd_dq(q, k, v, do, L, delta, **kw)
        want_dk, want_dv = R.chunk_bwd_dkv(q, k, v, do, L, delta, **kw)
        torch.cuda.synchronize()
        bf = q.dtype == torch.bfloat16
        tol = TOL_BWD_BF16 if bf else TOL_BWD
        key = "bf16" if bf else "fp32"
        out = {}
        for part, a, b in (("dq", dq, want_dq), ("dk", dk, want_dk), ("dv", dv, want_dv)):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{label}: non-finite {part}")
            abs_err = float((a - b).abs().max())
            worst_abs[part] = max(worst_abs[part], abs_err)
            rel = abs_err / (1.0 + float(b.abs().max()))
            if part == "dq" and not bf:
                if _max_violation(a, b, TOL_BWD)[1]:
                    raise AssertionError(f"{label}: dq max err {abs_err:.3e} beyond tol {TOL_BWD}")
            elif rel > tol:
                raise AssertionError(f"{label}: {part} err / (1 + max|ref|) {rel:.3e} "
                                     f"beyond tol {tol}")
            out[part] = rel
            by_dtype[key][part] = max(by_dtype[key][part], rel)
        for part in worst:
            worst[part] = max(worst[part], out[part])
        if tc is not None and bf:
            emu = (R.chunk_bwd_dq_tc(q, k, v, do, L, delta, **kw),
                   *R.chunk_bwd_dkv_tc(q, k, v, do, L, delta, **kw))
            for part, a, b, ref in (("dq", dq, emu[0], want_dq), ("dk", dk, emu[1], want_dk),
                                    ("dv", dv, emu[2], want_dv)):
                rel = _rel(torch, a, b)
                if rel > TOL_TC:
                    raise AssertionError(f"{label}: {part} relative error {rel:.3e} against "
                                         f"the bf16 rounding emulation beyond {TOL_TC}")
                tc[part] = max(tc.get(part, 0.0), rel)
                tc["rms_" + part] = min(tc.get("rms_" + part, math.inf), _rms(torch, ref))
                tc["abs_" + part] = max(tc.get("abs_" + part, 0.0),
                                        float((a - ref).abs().max()))
                tc["limit_" + part] = max(tc.get("limit_" + part, 0.0),
                                          tol * (1.0 + float(ref.abs().max())))
        return out

    n_det = 0

    def deterministic(label, q, k, v, do, L, delta, **kw):
        """Two launches of flash_bwd_dq, and two of flash_bwd_dkv, on the
        same inputs: the same bits (dq: each block owns its rows; dkv: the
        q-head splits are summed in split order; no atomics)."""
        nonlocal n_det
        for name, fn in (("flash_bwd_dq", lambda: [K.flash_bwd_dq(q, k, v, do, L, delta, **kw)]),
                         ("flash_bwd_dkv", lambda: K.flash_bwd_dkv(q, k, v, do, L, delta, **kw))):
            first, second = fn(), fn()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(first, second)):
                raise AssertionError(f"{label}: two {name} launches differ")
        n_det += 1

    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in (16, 64, 80, 128, 256):
            cases = [
                # label, b, hq, hkv, sq, sk, causal, window, q_off, k_off
                ("ragged-diag", 2, 4, 4, 100, 100, True, 0, 0, 0),
                ("gqa4-window-offsets", 2, 8, 2, 100, 70, True, 33, 90, 40),
                ("mqa16-window-offsets", 1, 16, 1, 130, 150, True, 64, 200, 60),
                ("future-keys-all-masked", 1, 4, 1, 64, 64, True, 33, 0, 200),
                ("noncausal-gqa2", 1, 4, 2, 37, 100, False, 0, 0, 0),
            ] if d != 80 else [c[:-1] for c in MHA80_CASES]
            for label, b, hq, hkv, sq, sk, causal, window, qo, ko in cases:
                q = rnd(b, hq, sq, d).to(dtype)
                k, v = rnd(b, hkv, sk, d).to(dtype), rnd(b, hkv, sk, d).to(dtype)
                kw = dict(causal=causal, window=window, q_offset=qo, k_offset=ko)
                do, L, delta = _bwd_inputs(torch, R, lse, finalize, q, k, v, g, **kw)
                check(f"{label} d={d} {dtype}", q, k, v, do, L, delta, **kw)
                n += 1

    def train_pairs(label, hq, hkv, d, window=0):
        """The training path's pairs: every live (i, j <= i) pair of an 8192
        prompt at u=4 (2048 x 2048, b1, bf16).  flash_fwd is held against
        the plain forward at each pair, fed the plain running state as its
        carry; each row's L and delta come from the plain forward over every
        key it sees; dq, dk, dv against the plain versions and their bf16
        rounding emulations; two launches of each backward kernel at every
        pair give the same bits."""
        nonlocal n
        cq, u = 2048, 4
        errs, acc, ftc, tc = {}, {}, {}, {}
        fcheck = _fwd_checker(torch, K, R, SoftmaxState, finalize, errs, acc, ftc)
        qs = [rnd(1, hq, cq, d).to(torch.bfloat16) for _ in range(u)]
        ks = [rnd(1, hkv, cq, d).to(torch.bfloat16) for _ in range(u)]
        vs = [rnd(1, hkv, cq, d).to(torch.bfloat16) for _ in range(u)]
        pair_worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
        n_pairs = 0
        for i in range(u):
            live = [j for j in range(i + 1)
                    if F.pair_live(i, j, cq=cq, window=window, sparsity=0.0)]
            st = None
            for j in live:
                st = fcheck(f"flash_fwd {label} pair ({i},{j})", torch.bfloat16, qs[i], ks[j],
                            vs[j], st, causal=True, window=window, q_offset=i * cq,
                            k_offset=j * cq)
            do, L, delta = _bwd_inputs(torch, R, lse, finalize, qs[i], None, None, g, states=st)
            for j in live:
                kw = dict(causal=True, window=window, q_offset=i * cq, k_offset=j * cq)
                out = check(f"{label} pair ({i},{j})", qs[i], ks[j], vs[j], do, L, delta, tc,
                            **kw)
                pair_worst = {p: max(pair_worst[p], out[p]) for p in out}
                deterministic(f"{label} pair ({i},{j})", qs[i], ks[j], vs[j], do, L, delta, **kw)
                n_pairs += 1
                n += 1
            del st, do, L, delta
        print(f"{label} pairs of an 8192 prompt at u=4 (2048 x 2048, b1 hq{hq} hkv{hkv} d{d} "
              f"bf16{f', window {window}' if window else ''}, all {n_pairs} live): flash_fwd "
              f"with carry and offsets: max abs err of out, m, l {errs['bfloat16']:.3e} (tol "
              f"{TOL['bfloat16']}), acc err / (1 + l) {acc['bfloat16']:.3e}, least rms of plain "
              f"out {ftc['rms_out']:.3e}, against the bf16 rounding emulation: acc, l relative "
              f"error {ftc['acc']:.3e}, {ftc['l']:.3e} (limit {TOL_TC}); "
              + _bwd_summary(pair_worst, tc))
        return {"fwd": errs["bfloat16"], "fwd_acc": acc["bfloat16"], "fwd_tc": ftc,
                "worst": pair_worst, "tc": tc, "pairs": n_pairs}

    def dist_pairs():
        """The shapes the distributed path (phase_dist) gives the kernels,
        fp32 and bf16, chunk 1 of 2048-token chunks: cp's rank of two holds
        1024 query rows of the chunk (llama3.2-1b, hq32 hkv8 d64; model rank
        m's rows at q_offset 2048 + 1024 m) against each whole key chunk, so
        its diagonal pair has sq 1024, sk 2048 and q_offset - k_offset =
        1024 m; ulysses' rank of two holds half the heads (hq16 hkv4 d64) of
        the 2048 x 2048 pairs.  flash_fwd with the carry of the off-diagonal
        pair, then flash_bwd_dq and flash_bwd_dkv from the rows' L and
        delta, each against its plain version."""
        nonlocal n
        worst = {}
        shapes = [(f"cp rank {m} (sq 1024, q_offset - k_offset of the diagonal {1024 * m})",
                   32, 8, 1024, 2048 + 1024 * m) for m in (0, 1)]
        shapes.append(("ulysses rank (hq16 hkv4, 2048 x 2048)", 16, 4, 2048, 2048))
        for dtype in (torch.float32, torch.bfloat16):
            errs, acc = {}, {}
            fcheck = _fwd_checker(torch, K, R, SoftmaxState, finalize, errs, acc)
            for label, hq, hkv, sq, q_offset in shapes:
                q = rnd(1, hq, sq, 64).to(dtype)
                ks = [rnd(1, hkv, 2048, 64).to(dtype) for _ in range(2)]
                vs = [rnd(1, hkv, 2048, 64).to(dtype) for _ in range(2)]
                st = None
                for j in (0, 1):
                    st = fcheck(f"flash_fwd {label} pair (1,{j}) {dtype}", dtype, q, ks[j],
                                vs[j], st, causal=True, q_offset=q_offset, k_offset=2048 * j)
                do, L, delta = _bwd_inputs(torch, R, lse, finalize, q, None, None, g, states=st)
                for j in (0, 1):
                    out = check(f"{label} pair (1,{j}) {dtype}", q, ks[j], vs[j], do, L, delta,
                                causal=True, q_offset=q_offset, k_offset=2048 * j)
                    key = str(dtype).split(".")[-1]
                    worst[key] = {p: max(worst.get(key, {}).get(p, 0.0), out[p]) for p in out}
                    n += 1
                del q, ks, vs, st, do, L, delta
            worst[str(dtype).split(".")[-1]]["fwd"] = errs[str(dtype).split(".")[-1]]
        print("distributed shapes (cp's 1024 query rows at q_offset - k_offset 0 and 1024 of "
              "the diagonal pair, hq32 hkv8 d64; ulysses' hq16 hkv4 d64 2048 x 2048), fp32 and "
              "bf16, flash_fwd with carry and both backward kernels within tolerance: "
              + "; ".join(f"{k} max abs err of out, m, l {w['fwd']:.3e}, dq, dk, dv err / "
                          f"(1 + max|ref|) {w['dq']:.3e}, {w['dk']:.3e}, {w['dv']:.3e}"
                          for k, w in worst.items()))
        return worst

    def layout_pairs():
        """The head layouts of musicgen-medium, internvl2-2b, qwen1.5-4b,
        yi-34b and mistral-nemo-12b (NEW_LAYOUTS), one pair each at the
        training shape: the diagonal pair (1, 1) of an 8192 prompt at u=4
        (2048 x 2048, b1, q_offset = k_offset = 2048), fp32 and bf16.
        flash_fwd against its plain version (bf16 also against its rounding
        emulation, TOL_TC), then flash_bwd_dq and flash_bwd_dkv from the
        pair's own L and delta against theirs (bf16 also against the
        emulations, and two launches of each the same bits)."""
        nonlocal n
        out = {}
        kw = dict(causal=True, q_offset=2048, k_offset=2048)
        for arch, hq, hkv, d in NEW_LAYOUTS:
            row = {}
            for dtype in (torch.float32, torch.bfloat16):
                errs, acc, ftc, tc = {}, {}, {}, {}
                fcheck = _fwd_checker(torch, K, R, SoftmaxState, finalize, errs, acc, ftc)
                q = rnd(1, hq, 2048, d).to(dtype)
                k, v = rnd(1, hkv, 2048, d).to(dtype), rnd(1, hkv, 2048, d).to(dtype)
                label = f"{arch} layout hq{hq} hkv{hkv} d{d} pair (1,1) {dtype}"
                st = fcheck(f"flash_fwd {label}", dtype, q, k, v, None, **kw)
                do, L, delta = _bwd_inputs(torch, R, lse, finalize, q, None, None, g, states=st)
                w = check(label, q, k, v, do, L, delta, tc, **kw)
                key = str(dtype).split(".")[-1]
                row[key] = {"fwd": errs[key], "fwd_acc": acc[key], **w}
                if dtype == torch.bfloat16:
                    row[key].update(fwd_tc=ftc["acc"], tc=tc)
                    deterministic(label, q, k, v, do, L, delta, **kw)
                n += 1
                del q, k, v, st, do, L, delta
            out[arch] = row
            bf = row["bfloat16"]
            print(f"{arch} head layout (hq{hq} hkv{hkv} d{d}, g {hq // hkv}), pair (1,1) of an "
                  f"8192 prompt at u=4: fp32 flash_fwd max abs err of out, m, l "
                  f"{row['float32']['fwd']:.3e}, dq, dk, dv err / (1 + max|ref|) "
                  f"{row['float32']['dq']:.3e}, {row['float32']['dk']:.3e}, "
                  f"{row['float32']['dv']:.3e}; bf16 flash_fwd {bf['fwd']:.3e} (acc, l against "
                  f"the rounding emulation {bf['fwd_tc']:.3e}, {ftc['l']:.3e}), "
                  + _bwd_summary(bf, bf["tc"]))
        return out

    dist = dist_pairs()
    layouts = layout_pairs()
    pairs = {"llama": train_pairs("llama3.2-1b", 32, 8, 64),
             "gpt": train_pairs("gpt-2.7b", 32, 32, 80),
             # window 2048, so pair (i, j) lives only for i - j <= 1
             "hybrid": train_pairs("recurrentgemma-9b", 16, 1, 256, window=2048)}
    if pairs["hybrid"]["pairs"] != 7:
        raise AssertionError(f"{pairs['hybrid']['pairs']} live pairs at u=4 with window 2048, "
                             "expected 7")
    fwd_check = _fwd_checker(torch, K, R, SoftmaxState, finalize, {}, {}, {})
    # the u=1 pair, at b1 hq4 hkv1 so the plain version's [sq, sk] fp32
    # matrices (1 GiB each) fit beside the kernel's inputs
    q, k, v = (rnd(1, 4, 8192, 64).to(torch.bfloat16), rnd(1, 1, 8192, 64).to(torch.bfloat16),
               rnd(1, 1, 8192, 64).to(torch.bfloat16))
    st = fwd_check("flash_fwd u=1 pair 8192 x 8192", torch.bfloat16, q, k, v, None, causal=True)
    do, L, delta = _bwd_inputs(torch, R, lse, finalize, q, None, None, g, states=st)
    del st
    out = check("u=1 pair 8192 x 8192", q, k, v, do, L, delta, causal=True)
    n += 1
    print(f"u=1 pair 8192 x 8192 (held at b1 hq4 hkv1 d64 bf16 so the plain version's fp32 "
          f"[sq, sk] matrices fit; the path runs hq32 hkv8): flash_fwd within tol; dq, dk, dv "
          f"err / (1 + max|ref|) {out['dq']:.3e}, {out['dk']:.3e}, {out['dv']:.3e}")
    del q, k, v, do, L, delta
    torch.cuda.empty_cache()
    print(f"backward kernels vs plain: {n} cases within tolerance ({TOL_BWD} fp32, dq "
          f"elementwise; {TOL_BWD_BF16} bf16 on the tensor cores); max dq, dk, dv err / (1 + "
          f"max|ref|) fp32 {by_dtype['fp32']['dq']:.3e}, {by_dtype['fp32']['dk']:.3e}, "
          f"{by_dtype['fp32']['dv']:.3e}, bf16 {by_dtype['bf16']['dq']:.3e}, "
          f"{by_dtype['bf16']['dk']:.3e}, {by_dtype['bf16']['dv']:.3e} (abs "
          f"{worst_abs['dq']:.3e}, {worst_abs['dk']:.3e}, {worst_abs['dv']:.3e}); "
          f"flash_bwd_dq and flash_bwd_dkv deterministic (two launches each, same bits) at "
          f"{n_det} training pairs")
    return {"abs": worst_abs, "rel": worst, "pairs": pairs, "dist": dist, "layouts": layouts}


def _bwd_summary(worst, tc):
    """One line of the backward readings at a training path's pairs."""
    return (f"dq, dk, dv err / (1 + max|ref|) {worst['dq']:.3e}, {worst['dk']:.3e}, "
            f"{worst['dv']:.3e} (abs {tc['abs_dq']:.3e}, {tc['abs_dk']:.3e}, {tc['abs_dv']:.3e} "
            f"within {tc['limit_dq']:.3e}, {tc['limit_dk']:.3e}, {tc['limit_dv']:.3e}; least rms "
            f"of plain dq, dk, dv {tc['rms_dq']:.3e}, {tc['rms_dk']:.3e}, {tc['rms_dv']:.3e}); "
            f"against the bf16 rounding emulation: dq, dk, dv relative error {tc['dq']:.3e}, "
            f"{tc['dk']:.3e}, {tc['dv']:.3e} (limit {TOL_TC})")


def phase_scan(torch, SK, SR, SO):
    """linear_scan against its plain version; the op's backward against
    autograd of the plain version."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    worst = {"elementwise": 0.0, "scaled": 0.0}
    n = 0

    def inputs(b, s, c, dtype, lo, hi, with_h0, rglru):
        a = lo + (hi - lo) * torch.rand((b, s, c), generator=g, device=dev)
        x = torch.randn((b, s, c), generator=g, device=dev)
        if rglru:  # RG-LRU's input scaling: h stays O(1)
            x = torch.sqrt(torch.clamp(1 - a * a, min=1e-12)) * x
        h0 = torch.randn((b, c), generator=g, device=dev) if with_h0 else None
        return a.to(dtype), x.to(dtype), h0

    cases = [
        # label, b, seq, chan, dtype, a range, h0, RG-LRU-scaled input, elementwise
        ("grid", 1, 8, 4, torch.float32, (-0.99, 0.99), True, False, True),
        ("grid-b2", 2, 32, 8, torch.float32, (-0.99, 0.99), True, False, True),
        ("ragged", 3, 77, 129, torch.float32, (-0.99, 0.99), False, False, True),
        ("ragged-bf16", 2, 1000, 300, torch.bfloat16, (-0.99, 0.99), True, False, True),
        ("seq1", 2, 1, 5, torch.float32, (-1.0, 1.0), True, False, True),
        ("near+1", 2, 4096, 257, torch.float32, (0.999, 1.0), True, False, False),
        ("near-1", 2, 4096, 257, torch.float32, (-1.0, -0.999), True, False, False),
        ("near+1-rglru", 1, 8192, 515, torch.float32, (0.99, 1.0), True, True, True),
        ("train-shape", 1, 8192, 4096, torch.float32, (0.0, 1.0), False, True, True),
        ("train-shape-bf16", 1, 8192, 4096, torch.bfloat16, (0.0, 1.0), True, True, True),
        # recurrentgemma-9b's prefill at the serve phase's prompts: b4, no h0
        ("serve-rglru-s64", 4, 64, 4096, torch.float32, (0.0, 1.0), False, True, True),
        ("serve-rglru-s65", 4, 65, 4096, torch.float32, (0.0, 1.0), False, True, True),
        ("serve-rglru-s2048", 4, 2048, 4096, torch.float32, (0.0, 1.0), False, True, True),
    ]
    for label, b, s, c, dtype, (lo, hi), with_h0, rglru, elementwise in cases:
        a, x, h0 = inputs(b, s, c, dtype, lo, hi, with_h0, rglru)
        for reverse in (False, True):
            got = SK.linear_scan(a, x, h0, reverse=reverse)
            want = (SR.linear_scan(a.flip(1), x.flip(1), h0).flip(1) if reverse
                    else SR.linear_scan(a, x, h0))
            torch.cuda.synchronize()
            tag = f"{label} [{b}, {s}, {c}] {str(dtype).split('.')[-1]} h0={with_h0} " \
                  f"reverse={reverse}"
            if not torch.isfinite(got).all() or got.dtype != torch.float32:
                raise AssertionError(f"{tag}: non-finite or non-fp32 output")
            err = float((got - want).abs().max())
            if elementwise:
                _, bad = _max_violation(got, want, TOL_SCAN)
                worst["elementwise"] = max(worst["elementwise"], err)
            else:
                bad = err > TOL_SCAN * (1 + float(want.abs().max()))
                worst["scaled"] = max(worst["scaled"], err / (1 + float(want.abs().max())))
            if bad:
                raise AssertionError(f"{tag}: max err {err:.3e} beyond tol {TOL_SCAN}")
            n += 1
        del a, x, h0, got, want
    bwd = _scan_bwd_checks(torch, SK, SR, inputs, g)
    sel = _selective_scan_block_checks(torch, SK, SR, g)
    # the op's backward (the fused kernel) at a reduced length
    a, x, h0 = inputs(2, 512, 300, torch.float32, 0.2, 0.999, True, False)
    w = torch.randn(a.shape, generator=g, device=dev)
    leaves = [t.requires_grad_(True) for t in (a, x, h0)]
    got = torch.autograd.grad((SO.linear_scan(*leaves) * w).sum(), leaves)
    want = torch.autograd.grad((SR.linear_scan(*leaves) * w).sum(), leaves)
    grad_err = {}
    for name, gv, wv in zip(("da", "db", "dh0"), got, want):
        err, bad = _max_violation(gv, wv, TOL_SCAN_GRAD)
        if bad or not torch.isfinite(gv).all():
            raise AssertionError(f"op backward: {name} max err {err:.3e} beyond {TOL_SCAN_GRAD}")
        grad_err[name] = err
    print(f"linear_scan vs plain: {n} cases within tolerance {TOL_SCAN}; max abs err "
          f"(elementwise cases) {worst['elementwise']:.3e}; max err / (1 + max|h|) (a near "
          f"+-1, raw input) {worst['scaled']:.3e}; op backward [2, 512, 300] vs autograd of the "
          f"plain version: max abs err da {grad_err['da']:.3e} db {grad_err['db']:.3e} dh0 "
          f"{grad_err['dh0']:.3e} (tol {TOL_SCAN_GRAD})")
    return {"max_abs_err": worst["elementwise"], "max_rel_err_near_unit": worst["scaled"],
            "grad": grad_err, **bwd, **sel}


SELECTIVE_BLOCK = (1, 256, 8192, 16)  # b, block tokens, d_inner, d_state: falcon-mamba-7b's
SELECTIVE_SERVE = ((4, 64), (4, 65))  # b, tokens: the serve phase's prefills, one block each


def _selective_block_inputs(torch, g, b, s):
    """One block of falcon-mamba-7b's selective scan as the mixer hands it to
    linear_scan: a = exp(dt A) in (0, 1] and b = (dt x) B, fp32 [b, s,
    d_inner * d_state], dt log-uniform in the init's band [0.001, 0.1], A =
    -(1..d_state) on every channel; h0 the carried state [b, d_inner *
    d_state]."""
    dev = torch.device("cuda")
    _, _, di, ds = SELECTIVE_BLOCK
    dt = torch.exp(math.log(1e-3) + (math.log(0.1) - math.log(1e-3))
                   * torch.rand((b, s, di), generator=g, device=dev))
    A = -torch.arange(1, ds + 1, dtype=torch.float32, device=dev).repeat(di, 1)
    x = torch.randn((b, s, di), generator=g, device=dev)
    bm = torch.randn((b, s, ds), generator=g, device=dev)
    a = torch.exp(dt[..., None] * A).reshape(b, s, di * ds)
    bb = ((dt * x)[..., None] * bm[:, :, None, :]).reshape(b, s, di * ds)
    h0 = torch.randn((b, di * ds), generator=g, device=dev)
    return a, bb, h0


def _selective_fwd_err(torch, SK, SR, a, bb, h0, tag):
    """linear_scan against its plain version at a selective-scan shape:
    max err / (1 + max |h|), raised beyond TOL_SCAN; returns (err, h)."""
    h = SK.linear_scan(a, bb, h0)
    want = SR.linear_scan(a, bb, h0)
    torch.cuda.synchronize()
    err = float((h - want).abs().max()) / (1 + float(want.abs().max()))
    if not torch.isfinite(h).all() or err > TOL_SCAN:
        raise AssertionError(f"{tag}: err {err:.3e} beyond {TOL_SCAN}")
    return err, h


def _selective_scan_block_checks(torch, SK, SR, g):
    """linear_scan at the selective scan's block shape [1, 256, 131072] with
    h0: the forward against its plain version at TOL_SCAN relative to (1 +
    max |h|), the fused backward at TOL_SCAN_GRAD (elementwise) and bit for
    bit the unfused chain, two launches of each bit for bit.  Then the
    forward alone at the serve phase's prefill blocks (SELECTIVE_SERVE)."""
    dev = torch.device("cuda")
    a, bb, h0 = _selective_block_inputs(torch, g, *SELECTIVE_BLOCK[:2])
    fwd_err, h = _selective_fwd_err(torch, SK, SR, a, bb, h0, "selective block linear_scan")
    dout = torch.randn(h.shape, generator=g, device=dev)
    got_bwd = SK.linear_scan_bwd(a, h, h0, dout, torch.float32)
    want_bwd = SR.linear_scan_bwd(a, h, h0, dout, torch.float32)
    unfused = SR.linear_scan_bwd(a, h, h0, dout, torch.float32,
                                 reverse_scan=lambda a_, b_: SK.linear_scan(a_, b_, reverse=True))
    same = torch.equal(SK.linear_scan(a, bb, h0), h) and all(
        torch.equal(u, v) for u, v in zip(SK.linear_scan_bwd(a, h, h0, dout, torch.float32),
                                          got_bwd))
    torch.cuda.synchronize()
    bwd_err = 0.0
    for name, gv, wv, uv in zip(("da", "db", "dh0"), got_bwd, want_bwd, unfused):
        if not torch.isfinite(gv).all() or not torch.equal(gv, uv):
            raise AssertionError(f"selective block linear_scan_bwd {name}: non-finite or not "
                                 "the unfused chain's bits")
        diff = (gv - wv).abs()
        if bool((diff > TOL_SCAN_GRAD * (1 + wv.abs())).any()):
            raise AssertionError(f"selective block linear_scan_bwd {name}: max err "
                                 f"{float(diff.max()):.3e} beyond {TOL_SCAN_GRAD}")
        bwd_err = max(bwd_err, float(diff.max()))
    print(f"linear_scan at the selective scan's block {list(a.shape)} fp32 with h0 (a = exp(dt "
          f"A) in [{float(a.min()):.4f}, {float(a.max()):.4f}]): forward max err / (1 + max|h|) "
          f"{fwd_err:.3e} (tol {TOL_SCAN}); fused backward max abs err {bwd_err:.3e} (tol "
          f"{TOL_SCAN_GRAD}), bit for bit the unfused chain; two launches of each bit for bit: "
          f"{same}")
    if not same:
        raise AssertionError("two launches at the selective block differ")
    del a, bb, h0, h, dout, got_bwd, want_bwd, unfused
    serve_err = 0.0
    for b, s in SELECTIVE_SERVE:
        a, bb, h0 = _selective_block_inputs(torch, g, b, s)
        tag = f"selective serve block linear_scan {list(a.shape)}"
        serve_err = max(serve_err, _selective_fwd_err(torch, SK, SR, a, bb, h0, tag)[0])
        del a, bb, h0
    print(f"linear_scan at the serve phase's selective blocks "
          f"{[[b, s, SELECTIVE_BLOCK[2] * SELECTIVE_BLOCK[3]] for b, s in SELECTIVE_SERVE]} fp32 "
          f"with h0: forward max err / (1 + max|h|) {serve_err:.3e} (tol {TOL_SCAN})")
    return {"selective_fwd_rel_err": fwd_err, "selective_bwd_max_abs_err": bwd_err,
            "selective_serve_fwd_rel_err": serve_err}


def _scan_bwd_checks(torch, SK, SR, inputs, g):
    """The fused backward against its plain version (ref.linear_scan_bwd) at
    TOL_SCAN_GRAD and bit for bit against the unfused chain it replaces (the
    forward kernel in reverse mode over a copied a_next, then torch's
    multiply and cast); two launches of each kernel bit for bit, and again
    while a side stream keeps the SMs busy."""
    dev = torch.device("cuda")

    def chain(a, h, h0, dout, b_dtype):
        return SR.linear_scan_bwd(a, h, h0, dout, b_dtype,
                                  reverse_scan=lambda a_, b_: SK.linear_scan(a_, b_, reverse=True))

    worst, flips = 0.0, 0
    cases = [
        # label, b, seq, chan, dtype, a range, h0, RG-LRU-scaled input
        ("train-shape", 1, 8192, 4096, torch.float32, (0.0, 1.0), False, True),
        ("train-shape-bf16", 1, 8192, 4096, torch.bfloat16, (0.0, 1.0), True, True),
        ("ragged", 3, 77, 129, torch.float32, (-0.99, 0.99), True, False),
    ]
    for label, b, s, c, dtype, (lo, hi), with_h0, rglru in cases:
        a, x, h0 = inputs(b, s, c, dtype, lo, hi, with_h0, rglru)
        h = SK.linear_scan(a, x, h0)
        dout = torch.randn(h.shape, generator=g, device=dev)
        got = SK.linear_scan_bwd(a, h, h0, dout, x.dtype)
        want = SR.linear_scan_bwd(a, h, h0, dout, x.dtype)
        unfused = chain(a, h, h0, dout, x.dtype)
        torch.cuda.synchronize()
        for name, gv, wv, uv in zip(("da", "db", "dh0"), got, want, unfused):
            if gv is None and wv is None and uv is None:
                continue
            tag = f"linear_scan_bwd {label} [{b}, {s}, {c}] {name}"
            if gv.dtype != wv.dtype or not torch.isfinite(gv).all():
                raise AssertionError(f"{tag}: {gv.dtype} (plain {wv.dtype}) or non-finite")
            if not torch.equal(gv, uv):
                raise AssertionError(f"{tag}: differs from the unfused chain")
            wf = wv.float()
            diff, limit = (gv.float() - wf).abs(), TOL_SCAN_GRAD * (1 + wf.abs())
            err = float(diff.max())
            if gv.dtype == torch.bfloat16:
                # both sides round fp32 values that differ in their last bits
                # to bf16: one bf16 step (2^-7 of the value) apart at most
                flips += int((diff > limit).sum())
                limit = limit + wf.abs() * 2.0 ** -7
            else:
                worst = max(worst, err)
            if bool((diff > limit).any()):
                raise AssertionError(f"{tag}: max err {err:.3e} beyond {TOL_SCAN_GRAD}")
        del a, x, h0, h, dout, got, want, unfused

    # two launches of each kernel, then two more beside a busy side stream
    a, x, _ = inputs(1, 8192, 4096, torch.float32, 0.0, 1.0, False, True)
    h = SK.linear_scan(a, x)
    dout = torch.randn(h.shape, generator=g, device=dev)
    fwd0, bwd0 = SK.linear_scan(a, x), SK.linear_scan_bwd(a, h, None, dout, torch.float32)
    same = torch.equal(SK.linear_scan(a, x), fwd0) and all(
        torch.equal(u, v) for u, v in zip(SK.linear_scan_bwd(a, h, None, dout, torch.float32)[:2],
                                          bwd0[:2]))
    # elementwise kernels over 1 GiB fill every SM for ~0.6 ms each (a matmul
    # would leave a cuBLAS workspace allocated for the side stream); the scans
    # start once the first has ended, and must end before the last does
    filler = torch.ones(2 ** 28, device=dev)
    side, main = torch.cuda.Stream(), torch.cuda.current_stream()
    started, scans_end, side_end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    side.wait_stream(main)
    with torch.cuda.stream(side):
        filler.mul_(1.0001)
        started.record()
        for _ in range(15):
            filler.mul_(1.0001)
        side_end.record()
    main.wait_event(started)
    fwd1 = SK.linear_scan(a, x)
    bwd1 = SK.linear_scan_bwd(a, h, None, dout, torch.float32)
    scans_end.record()
    torch.cuda.synchronize()
    del filler
    # ms from the scans' end to the side stream's: > 0 when they ran beside it
    margin = scans_end.elapsed_time(side_end)
    busy = torch.equal(fwd1, fwd0) and all(torch.equal(u, v) for u, v in zip(bwd1[:2], bwd0[:2]))
    print(f"linear_scan_bwd vs plain: 3 cases, max abs err (fp32 outputs) {worst:.3e} (tol "
          f"{TOL_SCAN_GRAD}); bf16 outputs one rounding step apart at {flips} elements; bit for "
          f"bit the unfused chain in every case; two launches of each kernel bit for bit: "
          f"{same}; again beside a busy side stream: {busy} (the side stream ran on for "
          f"{margin:.3f} ms after them)")
    if not (same and busy):
        raise AssertionError("two launches of linear_scan or linear_scan_bwd differ")
    if margin <= 0:
        raise AssertionError("the side stream ended before the scans: their launches beside "
                             "it were not tested")
    return {"bwd_max_abs_err": worst, "bwd_bf16_steps": flips}


# which kernel each block kind's serve and train paths must launch
KERNEL_OF_KIND = {"attn": "flash_fwd", "local_attn": "flash_fwd", "rglru": "linear_scan",
                  "ssm": "linear_scan"}


def _prompt_words(cfg, s: int) -> str:
    """A prompt of ``s`` positions, in words."""
    if cfg.frontend == "audio_frames":
        return f"{s} frames"
    if cfg.frontend == "vision_patches":
        return f"{cfg.num_patches} patches + {s - cfg.num_patches} tokens"
    return f"{s} tokens"


def phase_serve(torch, M, arch, card):
    """``arch`` at full size with random bf16 weights from a seeded
    generator, through the CLI's own function (serve_batch): batch 4,
    prompt 64 tokens (an audio model's 64 frames; a vision model's patches
    and 64 tokens), gen 32, greedy (an audio model decodes per token, each
    step a fresh random frame), the launch counts reset just before and
    read just after; each kernel its block kinds run must have launched,
    and flash_fwd once a live chunk pair of each attention layer.  With
    attention, a 2048-position prompt whose prefill logits at
    fpdt_chunks=4 must equal fpdt_chunks=1.  Then, with the bf16 weights
    released, decode's first step against a prefill of one more token (or
    frame: the one decode is fed) in fp32 weights (an MoE model at a
    capacity factor that drops no pair: decode's dispatch group is the
    batch's b tokens and the prefill's a chunk's, so only without drops is
    routing per token and the two comparable), and how far a changed first
    prompt token (or frame) moves those logits."""
    dev = torch.device("cuda")
    cfg = M.cfg_mod.get_config(arch)
    audio = cfg.frontend == "audio_frames"
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = M.T.init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    print(f"init_params {cfg.name} ({cfg.num_layers} layers, {cfg.num_params() / 1e9:.3f} B "
          f"params, {cfg.param_dtype}) in {time.perf_counter() - t0:.1f} s")
    b, s, new = 4, 64 + cfg.num_patches, 32
    prompt = M.CLI.random_prompt(cfg, b, s, gen, dev)
    frames = M.CLI.random_prompt(cfg, b, new - 1, gen, dev)["frame_embeds"] if audio else None
    # warm-up: cuBLAS and allocator set-up
    M.CLI.serve_batch(cfg, params, prompt, gen=new, frames=frames)

    torch.cuda.reset_peak_memory_stats()
    _reset_counts(M.K, M.SK)
    out = M.CLI.serve_batch(cfg, params, prompt, gen=new, frames=frames)
    counts = _counts(M.K, M.SK)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    logits, toks = out["prefill_logits"], out["tokens"]
    for kname in sorted({KERNEL_OF_KIND[k] for k in cfg.layer_kinds()}):
        if counts[kname] <= 0:
            raise AssertionError(f"the {arch} serve path launched {kname} no time")
    u = cfg.fpdt_chunks  # the prefill's flash_fwd: one launch a live chunk pair a layer
    want_fwd = sum(M.F.pair_live(i, j, cq=s // u, window=cfg.window if k == "local_attn" else 0,
                                 sparsity=cfg.attn_sparsity)
                   for k in cfg.layer_kinds() if k in ("attn", "local_attn")
                   for i in range(u) for j in range(i + 1))
    if counts["flash_fwd"] != want_fwd:
        raise AssertionError(f"the {arch} serve path launched flash_fwd {counts['flash_fwd']} "
                             f"times, reckoned {want_fwd}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")
    if tuple(toks.shape) != (b, new) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"bad generated tokens {tuple(toks.shape)}")
    steps = out["steps"]
    print(f"serve {cfg.name} ({cfg.num_layers} layers) b={b} prompt={_prompt_words(cfg, s)} "
          f"gen={new} (decode: {out['mode']}): launches {counts}; prefill "
          f"{out['prefill_ms']:.2f} ms; decode {out['decode_ms'] / steps:.3f} ms/step, "
          f"{steps * b / (out['decode_ms'] / 1e3):.1f} tok/s; peak {peak_gib:.2f} GiB [{card}]")
    print("generated ids (row 0):", toks[0].tolist())

    if M.T.has_attention(cfg):  # a 2048 prompt: FPDT with u=4 computes what u=1 computes
        s2 = 2048
        prompt2 = M.CLI.random_prompt(cfg, b, s2, gen, dev)
        res = {}
        for u in (1, 4):
            cu = dataclasses.replace(cfg, fpdt_chunks=u)
            M.SV.prefill_step(cu, None, params, prompt2, max_len=s2)  # warm-up
            _reset_counts(M.K, M.SK)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, _ = M.SV.prefill_step(cu, None, params, prompt2, max_len=s2)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            res[u] = lg
            if not torch.isfinite(lg).all() or M.K.launches <= 0:
                raise AssertionError(f"u={u}: non-finite logits or no kernel launch")
            print(f"prefill {cfg.name} b={b} prompt={_prompt_words(cfg, s2)} fpdt_chunks={u}: "
                  f"{ms:.2f} ms, launches {_counts(M.K, M.SK)} [{card}]")
        diff = float((res[4] - res[1]).abs().max())
        print(f"u=4 vs u=1 prefill logits: max |diff| = {diff:.3e} (must be 0)")
        if diff != 0.0:
            raise AssertionError("u=4 prefill differs from u=1")
        del res, lg, prompt2
    del params, out, logits
    torch.cuda.empty_cache()

    # decode agrees with prefill (the repo's own check): the first decode
    # step's logits == the last logits of a prefill over the prompt plus that
    # token (an audio model's: that frame).  In fp32 weights, so the two
    # orders of summation differ by fp32 rounding only; beside it, how far
    # the same logits move when only the first prompt token (frame) changes,
    # which reaches them through attention or the recurrent state alone.
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    if cfg.num_experts:  # capacity for every pair: routing is then per token, as decode's
        cfg32 = dataclasses.replace(cfg32, moe_capacity_factor=cfg.num_experts
                                    / cfg.experts_per_token)
    params32 = M.T.init_params(cfg32, torch.Generator(device=dev).manual_seed(0), dev)
    prompt = {k: v.float() if v.is_floating_point() else v for k, v in prompt.items()}
    key = "frame_embeds" if audio else "tokens"
    nxt = frames[:, :1].float() if audio else toks[:, :1]
    other = dict(prompt)
    other[key] = prompt[key].clone()
    if audio:
        other[key][:, 0] = -other[key][:, 0]
    else:
        other[key][:, 0] = (other[key][:, 0] + 1) % cfg.vocab_size
    with torch.no_grad():
        _, cache = M.SV.prefill_step(cfg32, None, params32, prompt, max_len=s + 1)
        dec, _ = M.SV.decode_step(cfg32, None, params32, cache, {key: nxt}, s)
        full, _ = M.SV.prefill_step(cfg32, None, params32,
                                    {**prompt, key: torch.cat([prompt[key], nxt], dim=1)},
                                    max_len=s + 1)
        moved, _ = M.SV.prefill_step(cfg32, None, params32,
                                     {**other, key: torch.cat([other[key], nxt], dim=1)},
                                     max_len=s + 1)
    scale = float(full.abs().max())
    rel = float((dec - full).abs().max()) / scale
    signal = float((moved - full).abs().max()) / scale
    del params32, cache
    torch.cuda.empty_cache()
    if cfg.num_experts:
        print(f"{cfg.name}: the decode-vs-prefill check runs at capacity factor "
              f"{cfg32.moe_capacity_factor:g} (no pair dropped): decode's group is the batch's "
              f"{b} tokens, the prefill's its chunk's, and only without drops is routing per token")
    first = {"audio_frames": "frame 0 (negated)", "vision_patches": "token 0 (after the patches)"
             }.get(cfg.frontend, "token 0")
    print(f"{cfg.name} decode-vs-prefill fp32 logits ({cfg.num_layers} layers): max |diff| / "
          f"max |logit| = {rel:.3e} (tolerance {FP32_LOGIT_RTOL}); changing prompt {first} "
          f"moves them {signal:.3e}")
    if not rel <= FP32_LOGIT_RTOL:
        raise AssertionError("decode step disagrees with prefill")
    if not signal >= 10 * FP32_LOGIT_RTOL:
        raise AssertionError("the decode-vs-prefill check cannot see the context: "
                             f"a changed prompt moves the logits by {signal:.3e} only")
    return counts


def _model_flops(cfg, b, s):
    """Model FLOPs of one training step: 6 N per token for the weights that
    a token touches (N = ``cfg.num_active_params()``: for an MoE model the
    router and the experts_per_token experts a token is routed to, not all
    of them, the model FLOPs convention; the dense models' N is all of
    ``num_params``), plus, in each attention layer, 12 d per live (q, k)
    pair and q-head (4 d forward, 8 d backward) under that layer's causal
    mask and window (none for attn, ``cfg.window`` for local_attn).  RG-LRU
    layers have no pairs: their weights are in N."""
    attn = 0
    for kind in cfg.layer_kinds():
        if kind in ("attn", "local_attn"):
            window = cfg.window if kind == "local_attn" else 0
            attn += 12 * cfg.head_dim * cfg.num_heads * _live_pairs(s, s, 0, 0, window) * b
    return 6 * cfg.num_active_params() * b * s + attn


def _leaf_rels(TR, got, want):
    """Each leaf's largest |got - want| relative to its largest magnitude."""
    return [float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-30)
            for a, b in zip(TR.tree_leaves(got), TR.tree_leaves(want))]


def _expert_leaves(M, params) -> list:
    """Indices (in ``tree_leaves`` order) of the expert weights: the MoE
    blocks' wu, wg and wd.  Their gradients move by a token's share of an
    expert when a routing decision differs between two runs."""
    return [i for i, (names, _) in enumerate(M.TR.tree_leaves_with_path(params))
            if M.SH.is_expert_leaf(names)]


@contextlib.contextmanager
def _recording_moe_inputs(M, n):
    """Records the parameters and input of the first ``n`` MoE FFN calls (a
    forward pass's layers, before any recompute), the input as a detached
    copy."""
    got, real = [], M.MOE.moe_ffn_chunked

    def record(cfg, p, x, n_chunks, par=None):
        if len(got) < n:
            got.append((p, x.detach().clone()))
        return real(cfg, p, x, n_chunks, par)

    M.MOE.moe_ffn_chunked = record
    try:
        yield got
    finally:
        M.MOE.moe_ffn_chunked = real


def _moe_decisions(M, cfg, inputs, par=None):
    """The port's routing (``MOE.routing``) of each recorded MoE layer's
    input (this rank's tokens): per layer the top-k experts [b, s, k] and
    keep masks, on the host.  No collective: on a layout where a group
    spans ranks its decisions need the exchanged counts, and that raises."""
    def no_gather(_):
        raise AssertionError("a group spans ranks: its decisions need the exchanged counts")

    out = []
    for p, x in inputs:
        topi, keep = M.MOE.routing(cfg, p, x, cfg.mlp_chunks, par, gather=no_gather)
        out.append((topi.short().cpu(), keep.cpu()))
    return out


def _decisions_differ(a, b):
    """(token, layer) routing decisions that differ: another top-k list or
    another keep mask."""
    return sum(int(((ta != tb).any(-1) | (ka != kb).any(-1)).sum())
               for (ta, ka), (tb, kb) in zip(a, b))


PROFILE_GROUPS = (  # first match wins; matched against the lower-cased kernel name
    ("flash_bwd_dkv", ("flash_bwd_dkv", "flash_bwd_round_do")),
    ("flash_bwd_dq", ("flash_bwd_dq",)),
    ("flash_fwd", ("flash_fwd",)),
    ("linear_scan", ("linear_scan_",)),
    ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
    ("copy", ("memcpy", "memset")),
)


def _group_of(name: str) -> str:
    low = name.lower()
    for group, keys in PROFILE_GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def _merged(intervals):
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out = []
    for s0, e0 in sorted(intervals):
        if out and s0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e0)
        else:
            out.append([s0, e0])
    return out


def _length(merged) -> float:
    return sum(e - s for s, e in merged)


def _overlap(a, b) -> float:
    """Length of the intersection of two merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _profile_step(torch, TRAIN, TL, cfg, params, oc, batch_fn, dev, opt_state, off, card):
    """One more training step under torch.profiler: device ms by kernel
    group, the device's idle share of the step's wall time, and how much of
    the offload copies' time (pinned <-> device, on the copy stream) ran
    while a compute kernel ran."""
    from torch.profiler import ProfilerActivity, profile

    off.reset_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        TRAIN.train_steps(cfg, params, oc, TL.TrainConfig(steps=1, log_every=2), batch_fn, dev,
                          opt_state=opt_state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler recorded no device time")
    by_group, other = {}, {}  # group -> ms; kernel name -> (count, ms) within "other"
    for e in kernels:
        g = _group_of(e.name)
        ms = (e.time_range.end - e.time_range.start) / 1e3
        by_group[g] = by_group.get(g, 0.0) + ms
        if g == "other":
            n, total = other.get(e.name, (0, 0.0))
            other[e.name] = (n + 1, total + ms)
    top_other = sorted(other.items(), key=lambda kv: -kv[1][1])[:8]
    compute = _merged([(e.time_range.start, e.time_range.end) for e in kernels
                       if _group_of(e.name) != "copy"])
    copies = _merged([(e.time_range.start, e.time_range.end) for e in kernels
                      if "memcpy" in e.name.lower() and "pinned" in e.name.lower()])
    api = {}  # CUDA runtime calls on the host: name -> (count, ms)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("cuda"):
            n, ms = api.get(e.name, (0, 0.0))
            api[e.name] = (n + 1, ms + (e.time_range.end - e.time_range.start) / 1e3)
    top_api = sorted(api.items(), key=lambda kv: -kv[1][1])[:5]
    copy_us = _length(copies)
    hidden = _overlap(copies, compute) / copy_us if copy_us else float("nan")
    busy = _length(compute) / wall_us
    offload = "on" if cfg.fpdt_offload else "off"
    groups = {g: round(ms, 3) for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1])}
    print(f"profiled step (offload {offload}): wall {wall_us / 1e3:.1f} ms; device ms by group "
          + json.dumps(groups)
          + f"; compute kernels busy {busy:.4f} of the wall time, idle {1 - busy:.4f}; "
          f"pinned<->device copies {copy_us / 1e3:.3f} ms, {hidden:.4f} of it under a compute "
          f"kernel; moved {off.to_host_bytes / 2**20:.1f} MiB to the host and "
          f"{off.to_device_bytes / 2**20:.1f} MiB back; host time in CUDA runtime calls "
          + ", ".join(f"{k} {n}x {ms:.1f} ms" for k, (n, ms) in top_api) + f" [{card}]")
    print("  largest kernels in 'other': " + "; ".join(
        f"{ms:.1f} ms in {n}x {name[:90]}" for name, (n, ms) in top_other))
    return {"wall_ms": wall_us / 1e3, "groups": by_group, "idle": 1 - busy,
            "copy_ms": copy_us / 1e3, "copy_hidden": hidden}


def _same_bits(torch, M, cfg, params, batch, label, variants):
    """The loss (and an MoE model's aux) and every gradient leaf of one
    batch at ``cfg`` against each of ``variants``, (name, overrides of
    ``cfg``) pairs, bit for bit: offload off (the same kernels in the same
    order), remat offload (the same recompute), or no override, a second
    run (no atomic sum reorders a float sum, the MoE dispatch's adjoint
    included)."""
    l_a, m_a, g_a = M.TL.value_and_grad(cfg, None, params, batch)
    leaves = M.TR.tree_leaves(g_a)
    for name, over in variants:
        loss, metrics, grads = M.TL.value_and_grad(dataclasses.replace(cfg, **over), None,
                                                   params, batch)
        torch.cuda.synchronize()
        differ = sum(not torch.equal(a, b) for a, b in zip(leaves, M.TR.tree_leaves(grads)))
        print(f"{label}: {name} vs as configured: loss {float(loss):.6f} vs {float(l_a):.6f}, "
              f"aux {float(metrics['aux']):.6f} vs {float(m_a['aux']):.6f}; gradient leaves "
              f"that differ: {differ} of {len(leaves)}")
        if not (torch.equal(l_a, loss) and torch.equal(m_a["aux"], metrics["aux"])) or differ:
            raise AssertionError(f"{label}: {name} gives another loss or other gradients")
        del grads
    del g_a, leaves
    torch.cuda.empty_cache()


def _pinned_residuals(torch, M, cfg, params, seq, batch):
    """The chunks offload stores are pinned host tensors: one layer's
    attention at the training shape, its saved tensors seen as they are
    saved."""
    dev = torch.device("cuda")
    attn_p = M.T.cycle(params["cycles"], 0)["pos0"]["attn"]
    x = (0.02 * torch.randn((batch, seq, cfg.d_model), device=dev)).to(torch.bfloat16)
    x.requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        o = M.F.fpdt_attention(cfg, None, attn_p, x)
    host = [t for t in saved if t.device.type == "cpu"]
    pinned = sum(t.numel() * t.element_size() for t in host if t.is_pinned())
    o.float().square().sum().backward()
    torch.cuda.synchronize()
    print(f"offloaded residuals of one layer: {len(host)} host tensors (q, k, v of "
          f"{cfg.fpdt_chunks} chunks), {pinned / 2**20:.1f} MiB pinned; x.grad finite: "
          f"{bool(torch.isfinite(x.grad).all())}")
    if len(host) != 3 * cfg.fpdt_chunks or not all(t.is_pinned() for t in host) or pinned <= 0:
        raise AssertionError("offloaded chunks are not pinned host tensors")


def _train_run(torch, M, cfg, card, *, profile_offload=(True,), extra_check=None,
               same_bits=(), readings=None):
    """A model's training phase at b1, seq 8192, u=4, mlp_chunks 8, remat
    full (offload as ``cfg`` has it): offload off and each ``same_bits``
    variant against ``cfg`` bit for bit (``_same_bits``);
    ``extra_check(cfg, params, batch)``; 3 AdamW steps through the CLI's
    own function (train_steps), the launch counts read around each step;
    step ms, tokens/s, MFU, peak memory, offload bytes; the losses against
    EARLIER_LOSSES; one profiled step per ``profile_offload`` flag; u=4 vs
    u=1 in fp32 weights at every layer.  A model with no attention layer
    (falcon-mamba-7b) has nothing for FPDT to chunk or offload, so the
    offload and u comparisons are skipped for it.  Returns each kernel's
    launches over the 3 steps; ``readings`` (a dict) gets the steps'
    records and the peak."""
    dev = torch.device("cuda")
    seq, batch, steps = TRAIN_SEQ, 1, 3
    t0 = time.perf_counter()
    params = M.T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    pbytes = sum(t.numel() * t.element_size() for t in M.TR.tree_leaves(params))
    pat, n_cycles, tail = M.T.layout_of(cfg)
    print(f"init_params {cfg.name} ({cfg.num_layers} layers: {n_cycles} cycles of {pat} + tail "
          f"{tail}; {cfg.num_params() / 1e9:.3f} B params, {cfg.param_dtype}, "
          f"{pbytes / 2**30:.2f} GiB) in {time.perf_counter() - t0:.1f} s")
    batch_fn = M.DP.make_batch_fn(cfg, M.cfg_mod.ShapeConfig("smoke", seq, batch, "train"))
    b0 = {k: torch.from_numpy(v).to(dev) for k, v in batch_fn(0).items()}
    attention = M.T.has_attention(cfg)
    variants = [("offload off", {"fpdt_offload": False})] * attention + list(same_bits)
    if variants:
        _same_bits(torch, M, cfg, params, b0, f"{cfg.name} ({cfg.num_layers} layers), step 1's "
                   "batch", variants)
    if extra_check is not None:
        extra_check(cfg, params, b0)

    oc = M.TRAIN.opt_config(cfg, 3e-4, steps)
    tc = M.TL.TrainConfig(steps=steps, log_every=steps + 1)
    off = M.PL.host_offload(dev)
    records = []

    def on_step(rec):
        rec["launches"] = _counts(M.K, M.SK)
        records.append(rec)
        _reset_counts(M.K, M.SK)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    off.reset_counts()
    _reset_counts(M.K, M.SK)
    params, opt_state, *_ = M.TRAIN.train_steps(cfg, params, oc, tc, batch_fn, dev,
                                                on_step=on_step)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    flops = _model_flops(cfg, batch, seq)
    want = _launches_per_step(cfg, M.F, M.T, M.MB, seq)
    for rec in records:
        mfu = flops / (rec["dt"] * PEAK_BF16_FLOPS)
        rec.update(tokens_per_s=batch * seq / rec["dt"], mfu=mfu)
        aux = f" aux {rec['aux']:.4f}" if "aux" in rec else ""
        print(f"train step {rec['step']}: loss {rec['loss']:.4f}{aux} grad_norm "
              f"{rec['grad_norm']:.4f} {rec['dt'] * 1e3:.1f} ms, {rec['tokens_per_s']:.0f} "
              f"tokens/s, MFU {mfu:.4f}; launches {rec['launches']} [{card}]")
        if not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"])):
            raise AssertionError(f"step {rec['step']}: non-finite loss or grad norm")
        if rec["launches"] != want:
            raise AssertionError(f"step {rec['step']}: launches {rec['launches']}, expected {want}")
    if len(records) != steps:
        raise AssertionError(f"{len(records)} steps taken, {steps} asked")
    _check_losses(cfg.name, records, card)
    if readings is not None:
        readings.update(records=records, peak_gib=peak_gib)
    print(f"train {cfg.name} ({cfg.num_layers} layers) b={batch} seq={seq} u={cfg.fpdt_chunks} "
          f"mlp_chunks={cfg.mlp_chunks} remat={cfg.remat} offload="
          f"{'on' if cfg.fpdt_offload else 'off'}: peak device memory "
          f"{peak_gib:.2f} GiB (reckoned {_reckoned_peak_gib(M, cfg, 1, seq):.2f}); host offload "
          f"moved {off.to_host_bytes / 2**30:.2f} GiB to pinned "
          f"host memory and {off.to_device_bytes / 2**30:.2f} GiB back over {steps} steps; model "
          f"FLOPs/step {flops:.4e} [{card}]")
    if cfg.fpdt_offload and (off.to_host_bytes <= 0 or off.to_device_bytes <= 0):
        raise AssertionError("offload on moved no bytes through pinned host memory")
    totals = {k: sum(r["launches"][k] for r in records) for k in want}
    # where a step's time goes (the first profiled step also pays the
    # profiler's own start-up)
    prof = {flag: _profile_step(torch, M.TRAIN, M.TL, dataclasses.replace(cfg, fpdt_offload=flag),
                                params, oc, batch_fn, dev, opt_state, off, card)
            for flag in profile_offload}
    if True in prof and not prof[True]["copy_ms"] > 0:
        raise AssertionError("the profiled step with offload on shows no pinned copies")
    del params, opt_state
    torch.cuda.empty_cache()
    if not attention:
        return totals

    # u=4 vs u=1 in fp32 weights: the loss and every gradient leaf (an MoE
    # model's mlp_chunks kept, so its chunks and groups are the same)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", fpdt_offload=False)
    p32 = M.T.init_params(cfg32, torch.Generator(device=dev).manual_seed(0), dev)
    moe_layers = cfg.num_layers if cfg.num_experts else 0
    with _recording_moe_inputs(M, moe_layers) as in4:
        l4, m4, g4 = M.TL.value_and_grad(cfg32, None, p32, b0)
    dec4 = _moe_decisions(M, cfg32, in4)
    del in4
    with _recording_moe_inputs(M, moe_layers) as in1:
        l1, m1, g1 = M.TL.value_and_grad(dataclasses.replace(cfg32, fpdt_chunks=1), None, p32,
                                         b0)
    dec1 = _moe_decisions(M, cfg32, in1)
    del in1
    torch.cuda.synchronize()
    loss_rel = abs(float(l4) - float(l1)) / abs(float(l1))
    n4, n1 = (math.sqrt(sum(float(x.float().square().sum()) for x in M.TR.tree_leaves(g)))
              for g in (g4, g1))
    loss_rel = max(loss_rel, abs(n4 - n1) / n1)
    rels = _leaf_rels(M.TR, g4, g1)
    grad_rel, leaf = max((r, n) for n, r in enumerate(rels))
    line = (f"fp32 weights, {cfg32.num_layers} layers, u=4 vs u=1 at seq {seq}: loss "
            f"{float(l4):.6f} vs {float(l1):.6f}, gradient norm {n4:.6f} vs {n1:.6f} (largest "
            f"rel {loss_rel:.3e}); largest gradient-leaf "
            f"error / leaf max {grad_rel:.3e} (leaf {leaf} of {len(rels)}); tolerance "
            f"{FPDT_GRAD_RTOL}")
    if cfg.qkv_bias:  # the biases' gradients, held with the other leaves
        names = ["/".join(n) for n, _ in M.TR.tree_leaves_with_path(g4)]
        line += "; " + ", ".join(f"{n} {r:.3e}" for n, r in zip(names, rels)
                                 if n.rsplit("/", 1)[-1] in ("bq", "bk", "bv"))
    gated = rels
    if cfg.num_experts:
        differ = _decisions_differ(dec4, dec1)
        experts = set(_expert_leaves(M, p32))
        if differ:  # a flipped decision moves an expert's gradient by a token's share
            gated = [r for n, r in enumerate(rels) if n not in experts]
        worst = max((r, n) for n, r in enumerate(rels) if n in experts)
        aux_rel = abs(float(m4["aux"]) - float(m1["aux"])) / abs(float(m1["aux"]))
        line += (f"; MoE routing decisions (token, layer) that differ: {differ} of "
                 f"{sum(t.shape[0] * t.shape[1] for t, _ in dec1)}; aux rel {aux_rel:.3e}; "
                 f"worst expert leaf {worst[0]:.3e} (leaf {worst[1]}), "
                 + ("gated" if not differ else "not gated: the others held"))
        loss_rel = max(loss_rel, aux_rel)
    print(line)
    if loss_rel > FPDT_GRAD_RTOL or max(gated) > FPDT_GRAD_RTOL:
        raise AssertionError("u=4 training gradients differ from u=1")
    del p32, g4, g1
    torch.cuda.empty_cache()
    return totals


TRAIN_SEQ = 8192  # the training phases' sequence length (b1, u=4: 2048-token chunks)


def _train_cfg(M, name, **overrides):
    """``name`` at the training phases' settings: u=4, mlp_chunks 8, remat
    full, FPDT offload on."""
    return dataclasses.replace(M.cfg_mod.get_config(name, **overrides), fpdt_chunks=4,
                               mlp_chunks=8, remat="full", fpdt_offload=True)


def phase_train(torch, M, card, readings):
    """llama3.2-1b at full width; profiled with offload off and on; the
    offloaded chunks are pinned host tensors."""
    return _train_run(torch, M, _train_cfg(M, "llama3.2-1b"), card, profile_offload=(False, True),
                      extra_check=lambda cfg, params, _: _pinned_residuals(torch, M, cfg, params,
                                                                           TRAIN_SEQ, 1),
                      readings=readings)


# The train CLI with the three flags it took last (6a): llama3.2-1b as phase
# 6 trains it (the CLI's --chunks 4 is u 4, mlp_chunks 8), with
# --compress-grads, --trace-out and --metrics-out.
CLI_ARGV = ("--arch llama3.2-1b --steps 3 --batch 1 --seq 8192 --chunks 4 --offload "
            "--remat full --compress-grads --log-every 1").split()
# The quantizer's fp32 temporaries an element of the slab it works on
# (optim/compression.py::quantize_with_feedback_: the target, its
# magnitudes or target / scale, q in int8, g_hat), 13 bytes at most.
QUANT_BYTES = 13
# The quantizer on the card against the CPU (6a), at these leaf shapes:
# llama3.2-1b's tied table; granite-moe-1b-a400m's vocabulary by d (the
# last block padded with 1024 zeros); a norm stack; a leaf shorter than a
# block.
QUANT_SHAPES = ((128256, 2048), (49155, 1024), (16, 2048), (1000,))


def _quantizer_card_vs_cpu(torch, M, card):
    """quantize_with_feedback on the card equals the same call on the CPU,
    bit for bit, in g_hat and the residual: fp32 and bf16 gradients of
    QUANT_SHAPES, each row's magnitude log-uniform in [1e-6, 1e3], and
    residuals of a thousandth of that, from a seed."""
    dev = torch.device("cuda")
    rows = []
    for i, shape in enumerate(QUANT_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(100 + i)
            lead = shape[0] if len(shape) > 1 else 1
            mag = torch.pow(10.0, torch.rand((lead,) + (1,) * (len(shape) - 1), generator=gen,
                                             device=dev) * 9 - 6)
            g = (torch.randn(shape, generator=gen, device=dev) * mag).to(dtype)
            r = torch.randn(shape, generator=gen, device=dev) * mag * 1e-3
            on_card = M.C.quantize_with_feedback(g, r)
            on_cpu = M.C.quantize_with_feedback(g.cpu(), r.cpu())
            same = [torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu)]
            rows.append(f"{list(shape)} {str(dtype)[6:]}: g_hat {same[0]}, residual {same[1]}")
            if not all(same):
                raise AssertionError(f"the quantizer on the card differs from the CPU's at "
                                     f"{shape} {dtype}")
            del g, r, on_card, on_cpu
    torch.cuda.empty_cache()
    print("quantizer on the card vs the CPU, bit for bit: " + "; ".join(rows) + f" [{card}]")


def phase_train_cli(torch, M, card, ref):
    """The train CLI's main in this process with CLI_ARGV and --trace-out /
    --metrics-out: all 16 layers of llama3.2-1b at full width, 3 steps.
    Held: the trace's 3 train.step spans (their durations the history's
    dt), the Prometheus series, B1-B3's launches a step as phase 6's, step
    1's loss the same bits as phase 6's (``ref``: the same weights, batch,
    config and kernels; compression moves only the update) and within
    LOSS_RTOL of EARLIER_LOSSES, the residuals' bytes 4 a parameter.
    Printed: steps 2-3 beside phase 6's, the peak beside its reckoning
    (phase 6's peak, the residuals and the quantizer's largest slab's
    temporaries), the quantizer's device ms a step for the whole tree
    (CUDA events around the call).  Then the quantizer on the card against
    the CPU.  Returns each kernel's launches over the 3 steps."""
    import tempfile

    cfg = _train_cfg(M, "llama3.2-1b")
    plans = M.TR.tree_leaves(M.SH.param_plans(cfg, 1, 1))
    n_params = sum(math.prod(p.shape) for p in plans)
    transient = QUANT_BYTES * min(M.C.SLAB, max(math.prod(p.shape) for p in plans))
    reckoned = ref["peak_gib"] + (4 * n_params + transient) / 2**30
    print(f"reckoned before the run: residuals 4 x {n_params} = {4 * n_params} bytes; peak "
          f"{reckoned:.2f} GiB (phase 6's {ref['peak_gib']:.2f} + the residuals "
          f"{4 * n_params / 2**30:.2f} + the quantizer's slab {transient / 2**30:.3f})")
    want = _launches_per_step(cfg, M.F, M.T, M.MB, TRAIN_SEQ)
    real_quantize, real_steps = M.C.tree_quantize_with_feedback_, M.TRAIN.train_steps
    events, runs = [], []

    def timed(*a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_quantize(*a, **kw)
        end.record()
        events.append((start, end))
        return out

    def kept(*a, **kw):
        runs.append(real_steps(*a, **kw))
        return runs[-1]

    with tempfile.TemporaryDirectory() as tmp:
        trace, prom = os.path.join(tmp, "train.json"), os.path.join(tmp, "train.prom")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts(M.K, M.SK)
        M.C.tree_quantize_with_feedback_, M.TRAIN.train_steps = timed, kept
        try:
            history = M.TRAIN.main(list(CLI_ARGV) + ["--trace-out", trace, "--metrics-out", prom])
        finally:
            M.C.tree_quantize_with_feedback_, M.TRAIN.train_steps = real_quantize, real_steps
        torch.cuda.synchronize()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        launches = _counts(M.K, M.SK)
        with open(trace) as fh:
            doc = json.load(fh)
        with open(prom) as fh:
            text = fh.read()
    (run,) = runs
    quant_ms = [a.elapsed_time(b) for a, b in events]
    residual_bytes = sum(t.numel() * t.element_size() for t in M.TR.tree_leaves(run.residuals))
    del run, runs
    torch.cuda.empty_cache()
    spans = [e for e in doc["traceEvents"] if e["name"] == "train.step" and e["ph"] == "X"]
    series = ['repro_train_steps{component="train"} 3',
              'repro_train_step_ms_count{component="train"} 3']
    base = ref["records"]
    for rec, b in zip(history, base):
        print(f"CLI --compress-grads step {rec['step']}: loss {rec['loss']:.6f} grad_norm "
              f"{rec['grad_norm']:.6f} {rec['dt'] * 1e3:.1f} ms; uncompressed (phase 6) loss "
              f"{b['loss']:.6f} grad_norm {b['grad_norm']:.6f} {b['dt'] * 1e3:.1f} ms; quantizer "
              f"{quant_ms[rec['step'] - 1]:.3f} ms device time [{card}]")
    mean_dt = sum(r["dt"] for r in history) / len(history)
    print(f"CLI llama3.2-1b ({cfg.num_layers} layers) --compress-grads --trace-out "
          f"--metrics-out: residuals {residual_bytes} bytes; peak {peak_gib:.2f} GiB (reckoned "
          f"{reckoned:.2f}; phase 6 {ref['peak_gib']:.2f}); quantizer {min(quant_ms):.3f}-{max(quant_ms):.3f} ms a step, "
          f"{sum(quant_ms) / len(quant_ms) / (mean_dt * 1e3):.4f} of the mean step; launches "
          f"{launches} over 3 steps; trace {len(doc['traceEvents'])} events, "
          f"{len(spans)} train.step spans; Prometheus series present: "
          f"{[x in text for x in series]} [{card}]")
    if len(history) != 3 or not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                                    for r in history):
        raise AssertionError("the CLI's history is not 3 finite steps")
    if history[0]["loss"] != base[0]["loss"]:
        raise AssertionError(f"step 1's loss {history[0]['loss']!r} is not phase 6's "
                             f"{base[0]['loss']!r}")
    early = EARLIER_LOSSES["llama3.2-1b"][0]
    if abs(history[0]["loss"] - early) > LOSS_RTOL * abs(early):
        raise AssertionError(f"step 1's loss moves beyond {LOSS_RTOL:.0%} of {early}")
    if launches != {k: 3 * v for k, v in want.items()}:
        raise AssertionError(f"launches {launches}, reckoned 3 x {want}")
    if residual_bytes != 4 * n_params:
        raise AssertionError(f"residuals of {residual_bytes} bytes, reckoned {4 * n_params}")
    if len(spans) != 3 or any(
            not math.isclose(e["dur"], r["dt"] * 1e6, rel_tol=1e-12) or e["args"]["step"]
            != r["step"] for e, r in zip(spans, history)):
        raise AssertionError(f"the trace's train.step spans {spans} are not the history's")
    if not all(x in text for x in series):
        raise AssertionError(f"the Prometheus text lacks {series}:\n{text}")
    _quantizer_card_vs_cpu(torch, M, card)
    return launches


def phase_train_hybrid(torch, M, card):
    """recurrentgemma-9b at full width, 8 layers."""
    return _train_run(torch, M, _train_cfg(M, "recurrentgemma-9b", num_layers=8), card)


def phase_train_gpt(torch, M, card):
    """gpt-2.7b (the paper's GPT) at full width and full depth (32 layers),
    B1-B3 at head_dim 80."""
    return _train_run(torch, M, _train_cfg(M, "gpt-2.7b"), card)


GRANITE = "granite-moe-1b-a400m"


def phase_train_granite(torch, M, card):
    """granite-moe-1b-a400m at full width and depth (24 layers; 32 experts,
    top-8): offload on == off, two runs of the first step and remat
    offload == remat full, each bit for bit; the training run, profiled
    with offload on; u=4 vs u=1 in fp32 weights with the routing decisions
    that differ counted."""
    return _train_run(torch, M, _train_cfg(M, GRANITE), card,
                      same_bits=[("a second run", {}), ("remat offload", {"remat": "offload"})])


FRONTEND_ARCHS = ("musicgen-medium", "internvl2-2b")
QWEN, QWEN_LAYERS = "qwen1.5-4b", 8  # of 40: 1.412 B parameters, 16.9 GB of training state


def phase_train_frontend(torch, M, card, arch):
    """musicgen-medium (48 layers, audio frames) or internvl2-2b (24 layers,
    vision patches) at full width and depth: as 6b without the profiled
    step; internvl's loss of the first batch counts its b (S - num_patches)
    labelled tokens, none at a patch position."""
    cfg = _train_cfg(M, arch)

    def no_patch_loss(cfg, params, batch):
        with torch.no_grad():
            _, metrics = M.T.loss_fn(cfg, None, params, batch)
        b, seq = batch["tokens"].shape[0], TRAIN_SEQ
        want = b * (seq - cfg.num_patches)
        print(f"{cfg.name}: the loss counts {float(metrics['tokens']):.0f} tokens of the "
              f"{b} x {seq} positions, b (S - {cfg.num_patches} patches) = {want} [{card}]")
        if float(metrics["tokens"]) != want:
            raise AssertionError("the vision model's loss counts patch positions")

    vision = cfg.frontend == "vision_patches"
    return _train_run(torch, M, cfg, card, profile_offload=(),
                      extra_check=no_patch_loss if vision else None)


def phase_train_qwen(torch, M, card):
    """qwen1.5-4b at full width and 8 layers: the FPDT backward with the qkv
    bias, whose gradients the u=4 vs u=1 comparison holds with every other
    leaf; as 6b without the profiled step."""
    return _train_run(torch, M, _train_cfg(M, QWEN, num_layers=QWEN_LAYERS), card,
                      profile_offload=())


MOE_LAYER_ITERS = 10


def phase_moe_layer(torch, M, card):
    """One granite MoE FFN layer alone at the training shape (b1, TRAIN_SEQ
    tokens, mlp_chunks 8, bf16 with the fp32 router): its forward and
    backward under torch.cuda.set_sync_debug_mode("error"), so that any
    host read of a device value (an .item(), a nonzero, a mask index, a
    bounds check) fails the phase; a second run the same bits; the device
    time of a forward and of a forward and backward (CUDA events), and
    what 24 layers of them take in a remat-full step (each layer's forward
    three times: the cycle's pass, its recompute and the chunk's
    recompute; its backward once)."""
    dev = torch.device("cuda")
    cfg = _train_cfg(M, GRANITE)
    g = torch.Generator(device=dev).manual_seed(3)
    p = {k: v.requires_grad_(True)
         for k, v in M.MOE.init_moe(cfg, g, torch.bfloat16, dev).items()}
    x = torch.randn((1, TRAIN_SEQ, cfg.d_model), generator=g, device=dev).to(torch.bfloat16)
    x.requires_grad_(True)
    dy = torch.randn((1, TRAIN_SEQ, cfg.d_model), generator=g, device=dev)

    def run():
        for t in (x, *p.values()):
            t.grad = None
        y, aux = M.MOE.moe_ffn_chunked(cfg, p, x, cfg.mlp_chunks)
        ((y.float() * dy).sum() + aux).backward()
        return [y.detach(), aux.detach(), x.grad, *(p[k].grad for k in sorted(p))]

    run()  # warm-up: cuBLAS handles and the allocator's pools
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    second = run()
    torch.cuda.synchronize()
    differ = [n for n, (a, b) in enumerate(zip(first, second)) if not torch.equal(a, b)]
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    events[0].record()
    with torch.no_grad():
        for _ in range(MOE_LAYER_ITERS):
            M.MOE.moe_ffn_chunked(cfg, p, x, cfg.mlp_chunks)
    events[1].record()
    for _ in range(MOE_LAYER_ITERS):
        run()
    events[2].record()
    torch.cuda.synchronize()
    fwd = events[0].elapsed_time(events[1]) / MOE_LAYER_ITERS
    both = events[1].elapsed_time(events[2]) / MOE_LAYER_ITERS
    layers = M.cfg_mod.get_config(GRANITE).num_layers
    print(f"granite MoE layer alone (b1 s{TRAIN_SEQ}, {cfg.num_experts} experts top-"
          f"{cfg.experts_per_token}, mlp_chunks {cfg.mlp_chunks}, bf16): forward and backward "
          f"under set_sync_debug_mode('error') with no host read; a second run differs in "
          f"{differ or 'nothing'}; forward {fwd:.3f} ms, forward + backward {both:.3f} ms "
          f"(CUDA events, {MOE_LAYER_ITERS} runs); a remat-full step's {layers} layers: "
          f"{layers * (2 * fwd + both):.1f} ms [{card}]")
    if differ:
        raise AssertionError(f"two runs of the MoE layer differ in outputs {differ}")
    return {"fwd_ms": fwd, "fwd_bwd_ms": both}


FALCON_LAYERS = 16  # of 64: 2.218 B parameters, 24.8 GiB of weights, gradients, AdamW state


def phase_train_falcon(torch, M, card):
    """falcon-mamba-7b at full width, FALCON_LAYERS of its 64 layers (64 need
    ~87 GB of state): remat offload == remat full bit for bit at this depth,
    then the training run (no attention: no FPDT offload, profiled once)."""
    cfg = dataclasses.replace(_train_cfg(M, "falcon-mamba-7b", num_layers=FALCON_LAYERS),
                              fpdt_offload=False)
    return _train_run(torch, M, cfg, card, profile_offload=(False,),
                      same_bits=[("remat offload", {"remat": "offload"})])


def _check_losses(name, records, card):
    """Each step's loss against an earlier commit's (EARLIER_LOSSES); a model
    with no earlier figure prints its losses for the next change to hold."""
    losses = [rec["loss"] for rec in records]
    earlier = EARLIER_LOSSES.get(name)
    if earlier is None:
        print(f"{name} losses {', '.join(f'{x:.4f}' for x in losses)}: no earlier figure to "
              f"hold them to [{card}]")
        return
    pairs = list(zip(losses, earlier))
    print(f"{name} losses, this run vs the earlier commit's from the same seed: "
          + ", ".join(f"step {n + 1} {a:.4f} vs {e:.4f}" for n, (a, e) in enumerate(pairs))
          + f" (limit {LOSS_RTOL:.0%}) [{card}]")
    if len(pairs) != len(earlier) or any(abs(a - e) > LOSS_RTOL * abs(e) for a, e in pairs):
        raise AssertionError(f"{name}: losses move beyond {LOSS_RTOL:.0%} of the earlier ones")


def _launches_per_step(cfg, F, T, MB, seq, sp=1):
    """Launches per training step (a rank's, over ``sp`` model ranks) of each
    kernel under remat full or offload: a layer in a recomputed cycle runs
    its forward twice (and flash_fwd once per live pair each time), a tail
    layer once; the backward once.  An ssm layer's selective scan runs
    linear_scan once a block (MB.BLOCK_S tokens) in each of those forwards,
    and once more in the block's own checkpoint recompute, and
    linear_scan_bwd once a block.  Under sp > 1 a recurrent layer scans
    twice (pass 1 and pass 2), each over the rank's u spans as u rows of
    seq / (u sp) tokens, so a scan's blocks are a span's.  An attention
    block's MoE FFN (granite) launches none of these kernels: its routing,
    dispatch and expert products are PyTorch ops, so an MoE layer counts as
    its attention alone."""
    pat, n_cycles, tail = T.layout_of(cfg)
    u, cq = cfg.fpdt_chunks, seq // cfg.fpdt_chunks
    scans, row = (2, seq // (u * sp)) if sp > 1 else (1, seq)
    want = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "linear_scan": 0,
            "linear_scan_bwd": 0}
    for kind, passes in [(k, 2) for k in pat for _ in range(n_cycles)] + [(k, 1) for k in tail]:
        if kind == "rglru":
            want["linear_scan"] += scans * passes
            want["linear_scan_bwd"] += scans
        elif kind == "ssm":
            blocks = row // min(MB.BLOCK_S, row)
            want["linear_scan"] += scans * (passes + 1) * blocks
            want["linear_scan_bwd"] += scans * blocks
        else:
            window = cfg.window if kind == "local_attn" else 0
            pairs = sum(F.pair_live(i, j, cq=cq, window=window, sparsity=cfg.attn_sparsity)
                        for i in range(u) for j in range(i + 1))
            want["flash_fwd"] += passes * pairs
            want["flash_bwd_dq"] += pairs
            want["flash_bwd_dkv"] += pairs
    return want


LONG_SEQS = (16384, 32768)
LONG_CHUNK = 4096  # tokens an FPDT chunk, as the paper fixes it
LONG_SETTINGS = {  # the paper's two memory levers, added one at a time
    "A": dict(fpdt_offload=False, remat="full"),
    "B": dict(fpdt_offload=True, remat="full"),
    "C": dict(fpdt_offload=True, remat="offload"),
}


def phase_long_context(torch, M, card):
    """gpt-2.7b at full depth, b1, chunk 4096 (u = s / 4096, mlp_chunks 2u)
    at s in LONG_SEQS under settings A (FPDT offload off, remat full), B
    (offload on, remat full) and C (offload on, remat offload): 2 AdamW steps
    each after a reset of the peak-memory count; the second step's ms, peak
    device memory, offload bytes and the pinned bytes held at the peak.  C
    must equal B bit for bit at the shorter length, move exactly the cycle
    inputs more to the host, and peak lower.  From the two lengths, each
    setting's device bytes per token and intercept, and the context it
    would reach on this card, reckoned from them."""
    dev = torch.device("cuda")
    off = M.PL.host_offload(dev)
    base = M.cfg_mod.get_config("gpt-2.7b")
    _, n_cycles, _ = M.T.layout_of(base)
    runs = {}
    for seq in LONG_SEQS:
        u = seq // LONG_CHUNK
        cfgs = {k: dataclasses.replace(base, fpdt_chunks=u, mlp_chunks=2 * u, **kw)
                for k, kw in LONG_SETTINGS.items()}
        batch_fn = M.DP.make_batch_fn(base, M.cfg_mod.ShapeConfig("long", seq, 1, "train"))
        if seq == LONG_SEQS[0]:  # remat offload == remat full, bit for bit
            params = M.T.init_params(base, torch.Generator(device=dev).manual_seed(0), dev)
            b0 = {k: torch.from_numpy(v).to(dev) for k, v in batch_fn(0).items()}
            _same_bits(torch, M, cfgs["B"], params, b0, f"gpt-2.7b seq {seq} (offload on, remat "
                       "full)", [("remat offload", {"remat": "offload"})])
            del params, b0
            torch.cuda.empty_cache()
        for name, cfg in cfgs.items():
            params = M.T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
            oc = M.TRAIN.opt_config(cfg, 3e-4, 2)
            recs = []

            def on_step(rec):
                torch.cuda.synchronize()
                rec.update(peak=torch.cuda.max_memory_allocated(), to_host=off.to_host_bytes,
                           to_device=off.to_device_bytes, held=off.peak_held_bytes)
                recs.append(rec)
                off.reset_counts()

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            off.reset_counts()
            M.TRAIN.train_steps(cfg, params, oc, M.TL.TrainConfig(steps=2, log_every=3),
                                batch_fn, dev, on_step=on_step)
            rec = recs[-1]
            rec["flops"] = _model_flops(cfg, 1, seq)
            runs[name, seq] = rec
            print(f"long context {name} ({'FPDT offload ' + ('on' if cfg.fpdt_offload else 'off')}"
                  f", remat {cfg.remat}) gpt-2.7b b1 seq {seq} u={u} mlp_chunks={2 * u}: step 2 "
                  f"{rec['dt'] * 1e3:.1f} ms ({seq / rec['dt']:.0f} tokens/s, MFU "
                  f"{rec['flops'] / (rec['dt'] * PEAK_BF16_FLOPS):.4f}), loss {rec['loss']:.4f}; "
                  f"peak device memory {rec['peak'] / 2**30:.3f} GiB; step 2 moved "
                  f"{rec['to_host'] / 2**30:.3f} GiB to pinned host memory and "
                  f"{rec['to_device'] / 2**30:.3f} GiB back; pinned bytes held at most "
                  f"{rec['held'] / 2**30:.3f} GiB [{card}]")
            if not math.isfinite(rec["loss"]):
                raise AssertionError(f"{name} seq {seq}: non-finite loss")
            del params, recs
            torch.cuda.empty_cache()
        extra = n_cycles * seq * base.d_model * 2  # bf16 cycle inputs of b1
        got = runs["C", seq]["to_host"] - runs["B", seq]["to_host"]
        print(f"seq {seq}: C moved {got} bytes more to the host than B in step 2, the cycle "
              f"inputs are {extra} ({n_cycles} x {seq} x {base.d_model} x 2); C's peak "
              f"{runs['C', seq]['peak'] / 2**30:.3f} GiB vs B's {runs['B', seq]['peak'] / 2**30:.3f}")
        if got != extra:
            raise AssertionError(f"seq {seq}: remat offload moved {got} extra bytes, not {extra}")
        if not runs["C", seq]["peak"] < runs["B", seq]["peak"]:
            raise AssertionError(f"seq {seq}: remat offload does not lower the peak")

    card_bytes = torch.cuda.mem_get_info(dev)[1]
    host_bytes = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    s0, s1 = LONG_SEQS
    fit = {}
    for name in LONG_SETTINGS:
        p0, p1 = runs[name, s0]["peak"], runs[name, s1]["peak"]
        slope = (p1 - p0) / (s1 - s0)
        intercept = p0 - slope * s0
        longest = (card_bytes - intercept) / slope
        h0, h1 = runs[name, s0]["held"], runs[name, s1]["held"]
        host_slope = (h1 - h0) / (s1 - s0)
        host_longest = (host_bytes - (h0 - host_slope * s0)) / host_slope if host_slope > 0 \
            else math.inf
        fit[name] = {"bytes_per_token": slope, "intercept_bytes": intercept,
                     "reckoned_longest_tokens": longest,
                     "pinned_bytes_per_token": host_slope,
                     "reckoned_host_longest_tokens": host_longest}
        print(f"long context {name}: {slope / 1e3:.2f} KB of device memory a token above an "
              f"intercept of {intercept / 2**30:.3f} GiB; reckoned longest context on this card's "
              f"{card_bytes / 2**30:.2f} GiB: {longest:.0f} tokens; pinned host bytes "
              f"{host_slope / 1e3:.2f} KB a token, reckoned longest context in this host's "
              f"{host_bytes / 2**30:.1f} GiB of RAM: {host_longest:.0f} tokens [{card}]")
    print("long context " + json.dumps({
        "runs": {f"{k}@{seq}": {"step_ms": r["dt"] * 1e3, "peak_bytes": r["peak"],
                                "to_host_bytes": r["to_host"], "to_device_bytes": r["to_device"],
                                "pinned_held_bytes": r["held"], "loss": r["loss"]}
                 for (k, seq), r in runs.items()},
        "fit": fit, "card_bytes": card_bytes, "host_bytes": host_bytes, "card": card}))


# ---------------------------------------------------------------------------
# distribution: FPDT's ulysses and cp kinds on torch.distributed
# ---------------------------------------------------------------------------

DIST_SEQ, DIST_U = 16384, 8  # b1: chunks of 2048 tokens, 1024 of each on a rank of two
DIST_NCCL_SEQ, DIST_NCCL_U = 8192, 4
DIST_RANKS = 2  # gloo ranks sharing the one card
# attention-only parity: label, arch (whose attention width is taken), kind
# asked through attn_impl
DIST_ATTN = (("llama3.2-1b ulysses (16 q / 4 kv heads a rank)", "llama3.2-1b", "ulysses"),
             ("llama3.2-1b cp", "llama3.2-1b", "cp"),
             ("recurrentgemma-9b ulysses (8 q heads a rank, its 1 kv head gathered)",
              "recurrentgemma-9b", "ulysses"))
# (output, gradients): the output elementwise, |got - want| <= tol * (1 +
# |want|); each gradient relative to its largest magnitude, as
# FPDT_GRAD_RTOL (a weight's gradient sums over the tokens, and in bf16 each
# rank's partial sum is rounded before the two are added).  fp32:
# tests/test_fpdt.py's 2e-4 and 5e-4; bf16: the repo's bf16 kernel tolerance.
DIST_TOL = {"float32": (2e-4, 5e-4), "bfloat16": (TOL["bfloat16"], TOL["bfloat16"])}
# llama3.2-1b's 1 x 2 training: its layers (of 16), and AdamW steps by
# kind.  The ranks' time is gloo's, through the host: it grows with each
# layer's all-to-alls and gradient bytes and with each step, so the 1 x 2
# trainings are cut in depth and steps (llama's ulysses takes a second
# step) and keep every check.  llama3.2-1b runs 4 layers here and
# on 2 x 1 (8 gave the script 770-800 s of its 800 s aim, the gloo steps
# spreading 40 s between calls).
DIST_LLAMA_LAYERS = 4
DIST_STEPS = (("ulysses", 2), ("cp", 1))
# The first batch's bf16 gradients, two ranks against one, relative in each
# leaf's norm: FPDT_GRAD_RTOL for every leaf but the tied embedding.  Its
# head part sums 64 loss chunks' gradients in bf16 and loses small
# increments to rounding, fewer where each rank sums half: on the H100 its
# norm read 7.56e-2 from one rank's and the global norm 8.5e-3.  A rank's
# contribution dropped or counted twice moves both by 0.29 or more (half of
# the tokens' gradient; 1 - 1/sqrt(2) where the halves are uncorrelated),
# so these limits sit between the two.
DIST_BF16_EMBED_RTOL = 0.15
DIST_BF16_NORM_RTOL = 2.5e-2
DIST_JOIN_S = 900  # the ranks' whole run, start-up included (BUDGET_S may cut it)
DIST_EXIT_S = 60  # from a rank's readings written to its exit
# The recurrent families trained on 1 x DIST_RANKS (b1, DIST_SEQ, u = DIST_U,
# remat full, offload on): arch, layers, AdamW steps.  Each rank holds the
# whole model and its AdamW state: recurrentgemma-9b's one (rglru, rglru,
# local_attn) cycle is 2.60 B parameters, 29 GiB of state; falcon-mamba-7b's
# 4 layers 0.95 B, 11 GiB.  Their fp32-weight checks run at the same depth.
DIST_RECURRENT = (("recurrentgemma-9b", 3, 1), ("falcon-mamba-7b", 4, 1))
# granite-moe-1b-a400m trained on 1 x DIST_RANKS the same way (ulysses: 8 q
# / 4 kv heads a rank), cut to 6 of its 24 layers: each MoE chunk (mlp_chunks
# 2u) is one rank's 1024-token span, so every group is local and no counts
# are gathered; full depth would add ~2 GB of gloo gradient all-reduce a
# step and nothing this phase does not already show.
# It runs expert-parallel (its 32 experts split over the two model ranks):
# every layer moves its chunks' [e, G, cap, d] slots through gloo
# (``_slot_collectives``: 11.9 GB a bf16 step at 6 layers, twice that for
# the fp32 first batch), so it takes one step (with two, the script read
# 848 s on an H100 80GB HBM3 at 700 W, past its 800 s aim).  The step's
# seconds predicted before the first run on the card, printed beside the
# reading, not gated.
DIST_MOE = (("granite-moe-1b-a400m", 6, 1),)
DIST_MOE_PREDICTED_S = (12.0, 30.0)
# One llama4-maverick-400b-a17b MoE FFN layer at its published width (d
# 5120, 128 experts of d_ff 8192, top-1; bf16 with the fp32 router) on
# 1 x DIST_RANKS, expert-parallel: b1, MAVERICK_SEQ tokens in the
# chunk-interleaved layout (u = DIST_U, mlp_chunks 2u: each MoE chunk one
# rank's 512-token span, one group, capacity 5), forward and backward
# through moe_ffn_chunked, held to one rank's run on the same weights and
# input in this process first (its stacks 30.0 GiB, as much again of
# gradients).  Expert j's weights come from seed MAVERICK_SEED + 1 + j, so
# a rank makes only its own experts.
MAVERICK = "llama4-maverick-400b-a17b"
MAVERICK_SEQ, MAVERICK_SEED = 8192, 11
# the mixers alone, at their archs' full width: mixer, arch
DIST_MIXERS = (("rglru", "recurrentgemma-9b"), ("mamba", "falcon-mamba-7b"))
# (output, gradients): the output max |err| / (1 + max |want|), each gradient
# max |err| / max |want|; fp32 tests/test_fpdt.py's 2e-4 and 5e-4, bf16 the
# repo's bf16 kernel tolerance.
DIST_MIXER_TOL = {"float32": (2e-4, 5e-4), "bfloat16": (TOL["bfloat16"], TOL["bfloat16"])}


# ZeRO-3 on DIST_RANKS x 1 (``launch/shardings.py``): llama3.2-1b at full
# width and DIST_LLAMA_LAYERS layers (506 M parameters: 4.71 GiB of bf16
# weights and fp32 moments on one rank, half that a rank), one b1 s 8192
# row a data rank, u 4, remat full, FPDT offload on, ZERO_STEPS steps.  A
# rank's peak must lie within ZERO_PEAK_BAND of its reckoning.
ZERO_BATCH, ZERO_SEQ, ZERO_U, ZERO_STEPS = DIST_RANKS, 8192, 4, 2
ZERO_PEAK_BAND = (0.8, 1.2)
# adamw.apply's fp32 temporaries an element of the slice it updates
# (``UPDATE_SLICE``): g, m1, v1, m-hat, v-hat, the step and the operands
# of each, 36 bytes at their most (tools/adamw_temporaries.py counts them;
# tests/test_torch_adamw.py holds this constant to that count)
ADAMW_BYTES, ADAMW_SLICE = 36, 1 << 26
# the caching allocator rounds a small tensor up to 512 bytes and hands a
# large one its block unsplit where no more than 1 MiB would remain
ALLOC_SLACK = 1 << 20
# The checkpoint case: llama3.2-1b at full width and CKPT_LAYERS layers
# (384 M parameters, 3.8 GB on disk), b CKPT_BATCH s CKPT_SEQ, saved on
# DIST_RANKS x 1 and restored there, on 1 x DIST_RANKS and on one rank;
# the bf16 step after a restore onto another mesh held as the other bf16
# steps on a mesh are: its loss within CKPT_RTOL of the uninterrupted
# one's (FPDT_GRAD_RTOL), its grad norm within DIST_BF16_NORM_RTOL.
CKPT_LAYERS, CKPT_BATCH, CKPT_SEQ = 2, DIST_RANKS, 8192
CKPT_RTOL = 5e-4


def _zero_cfg(M):
    return dataclasses.replace(_dist_cfg(M, layers=DIST_LLAMA_LAYERS), fpdt_chunks=ZERO_U,
                               mlp_chunks=2 * ZERO_U)


def _ckpt_cfg(M):
    return dataclasses.replace(_dist_cfg(M, layers=CKPT_LAYERS), fpdt_chunks=ZERO_U,
                               mlp_chunks=2 * ZERO_U)


def _dist_cfg(M, arch="llama3.2-1b", layers=None, **over):
    """``arch`` at full width (``layers`` of its layers, or all) for the
    distributed phase: u = DIST_U, mlp_chunks 2u, remat full, FPDT offload
    on."""
    cut = {} if layers is None else {"num_layers": layers}
    return dataclasses.replace(M.cfg_mod.get_config(arch, **cut), fpdt_chunks=DIST_U,
                               mlp_chunks=2 * DIST_U, remat="full", fpdt_offload=True, **over)


def _adamw_slice(shape) -> int:
    """Elements of the largest slice ``adamw.apply`` updates at once of a
    leaf of ``shape`` (its leading-axis slices of about UPDATE_SLICE)."""
    n = math.prod(shape)
    if not shape or n <= ADAMW_SLICE:
        return n
    row = n // shape[0]
    return max(1, ADAMW_SLICE // row) * row


def _reckoned_peak_gib(M, cfg, sp, seq=None, dp=1, batch=1):
    """A rank's peak device memory in a training step over ``batch`` rows
    of ``seq`` tokens (DIST_SEQ) on a dp x sp mesh, reckoned from the
    shapes before the run: the training state (the rank's shards of the
    weights, their gradients and the AdamW moments, ``launch/shardings.py``;
    on one rank bf16 weights and gradients and fp32 moments, 12 bytes a
    parameter) and the larger of two phases.  AdamW: ADAMW_BYTES a element
    of the largest slice it updates at once.  The backward: every cycle's
    saved input (remat full) and the largest of the tail layers'
    activations, one cycle's recompute (under a mesh with its gathered
    weights and their whole gradients, the expert stacks under expert
    parallelism the rank's e/sp experts) and the loss's (the head's gradient
    and a chunk's next one, under a mesh with the gathered table); with per
    token and layer the tensors a block keeps for its backward (counted
    from the code: RG-LRU 4d + 48 di + 6 d_ff bytes, attention 4d + 6 hq dh
    + 6 d_ff, with the MoE FFN 4d + 6 hq dh + 2d, Mamba 2d + 30 di), for an
    ssm layer the selective scan's block in its backward (a, b, the states
    and their gradients: six fp32 [rows, 256, di, ds], rows = u under sp >
    1) and for an MoE layer one chunk's backward (its routing's four int64
    [T, k, e], the [e, g, cap] slots at 4d + 8 d_ff bytes, the k gathered
    outputs, twice for their gradients).  Not measured: an estimate to
    print beside the reading (and, for the ZeRO-3 case, the band it is
    held to)."""
    import torch

    tokens = batch * (seq or DIST_SEQ) // (sp * dp)
    d, di, ff = cfg.d_model, cfg.d_inner, cfg.d_ff
    attn = 4 * d + 6 * cfg.num_heads * cfg.head_dim
    per_token = {"rglru": 4 * d + 48 * di + 6 * ff, "local_attn": attn + 6 * ff,
                 "ssm": 2 * d + 30 * di, "attn": attn + (2 * d if cfg.num_experts else 6 * ff)}
    rows = cfg.fpdt_chunks if sp > 1 else 1
    block = 6 * rows * M.MB.BLOCK_S * di * cfg.ssm_state * 4
    if cfg.num_experts:  # one chunk of the MoE FFN in its backward
        e, k, n = cfg.num_experts, cfg.experts_per_token, max(1, cfg.mlp_chunks)
        t = tokens // n
        tg = min(M.MOE.GROUP_TOKENS, t)
        slots = e * (t // tg) * M.MOE.capacity(tg, cfg)
        block = 2 * (4 * t * k * e * 8 + slots * (4 * d + 8 * ff) + t * k * d * 2)

    def layers(kinds):
        return sum(tokens * per_token[k] + (block if k == "ssm" or cfg.num_experts else 0)
                   for k in kinds)

    pat, n_cycles, tail = M.T.layout_of(cfg)
    plans = M.SH.param_plans(cfg, dp, sp)
    leaves = M.TR.tree_leaves(plans)
    state = M.SH.state_bytes(plans, getattr(torch, cfg.opt_state_dtype)) + sum(
        p.local_bytes() for p in leaves)
    adamw = ADAMW_BYTES * max(_adamw_slice(p.local_shape()) for p in leaves)
    meshed = dp * sp > 1
    table = cfg.padded_vocab * d * getattr(torch, cfg.param_dtype).itemsize
    ep = sp > 1 and cfg.num_experts and cfg.num_experts % sp == 0

    def used(names, p):  # a cycle stack's bytes as the model gathers it
        whole = math.prod(p.shape) * p.dtype.itemsize
        return whole // sp if ep and M.SH.is_expert_leaf(names) else whole

    cycle = (2 * sum(used(n, p) for n, p in M.TR.tree_leaves_with_path(plans["cycles"]))
             // n_cycles if meshed else 0)
    backward = n_cycles * tokens * d * 2 + max(layers(pat) + cycle, layers(tail),
                                               (3 if meshed else 2) * table)
    return (state + max(adamw, backward)) / 2**30


def _live_off_diagonal(M, cfg, seq, window):
    """The live (i, j < i) chunk pairs of an FPDT layer over ``seq`` tokens."""
    u = cfg.fpdt_chunks
    return sum(M.F.pair_live(i, j, cq=seq // u, window=window, sparsity=cfg.attn_sparsity)
               for i in range(u) for j in range(i))


def _fpdt_collectives(M, cfg, kind, sp, b, seq, passes, x_bytes, window=0):
    """(calls, bytes) of each collective that one FPDT attention layer hands
    in on a rank over ``passes`` forwards and one backward, as
    ``core/fpdt.py`` issues them: per chunk, ulysses sends q (and k, v where
    hkv % sp == 0) through seq_to_heads and o back, and in the backward do
    out and dq (dk, dv) back as each chunk finishes, in x's dtype; gathered
    KV (ulysses with hkv % sp != 0, and cp) goes through gather_seq in x's
    dtype and its dk, dv come back through reduce_scatter_seq in fp32 over
    the chunk's tokens and every kv head.  A forward that offloads (the
    last, the recompute under remat, when ``cfg.fpdt_offload`` and u > 1)
    keeps the rank's own slice of gathered KV on the host, so it gathers
    each k and v again for every live off-diagonal pair that fetches it,
    and the backward gathers each chunk's once after its fetch."""
    P = M.P
    u = cfg.fpdt_chunks
    c = seq // u // sp
    q = b * cfg.num_heads * c * cfg.head_dim * x_bytes  # a rank's q, o, do or dq of a chunk
    kv = b * cfg.num_kv_heads * c * cfg.head_dim * x_bytes  # its k, v, dk or dv
    kv32 = b * cfg.num_kv_heads * c * sp * cfg.head_dim * 4  # a chunk's dk or dv, fp32
    calls, nbytes = dict.fromkeys(P.COLLECTIVES, 0), dict.fromkeys(P.COLLECTIVES, 0)

    def add(name, n, size):
        calls[name] += n
        nbytes[name] += n * size

    if kind == "ulysses":
        add("seq_to_heads", passes * u + u, q)  # q in each forward, do in the backward
        add("heads_to_seq", passes * u + u, q)  # o, dq
    if kind == "ulysses" and cfg.num_kv_heads % sp == 0:
        add("seq_to_heads", 2 * passes * u, kv)
        add("heads_to_seq", 2 * u, kv)
    else:
        fetches = (_live_off_diagonal(M, cfg, seq, window) + u
                   if cfg.fpdt_offload and u > 1 else 0)
        add("gather_seq", 2 * passes * u + 2 * fetches, kv)
        add("reduce_scatter_seq", 2 * u, kv32)
    return calls, nbytes


def _mixer_collectives(cfg, kind, sp, b, passes, x_bytes):
    """(calls, bytes) of gather_spans and reduce_scatter_spans that one
    recurrent layer (rglru or ssm) hands in on a rank over ``passes``
    forwards and one backward under sp > 1 (``models/mamba.py``): each
    forward gathers the [b, u, d_conv - 1, di] conv tails in x's dtype and
    the fp32 span summaries ([b, u, 2 di] for RG-LRU, [b, u, di (1 + ds)]
    for Mamba); the backward reduce-scatters both, sp times the bytes."""
    u, di = cfg.fpdt_chunks, cfg.d_inner
    width = 2 * di if kind == "rglru" else di * (1 + cfg.ssm_state)
    sent = b * u * ((cfg.d_conv - 1) * di * x_bytes + width * 4)
    return ({"gather_spans": 2 * passes, "reduce_scatter_spans": 2},
            {"gather_spans": passes * sent, "reduce_scatter_spans": sp * sent})


def _zero_collectives(M, cfg, dp, sp, compress=False):
    """(calls, bytes) of gather_params, reduce_scatter_grads and the
    gradients' all_reduce_sum in one training step's value_and_grad and
    reduce_grads on a rank of a dp x sp mesh under remat full (with
    ``compress``, and the int8 compression's all_reduce_max), as
    ``launch/shardings.py`` places the leaves: a gather sends the rank's
    shard over data, then what it has over model; its adjoint sends the
    whole gradient over model, then what is left over data.  A cycle's leaf
    is gathered twice a cycle (the checkpoint's pass and its recompute: its
    cycle's view, or the whole stack where its cycles axis is split) and
    reduce-scattered once; the tied table twice (lookup and head), every
    other leaf once.  An MoE expert stack (wu, wg, wd) whose e splits over
    model (expert parallelism, sp > 1) is gathered and reduce-scattered
    over data only: the rank runs its e/sp experts.  Each leaf replicated
    on an axis with ranks is summed once (over the world where it is split
    on neither).  Compression
    reduces the block maxima of every leaf whose shards' runs of the whole
    flat leaf (``SH.run_length``) are not whole 2048-element blocks with
    MAX, one call for each of the data, model and both groups such leaves
    are split over, 4 bytes a block of those leaves."""
    _, n_cycles, _ = M.T.layout_of(cfg)
    names = ("gather_params", "reduce_scatter_grads", "all_reduce_sum", "all_reduce_max")
    calls, nbytes = dict.fromkeys(names, 0), dict.fromkeys(names, 0)
    groups = set()
    ep = sp > 1 and cfg.num_experts and cfg.num_experts % sp == 0
    for path, plan in M.SH.by_path(M.SH.param_plans(cfg, dp, sp)).items():
        full, local = math.prod(plan.shape) * plan.dtype.itemsize, plan.local_bytes()
        expert = ep and M.SH.is_expert_leaf(path.split("/"))
        uses, passes = 1, 1
        if path.startswith("cycles/"):
            uses, passes = n_cycles, 2
            if not plan.splits_cycles:
                full, local = full // n_cycles, local // n_cycles
        elif path == "embed" and cfg.tie_embeddings:
            uses = 2
        if plan.data_split:
            calls["gather_params"] += passes * uses
            nbytes["gather_params"] += passes * uses * local
            calls["reduce_scatter_grads"] += uses
            nbytes["reduce_scatter_grads"] += uses * (full // sp if plan.model_split else full)
        if plan.model_split and not expert:
            calls["gather_params"] += passes * uses
            nbytes["gather_params"] += passes * uses * local * (dp if plan.data_split else 1)
            calls["reduce_scatter_grads"] += uses
            nbytes["reduce_scatter_grads"] += uses * full
        if (dp > 1 and not plan.data_split) or (sp > 1 and not plan.model_split):
            calls["all_reduce_sum"] += 1
            nbytes["all_reduce_sum"] += plan.local_bytes()
        if (compress and (plan.data_split or plan.model_split)
                and M.SH.run_length(plan) % M.C.BLOCK):
            groups.add((plan.data_split, plan.model_split))
            nbytes["all_reduce_max"] += 4 * -(-math.prod(plan.shape) // M.C.BLOCK)
    calls["all_reduce_max"] = len(groups)
    return calls, nbytes


def _train_collectives(M, cfg, kind, dp, sp, b, seq, compress=False):
    """(calls, bytes) of each collective a training step hands in on a rank
    of a dp x sp mesh under remat full (``b`` rows of ``seq`` tokens a data
    rank): every attention or recurrent layer of a cycle runs two forwards
    (the checkpoint's pass and its recompute), a tail layer one; an MoE
    layer's forward gathers its counts once where a group or a chunk spans
    ranks (``MOE.mesh_plan``: rows x e int32), and under expert
    parallelism moves its slots (``_slot_collectives``); loss_fn sums (loss, count)
    over the world once (8 bytes; 12 with an MoE model's aux); the ZeRO-3
    gathers, reduce-scatters and gradient sums (``_zero_collectives``); the
    global norm sums 8 bytes over data and 4 over model where the axis has
    ranks; the loop sums its two stop flags once (8 bytes).  A data-only
    mesh attends locally (``T.attn_kind``): no FPDT collective.
    ``compress``: and the compression's block maxima
    (``_zero_collectives``)."""
    P = M.P
    pat, n_cycles, tail = M.T.layout_of(cfg)
    calls, nbytes = dict.fromkeys(P.COLLECTIVES, 0), dict.fromkeys(P.COLLECTIVES, 0)
    x_bytes = 2 if cfg.param_dtype == "bfloat16" else 4
    moe_rows = 0
    if cfg.num_experts:
        n = cfg.mlp_chunks if cfg.mlp_chunks > 1 and seq % cfg.mlp_chunks == 0 else 1
        moe_rows = M.MOE.mesh_plan(cfg, seq, b * dp, sp, dp, n, 0).rows
    layers = [(k, 2, i == len(pat) - 1) for _ in range(n_cycles) for i, k in enumerate(pat)]
    for k, passes, last in layers + [(k, 1, False) for k in tail]:
        if k in ("attn", "local_attn") and moe_rows:
            calls["gather_counts"] += passes
            nbytes["gather_counts"] += passes * moe_rows * cfg.num_experts * 4
        if k in ("attn", "local_attn") and cfg.num_experts:
            for name, (n, size) in _slot_collectives(cfg, dp, sp, b, seq, passes, last).items():
                calls[name] += n
                nbytes[name] += size
        if k in ("attn", "local_attn") and kind != "local":
            c, n = _fpdt_collectives(M, cfg, kind, sp, b, seq, passes, x_bytes,
                                     cfg.window if k == "local_attn" else 0)
        elif k in ("attn", "local_attn"):
            continue
        elif sp > 1:
            c, n = _mixer_collectives(cfg, k, sp, b, passes, x_bytes)
        else:
            continue
        for name in c:
            calls[name] += c[name]
            nbytes[name] += n[name]
    c, n = _zero_collectives(M, cfg, dp, sp, compress)
    for name in c:
        calls[name] += c[name]
        nbytes[name] += n[name]
    calls["all_reduce_sum"] += 2 + (dp > 1) + (sp > 1)
    nbytes["all_reduce_sum"] += (12 if cfg.num_experts else 8) + 8 + 8 * (dp > 1) + 4 * (sp > 1)
    return calls, nbytes


def _slot_collectives(cfg, dp, sp, b, seq, passes, last):
    """{name: (calls, bytes)} of dispatch_slots and combine_slots that one
    MoE layer hands in on a rank of data rank 0 under expert parallelism
    (e % sp == 0, sp > 1; none else), ``b`` rows of ``seq`` tokens a data
    rank (``models/moe.py``): every rank runs every chunk.  A forward
    dispatches a chunk's slots [e, G, cap, d] in the weights' dtype (G the
    groups of GROUP_TOKENS (or the chunk's B L tokens) that the model
    group's rows of the chunk touch; sent whole) and combines its e/sp
    experts' (a sp-th); the backward goes the other way round.  A chunk
    runs ``passes`` forwards of the layer plus its own checkpoint's
    recompute, and one backward; in a remat-full cycle (``passes`` 2) the
    cycle's recompute (a non-reentrant checkpoint, which stops early) ends
    once it has saved the inputs of the last chunk of the cycle's last
    layer (``last``), so that chunk runs one forward less."""
    out = {"dispatch_slots": (0, 0), "combine_slots": (0, 0)}
    e = cfg.num_experts
    if sp == 1 or e % sp:
        return out
    n = cfg.mlp_chunks if cfg.mlp_chunks > 1 and seq % cfg.mlp_chunks == 0 else 1
    L, B = seq // n, b * dp
    tg = min(512, B * L)
    groups = (b * L - 1) // tg + 1
    cap = max(4, min(math.ceil(tg * cfg.experts_per_token / e * cfg.moe_capacity_factor), tg))
    full = e * groups * cap * cfg.d_model * (4 if cfg.param_dtype == "float32" else 2)
    fwd = n * (passes + 1) - (passes == 2 and last)
    return {"dispatch_slots": (fwd + n, fwd * full + n * full // sp),
            "combine_slots": (fwd + n, fwd * full // sp + n * full)}


def _collective_counts(P):
    return {name: [P.calls[name], P.nbytes[name]] for name in P.COLLECTIVES}


def _elementwise_err(torch, got, want):
    """max |got - want| / (1 + |want|) over the elements."""
    return float(((got.float() - want.float()).abs() / (1.0 + want.float().abs())).max())


def _leaf_rel(torch, got, want):
    """max |got - want| / max |want|."""
    return float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())


def _attention_run(torch, F, cfg, par, kind, w, x, do):
    """o and the gradients of x and w through fpdt_attention."""
    xg = x.clone().requires_grad_(True)
    wg = {n: t.clone().requires_grad_(True) for n, t in w.items()}
    o = F.fpdt_attention(cfg, par, wg, xg, kind=kind)
    o.backward(do)
    return o.detach(), xg.grad, {n: t.grad for n, t in wg.items()}


def _attention_inputs(torch, L, F, cfg, dev, seq, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, cfg.param_dtype)
    w = {n: t for n, t in L.init_attn(cfg, g, dt, dev).items() if n in F.WEIGHTS}
    x = torch.randn((1, seq, cfg.d_model), generator=g, device=dev).to(dt)
    do = torch.randn((1, seq, cfg.q_dim), generator=g, device=dev).to(dt)
    return w, x, do


def _dist_nccl_one_rank(torch, M, card):
    """kind="ulysses" over a 1-rank NCCL group (the path multi-card runs
    take) against kind="local": llama3.2-1b's attention at full width, bf16,
    b1, DIST_NCCL_SEQ tokens, u = DIST_NCCL_U, offload on; forward and
    backward bit for bit, and the collectives as reckoned."""
    import tempfile

    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(M.cfg_mod.get_config("llama3.2-1b"), fpdt_chunks=DIST_NCCL_U,
                              fpdt_offload=True)
    saved = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                            M.MESH.INIT_METHOD_ENV)}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                          **{M.MESH.INIT_METHOD_ENV: f"file://{tmp}/store"})
        try:
            M.MESH.init_from_env("nccl")
            par = M.P.ParallelContext(M.MESH.make_mesh(1, 1))
            w, x, do = _attention_inputs(torch, M.L, M.F, cfg, dev, DIST_NCCL_SEQ, 5)
            want = _attention_run(torch, M.F, cfg, None, "local", w, x, do)
            M.P.reset_counts()
            got = _attention_run(torch, M.F, cfg, par, "ulysses", w, x, do)
            torch.cuda.synchronize()
            counts = _collective_counts(M.P)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    parts = [("o", got[0], want[0]), ("dx", got[1], want[1])] + [
        ("d" + n, got[2][n], want[2][n]) for n in want[2]]
    differ = [name for name, a, b in parts if not torch.equal(a, b)]
    c, n = _fpdt_collectives(M, cfg, "ulysses", 1, 1, DIST_NCCL_SEQ, 1, 2)
    want_counts = {k: [c[k], n[k]] for k in M.P.COLLECTIVES}
    print(f"nccl, world size 1 (device to device): ulysses vs local, llama3.2-1b attention "
          f"(d_model 2048, hq 32, hkv 8, dh 64) bf16 b1 s{DIST_NCCL_SEQ} u={DIST_NCCL_U} offload "
          f"on: {len(parts) - len(differ)} of {len(parts)} of o, dx, dwq, dwk, dwv bit for bit; "
          f"collectives (calls, bytes) {counts} [{card}]")
    if differ:
        raise AssertionError(f"nccl ulysses differs from local in {differ}")
    if counts != want_counts:
        raise AssertionError(f"collectives {counts}, reckoned {want_counts}")
    del got, want, w, x, do
    torch.cuda.empty_cache()


def _gathered_norms(torch, M, cfg, par, tree):
    """Each leaf's norm, under a mesh of the leaf gathered from this rank's
    shard (one leaf at a time)."""
    plans = M.SH.plans_of(cfg, par)
    leaves = M.TR.tree_leaves(tree)
    if plans is None:
        return [float(g.float().norm()) for g in leaves]
    out = []
    with torch.no_grad():
        for plan, g in zip(M.TR.tree_leaves(plans), leaves):
            out.append(float(M.SH.gather(plan, g, par).float().norm()))
    return out


def _grad_readings(torch, M, cfg, par, dev, batch=1, seq=DIST_SEQ):
    """(loss, global gradient norm, each gradient leaf's norm, the index of
    the embedding's leaf) of the first ``batch`` x ``seq`` batch from seed
    0's weights in ``cfg``'s dtype, on one rank (``par`` None) or this
    rank's part of it with this rank's ZeRO-3 shards, the gradients
    reduced as the train step reduces them and each leaf gathered for its
    norm.  For an MoE model also aux, the expert leaves' indices and each
    layer's routing decisions of this rank's tokens (``decisions``, host
    tensors)."""
    params = M.T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev, par)
    batch_fn = M.DP.make_batch_fn(cfg, M.cfg_mod.ShapeConfig("dist", seq, batch, "train"))
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in M.DP.shard_batch(batch_fn(0), par, cfg.fpdt_chunks).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _recording_moe_inputs(M, cfg.num_layers if cfg.num_experts else 0) as inputs:
        loss, metrics, grads = M.TL.value_and_grad(cfg, par, params, batch)
    grads = M.TL.reduce_grads(cfg, par, grads)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    norms = _gathered_norms(torch, M, cfg, par, grads)
    out = {"loss": float(loss), "grad_norm": math.sqrt(sum(x * x for x in norms)),
           "leaf_norms": norms, "peak_gib": peak,
           "embed_leaf": next(i for i, g in enumerate(M.TR.tree_leaves(grads))
                              if g is grads["embed"])}
    if cfg.num_experts:
        out.update(aux=float(metrics["aux"]), expert_leaves=_expert_leaves(M, params),
                   decisions=_moe_decisions(M, cfg, inputs, par))
    del params, grads, batch, inputs
    torch.cuda.empty_cache()
    return out


def _dist_train_reference(torch, M, card, cfg, bf16_grads=False, batch=1, seq=DIST_SEQ):
    """``cfg`` at the distributed phase's settings on one rank: one AdamW
    step in bf16 (loss, grad norm) and the gradients in fp32 weights
    (``_grad_readings``; also in bf16 weights with ``bf16_grads``), of the
    first ``batch`` x ``seq`` batch from seed 0's weights."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = M.T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    batch_fn = M.DP.make_batch_fn(cfg, M.cfg_mod.ShapeConfig("dist", seq, batch, "train"))
    torch.cuda.reset_peak_memory_stats()
    hist = M.TRAIN.train_steps(cfg, params, M.TRAIN.opt_config(cfg, 3e-4, 1),
                               M.TL.TrainConfig(steps=1, log_every=2), batch_fn, dev).history
    peak = torch.cuda.max_memory_allocated() / 2**30
    rec = hist[0]
    del params, hist
    torch.cuda.empty_cache()
    fp32 = _grad_readings(torch, M, dataclasses.replace(cfg, param_dtype="float32"), None, dev,
                          batch, seq)
    out = {"bf16": rec, "fp32": fp32, "peak_gib": peak}
    if bf16_grads:
        out["bf16_grads"] = _grad_readings(torch, M, cfg, None, dev, batch, seq)
    print(f"one-rank reference, {cfg.name} ({cfg.num_layers} layers) b{batch} s{seq} "
          f"u={cfg.fpdt_chunks} remat full offload on: bf16 step loss {rec['loss']:.6f} "
          f"grad_norm {rec['grad_norm']:.6f}, {rec['dt'] * 1e3:.1f} ms, peak {peak:.2f} GiB; "
          f"fp32 weights ({cfg.num_layers} layers) loss {fp32['loss']:.6f} grad_norm "
          f"{fp32['grad_norm']:.6f}; {time.perf_counter() - t0:.1f} s [{card}]")
    return out


def _param_digest(torch, M, cfg, par, tree) -> str:
    """sha256 of every leaf's bytes, under a mesh of each leaf gathered
    from this rank's shard (one at a time): ranks that hold the same
    model read the same digest."""
    import hashlib

    plans = M.SH.plans_of(cfg, par)
    leaves = M.TR.tree_leaves(tree)
    h = hashlib.sha256()
    with torch.no_grad():
        for plan, t in zip(M.TR.tree_leaves(plans) if plans else [None] * len(leaves), leaves):
            if plan is not None:
                t = M.SH.gather(plan, t, par)
            h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy())
    return h.hexdigest()


def _state_digest(torch, M, cfg, par, state) -> str:
    """``_param_digest`` of the parameters and the AdamW state (step, m, v)."""
    opt = state["opt"]
    return "/".join([_param_digest(torch, M, cfg, par, state["params"]),
                     _param_digest(torch, M, cfg, None, [opt.step]),
                     _param_digest(torch, M, cfg, par, opt.m),
                     _param_digest(torch, M, cfg, par, opt.v)])


def _dist_rank(rank, world, tmp, spawned_at):
    """One gloo rank of the distributed phase, on the one card: the
    attention-only parity, the recurrent mixers alone, llama3.2-1b's
    1 x world training, then each DIST_RECURRENT and DIST_MOE arch's, then
    llama3.2-1b's ZeRO-3 training on world x 1, the checkpoint and
    compression cases and maverick's MoE layer.
    Writes its readings to ``tmp/rank<r>.json``, with each part's seconds
    (its start-up from ``spawned_at``, a ``time.time()``, included) and
    the time its work ended; each part's end also goes to stderr.  On
    SIGUSR1 it writes every thread's stack to stderr."""
    import faulthandler

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    seconds = {"start-up": time.time() - spawned_at}
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # as launch/train.py
    M = _modules()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      **{M.MESH.INIT_METHOD_ENV: f"file://{tmp}/store"})
    M.MESH.init_from_env("gloo")

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"rank {rank}: {name} {seconds[name]:.1f} s", file=sys.stderr, flush=True)
        return res

    try:
        dev = M.MESH.rank_device("cuda", rank)
        torch.cuda.set_device(dev)
        par = M.P.ParallelContext(M.MESH.make_mesh(1, world))
        zpar = M.P.ParallelContext(M.MESH.make_mesh(world, 1))  # the same world, data-parallel
        out = {"attention": timed("attention", _dist_attention, torch, M, par, dev),
               "mixers": timed("mixers", _dist_mixers, torch, M, par, dev), "train": {}}
        for kind, steps in DIST_STEPS:
            cfg = _dist_cfg(M, layers=DIST_LLAMA_LAYERS, attn_impl=kind)
            out["train"][f"llama3.2-1b {kind}"] = timed(f"llama3.2-1b {kind}", _dist_train_case,
                                                        torch, M, par, dev, cfg, steps, True)
        for arch, layers, steps in DIST_RECURRENT + DIST_MOE:
            cfg = _dist_cfg(M, arch, layers)
            label = f"{arch} {M.T.attn_kind(cfg, par)}" if M.T.has_attention(cfg) else arch
            out["train"][label] = timed(label, _dist_train_case, torch, M, par, dev, cfg, steps,
                                        False)
            decisions = out["train"][label]["fp32"].pop("decisions", None)
            if decisions is not None:  # this rank's routing, for the parent to compare
                torch.save(decisions, Path(tmp, f"routing-{arch}-rank{rank}.pt"))
        label = "llama3.2-1b zero3"
        out["train"][label] = timed(label, _dist_train_case, torch, M, zpar, dev, _zero_cfg(M),
                                    ZERO_STEPS, True, ZERO_BATCH, ZERO_SEQ)
        out["ckpt"] = timed("checkpoint", _dist_ckpt, torch, M, zpar, par, dev, tmp)
        out["compress"] = timed("compress", _dist_compress, torch, M, zpar, par, dev)
        out["maverick"] = timed(f"{MAVERICK} MoE layer", _dist_maverick, torch, M, par, dev,
                                tmp)
        out["seconds"] = seconds
    finally:
        dist.destroy_process_group()
    out["done_at"] = time.time()
    Path(tmp, f"rank{rank}.part").write_text(json.dumps(out))
    os.replace(Path(tmp, f"rank{rank}.part"), Path(tmp, f"rank{rank}.json"))


def _dist_train_case(torch, M, par, dev, cfg, steps, bf16_grads, batch=1, seq=DIST_SEQ):
    """A training case on this rank's mesh: the first batch's gradients
    in fp32 weights (and in bf16 with ``bf16_grads``), then the steps."""
    return {"fp32": _grad_readings(torch, M, dataclasses.replace(cfg, param_dtype="float32"),
                                   par, dev, batch, seq),
            **({"bf16_grads": _grad_readings(torch, M, cfg, par, dev, batch, seq)}
               if bf16_grads else {}),
            **_dist_train(torch, M, par, dev, cfg, steps, batch, seq)}


def _maverick_cfg(M):
    return _dist_cfg(M, MAVERICK, 1)


def _maverick_moe(torch, M, cfg, dev, experts):
    """The MoE FFN's parameters with the experts ``experts`` (a range) in
    its stacks, each a leaf that requires grad: the fp32 router [d, e] from
    seed MAVERICK_SEED, expert j's wu, wg [d, ff] and wd [ff, d] in bf16
    from seed MAVERICK_SEED + 1 + j, at ``init_moe``'s scales."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    g = torch.Generator(device=dev).manual_seed(MAVERICK_SEED)
    p = {"router": M.L._dense_init(g, (d, e), torch.float32, dev)}
    shapes = {"wu": ((d, ff), d), "wg": ((d, ff), d), "wd": ((ff, d), ff)}
    for k, (shape, _) in shapes.items():
        p[k] = torch.empty((len(experts), *shape), dtype=torch.bfloat16, device=dev)
    for i, j in enumerate(experts):
        g = torch.Generator(device=dev).manual_seed(MAVERICK_SEED + 1 + j)
        for k, (shape, fan_in) in shapes.items():
            p[k][i] = M.L._dense_init(g, shape, torch.bfloat16, dev, fan_in=fan_in)
    return {k: v.requires_grad_(True) for k, v in p.items()}


def _maverick_inputs(torch, cfg, dev):
    """The layer's input x [1, MAVERICK_SEQ, d] (bf16) and the gradient of
    its output (fp32), from seed MAVERICK_SEED - 1."""
    g = torch.Generator(device=dev).manual_seed(MAVERICK_SEED - 1)
    x = torch.randn((1, MAVERICK_SEQ, cfg.d_model), generator=g, device=dev).to(torch.bfloat16)
    return x, torch.randn((1, MAVERICK_SEQ, cfg.d_model), generator=g, device=dev)


def _maverick_run(torch, M, cfg, p, leaves, x, dy, par=None):
    """moe_ffn_chunked's forward and backward of ``(y * dy).sum() + aux``
    with the parameters ``p`` (``leaves``' gradients read): on the host y,
    dx, aux, each expert's gradient norm of wu, wg and wd [3, experts] and
    the routing decisions of x's tokens."""
    x = x.detach().requires_grad_(True)
    y, aux = M.MOE.moe_ffn_chunked(cfg, p, x, cfg.mlp_chunks, par)
    ((y.float() * dy).sum() + aux).backward()
    norms = [[float(g.float().norm()) for g in leaves[k].grad] for k in ("wu", "wg", "wd")]
    return {"y": y.detach().cpu(), "dx": x.grad.cpu(), "aux": float(aux.detach()),
            "norms": norms, "decisions": _moe_decisions(M, cfg, [(p, x.detach())], par)[0]}


def _maverick_peaks_gib(cfg, sp):
    """A rank's reckoned peak under expert parallelism (its e/sp experts'
    stacks, their gradients, and one chunk's gradient of one stack before
    autograd adds it in) and on the gathered path (its shard, the gathered
    stacks, their whole gradients and one chunk's gradient of one stack),
    from the shapes; the layer's activations (tens of MB) left out."""
    stacks = 3 * cfg.num_experts * cfg.d_model * cfg.d_ff * 2
    return ((2 * stacks + stacks // 3) / sp / 2**30,
            (stacks / sp + 2 * stacks + stacks // 3) / 2**30)


def _maverick_reference(torch, M, card):
    """The maverick layer on one rank, in this process: its host readings
    (``_maverick_run``) and peak; the card freed after."""
    dev = torch.device("cuda")
    cfg = _maverick_cfg(M)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    p = _maverick_moe(torch, M, cfg, dev, range(cfg.num_experts))
    x, dy = _maverick_inputs(torch, cfg, dev)
    out = _maverick_run(torch, M, cfg, p, p, x, dy)
    torch.cuda.synchronize()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del p, x, dy
    torch.cuda.empty_cache()
    print(f"one-rank reference, {MAVERICK} MoE FFN layer ({cfg.num_experts} experts of d "
          f"{cfg.d_model} x d_ff {cfg.d_ff}, top-{cfg.experts_per_token}, bf16) b1 "
          f"s{MAVERICK_SEQ}, {cfg.mlp_chunks} chunks: aux {out['aux']:.6f}, peak "
          f"{out['peak_gib']:.2f} GiB (reckoned {_maverick_peaks_gib(cfg, 1)[0]:.2f}); "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    return out


def _dist_maverick(torch, M, par, dev, tmp):
    """The maverick layer on this rank, expert-parallel: the rank makes its
    own experts' stacks, the cycle gather hands them on (over data only:
    no gather on 1 x DIST_RANKS), then the forward and backward on its
    tokens; its y, dx and routing to ``tmp`` for the parent, its experts'
    gradient norms, the collectives against their reckoning, its peak."""
    import torch.distributed as dist

    cfg = _maverick_cfg(M)
    if not M.SH.expert_parallel(cfg, par):
        raise AssertionError(f"{MAVERICK} does not run expert-parallel on this mesh")
    per = cfg.num_experts // par.sp
    mine = range(par.sp_rank * per, (par.sp_rank + 1) * per)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    dist.barrier()  # neither rank allocates while the other still caches its last part
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    shards = _maverick_moe(torch, M, cfg, dev, mine)
    pos = torch.from_numpy(M.DP.token_positions(MAVERICK_SEQ, par.sp, par.sp_rank,
                                                cfg.fpdt_chunks)).to(dev)
    x, dy = (t[:, pos].contiguous() for t in _maverick_inputs(torch, cfg, dev))
    plans = M.SH.param_plans(cfg, par.dp, par.sp)["cycles"]["pos0"]
    M.P.reset_counts()
    p = M.SH.gather_cycle({"moe": plans["moe"]}, {"moe": shards}, 0, par)["moe"]
    out = _maverick_run(torch, M, cfg, p, shards, x, dy, par)
    counts = _collective_counts(M.P)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.save({k: out.pop(k) for k in ("y", "dx", "decisions")},
               Path(tmp, f"maverick-rank{par.rank}.pt"))
    del shards, p, x, dy
    torch.cuda.empty_cache()
    want = dict.fromkeys(M.P.COLLECTIVES, (0, 0))
    want.update(_slot_collectives(cfg, par.dp, par.sp, 1, MAVERICK_SEQ, 1, False))
    ep, gathered = _maverick_peaks_gib(cfg, par.sp)
    return {**out, "experts": [mine.start, mine.stop], "counts": counts,
            "want_counts": {k: list(v) for k, v in want.items()}, "peak_gib": peak,
            "reckoned_peak_gib": ep, "gathered_peak_gib": gathered, "seconds": seconds}


def _check_maverick(torch, M, ranks, ref, saved, card):
    """Each rank's maverick layer against the one-rank reference: the same
    routing decisions, y and dx within the bf16 limit (max |err| / (1 +
    |want|)), each of its experts' gradient norms of wu, wg and wd within
    DIST_TOL's bf16 gradient limit, the collectives (no gather_params, the
    slot collectives as reckoned) to the byte; its peak printed beside
    its reckoning and the gathered path's."""
    tol_y, tol_g = DIST_TOL["bfloat16"]
    cfg = _maverick_cfg(M)
    for r, got in enumerate(ranks):
        a, mine = got["maverick"], saved[r]
        pos = torch.from_numpy(M.DP.token_positions(MAVERICK_SEQ, DIST_RANKS, r, cfg.fpdt_chunks))
        errs = {k: _elementwise_err(torch, mine[k], ref[k][:, pos]) for k in ("y", "dx")}
        topi, keep = ref["decisions"]
        differ = _decisions_differ([mine["decisions"]], [(topi[:, pos], keep[:, pos])])
        lo, hi = a["experts"]
        norm_rel = max(abs(x - w) / max(w, 1e-30) for k in range(3)
                       for x, w in zip(a["norms"][k], ref["norms"][k][lo:hi]))
        print(f"  rank {r} {MAVERICK} MoE FFN layer, experts {lo}-{hi - 1} of "
              f"{cfg.num_experts}, b1 s{MAVERICK_SEQ} (its {MAVERICK_SEQ // DIST_RANKS} tokens), "
              f"expert-parallel vs one rank: routing decisions that differ {differ}; y "
              f"{errs['y']:.3e}, dx {errs['dx']:.3e} (max |err| / (1 + |want|), limit {tol_y}); "
              f"its experts' gradient norms rel {norm_rel:.3e} (limit {tol_g}); aux share "
              f"{a['aux']:.6f} of one rank's {ref['aux']:.6f}; collectives "
              f"{ {k: v for k, v in a['counts'].items() if v[0]} } (no gather_params); peak "
              f"{a['peak_gib']:.2f} GiB (reckoned {a['reckoned_peak_gib']:.2f}; the gathered "
              f"path {a['gathered_peak_gib']:.2f}); {a['seconds']:.1f} s [{card}]")
        if differ:
            raise AssertionError(f"rank {r} {MAVERICK}: {differ} routing decisions differ")
        if max(errs.values()) > tol_y or norm_rel > tol_g:
            raise AssertionError(f"rank {r} {MAVERICK}: beyond tolerance")
        if a["counts"] != a["want_counts"]:
            raise AssertionError(f"rank {r} {MAVERICK}: collectives {a['counts']}, reckoned "
                                 f"{a['want_counts']}")


def _dist_mixers(torch, M, par, dev):
    """Each DIST_MIXERS mixer at its arch's full width (RG-LRU lru_width
    4096; Mamba d_inner 8192, d_state 16) in fp32 and bf16, b1, DIST_SEQ
    tokens, u = DIST_U (spans of DIST_SEQ / (u sp) tokens): this rank's y
    and dx, and every dW summed over the world, of the sequence-parallel
    mixer against the one-rank mixer over the whole sequence on the same
    card and inputs; the collectives of the distributed call."""
    pos = torch.from_numpy(M.DP.token_positions(DIST_SEQ, par.sp, par.sp_rank, DIST_U)).to(dev)
    out = {}
    for mixer, arch in DIST_MIXERS:
        mod = M.R if mixer == "rglru" else M.MB
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(M.cfg_mod.get_config(arch), param_dtype=dtype,
                                      fpdt_chunks=DIST_U)
            dt = getattr(torch, dtype)
            g = torch.Generator(device=dev).manual_seed(11)
            init = mod.init_rglru if mixer == "rglru" else mod.init_mamba
            p = init(cfg, g, dt, dev)
            x = torch.randn((1, DIST_SEQ, cfg.d_model), generator=g, device=dev).to(dt)
            dy = torch.randn((1, DIST_SEQ, cfg.d_model), generator=g, device=dev).to(dt)
            fn = mod.rglru_mixer if mixer == "rglru" else mod.mamba_mixer

            def run(par_, x_, dy_):
                xg = x_.clone().requires_grad_(True)
                pg = {n: t.clone().requires_grad_(True) for n, t in p.items()}
                y, _ = fn(cfg, pg, xg, None, par_)
                y.backward(dy_)
                return y.detach(), xg.grad, {n: t.grad for n, t in pg.items()}

            want = run(None, x, dy)
            M.P.reset_counts()
            got = run(par, x[:, pos].contiguous(), dy[:, pos].contiguous())
            torch.cuda.synchronize()
            counts = {k: v for k, v in _collective_counts(M.P).items() if v[0]}
            y_want = want[0][:, pos].float()
            errs = {"y": float((got[0].float() - y_want).abs().max())
                    / (1.0 + float(y_want.abs().max())),
                    "dx": _leaf_rel(torch, got[1], want[1][:, pos])}
            for n, gr in got[2].items():
                errs["d" + n] = _leaf_rel(torch, M.P.all_reduce_sum(gr.float().contiguous()),
                                          want[2][n])
            c, nb = _mixer_collectives(cfg, "rglru" if mixer == "rglru" else "ssm", par.sp, 1,
                                       1, 2 if dtype == "bfloat16" else 4)
            out[f"{mixer} ({arch} width) {dtype}"] = {
                "errs": errs, "counts": counts, "want_counts": {k: [c[k], nb[k]] for k in c}}
            del want, got, p, x, dy
            torch.cuda.empty_cache()
    return out


def _dist_attention(torch, M, par, dev):
    """Each DIST_ATTN case in fp32 and bf16, b1, DIST_SEQ tokens, u =
    DIST_U, offload on: this rank's o and dx, and dW summed over the world,
    against kind="local" over the whole sequence on the same card and
    inputs; the collectives of the distributed call; the pinned host bytes
    it held at most and fetched back, against the own-slice reckoning
    (``_host_bytes``); and the same call with offload off, which must give
    the same bits."""
    pos = torch.from_numpy(M.DP.token_positions(DIST_SEQ, par.sp, par.sp_rank, DIST_U)).to(dev)
    off = M.PL.host_offload(dev)
    out = {}
    for label, arch, impl in DIST_ATTN:
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(M.cfg_mod.get_config(arch), attn_impl=impl,
                                      param_dtype=dtype, fpdt_chunks=DIST_U, fpdt_offload=True)
            kind = M.T.attn_kind(cfg, par)
            if kind != impl:
                raise AssertionError(f"{label}: attention kind {kind}")
            w, x, do = _attention_inputs(torch, M.L, M.F, cfg, dev, DIST_SEQ, 7)
            want = _attention_run(torch, M.F, cfg, None, "local", w, x, do)
            xl, dol = x[:, pos].contiguous(), do[:, pos].contiguous()
            torch.cuda.synchronize()
            off.reset_counts()
            held = off.held_bytes
            M.P.reset_counts()
            got = _attention_run(torch, M.F, cfg, par, kind, w, xl, dol)
            torch.cuda.synchronize()
            counts = _collective_counts(M.P)
            host = {"peak_held": off.peak_held_bytes - held, "to_device": off.to_device_bytes}
            x_bytes = 2 if dtype == "bfloat16" else 4
            host.update(_host_bytes(M, cfg, kind, par, x_bytes))
            M.P.reset_counts()
            plain = _attention_run(torch, M.F, dataclasses.replace(cfg, fpdt_offload=False),
                                   par, kind, w, xl, dol)
            counts_off = _collective_counts(M.P)
            differ = [n for n, a, b in zip(("o", "dx"), got[:2], plain[:2])
                      if not torch.equal(a, b)]
            differ += ["d" + n for n in got[2] if not torch.equal(got[2][n], plain[2][n])]
            errs = {"o": _elementwise_err(torch, got[0], want[0][:, pos]),
                    "dx": _leaf_rel(torch, got[1], want[1][:, pos])}
            for n, g in got[2].items():
                errs["d" + n] = _leaf_rel(torch, M.P.all_reduce_sum(g.float().contiguous()),
                                          want[2][n])
            c, nb = _fpdt_collectives(M, cfg, kind, par.sp, 1, DIST_SEQ, 1, x_bytes)
            c0, nb0 = _fpdt_collectives(M, dataclasses.replace(cfg, fpdt_offload=False), kind,
                                        par.sp, 1, DIST_SEQ, 1, x_bytes)
            out[f"{label} {dtype}"] = {
                "errs": errs, "counts": counts, "counts_off": counts_off, "host": host,
                "offload_off_differs": differ,
                "want_counts": {k: [c[k], nb[k]] for k in M.P.COLLECTIVES},
                "want_counts_off": {k: [c0[k], nb0[k]] for k in M.P.COLLECTIVES}}
            del want, got, plain, w, x, do, xl, dol
            torch.cuda.empty_cache()
    return out


def _host_bytes(M, cfg, kind, par, x_bytes):
    """Pinned host bytes of one FPDT layer's forward and backward with
    offload on, on a rank, as ``core/fpdt.py`` moves them (no window): per
    chunk its q (c tokens, or all C of hq/sp heads under ulysses: the same
    bytes) and its k and v as the store keeps them, held until the backward
    ends; fetched back for every live off-diagonal pair (k, v) and in the
    backward for every chunk (k, v) and every live pair (q).  Own slice:
    the rank's [hkv, c] of k and v (or hkv/sp heads of all C tokens, the
    same bytes); gathered: the k and v the pairs read (cp every kv head,
    ulysses the kv heads its q heads read, of all C tokens), which the store
    kept before it kept the rank's own."""
    u, sp = DIST_U, par.sp
    c = DIST_SEQ // u // sp
    q = cfg.num_heads * c * cfg.head_dim * x_bytes
    own = cfg.num_kv_heads * c * cfg.head_dim * x_bytes
    read = own
    if kind == "cp":
        read = own * sp
    elif cfg.num_kv_heads % sp:
        read = len(M.F.kv_heads_read(cfg.num_heads, cfg.num_kv_heads, sp, par.sp_rank)) \
            * c * sp * cfg.head_dim * x_bytes
    pairs = _live_off_diagonal(M, cfg, DIST_SEQ, 0) + u
    return {"want_peak_held": u * (q + 2 * own), "want_to_device": pairs * (q + 2 * own),
            "gathered_peak_held": u * (q + 2 * read), "gathered_to_device": pairs * (q + 2 * read)}


def _dist_train(torch, M, par, dev, cfg, steps, batch=1, seq=DIST_SEQ):
    """``cfg`` on this rank's part of each ``batch`` x ``seq`` batch:
    what the rank holds after init_params and adamw.init (the tensors'
    bytes, the allocator's, and the reckoning of the ZeRO-3 shards), then
    ``steps`` AdamW steps from seed 0's weights through train_steps, the
    kernels' launches and the collectives read around each step; peak
    memory beside its reckoning; a digest of the parameters after the
    steps (gathered) from every rank."""
    import torch.distributed as dist

    kind = M.T.attn_kind(cfg, par)
    reckoned = _reckoned_peak_gib(M, cfg, par.sp, seq, par.dp, batch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = M.T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev, par)
    oc = M.TRAIN.opt_config(cfg, 3e-4, steps)
    opt_state = M.TL.adamw.init(oc, params)
    torch.cuda.synchronize()
    held = [*M.TR.tree_leaves(params), opt_state.step, *M.TR.tree_leaves(opt_state.m),
            *M.TR.tree_leaves(opt_state.v)]
    state = {"tensor_bytes": sum(t.numel() * t.element_size() for t in held),
             "allocated_bytes": torch.cuda.memory_allocated() - before,
             "reckoned_bytes": M.SH.state_bytes(M.SH.param_plans(cfg, par.dp, par.sp),
                                                getattr(torch, cfg.opt_state_dtype)),
             "one_rank_bytes": M.SH.state_bytes(M.SH.param_plans(cfg, 1, 1),
                                                getattr(torch, cfg.opt_state_dtype)),
             "leaves": len(held),
             "init_peak_gib": (torch.cuda.max_memory_allocated() - before) / 2**30}
    del held
    batch_fn = M.DP.make_batch_fn(cfg, M.cfg_mod.ShapeConfig("dist", seq, batch, "train"))
    c, nb = _train_collectives(M, cfg, kind, par.dp, par.sp, batch // par.dp, seq)
    records = []

    def on_step(rec):
        rec["launches"] = _counts(M.K, M.SK)
        rec["collectives"] = _collective_counts(M.P)
        records.append(rec)
        _reset_counts(M.K, M.SK)
        M.P.reset_counts()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(M.K, M.SK)
    M.P.reset_counts()
    params, opt_state, *_ = M.TRAIN.train_steps(
        cfg, params, oc, M.TL.TrainConfig(steps=steps, log_every=steps + 1), batch_fn, dev,
        par=par, opt_state=opt_state, on_step=on_step)
    peak = torch.cuda.max_memory_allocated() / 2**30
    digests = [None] * dist.get_world_size()
    dist.all_gather_object(digests, _param_digest(torch, M, cfg, par, params))
    del params, opt_state
    torch.cuda.empty_cache()
    return {"records": records, "peak_gib": peak, "reckoned_peak_gib": reckoned,
            "digests": digests, "layers": cfg.num_layers, "steps": steps, "state": state,
            "mesh": f"{par.dp}x{par.sp}", "batch": batch, "seq": seq,
            "want_launches": _launches_per_step(cfg, M.F, M.T, M.MB, seq, par.sp),
            "want_collectives": {k: [c[k], nb[k]] for k in M.P.COLLECTIVES}}


def _ckpt_steps(torch, M, cfg, par, dev, state, first, last, oc):
    """AdamW steps ``first`` + 1 .. ``last`` of the checkpoint case on
    ``par``'s mesh (one rank: None) over its CKPT_BATCH x CKPT_SEQ
    batches: (state, [(loss, grad norm)])."""
    batch_fn = M.DP.make_batch_fn(cfg, M.cfg_mod.ShapeConfig("ckpt", CKPT_SEQ, CKPT_BATCH,
                                                             "train"))
    step = M.TL.make_train_step(cfg, par, oc, M.TL.TrainConfig())
    p, st, out = state["params"], state["opt"], []
    for s in range(first, last):
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in M.DP.shard_batch(batch_fn(s), par, cfg.fpdt_chunks).items()}
        p, st, m = step(p, st, b)
        out.append([float(m["loss"]), float(m["grad_norm"])])
    torch.cuda.synchronize()
    return {"params": p, "opt": st}, out


def _ckpt_fresh(torch, M, cfg, par, dev, oc):
    p = M.T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev, par)
    return {"params": p, "opt": M.TL.adamw.init(oc, p)}


def _dist_ckpt(torch, M, zpar, par, dev, tmp):
    """llama3.2-1b at full width and CKPT_LAYERS layers on the data x 1
    mesh ``zpar``: step 1, a checkpoint of it (async, then joined), step
    2; step 1 restored on the same mesh (the rank's shards the saved bits)
    and step 2 again (the same loss and the same shards as the run that
    went on); restored onto the 1 x world mesh ``par`` and step 2 there.
    Each rank's digests are of its own shards; the parent restores the
    checkpoint (left in ``tmp/ckpt``) whole on one rank and holds every
    rank's shards of both meshes to it (``_ckpt_one_rank``).  Returns the
    readings (bytes written, seconds to save, write and restore)."""
    import torch.distributed as dist

    cfg = _ckpt_cfg(M)
    oc = M.TRAIN.opt_config(cfg, 3e-4, 2)
    state, first = _ckpt_steps(torch, M, cfg, zpar, dev, _ckpt_fresh(torch, M, cfg, zpar, dev,
                                                                     oc), 0, 1, oc)
    saved = _state_digest(torch, M, cfg, None, state)
    mgr = M.CKPT.CheckpointManager(str(Path(tmp, "ckpt")), cfg=cfg, par=zpar)
    t0 = time.perf_counter()
    mgr.save(1, state, extra={"data_step": 1})
    t_save = time.perf_counter() - t0
    mgr.wait()
    t_write = time.perf_counter() - t0
    state, went_on = _ckpt_steps(torch, M, cfg, zpar, dev, state, 1, 2, oc)
    uninterrupted = _state_digest(torch, M, cfg, None, state)
    del state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    back, extra = mgr.restore(1, _ckpt_fresh(torch, M, cfg, zpar, dev, oc))
    dist.barrier()
    t_restore = time.perf_counter() - t0
    restored = _state_digest(torch, M, cfg, None, back)
    back, again = _ckpt_steps(torch, M, cfg, zpar, dev, back, 1, 2, oc)
    resumed = _state_digest(torch, M, cfg, None, back)
    del back
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    other, _ = M.CKPT.CheckpointManager(str(Path(tmp, "ckpt")), cfg=cfg, par=par).restore(
        1, _ckpt_fresh(torch, M, cfg, par, dev, oc))
    dist.barrier()
    t_other = time.perf_counter() - t0
    on_other = _state_digest(torch, M, cfg, None, other)
    other, other_step = _ckpt_steps(torch, M, cfg, par, dev, other, 1, 2, oc)
    del other
    torch.cuda.empty_cache()
    files = Path(tmp, "ckpt", "step_1")
    return {"first": first, "went_on": went_on, "again": again, "other_step": other_step,
            "saved": saved, "restored": restored, "uninterrupted": uninterrupted,
            "resumed": resumed, "on_other": on_other, "extra": extra,
            "bytes": sum(f.stat().st_size for f in files.iterdir()),
            "files": len(list(files.iterdir())), "params": cfg.num_params(),
            "save_s": t_save, "write_s": t_write, "restore_s": t_restore,
            "restore_other_s": t_other}


# The compression case on both meshes of the ranks (1 x DIST_RANKS and
# DIST_RANKS x 1): the sharded quantizer on random shard gradients laid out
# by the plans of COMPRESS_ARCHS (arch, layers), against one rank's
# quantization of each whole leaf; then one compressed step of llama3.2-1b
# at CKPT_LAYERS layers, b ZERO_BATCH (a row a rank) s ZERO_SEQ, on
# DIST_RANKS x 1 against one rank's compressed step on the whole batch.
COMPRESS_ARCHS = (("llama3.2-1b", 2), (GRANITE, 2))


def _dist_compress(torch, M, zpar, par, dev):
    """This rank's part of the compression case: per mesh and arch,
    whether every leaf's sharded quantization is this rank's shard of the
    whole leaf's, bit for bit, and the blocks that straddle shards; the
    compressed step on ``zpar`` and one rank's (run here on the whole
    batch): loss, grad norm, each parameter leaf's norm and update norm
    (gathered) against one rank's, the elements whose int8 value differs
    between the two (the gradients before quantization captured in the
    step), the collectives of the mesh step and their reckoning."""
    C = M.C
    out = {"quantizer": {}}
    for mesh, mp in ((f"1x{par.sp}", par), (f"{zpar.dp}x1", zpar)):
        for arch, layers in COMPRESS_ARCHS:
            cfg = M.cfg_mod.get_config(arch, num_layers=layers)
            plans = M.TR.tree_leaves(M.SH.param_plans(cfg, mp.dp, mp.sp))
            same, straddling = True, 0
            for i, plan in enumerate(plans):
                gen = torch.Generator(device=dev).manual_seed(1000 + i)
                g = (torch.randn(plan.shape, generator=gen, device=dev) * 1e-3).to(plan.dtype)
                r = torch.randn(plan.shape, generator=gen, device=dev) * 1e-6
                want = [M.SH.shard(plan, x, mp) for x in C.quantize_with_feedback(g, r)]
                got = C.quantize_with_feedback_sharded(plan, M.SH.shard(plan, g, mp),
                                                       M.SH.shard(plan, r, mp), mp)
                same = same and all(torch.equal(a, b) for a, b in zip(got, want))
                straddling += M.SH.straddling_blocks(plan, C.BLOCK)
                del g, r, want, got
            out["quantizer"][f"{arch} ({layers} layers) {mesh}"] = {
                "same": same, "straddling": straddling, "leaves": len(plans)}
    torch.cuda.empty_cache()

    cfg = _ckpt_cfg(M)
    oc = M.TRAIN.opt_config(cfg, 3e-4, 1)
    tc = M.TL.TrainConfig(steps=1, log_every=2, compress_grads=True)
    batch_fn = M.DP.make_batch_fn(cfg, M.cfg_mod.ShapeConfig("compress", ZERO_SEQ, ZERO_BATCH,
                                                             "train"))
    real, seen = C.tree_quantize_with_feedback_, []

    def capture(grads, residuals, *a):
        seen.append([g.clone() for g in M.TR.tree_leaves(grads)])
        return real(grads, residuals, *a)

    def fresh(p_):
        return M.T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev, p_)

    C.tree_quantize_with_feedback_ = capture
    try:
        one = M.TRAIN.train_steps(cfg, fresh(None), oc, tc, batch_fn, dev)
        records = []

        def on_step(rec):
            rec["collectives"] = _collective_counts(M.P)
            records.append(rec)

        shards = fresh(zpar)
        M.P.reset_counts()
        mesh = M.TRAIN.train_steps(cfg, shards, oc, tc, batch_fn, dev, par=zpar,
                                   on_step=on_step)
    finally:
        C.tree_quantize_with_feedback_ = real
    plans = M.SH.plans_of(cfg, zpar)
    init = M.TR.tree_leaves(fresh(None))
    with torch.no_grad():
        flips = sum(int((C.compress(M.SH.gather(p, g, zpar)).q != C.compress(w).q).sum())
                    for p, g, w in zip(M.TR.tree_leaves(plans), seen[1], seen[0]))
        got = M.TR.tree_leaves(M.SH.gather_params_tree(cfg, zpar, mesh.params))
        want = M.TR.tree_leaves(one.params)
        norm = lambda x: float(x.float().norm())  # noqa: E731
        param_rel = [abs(norm(a) - norm(b)) / norm(b) for a, b in zip(got, want)]
        update_rel = [norm(a.float() - b.float()) / max(norm(b.float() - c.float()), 1e-30)
                      for a, b, c in zip(got, want, init)]
    c, nb = _train_collectives(M, cfg, M.T.attn_kind(cfg, zpar), zpar.dp, zpar.sp,
                               ZERO_BATCH // zpar.dp, ZERO_SEQ, compress=True)
    out["step"] = {
        "mesh": f"{zpar.dp}x1", "loss": mesh.history[0]["loss"],
        "grad_norm": mesh.history[0]["grad_norm"], "one_loss": one.history[0]["loss"],
        "one_grad_norm": one.history[0]["grad_norm"], "param_rel": param_rel,
        "update_rel": update_rel, "flips": flips, "elements": cfg.num_params(),
        "embed_leaf": next(i for i, x in enumerate(M.TR.tree_leaves(one.params))
                           if x is one.params["embed"]),
        "collectives": records[0]["collectives"],
        "want_collectives": {k: [c[k], nb[k]] for k in M.P.COLLECTIVES},
        "residual_bytes": sum(t.numel() * t.element_size()
                              for t in M.TR.tree_leaves(mesh.residuals)),
        "reckoned_residual_bytes": M.SH.state_bytes(plans, torch.float32, residuals=True)
        - M.SH.state_bytes(plans, torch.float32)}
    del one, mesh, shards, seen, got, want, init
    torch.cuda.empty_cache()
    return out


def _check_compress(ranks, card):
    """The compression case of every rank: each mesh's sharded quantizer
    the shards of one rank's, bit for bit, with straddling blocks on each
    mesh; the compressed DIST_RANKS x 1 step against one rank's as the
    other bf16 steps on a mesh are held (its loss within FPDT_GRAD_RTOL;
    each parameter leaf's norm within DIST_BF16_EMBED_RTOL for the
    embedding and FPDT_GRAD_RTOL for the others), its collectives as
    reckoned, the residuals a rank holds 4 bytes an element of its shards;
    the elements quantized to another integer and each leaf's update norm
    printed."""
    for r, got in enumerate(ranks):
        q, st = got["compress"]["quantizer"], got["compress"]["step"]
        for case, v in q.items():
            print(f"  rank {r} sharded quantizer, {case}: {v['leaves']} leaves the shards of "
                  f"one rank's bit for bit: {v['same']}; blocks that straddle shards "
                  f"{v['straddling']}")
        for mesh in sorted({c.split()[-1] for c in q}):
            if sum(v["straddling"] for c, v in q.items() if c.endswith(mesh)) <= 0:
                raise AssertionError(f"rank {r}: no block straddles shards on {mesh}")
        if not all(v["same"] for v in q.values()):
            raise AssertionError(f"rank {r}: a sharded quantization differs from one rank's")
        emb = st["embed_leaf"]
        loss_rel = abs(st["loss"] - st["one_loss"]) / abs(st["one_loss"])
        others = max(x for i, x in enumerate(st["param_rel"]) if i != emb)
        print(f"  rank {r} compressed step, llama3.2-1b ({CKPT_LAYERS} layers) b{ZERO_BATCH} "
              f"s{ZERO_SEQ} on {st['mesh']} vs one rank: loss {st['loss']:.6f} vs "
              f"{st['one_loss']:.6f} (rel {loss_rel:.3e}), grad_norm {st['grad_norm']:.6f} vs "
              f"{st['one_grad_norm']:.6f}; parameter-leaf norms rel: embedding "
              f"{st['param_rel'][emb]:.3e} (limit {DIST_BF16_EMBED_RTOL}), the others at most "
              f"{others:.3e} (limit {FPDT_GRAD_RTOL}); update norms rel "
              + ", ".join(f"{x:.2e}" for x in st["update_rel"])
              + f"; elements quantized to another integer {st['flips']} of {st['elements']}; "
              f"residuals {st['residual_bytes']} bytes (reckoned "
              f"{st['reckoned_residual_bytes']}); all_reduce_max "
              f"{st['collectives']['all_reduce_max']} (reckoned "
              f"{st['want_collectives']['all_reduce_max']}) [{card}]")
        if loss_rel > FPDT_GRAD_RTOL or st["param_rel"][emb] > DIST_BF16_EMBED_RTOL or (
                others > FPDT_GRAD_RTOL):
            raise AssertionError(f"rank {r}: the compressed mesh step differs from one rank's")
        if st["collectives"] != st["want_collectives"]:
            raise AssertionError(f"rank {r} compressed step: collectives {st['collectives']}, "
                                 f"reckoned {st['want_collectives']}")
        if st["residual_bytes"] != st["reckoned_residual_bytes"]:
            raise AssertionError(f"rank {r}: residuals of {st['residual_bytes']} bytes")


def _check_zero_state(r, case, t, card):
    """What rank ``r`` held after init_params and adamw.init: the tensors'
    bytes the ZeRO-3 reckoning to the byte, the allocator's no less and at
    most ALLOC_SLACK a tensor more, about half of one rank's; its peak in
    the step within ZERO_PEAK_BAND of the reckoned."""
    st = t["state"]
    lo, hi = (f * t["reckoned_peak_gib"] for f in ZERO_PEAK_BAND)
    print(f"  rank {r} {case} {t['mesh']}: after init_params and adamw.init the rank holds "
          f"{st['tensor_bytes']} bytes in {st['leaves']} tensors (allocator "
          f"{st['allocated_bytes']}; reckoned from the shards {st['reckoned_bytes']}; one rank "
          f"{st['one_rank_bytes']}: {st['tensor_bytes'] / st['one_rank_bytes']:.4f} of it), "
          f"{st['tensor_bytes'] / 2**30:.3f} GiB; init peak {st['init_peak_gib']:.3f} GiB; step "
          f"peak {t['peak_gib']:.2f} GiB (reckoned {t['reckoned_peak_gib']:.2f}, band "
          f"{lo:.2f}-{hi:.2f}; the first batch's forward and backward alone "
          f"{t['bf16_grads']['peak_gib']:.2f}) [{card}]")
    if st["tensor_bytes"] != st["reckoned_bytes"]:
        raise AssertionError(f"rank {r} {case}: holds {st['tensor_bytes']} bytes, the shards "
                             f"reckon {st['reckoned_bytes']}")
    if not st["reckoned_bytes"] <= st["allocated_bytes"] <= (st["reckoned_bytes"]
                                                            + ALLOC_SLACK * st["leaves"]):
        raise AssertionError(f"rank {r} {case}: the allocator holds {st['allocated_bytes']} "
                             f"bytes for {st['reckoned_bytes']} of state")
    if st["tensor_bytes"] > 0.51 * st["one_rank_bytes"]:
        raise AssertionError(f"rank {r} {case}: more than half of one rank's state")
    if not lo <= t["peak_gib"] <= hi:
        raise AssertionError(f"rank {r} {case}: peak {t['peak_gib']:.2f} GiB outside "
                             f"{lo:.2f}-{hi:.2f}")


def _ckpt_one_rank(torch, M, card, tmp):
    """The ranks' DIST_RANKS x 1 checkpoint restored onto one rank on the
    card: the digests of each rank's shards of it on DIST_RANKS x 1 and on
    1 x DIST_RANKS (``_state_digest`` of ``SH.shard_params``), and the
    step after it."""
    dev = torch.device("cuda")
    cfg = _ckpt_cfg(M)
    oc = M.TRAIN.opt_config(cfg, 3e-4, 2)
    t0 = time.perf_counter()
    state, extra = M.CKPT.CheckpointManager(str(Path(tmp, "ckpt"))).restore(
        1, _ckpt_fresh(torch, M, cfg, None, dev, oc))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    digests = {}
    for shape in ((DIST_RANKS, 1), (1, DIST_RANKS)):
        for r in range(DIST_RANKS):
            par = M.P.ParallelContext(M.MESH.Mesh(*shape, r, "none", None, None))
            mine = {"params": M.SH.shard_params(cfg, par, state["params"]),
                    "opt": state["opt"]._replace(m=M.SH.shard_params(cfg, par, state["opt"].m),
                                                 v=M.SH.shard_params(cfg, par, state["opt"].v))}
            digests[f"{shape[0]}x{shape[1]} rank {r}"] = _state_digest(torch, M, cfg, None, mine)
            del mine
    state, step = _ckpt_steps(torch, M, cfg, None, dev, state, 1, 2, oc)
    del state
    torch.cuda.empty_cache()
    return {"digests": digests, "step": step, "extra": extra, "restore_s": seconds}


def _check_ckpt(ranks, one, card):
    """The checkpoint case: a restore on the saving mesh gives the saved
    shards and step 2's bits; onto 1 x DIST_RANKS and onto one rank the
    saved bits (each rank's shards of both meshes against the one-rank
    restore's), and step 2 held as the other bf16 steps on a mesh are."""
    for r, got in enumerate(ranks):
        c = got["ckpt"]
        want = c["went_on"][0]
        here = one["digests"][f"{DIST_RANKS}x1 rank {r}"]
        there = one["digests"][f"1x{DIST_RANKS} rank {r}"]
        rel = {f"{where} {k}": abs(a - b) / abs(b) for where, step in
               (("1x", c["other_step"][0]), ("one", one["step"][0]))
               for k, a, b in zip(("loss", "grad_norm"), step, want)}
        print(f"  rank {r} checkpoint, llama3.2-1b ({CKPT_LAYERS} layers, {c['params']} "
              f"parameters) b{CKPT_BATCH} s{CKPT_SEQ}: step 1 (loss, grad_norm) {c['first'][0]}, "
              f"saved on {DIST_RANKS}x1: {c['bytes']} bytes in {c['files']} files, save returned "
              f"in {c['save_s']:.2f} s, written in {c['write_s']:.2f} s; restored there in "
              f"{c['restore_s']:.2f} s (the rank's shards as saved: "
              f"{c['restored'] == c['saved']}), step 2 {c['again'][0]} vs uninterrupted {want} "
              f"(the same shards after it: {c['resumed'] == c['uninterrupted']}); onto "
              f"1x{DIST_RANKS} in {c['restore_other_s']:.2f} s and onto one rank in "
              f"{one['restore_s']:.2f} s (one rank's restore cut for this rank: as saved "
              f"{here == c['saved']}, as its 1x{DIST_RANKS} restore {there == c['on_other']}); "
              f"step 2 there vs uninterrupted, rel: "
              + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
              + f" (loss limit {CKPT_RTOL}, bf16 grad_norm limit {DIST_BF16_NORM_RTOL}) [{card}]")
        if c["extra"] != {"data_step": 1} or one["extra"] != {"data_step": 1}:
            raise AssertionError(f"rank {r} checkpoint: extra {c['extra']} / {one['extra']}")
        if not (c["restored"] == c["saved"] == here and there == c["on_other"]):
            raise AssertionError(f"rank {r} checkpoint: a restore is not the saved bits")
        if c["again"] != c["went_on"] or c["resumed"] != c["uninterrupted"]:
            raise AssertionError(f"rank {r} checkpoint: the resumed step 2 differs from the "
                                 "uninterrupted one")
        if (max(v for k, v in rel.items() if k.endswith("loss")) > CKPT_RTOL
                or max(rel.values()) > DIST_BF16_NORM_RTOL):
            raise AssertionError(f"rank {r} checkpoint: step 2 after a restore onto another "
                                 f"mesh moves {rel}")


def _dump_stacks(procs):
    """Every live rank writes its threads' stacks to stderr (SIGUSR1)."""
    live = [p for p in procs if p.is_alive()]
    for p in live:
        os.kill(p.pid, signal.SIGUSR1)
    if live:
        time.sleep(3)


def _join_ranks(procs, timeout, tmp):
    """Wait for every rank.  The first to fail, or the deadline, has the
    live ranks write their stacks, kills them all and fails the phase.  A
    rank that wrote its readings (``tmp/rank<r>.json``) and has not exited
    DIST_EXIT_S later writes its stacks and is stopped: returns those
    ranks, whose readings the phase still checks."""
    import multiprocessing.connection

    deadline = time.monotonic() + timeout
    done_at, stopped = {}, []
    try:
        while any(p.exitcode is None for p in procs):
            now = time.monotonic()
            for r in range(len(procs)):
                if r not in done_at and Path(tmp, f"rank{r}.json").exists():
                    done_at[r] = now
            late = [r for r, p in enumerate(procs)
                    if p.exitcode is None and r in done_at and now - done_at[r] > DIST_EXIT_S]
            if late:
                _dump_stacks([procs[r] for r in late])
                for r in late:
                    procs[r].kill()
                    procs[r].join()
                stopped += late
                continue
            if now >= deadline:
                _dump_stacks(procs)
                raise AssertionError(f"the ranks did not finish within {timeout:.0f} s (their "
                                     "stacks are on stderr)")
            multiprocessing.connection.wait([p.sentinel for p in procs if p.exitcode is None],
                                            timeout=min(deadline - now, 5.0))
            bad = [p.exitcode for r, p in enumerate(procs)
                   if r not in stopped and p.exitcode not in (None, 0)]
            if bad:
                _dump_stacks(procs)
                raise AssertionError(f"a rank exited with {bad[0]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return stopped


def phase_dist(torch, M, card):
    """FPDT's distribution (core/parallel.py) and the recurrent mixers' two
    passes: the NCCL world-size-1 path bit for bit against local; one-rank
    references of each training case; then DIST_RANKS gloo ranks spawned
    on the one card (gloo takes the CUDA tensors and stages them through
    host memory itself): the attention-only parity of DIST_ATTN (with the
    host bytes of the own-slice KV store and offload off bit for bit), the
    mixers alone, llama3.2-1b's 1 x DIST_RANKS training and the
    DIST_RECURRENT archs', each first step against its one-rank reference,
    then llama3.2-1b's ZeRO-3 training on DIST_RANKS x 1 and the checkpoint
    case (restored onto one rank in this process), and maverick's MoE
    layer expert-parallel against its one-rank run here.  Returns each
    kernel's launches on rank 0 by training path."""
    import multiprocessing
    import tempfile

    _dist_nccl_one_rank(torch, M, card)
    t0 = time.perf_counter()
    refs = {"llama3.2-1b": _dist_train_reference(torch, M, card,
                                                 _dist_cfg(M, layers=DIST_LLAMA_LAYERS),
                                                 bf16_grads=True)}
    for arch, layers, _ in DIST_RECURRENT + DIST_MOE:
        refs[arch] = _dist_train_reference(torch, M, card, _dist_cfg(M, arch, layers))
    refs["llama3.2-1b zero3"] = _dist_train_reference(torch, M, card, _zero_cfg(M),
                                                      bf16_grads=True, batch=ZERO_BATCH,
                                                      seq=ZERO_SEQ)
    maverick = _maverick_reference(torch, M, card)
    torch.cuda.empty_cache()  # the ranks share the card: this process keeps nothing cached
    print(f"one-rank references: {time.perf_counter() - t0:.1f} s; this process holds "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB of the card's memory")
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_dist_rank, args=(r, DIST_RANKS, tmp, time.time()))
                 for r in range(DIST_RANKS)]
        for p in procs:
            p.start()
        stopped = _join_ranks(procs, min(DIST_JOIN_S, BUDGET_S - (time.monotonic() - STARTED)),
                              tmp)
        joined = time.time()
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(DIST_RANKS)]
        routing = {arch: [torch.load(Path(tmp, f"routing-{arch}-rank{r}.pt"))
                          for r in range(DIST_RANKS)] for arch, _, _ in DIST_MOE}
        one_rank_ckpt = _ckpt_one_rank(torch, M, card, tmp)
        maverick_ranks = [torch.load(Path(tmp, f"maverick-rank{r}.pt"))
                          for r in range(DIST_RANKS)]
    print(f"gloo, {DIST_RANKS} ranks sharing the card: the port hands gloo the CUDA tensors "
          f"(no explicit staging); gloo stages them through host memory; the ranks took "
          f"{time.perf_counter() - t0:.1f} s, rank 0's parts (s): "
          + ", ".join(f"{k} {v:.1f}" for k, v in ranks[0]["seconds"].items())
          + f"; from the last rank's end of work to the join "
          f"{joined - max(r['done_at'] for r in ranks):.1f} s")
    for r in stopped:
        print(f"rank {r} wrote its readings and had not exited {DIST_EXIT_S} s later: stopped "
              "(its stacks are on stderr)")

    for case in ranks[0]["attention"]:
        dtype = case.split()[-1]
        tol_o, tol_g = DIST_TOL[dtype]
        for r, got in enumerate(ranks):
            a = got["attention"][case]
            errs, host = a["errs"], a["host"]
            print(f"  rank {r} {case}, b1 s{DIST_SEQ} u={DIST_U} offload on, vs local: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                  + f" (o: max |err| / (1 + |want|), limit {tol_o}; gradients: max |err| / "
                  f"max |want|, limit {tol_g}); collectives "
                  + str({k: v for k, v in a["counts"].items() if v[0]})
                  + f"; pinned host bytes held at most {host['peak_held']} (own-slice "
                  f"reckoning {host['want_peak_held']}, a gathered store "
                  f"{host['gathered_peak_held']}), fetched {host['to_device']} (reckoned "
                  f"{host['want_to_device']}, a gathered store {host['gathered_to_device']}); "
                  f"offload off differs in {a['offload_off_differs'] or 'nothing'}")
            if errs["o"] > tol_o or any(errs[k] > tol_g for k in errs if k != "o"):
                raise AssertionError(f"rank {r} {case}: beyond tolerance")
            if a["counts"] != a["want_counts"] or a["counts_off"] != a["want_counts_off"]:
                raise AssertionError(f"rank {r} {case}: collectives {a['counts']} (offload off "
                                     f"{a['counts_off']}), reckoned {a['want_counts']} "
                                     f"({a['want_counts_off']})")
            if (host["peak_held"], host["to_device"]) != (host["want_peak_held"],
                                                          host["want_to_device"]):
                raise AssertionError(f"rank {r} {case}: host bytes {host}")
            if a["offload_off_differs"]:
                raise AssertionError(f"rank {r} {case}: offload off gives other bits in "
                                     f"{a['offload_off_differs']}")

    for case in ranks[0]["mixers"]:
        tol_y, tol_g = DIST_MIXER_TOL[case.split()[-1]]
        for r, got in enumerate(ranks):
            a = got["mixers"][case]
            errs = a["errs"]
            print(f"  rank {r} mixer {case}, b1 s{DIST_SEQ} u={DIST_U}, two ranks vs one: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                  + f" (y: max |err| / (1 + max |want|), limit {tol_y}; gradients: max |err| / "
                  f"max |want|, limit {tol_g}); collectives {a['counts']} [{card}]")
            if errs["y"] > tol_y or any(errs[k] > tol_g for k in errs if k != "y"):
                raise AssertionError(f"rank {r} mixer {case}: beyond tolerance")
            if a["counts"] != a["want_counts"]:
                raise AssertionError(f"rank {r} mixer {case}: collectives {a['counts']}, "
                                     f"reckoned {a['want_counts']}")

    totals = {}
    for case in ranks[0]["train"]:
        arch = case.split()[0]
        for r, got in enumerate(ranks):
            t = got["train"][case]
            recs = t["records"]
            if "zero3" in case:
                _check_zero_state(r, case, t, card)
            pred = (f", predicted {DIST_MOE_PREDICTED_S[0]:.0f}-{DIST_MOE_PREDICTED_S[1]:.0f} s "
                    "expert-parallel" if arch in {a for a, _, _ in DIST_MOE} else "")
            for rec in recs:
                print(f"  rank {r} train {case} {t['mesh']} b{t['batch']} s{t['seq']} "
                      f"({t['layers']} layers) step "
                      f"{rec['step']}: loss {rec['loss']:.6f} grad_norm {rec['grad_norm']:.6f} "
                      f"{rec['dt'] * 1e3:.1f} ms{pred} (gloo through the host on one shared "
                      f"card, not a multi-card speed); launches {rec['launches']}; collectives "
                      f"{ {k: v for k, v in rec['collectives'].items() if v[0]} }")
                if not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"])):
                    raise AssertionError(f"rank {r} {case}: non-finite loss or grad norm")
                if rec["launches"] != t["want_launches"]:
                    raise AssertionError(f"rank {r} {case} step {rec['step']}: launches "
                                         f"{rec['launches']}, reckoned {t['want_launches']}")
                if rec["collectives"] != t["want_collectives"]:
                    raise AssertionError(f"rank {r} {case} step {rec['step']}: collectives "
                                         f"{rec['collectives']}, reckoned "
                                         f"{t['want_collectives']}")
            ref = refs[case] if case in refs else refs[arch]
            first, ref16 = recs[0], ref["bf16"]
            rel16 = {k: abs(first[k] - ref16[k]) / abs(ref16[k]) for k in ("loss", "grad_norm")}
            f32, ref32 = t["fp32"], ref["fp32"]
            rel32 = {k: abs(f32[k] - ref32[k]) / abs(ref32[k])
                     for k in ("loss", "grad_norm", "aux") if k in ref32}
            leaf_rels = [abs(a - b) / b for a, b in zip(f32["leaf_norms"], ref32["leaf_norms"])]
            leaf32, moe = max(leaf_rels), ""
            if arch in routing:  # the port's routing of both runs' layer inputs
                pos = torch.from_numpy(M.DP.token_positions(DIST_SEQ, DIST_RANKS, r, DIST_U))
                differ = _decisions_differ(routing[arch][r],
                                           [(a[:, pos], b[:, pos]) for a, b in ref32["decisions"]])
                experts = set(ref32["expert_leaves"])
                worst = max((x, n) for n, x in enumerate(leaf_rels) if n in experts)
                if differ:  # a flipped decision moves an expert's gradient by a token's share
                    leaf32 = max(x for n, x in enumerate(leaf_rels) if n not in experts)
                moe = (f"; aux rel {rel32['aux']:.3e}; MoE routing decisions (token, layer) that "
                       f"differ from one rank's: {differ} of {DIST_SEQ // DIST_RANKS * t['layers']}"
                       f"; worst expert-leaf norm rel {worst[0]:.3e} (leaf {worst[1]}, "
                       + ("gated)" if not differ else "not gated: the others held)"))
            print(f"  rank {r} {case} vs one rank, first batch: in fp32 weights ({t['layers']} "
                  f"layers) loss rel {rel32['loss']:.3e}, grad_norm rel {rel32['grad_norm']:.3e}, "
                  f"largest gradient-leaf norm rel {leaf32:.3e} (limit {FPDT_GRAD_RTOL}){moe}; the "
                  f"bf16 step's loss rel {rel16['loss']:.3e} (limit {FPDT_GRAD_RTOL}) and "
                  f"grad_norm rel {rel16['grad_norm']:.3e}; peak device memory "
                  f"{t['peak_gib']:.2f} GiB (reckoned {t['reckoned_peak_gib']:.2f}); parameter "
                  f"digests {[d[:12] for d in t['digests']]} [{card}]")
            if len(recs) != t["steps"]:
                raise AssertionError(f"rank {r} {case}: {len(recs)} steps of {t['steps']}")
            if max(*rel32.values(), leaf32, rel16["loss"]) > FPDT_GRAD_RTOL:
                raise AssertionError(f"rank {r} {case}: first step differs from one rank")
            if "bf16_grads" in t:
                b16, rb16 = t["bf16_grads"], ref["bf16_grads"]
                leaf16 = [abs(a - b) / b for a, b in zip(b16["leaf_norms"], rb16["leaf_norms"])]
                emb = rb16["embed_leaf"]
                norm16 = abs(b16["grad_norm"] - rb16["grad_norm"]) / rb16["grad_norm"]
                print(f"  rank {r} {case} vs one rank, first batch, bf16 gradient-leaf norms "
                      "rel: " + ", ".join(f"{x:.2e}" for x in leaf16) + f"; the embedding "
                      f"(leaf {emb}) {leaf16[emb]:.3e} (limit {DIST_BF16_EMBED_RTOL}), the others "
                      f"limit {FPDT_GRAD_RTOL}; global norm {norm16:.3e} (limit "
                      f"{DIST_BF16_NORM_RTOL}), the step's {rel16['grad_norm']:.3e}")
                if (b16["embed_leaf"] != emb or leaf16[emb] > DIST_BF16_EMBED_RTOL
                        or max(x for i, x in enumerate(leaf16) if i != emb) > FPDT_GRAD_RTOL
                        or max(norm16, rel16["grad_norm"]) > DIST_BF16_NORM_RTOL):
                    raise AssertionError(f"rank {r} {case}: first batch's bf16 gradients differ "
                                         "from one rank's")
            if len(set(t["digests"])) != 1:
                raise AssertionError(f"{case}: the ranks' parameters differ after the steps")
        t0 = ranks[0]["train"][case]
        kind = case[len(arch):]  # " ulysses", " cp", " zero3", or nothing
        totals[f"train {arch} {t0['mesh']}{kind} (per rank)"] = {
            k: sum(rec["launches"][k] for rec in t0["records"]) for k in t0["want_launches"]}
    _check_ckpt(ranks, one_rank_ckpt, card)
    _check_compress(ranks, card)
    _check_maverick(torch, M, ranks, maverick, maverick_ranks, card)
    return totals


def _eager_ms(torch, fn, iters=200, warmup=20):
    """Per call, launched back to back from the host (CUDA events): at small
    shapes this is the host's dispatch time, wrapper included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(torch, fn, per_graph=20, replays=10):
    """Per call, on the device: ``per_graph`` calls captured in one CUDA
    graph, the graph replayed and timed with CUDA events, so no host work
    sits between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as capture wants
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * per_graph)
    del graph
    return ms


def _bound(b, hq, hkv, sq, sk, d, in_bytes, q_offset, k_offset, carry, window=0):
    """Least time on the card: (ms, "bytes"|"operations").  Operations count
    4*d per live causal (q, k) pair (q.k and p.v) under the window; bytes
    count q, k, v (and a carry) read once and (acc, m, l) written once."""
    live = _live_pairs(sq, sk, q_offset, k_offset, window)
    flops = 4 * d * live * b * hq
    nbytes = in_bytes * (b * hq * sq * d + 2 * b * hkv * sk * d) + 4 * (b * hq * sq * (d + 2))
    if carry:
        nbytes += 4 * (b * hq * sq * (d + 2))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _live_pairs(sq, sk, q_offset, k_offset, window=0):
    """Causal (q, k) pairs these offsets leave live; with window > 0 only
    keys with qpos - kpos < window."""
    live = 0
    for r in range(sq):
        qpos = q_offset + r
        hi = min(sk - 1, qpos - k_offset)  # last key index the row sees
        lo = max(0, qpos - window + 1 - k_offset) if window > 0 else 0
        live += max(0, hi - lo + 1)
    return live


def _bwd_bound(which, b, hq, hkv, sq, sk, d, in_bytes, q_offset, k_offset, window=0):
    """Least time of flash_bwd_dq ("dq") or flash_bwd_dkv ("dkv") on the card:
    (ms, "bytes"|"operations").  Operations: 6 d (dq) or 8 d (dkv) per live
    causal pair and q-head; bytes: q, k, v, do, L, delta read once, the
    outputs written once."""
    live = _live_pairs(sq, sk, q_offset, k_offset, window)
    flops = (6 if which == "dq" else 8) * d * live * b * hq
    nbytes = in_bytes * (b * hq * sq * d + 2 * b * hkv * sk * d) + 4 * b * hq * sq * (d + 2)
    nbytes += 4 * (b * hq * sq * d if which == "dq" else 2 * b * hkv * sk * d)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _sdpa_flash_bwd(torch, q, k, v, do, causal):
    """The flash-attention backward behind SDPA on one pair (dq, dk and dv
    together, GQA in the op; it recomputes its own softmax from its
    forward's out and logsumexp), called directly so that it is timed as
    device time from a CUDA graph like the kernels: (fn, None) or (None,
    the reason it cannot run these inputs).  The port never calls it."""
    try:
        fwd = torch.ops.aten._scaled_dot_product_flash_attention(q, k, v, 0.0, causal)
        do16 = do.to(q.dtype)

        def library():
            return torch.ops.aten._scaled_dot_product_flash_attention_backward(
                do16, q, k, v, fwd[0], fwd[1], fwd[2], fwd[3], fwd[4], fwd[5], 0.0, causal,
                fwd[6], fwd[7])

        grads = library()
    except RuntimeError as e:  # a yardstick only: the kernels do not depend on it
        return None, str(e).splitlines()[0]
    if tuple(grads[1].shape) != tuple(k.shape) or not all(torch.isfinite(t).all()
                                                          for t in grads):
        raise AssertionError(f"sdpa flash backward gave dk {tuple(grads[1].shape)} or "
                             "non-finite grads")
    return library, None


def phase_timing(torch, K, R, SK, SR, lse, finalize, card):
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    rows, seen = {}, []  # rows by key; every timed row
    hyb = "recurrentgemma-9b 8192 u=4 {} pair cq=2048 b1 hq16 hkv1 d256 window 2048"
    gpt = "gpt-2.7b 8192 u=4 {} pair cq=2048 b1 hq32 hkv32 d80"
    shapes = [
        # key, label, b, hq, hkv, sq, sk, d, window, q_off, k_off, carry
        ("flash_fwd_serve", "serve prefill b4 s64 (u=1)", 4, 32, 8, 64, 64, 64, 0, 0, 0, False),
        (None, "2048 prompt u=4 off-diagonal pair cq=512", 4, 32, 8, 512, 512, 64, 0, 512, 0,
         True),
        (None, "2048 prompt u=4 diagonal pair cq=512", 4, 32, 8, 512, 512, 64, 0, 512, 512,
         True),
        ("flash_fwd_train", "train 8192 u=4 off-diagonal pair cq=2048 b1", 1, 32, 8, 2048, 2048,
         64, 0, 2048, 0, True),
        (None, "train 8192 u=4 diagonal pair cq=2048 b1", 1, 32, 8, 2048, 2048, 64, 0, 2048,
         2048, True),
        # the off-diagonal pair opens its rows' softmax (no carry), the diagonal continues it
        ("flash_fwd_hybrid", hyb.format("off-diagonal"), 1, 16, 1, 2048, 2048, 256, 2048, 2048,
         0, False),
        (None, hyb.format("diagonal"), 1, 16, 1, 2048, 2048, 256, 2048, 2048, 2048, True),
        # this slice's main path: pair (1, 0) opens its rows' softmax, (1, 1) continues it
        ("flash_fwd", gpt.format("off-diagonal"), 1, 32, 32, 2048, 2048, 80, 0, 2048, 0, False),
        ("flash_fwd_gpt_diagonal", gpt.format("diagonal"), 1, 32, 32, 2048, 2048, 80, 0, 2048,
         2048, True),
    ]
    for key, label, b, hq, hkv, sq, sk, d, window, qo, ko, carry in shapes:
        q = torch.randn((b, hq, sq, d), generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn((b, hkv, sk, d), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((b, hkv, sk, d), generator=g, device=dev).to(torch.bfloat16)
        st = None
        if carry:
            st = (torch.randn((b, hq, sq, d), generator=g, device=dev),
                  torch.randn((b, hq, sq), generator=g, device=dev),
                  torch.rand((b, hq, sq), generator=g, device=dev) + 0.5)
        kw = dict(causal=True, window=window, q_offset=qo, k_offset=ko)

        def kern():
            return K.flash_fwd(q, k, v, st, **kw)

        def plain():
            return R.attend_chunk(q, k, v, carry=None if st is None else R.SoftmaxState(*st),
                                  **kw)

        # yardstick: one library call of (normalized) GQA attention on the
        # same q/k/v: causal on the diagonal pairs (where a window of the
        # chunk's length never binds), unmasked off the diagonal, as the
        # backward's yardstick is
        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=qo == ko, enable_gqa=True)

        bound_ms, bound_by = _bound(b, hq, hkv, sq, sk, d, 2, qo, ko, carry, window)
        live = _live_pairs(sq, sk, qo, ko, window)
        row = {"kernel": "flash_fwd", "shape": label, "ms": _device_ms(torch, kern),
               "plain_ms": _device_ms(torch, plain), "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": _device_ms(torch, library),
               "library": "scaled_dot_product_attention forward"
               + (", causal" if qo == ko else
                  f", unmasked: {sq * sk / live:.2f}x this pair's live work"),
               "wrapper_ms": _eager_ms(torch, kern), "card": card}
        print("timing " + json.dumps(row))
        seen.append(row)
        if key:
            rows[key] = row
        del q, k, v, st

    # the backward kernels at the training paths' pair shapes: bf16 q/k/v,
    # fp32 do, L and delta from the plain forward of the pair
    pairs = [
        # key suffix, label, hq, hkv, d, window, q_off, k_off
        ("_train", "train 8192 u=4 off-diagonal pair cq=2048 b1", 32, 8, 64, 0, 2048, 0),
        (None, "train 8192 u=4 diagonal pair cq=2048 b1", 32, 8, 64, 0, 2048, 2048),
        ("_hybrid", hyb.format("off-diagonal"), 16, 1, 256, 2048, 2048, 0),
        (None, hyb.format("diagonal"), 16, 1, 256, 2048, 2048, 2048),
        ("", gpt.format("off-diagonal"), 32, 32, 80, 0, 2048, 0),
        ("_gpt_diagonal", gpt.format("diagonal"), 32, 32, 80, 0, 2048, 2048),
    ]
    for suffix, label, hq, hkv, d, window, qo, ko in pairs:
        b, s_ = 1, 2048
        q = torch.randn((b, hq, s_, d), generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn((b, hkv, s_, d), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((b, hkv, s_, d), generator=g, device=dev).to(torch.bfloat16)
        kw = dict(causal=True, window=window, q_offset=qo, k_offset=ko)
        st = R.attend_chunk(q, k, v, **kw)
        do = torch.randn(q.shape, generator=g, device=dev)
        L, delta = lse(st), (do * finalize(st)).sum(-1)
        del st
        library, why = _sdpa_flash_bwd(torch, q, k, v, do, causal=qo == ko)
        library_ms = _device_ms(torch, library) if library is not None else None
        if why:
            print(f"timing: no library backward at {label}: {why}")
        for name, which in (("flash_bwd_dq", "dq"), ("flash_bwd_dkv", "dkv")):
            wrap = K.flash_bwd_dq if which == "dq" else K.flash_bwd_dkv
            ref = R.chunk_bwd_dq if which == "dq" else R.chunk_bwd_dkv

            def kern():
                return wrap(q, k, v, do, L, delta, **kw)

            def plain():
                return ref(q, k, v, do, L, delta, **kw)

            bound_ms, bound_by = _bwd_bound(which, b, hq, hkv, s_, s_, d, 2, qo, ko, window)
            row = {"kernel": name, "shape": label, "ms": _device_ms(torch, kern),
                   "plain_ms": _device_ms(torch, plain, per_graph=5, replays=4),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": library_ms,
                   "library": "aten flash-attention backward: dq, dk and dv together"
                   + ("" if qo == ko else ", unmasked: twice this pair's live work"),
                   "wrapper_ms": _eager_ms(torch, kern, iters=20, warmup=3), "card": card}
            if which == "dkv":
                row["n_split"] = K.dkv_splits(b, hq, hkv, s_)
            print("timing " + json.dumps(row))
            seen.append(row)
            if suffix is not None:
                rows[name + suffix] = row
        del q, k, v, do, L, delta, library
        torch.cuda.empty_cache()

    # linear_scan at the RG-LRU training shape: fp32 a and gated input
    # [1, 8192, 4096], no h0 (a layer's scan starts from zeros)
    a = torch.rand((1, 8192, 4096), generator=g, device=dev)
    x = torch.randn((1, 8192, 4096), generator=g, device=dev)

    def kern():
        return SK.linear_scan(a, x)

    def plain():
        return SR.linear_scan(a, x)

    n_el = a.numel()
    t_bytes = 3 * 4 * n_el / PEAK_BYTES  # a, b read once, h written once
    t_ops = 2 * n_el / PEAK_FP32_FLOPS  # one multiply and one add per element, fp32
    row = {"kernel": "linear_scan", "shape": "RG-LRU scan [1, 8192, 4096] fp32, no h0",
           "ms": _device_ms(torch, kern),
           "plain_ms": _device_ms(torch, plain, per_graph=1, replays=3),
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None, "library": "none: no PyTorch call computes a linear recurrence",
           "wrapper_ms": _eager_ms(torch, kern, iters=50, warmup=5), "card": card}
    print("timing " + json.dumps(row))
    rows["linear_scan"] = row
    seen.append(row)

    # linear_scan at the selective scan's block: 8 segments a channel
    # instead of 256, with the carried state as h0
    sa, sb, sh0 = _selective_block_inputs(torch, g, *SELECTIVE_BLOCK[:2])

    def kern_sel():
        return SK.linear_scan(sa, sb, sh0)

    def plain_sel():
        return SR.linear_scan(sa, sb, sh0)

    t_bytes = (3 * sa.numel() + sh0.numel()) * 4 / PEAK_BYTES  # a, b, h0 read; h written
    t_ops = 2 * sa.numel() / PEAK_FP32_FLOPS
    row = {"kernel": "linear_scan", "shape": "selective scan block [1, 256, 131072] fp32, h0",
           "ms": _device_ms(torch, kern_sel),
           "plain_ms": _device_ms(torch, plain_sel, per_graph=1, replays=3),
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None, "library": "none: no PyTorch call computes a linear recurrence",
           "wrapper_ms": _eager_ms(torch, kern_sel, iters=50, warmup=5), "card": card}
    print("timing " + json.dumps(row))
    rows["linear_scan_selective"] = row
    seen.append(row)
    del sa, sb, sh0

    # the fused backward at the same shape, as the RG-LRU layer's backward
    # gives it: fp32 a, h and dout, fp32 db, no h0; beside it the unfused
    # chain it replaced (the forward kernel in reverse mode over a copied
    # a_next, two cats, a multiply), in this call
    h = SK.linear_scan(a, x)
    dout = torch.randn(h.shape, generator=g, device=dev)

    def kern_bwd():
        return SK.linear_scan_bwd(a, h, None, dout, torch.float32)

    def plain_bwd():
        return SR.linear_scan_bwd(a, h, None, dout, torch.float32)

    def unfused():
        return SR.linear_scan_bwd(a, h, None, dout, torch.float32,
                                  reverse_scan=lambda a_, b_: SK.linear_scan(a_, b_, reverse=True))

    t_bytes = 5 * 4 * n_el / PEAK_BYTES  # a, dout, h read once; da, db written once
    t_ops = 3 * n_el / PEAK_FP32_FLOPS  # a multiply-add and the da multiply per element
    row = {"kernel": "linear_scan_bwd", "shape": "RG-LRU scan backward [1, 8192, 4096] fp32, "
           "no h0", "ms": _device_ms(torch, kern_bwd),
           "plain_ms": _device_ms(torch, plain_bwd, per_graph=1, replays=3),
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None, "library": "none: no PyTorch call computes a linear recurrence",
           "unfused_ms": _device_ms(torch, unfused),
           "wrapper_ms": _eager_ms(torch, kern_bwd, iters=50, warmup=5), "card": card}
    print("timing " + json.dumps(row))
    rows["linear_scan_bwd"] = row
    del a, x, h, dout
    torch.cuda.empty_cache()
    print("redesigned kernels, device ms now vs the earlier kernels they replaced "
          "(EARLIER_MS): " + "; ".join(
              f"{r['kernel']} {r['shape']}: {r['ms']:.4f} vs {EARLIER_MS[r['kernel'], r['shape']]}"
              for r in seen if (r["kernel"], r["shape"]) in EARLIER_MS) + f" [{card}]")
    return rows


def _modules():
    """The port's modules the phases drive, by short name."""
    from repro_torch import configs as cfg_mod
    from repro_torch import tree as TR
    from repro_torch.core import fpdt as F
    from repro_torch.core import parallel as P
    from repro_torch.data import pipeline as DP
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.linear_scan import kernel as SK
    from repro_torch.launch import mesh as MESH
    from repro_torch.checkpoint import manager as CKPT
    from repro_torch.launch import serve as CLI
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import train as TRAIN
    from repro_torch.models import layers as L
    from repro_torch.models import mamba as MB
    from repro_torch.models import moe as MOE
    from repro_torch.models import rglru as R
    from repro_torch.models import serve as SV
    from repro_torch.models import transformer as T
    from repro_torch.optim import compression as C
    from repro_torch.runtime import placement as PL
    from repro_torch.runtime import train_loop as TL

    return types.SimpleNamespace(K=K, SK=SK, cfg_mod=cfg_mod, T=T, F=F, TR=TR, TL=TL, PL=PL,
                                 DP=DP, TRAIN=TRAIN, CLI=CLI, SV=SV, MB=MB, R=R, L=L, P=P,
                                 MESH=MESH, MOE=MOE, SH=SH, CKPT=CKPT, C=C)


def main():
    import faulthandler

    t_start = time.perf_counter()
    faulthandler.enable()
    faulthandler.dump_traceback_later(BUDGET_S - (time.monotonic() - STARTED))
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        fail(f"the port is not beside this script: {SRC / 'repro_torch'} is missing")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 products in full fp32

    from repro_torch.core.online_softmax import SoftmaxState, finalize, lse
    from repro_torch.kernels import build as B
    from repro_torch.kernels.flash_attention import ref as R
    from repro_torch.kernels.linear_scan import ops as SO
    from repro_torch.kernels.linear_scan import ref as SR

    M = _modules()
    K, SK, F = M.K, M.SK, M.F
    card, name = phase("device", phase_device, torch)
    phase("build", phase_build, B, K.SOURCES + SK.SOURCES)
    errs = phase("kernel vs plain", phase_kernel, torch, K, R, SoftmaxState, finalize)
    bwd = phase("backward kernels vs plain", phase_kernel_bwd, torch, K, R, F, SoftmaxState, lse,
                finalize)
    scan = phase("linear_scan vs plain", phase_scan, torch, SK, SR, SO)
    serve = {arch: phase(f"serve {arch}", phase_serve, torch, M, arch, card)
             for arch in ("llama3.2-1b", "recurrentgemma-9b", "falcon-mamba-7b", GRANITE,
                          *FRONTEND_ARCHS)}
    train_ref = {}
    train = phase("train llama3.2-1b", phase_train, torch, M, card, train_ref)
    cli = phase("train CLI llama3.2-1b --compress-grads --trace-out --metrics-out",
                phase_train_cli, torch, M, card, train_ref)
    hybrid = phase("train recurrentgemma-9b (8 layers)", phase_train_hybrid, torch, M, card)
    gpt = phase("train gpt-2.7b", phase_train_gpt, torch, M, card)
    falcon = phase(f"train falcon-mamba-7b ({FALCON_LAYERS} layers)", phase_train_falcon, torch,
                   M, card)
    phase("granite MoE layer under set_sync_debug_mode('error')", phase_moe_layer, torch, M, card)
    granite = phase(f"train {GRANITE}", phase_train_granite, torch, M, card)
    frontends = {arch: phase(f"train {arch}", phase_train_frontend, torch, M, card, arch)
                 for arch in FRONTEND_ARCHS}
    qwen = phase(f"train {QWEN} ({QWEN_LAYERS} layers)", phase_train_qwen, torch, M, card)
    phase("long context gpt-2.7b", phase_long_context, torch, M, card)
    dist = phase("distribution (ulysses, cp, the recurrent mixers)", phase_dist, torch, M, card)
    timing = phase("timing", phase_timing, torch, K, R, SK, SR, lse, finalize, card)

    def at(key, tag):  # another timed shape's figures, as extra keys
        row = timing[key]
        return {f"{k}_{tag}": row[k] for k in ("ms", "bound_ms", "plain_ms", "library_ms")}

    flash = "src/repro_torch/kernels/flash_attention/csrc/"
    scan_src = "src/repro_torch/kernels/linear_scan/csrc/linear_scan.cu"
    replaces = "src/repro/kernels/flash_attention/kernel.py:"
    pairs = bwd["pairs"]
    layouts = {arch: row["bfloat16"] for arch, row in bwd["layouts"].items()}  # the path's dtype
    entries = [
        ("flash_fwd", flash + "flash_fwd.cu", replaces + "134",
         max(*errs.values(), *(p["fwd"] for p in pairs.values())),
         {"max_err_fp32": errs["float32"], "max_err_bf16": errs["bfloat16"],
          **{f"max_err_{m}_pairs": p["fwd"] for m, p in pairs.items()},
          **{f"max_acc_rel_err_{m}_pairs": p["fwd_acc"] for m, p in pairs.items()},
          **{f"tc_rel_err_acc_{m}_pairs": p["fwd_tc"]["acc"] for m, p in pairs.items()},
          **{f"max_err_dist_pairs_{k}": w["fwd"] for k, w in bwd["dist"].items()},
          **{f"max_err_{a}_layout_pair": w["fwd"] for a, w in layouts.items()},
          **{f"tc_rel_err_acc_{a}_layout_pair": w["fwd_tc"] for a, w in layouts.items()},
          "library": timing["flash_fwd"]["library"],
          **at("flash_fwd_gpt_diagonal", "gpt_diagonal_pair"),
          **at("flash_fwd_train", "llama_train_pair"), **at("flash_fwd_hybrid", "hybrid_pair"),
          **at("flash_fwd_serve", "serve")}),
        ("flash_bwd_dq", flash + "flash_bwd.cu", replaces + "273", bwd["abs"]["dq"],
         {"max_rel_err": bwd["rel"]["dq"],
          **{f"max_rel_err_dist_pairs_{k}": w["dq"] for k, w in bwd["dist"].items()},
          **{f"max_rel_err_{m}_pairs": p["worst"]["dq"] for m, p in pairs.items()},
          **{f"tc_rel_err_{m}_pairs": p["tc"]["dq"] for m, p in pairs.items()},
          **{f"max_rel_err_{a}_layout_pair": w["dq"] for a, w in layouts.items()},
          **at("flash_bwd_dq_gpt_diagonal", "gpt_diagonal_pair"),
          **at("flash_bwd_dq_train", "llama_train_pair"),
          **at("flash_bwd_dq_hybrid", "hybrid_pair")}),
        ("flash_bwd_dkv", flash + "flash_bwd.cu", replaces + "367",
         max(bwd["abs"]["dk"], bwd["abs"]["dv"]),
         {"max_rel_err_dk": bwd["rel"]["dk"], "max_rel_err_dv": bwd["rel"]["dv"],
          **{f"max_rel_err_{p}_dist_pairs_{k}": w[p] for k, w in bwd["dist"].items()
             for p in ("dk", "dv")},
          **{f"max_rel_err_dk_{m}_pairs": p["worst"]["dk"] for m, p in pairs.items()},
          **{f"max_rel_err_dv_{m}_pairs": p["worst"]["dv"] for m, p in pairs.items()},
          **{f"tc_rel_err_dk_{m}_pairs": p["tc"]["dk"] for m, p in pairs.items()},
          **{f"max_rel_err_{p}_{a}_layout_pair": w[p] for a, w in layouts.items()
             for p in ("dk", "dv")},
          "n_split": timing["flash_bwd_dkv"]["n_split"],
          "n_split_llama_train_pair": timing["flash_bwd_dkv_train"]["n_split"],
          "n_split_hybrid_pair": timing["flash_bwd_dkv_hybrid"]["n_split"],
          **at("flash_bwd_dkv_gpt_diagonal", "gpt_diagonal_pair"),
          **at("flash_bwd_dkv_train", "llama_train_pair"),
          **at("flash_bwd_dkv_hybrid", "hybrid_pair")}),
        ("linear_scan", scan_src, "src/repro/kernels/linear_scan/kernel.py:67",
         scan["max_abs_err"], {"max_rel_err_near_unit": scan["max_rel_err_near_unit"],
                               "max_rel_err_selective_block": scan["selective_fwd_rel_err"],
                               **at("linear_scan_selective", "selective_block")}),
        ("linear_scan_bwd", scan_src, "src/repro/kernels/linear_scan/kernel.py:67",
         scan["bwd_max_abs_err"], {"max_abs_err_op_grad": max(scan["grad"].values()),
                                   "bf16_rounding_steps": scan["bwd_bf16_steps"],
                                   "max_abs_err_selective_block":
                                       scan["selective_bwd_max_abs_err"],
                                   "unfused_ms": timing["linear_scan_bwd"]["unfused_ms"]}),
    ]
    kernels = {"kernels": []}
    for kname, src, repl, err, extra in entries:
        row = timing[kname]
        if not all(math.isfinite(x) for x in (row["ms"], row["plain_ms"])):
            fail(f"non-finite timing of {kname}")
        by_path = {**{f"serve {arch}": counts[kname] for arch, counts in serve.items()},
                   "train llama3.2-1b": train[kname], "train llama3.2-1b compress": cli[kname],
                   "train recurrentgemma-9b": hybrid[kname],
                   "train gpt-2.7b": gpt[kname], "train falcon-mamba-7b": falcon[kname],
                   f"train {GRANITE}": granite[kname],
                   **{f"train {arch}": d[kname] for arch, d in frontends.items()},
                   f"train {QWEN}": qwen[kname],
                   **{path: d[kname] for path, d in dist.items()}}
        # each kernel's own path: gpt-2.7b's training for the attention
        # kernels, this slice's falcon-mamba-7b training for the scan
        path = "train falcon-mamba-7b" if kname.startswith("linear_scan") else "train gpt-2.7b"
        if by_path[path] <= 0:
            fail(f"the {path} path launched {kname} no time")
        kernels["kernels"].append({
            "name": kname, "route": "cuda", "source": src, "replaces": repl,
            "launches": by_path[path], "launches_path": path, "launches_by_path": by_path,
            "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "wrapper_ms": row["wrapper_ms"],
            "timed_shape": row["shape"], **extra})
    faulthandler.cancel_dump_traceback_later()
    print(f"chip_smoke.py took {time.perf_counter() - t_start:.1f} s, the kernels' build "
          "included")
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
