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
  2b. dryrun  — the port's dry-run (launch/dryrun.py --all --mesh both) in
                this process into a temp directory: every arch x shape cell
                on JAX's production meshes reckoned from meta-device shapes
                (no card), 66 records all ok within DRYRUN_S seconds;
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
  5b. engines — continuous batching through the CLI's own run_engine, in
                fp32 weights at full width and depth: llama3.2-1b's fused
                engine (ServeEngine: 8 requests of 67-228 tokens over 4
                slots, prefill chunk 64, segment 8, 16 new tokens), its
                first segment under set_sync_debug_mode("error"); each
                request's tokens equal to its solo generation (prefill_step
                + decode_tokens), its first-token logits the solo prefill's
                within FP32_LOGIT_RTOL, a stop token cutting every request
                where its solo run would; the BlockingServeEngine on the
                same workload (the fused engine's tokens, flash_fwd launched
                as reckoned for its batched prefill and each refill); both
                engines' steady p50 and refill-active p95 dispatch ms; then
                recurrentgemma-9b (38 layers) and falcon-mamba-7b (64) on 6
                requests of 35-114 tokens (each ending in a partial chunk),
                8 new tokens: tokens equal to solo generation, and at the
                chunk step that ends each prompt its logits and its slot's
                recurrent state leaves the solo prefill's within
                FP32_LOGIT_RTOL, linear_scan launched; last, host-streamed
                decode KV: llama3.2-1b b2, a 65536-position cache, a
                32768-token FPDT prefill, 8 greedy decode steps with the
                full-attention k and v in pinned host memory in 16 slabs
                against on-device decode of the same cache: the same
                tokens, logits within FP32_LOGIT_RTOL, 9 of 16 slabs merged
                a layer and step, the bytes fetched as reckoned, no k or v
                byte on the card, ms a step beside the host link's rate;
  5c. paged   — the paged pool (runtime/paged.py) through run_engine, with
                5b's llama3.2-1b weights, settings and solo tokens, 16
                tokens a page: (a) 5b's 8 requests through PagedServeEngine,
                segment 1 under set_sync_debug_mode("error"), the fused
                engine's and solo tokens, pages_peak between the first four
                reserves and the pool, the device peak within 10% of its
                reckoning; (b) 8 requests behind a 512-token shared prompt,
                radix on and off: the same tokens, 2048 prefix-hit tokens
                (the four refills' shared pages) and as many fewer
                prefilled; (c) a 120-page pool with a spill tier, (b) twice:
                (b)'s tokens, a deferral, a demotion, a promote; (d) (b)'s
                tree saved and restored into a new engine: (b)'s tokens,
                every admission hitting the restored prefix; (e)
                SLOPagedServeEngine: a decoding priority-1 request
                preempted by a priority-0 arrival and fifo, both the solo
                tokens, and a prefill-budget pause, the solo tokens; (f)
                (b)'s workload with the pool parked in pinned host memory
                (n_host_chunks): (b)'s tokens, (n_pages + 1) x 1048576 B
                pinned and no pool k or v on the card, the peak within 10%
                of its reckoning, the bytes fetched and written back as
                reckoned from the replayed schedule, segment 1 under
                set_sync_debug_mode("error"), flash_fwd 0;
  5d. mesh    — serving over a mesh: (a) 5c's (b) workload on a 1 x 2
                serve mesh of two gloo ranks sharing the card (llama3.2-1b,
                16 layers, fp32, its 8 kv heads split 4 a rank): 5c's
                tokens, a rank's pool (n_pages + 1) x (524288 + 1024) B
                (half of one rank's k and v, the whole pkpos), its peak
                within 10% of the weights, the pool and a step's
                transient, gather_heads one a layer a step at its reckoned
                bytes, the first segment under set_sync_debug_mode("error")
                (gloo's own staging exempt), flash_fwd launched no time,
                the gathers' share of the run; then its prefix store saved
                on the mesh (gather_pages at its reckoned calls and bytes)
                and restored on one rank: 5c's tokens, every admission a
                hit; (a') in the same spawn, falcon-mamba-7b (8 layers) and
                recurrentgemma-9b (6) at full width, fp32, on 5b's
                recurrent requests, d_inner over model, then llama3.2-1b
                (4 layers) on (a)'s prompts with the pool parked and with
                dense host KV at one kv head (its positions over model,
                the ranks' states merged): each one rank's tokens (this
                process, after (b)), the recurrent state leaves at half of
                d_inner to the byte, gather_channels and the dense case's
                gather_state as reckoned, linear_scan launched on each
                rank, a rank's pinned bytes as reckoned and as the dry-run
                reckons a rank's host_cache_bytes (SV.rank_cache_bytes);
                then llama3.2-1b (4 layers, one kv head) with a pool no
                dim of which 2 divides (3-entry pages, an odd page count):
                the pool on the card whole at its reckoned bytes, nothing
                pinned, one warning; then the same ranks as a 2 x 1 mesh
                (the data axis), at 8 kv heads: the pool parked by in-page positions
                over data, one slot's dense host KV by a slab's positions
                over data (gather_parked at its reckoned calls and bytes)
                and dense host KV of 783 positions, which 2 does not
                divide, parked whole on each rank (gather_written at its
                reckoned calls and bytes): one rank's tokens in each;
                (b) after
                the ranks, the replica tier in this process:
                tests/test_faults.py's seeded crash at full depth (two 1 x 1
                paged replicas, two rounds of four sessions, the first
                session's home replica dying on its second dispatch, a
                shared store): the no-fault tokens, one death, pages and
                prefix tokens recovered through the store; (c) the serve
                CLI, --mesh 1x2 --replicas 3 --paged --fault-plan
                "V:hang@0~T" --dispatch-timeout T --retry 0
                --shared-kv-store --batch 1 --prefill-chunk 16 (the page
                size) at 4 layers, V the replica most requests
                route to (it prefills and runs them, then times out and
                dies), beside the same CLI without a fault: the clean
                run's tokens (their sha256), one death, V's requests
                re-homed, V's pages saved and restored into the survivors
                through the proxies and prefix tokens of the re-homed
                requests read from them;
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
  6c. gpt     — gpt-2.7b (the paper's GPT) at full width and 8 of its 32
                layers (GPT_TRAIN_LAYERS), B1-B3 at head_dim 80: the same as 6b
                (u = 4 vs u = 1 at all 8 layers), its losses held to
                EARLIER_LOSSES (taken at 8 layers with commit b137e8f's
                training code, whose 32-layer losses met 0fd5e81's);
  6d. falcon  — falcon-mamba-7b at full width and 4 of its 64 layers, the
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
  6f. granite — granite-moe-1b-a400m at full width and 6 of its 24 layers
                (32 experts, top-8): as 6b, with two runs of the first step and
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
  6x. examples — B1-B3 at quickstart's head layout (b2 hq10 hkv5 d64,
                128 x 128, causal) in fp32 and bf16 against their plain
                versions; then each example of src/repro_torch/examples
                through its main at its JAX script's defaults, the launch
                counts reset before each and read after: quickstart (the
                ~100M-param model, 100 steps at b2 s128: finite losses that
                fall, checkpoints at 50 and 100; its launches a step),
                convergence_fpdt (40 steps, the Fig. 14 curves within 5e-3),
                fault_tolerance_demo (preempted after step 12, resumed to 30
                on the same bits, the straggler alert), serve_batched (the
                fused default, --paged --shared-prefix 128 --page-size 16
                and --arch falcon-mamba-7b --requests 4: every request
                served) and long_context_fpdt --mesh 1x2 on two gloo ranks
                (FPDT == Ulysses at 1e-4 and 1e-3; each rank's main run as
                a rank of a spawned world, its launch counts read in the
                rank); each example's seconds; quickstart's step profiled
                (as 6b's);
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
                1 x 2, b1 s 16384 u 8 remat full offload on, 1 AdamW
                step under ulysses and 1 under cp, then recurrentgemma-9b
                (3 layers: one rglru, rglru, local_attn cycle) and
                falcon-mamba-7b (2 layers), 1 step each, and
                granite-moe-1b-a400m (2 layers, ulysses), 1 step,
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
                (launches_by_path: the six serve paths, the five engine and
                host-KV paths, the paged and SLO paths, eight trainings,
                the CLI's compressed training and the distributed
                trainings, per rank, the examples, the long-context
                example's per rank),
                the new head layouts' and quickstart's layout's errors;
  9. last line: {"ok": true, "device": {...}}.

It imports only the port (``src/repro_torch``), torch and the standard
library, and stops if there is no card or no port beside it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
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
import warnings
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
# chip call with its child; gpt-2.7b's (at GPT_TRAIN_LAYERS, 8 layers) from
# this script's first card run at that depth, on a tree whose training code was
# commit b137e8f's, where gpt's 32-layer losses still met those taken at commit
# 0fd5e81 (the anchor before the cut); musicgen-medium's, internvl2-2b's and
# qwen1.5-4b's (8 layers) from this script's first card run of them, where
# their frontends and registration were added.  Each step is held within
# LOSS_RTOL of them.
EARLIER_LOSSES = {"llama3.2-1b": (12.1212, 10.8319, 14.2329),
                  "recurrentgemma-9b": (12.8542, 10.5876, 9.7271),
                  "gpt-2.7b": (11.4793, 18.8279, 17.4778),
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


DRYRUN_CELLS = 66  # 10 archs x 3 shapes + 3 long_500k archs, on 2 meshes
DRYRUN_S = 30.0


def phase_dryrun(M, card):
    """The dry-run sweep on the card's machine (which has no JAX): every
    cell's record written, all ok, in under DRYRUN_S seconds; the status
    lines go to a buffer, the count and the seconds are printed."""
    import io
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        lines = io.StringIO()
        with contextlib.redirect_stdout(lines):
            try:
                M.D.main(["--all", "--mesh", "both", "--out", d])
                code = 0
            except SystemExit as e:
                code = e.code
        recs = [json.loads(p.read_text()) for p in Path(d).glob("*.json")]
    seconds = time.perf_counter() - t0
    ok = sum(r["ok"] for r in recs)
    host = {r["mesh"]: r["reckoned"]["host_cache_bytes"] for r in recs
            if (r["arch"], r["shape"]) == ("llama3.2-1b", "long_500k") and r["ok"]}
    print(f"dry-run sweep: {ok} ok of {len(recs)} cells in {seconds:.2f} s (exit {code}); "
          f"llama3.2-1b long_500k host_cache_bytes a rank {host} [{card}]")
    if code != 0 or len(recs) != DRYRUN_CELLS or ok != DRYRUN_CELLS:
        raise AssertionError(f"the dry-run sweep gave {ok} ok of {len(recs)} records "
                             f"(exit {code}); want {DRYRUN_CELLS} ok\n" + lines.getvalue())
    if seconds > DRYRUN_S:
        raise AssertionError(f"the dry-run sweep took {seconds:.1f} s, over {DRYRUN_S} s")
    return seconds


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


def _prefill_launches(M, cfg, s: int) -> int:
    """flash_fwd launches of one prefill of ``s`` positions: one a live chunk
    pair (u = fpdt_chunks) of each attention layer."""
    u = cfg.fpdt_chunks
    return sum(M.F.pair_live(i, j, cq=s // u, window=cfg.window if k == "local_attn" else 0,
                             sparsity=cfg.attn_sparsity)
               for k in cfg.layer_kinds() if k in ("attn", "local_attn")
               for i in range(u) for j in range(i + 1))


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
    want_fwd = _prefill_launches(M, cfg, s)
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
    flops = M.D.model_flops(cfg, batch, seq)
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
          f"{peak_gib:.2f} GiB (reckoned {M.D.reckoned_peak_gib(cfg, 1, seq):.2f}); host offload "
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


# gpt-2.7b's training depth: 8 of its 32 layers (its full depth runs in the
# long-context phase 6g).  Cut from 32 to make room for the serve mesh's
# recurrent and host-streamed cases (5d (a')) and the parked pool (5c (f));
# every check of the phase runs at this depth.
GPT_TRAIN_LAYERS = 8


def phase_train_gpt(torch, M, card):
    """gpt-2.7b (the paper's GPT) at full width and GPT_TRAIN_LAYERS layers,
    B1-B3 at head_dim 80."""
    return _train_run(torch, M, _train_cfg(M, "gpt-2.7b", num_layers=GPT_TRAIN_LAYERS), card)


GRANITE = "granite-moe-1b-a400m"


# granite's training depth: 6 of its 24 layers (served at 24 in phase 5).
# Cut from 24 to 12 to make room for the serve engines' phases (5b), and to
# 6 for the examples phase; every check of the phase runs at this depth.
GRANITE_TRAIN_LAYERS = 6


def phase_train_granite(torch, M, card):
    """granite-moe-1b-a400m at full width and GRANITE_TRAIN_LAYERS layers (32
    experts, top-8): offload on == off, two runs of the first step and remat
    offload == remat full, each bit for bit; the training run, profiled
    with offload on; u=4 vs u=1 in fp32 weights with the routing decisions
    that differ counted."""
    return _train_run(torch, M, _train_cfg(M, GRANITE, num_layers=GRANITE_TRAIN_LAYERS), card,
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


# of 64: 1.375 B parameters (16 layers, 2.218 B, ran until the serve
# engines' phases needed the room; every check runs at this depth); the
# training phase runs 4 since the examples phase (every check at that depth)
FALCON_LAYERS = 8
FALCON_TRAIN_LAYERS = 4


def phase_train_falcon(torch, M, card):
    """falcon-mamba-7b at full width, FALCON_TRAIN_LAYERS of its 64 layers (64
    need ~87 GB of state): remat offload == remat full bit for bit at this
    depth, then the training run (no attention: no FPDT offload, profiled
    once)."""
    cfg = dataclasses.replace(_train_cfg(M, "falcon-mamba-7b", num_layers=FALCON_TRAIN_LAYERS),
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
            rec["flops"] = M.D.model_flops(cfg, 1, seq)
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
# the examples (src/repro_torch/examples/), each through its main
# ---------------------------------------------------------------------------

# quickstart_config's attention at its default batch: b, hq, hkv, tokens
# (u = 1: 128 queries against 128 keys), head_dim
QUICKSTART_LAYOUT = (2, 10, 5, 128, 64)
QUICKSTART_STEPS = 100
# each example's flags: the JAX scripts' defaults (convergence at 40 steps,
# quickstart at 100 steps of b2 s128, the whole fault-tolerance demo); the
# long-context demo on two gloo ranks sharing the card.  The kernels each
# must launch: B1-B3 in the three trainings and on every long-context rank;
# in serve_batched B4 for
# falcon-mamba-7b's scans, none for the fused and paged engines, which
# attend in plain PyTorch (the JAX package's chunk and paged attention are
# jnp, no Pallas kernel; phases 5b and 5c read 0 there too)
ATTENTION_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
EXAMPLE_SERVE = (("fused", [], ()),
                 ("paged", ["--paged", "--shared-prefix", "128", "--page-size", "16"], ()),
                 ("falcon-mamba-7b", ["--arch", "falcon-mamba-7b", "--requests", "4"],
                  ("linear_scan",)))
EXAMPLE_LONG = ["--mesh", "1x2", "--dist-backend", "gloo"]
EXAMPLES_S = 60.0  # the phase's aim; printed beside its seconds, not a check


def _quickstart_layout(torch, K, R, SoftmaxState, finalize, lse):
    """B1-B3 at quickstart's head layout (QUICKSTART_LAYOUT, a kv group of
    2 at 10 q heads, causal), fp32 and bf16: flash_fwd against
    ref.attend_chunk at TOL, flash_bwd_dq and flash_bwd_dkv against
    ref.chunk_bwd_dq / chunk_bwd_dkv from the rows' own L and delta (fp32:
    TOL_BWD, dq elementwise, dk and dv relative to 1 + max|ref|; bf16:
    TOL_BWD_BF16 relative to 1 + max|ref|)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    b, hq, hkv, s, d = QUICKSTART_LAYOUT
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[-1]
        errs = {}
        check = _fwd_checker(torch, K, R, SoftmaxState, finalize, errs, {})
        q, k, v = (torch.randn((b, h, s, d), generator=g, device=dev).to(dtype)
                   for h in (hq, hkv, hkv))
        label = f"quickstart layout b{b} hq{hq} hkv{hkv} d{d} {s} x {s} {key}"
        st = check(f"flash_fwd {label}", dtype, q, k, v, None, causal=True)
        do, L, delta = _bwd_inputs(torch, R, lse, finalize, q, None, None, g, states=st)
        got = (K.flash_bwd_dq(q, k, v, do, L, delta, causal=True),
               *K.flash_bwd_dkv(q, k, v, do, L, delta, causal=True))
        want = (R.chunk_bwd_dq(q, k, v, do, L, delta, causal=True),
                *R.chunk_bwd_dkv(q, k, v, do, L, delta, causal=True))
        torch.cuda.synchronize()
        tol = TOL_BWD_BF16 if dtype == torch.bfloat16 else TOL_BWD
        row = {"fwd": errs[key]}
        for part, a, w in zip(("dq", "dk", "dv"), got, want):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{label}: non-finite {part}")
            rel = float((a - w).abs().max()) / (1.0 + float(w.abs().max()))
            if part == "dq" and dtype == torch.float32:
                if _max_violation(a, w, TOL_BWD)[1]:
                    raise AssertionError(f"{label}: dq beyond tol {TOL_BWD} elementwise")
            elif rel > tol:
                raise AssertionError(f"{label}: {part} err / (1 + max|ref|) {rel:.3e} beyond "
                                     f"tol {tol}")
            row[part] = rel
        out[key] = row
    print(f"quickstart head layout (b{b} hq{hq} hkv{hkv} d{d}, {s} x {s}, causal): "
          + "; ".join(f"{k} flash_fwd max abs err of out, m, l {r['fwd']:.3e}, dq, dk, dv err "
                      f"/ (1 + max|ref|) {r['dq']:.3e}, {r['dk']:.3e}, {r['dv']:.3e}"
                      for k, r in out.items())
          + f" (tol fwd {TOL['float32']} / {TOL['bfloat16']}, bwd {TOL_BWD} / {TOL_BWD_BF16})")
    return out


def _example_rank(out_dir, argv):
    """One rank of the long-context example (``launch/mesh.py::spawn`` sets
    its RANK and WORLD_SIZE, so the example's main runs as one rank of that
    world): the launch counts reset just before main and read just after,
    written with its results to ``out_dir/rank<r>.json``."""
    sys.path.insert(0, str(SRC))
    from repro_torch.examples import long_context_fpdt as LC

    M = _modules()
    _reset_counts(M.K, M.SK)
    results = LC.main(argv)
    Path(out_dir, f"rank{os.environ['RANK']}.json").write_text(
        json.dumps({"launches": _counts(M.K, M.SK), "results": results}))


def _long_context_ranks(M, card):
    """long_context_fpdt at EXAMPLE_LONG, its ranks spawned here so that
    each reads its own launch counts: (seconds, rank 0's counts), after
    every rank launched B1-B3, each as often as its two variants reckon
    (``_launches_per_step`` at the model axis's sequence split)."""
    import functools
    import tempfile

    from repro_torch.examples import long_context_fpdt as LC

    args = LC.parse_args(EXAMPLE_LONG)
    world = args.shape[0] * args.shape[1]
    reckoned = {}
    for cfg in LC.variant_configs(LC.base_config(), args.chunks).values():
        for k, n in _launches_per_step(cfg, M.F, M.T, M.MB, args.seq, sp=args.shape[1]).items():
            reckoned[k] = reckoned.get(k, 0) + n
    label = "long_context_fpdt " + " ".join(EXAMPLE_LONG)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        code = M.MESH.spawn(functools.partial(_example_rank, tmp), EXAMPLE_LONG, world)
        seconds = time.perf_counter() - t0
        if code:
            raise AssertionError(f"example {label}: a rank exited with {code}")
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(world)]
    for r, rank in enumerate(ranks):
        print(f"example {label} rank {r}: launches {rank['launches']}; "
              + "; ".join(f"{name} loss {loss:.5f} sum |g| {gsum:.2f} peak "
                          f"{peak / 2**20:.0f} MiB" for name, (loss, gsum, peak)
                          in rank["results"].items()) + f" [{card}]")
        missing = [k for k in ATTENTION_KERNELS if rank["launches"][k] <= 0]
        if missing:
            raise AssertionError(f"example {label}: rank {r} launched {missing} no time")
        if rank["launches"] != reckoned:
            raise AssertionError(f"example {label}: rank {r} launches {rank['launches']}, "
                                 f"reckoned {reckoned}")
    print(f"example {label}: {seconds:.1f} s (the ranks' start-up included) [{card}]",
          flush=True)
    return seconds, ranks[0]["launches"]


def phase_examples(torch, M, card, R, SoftmaxState, finalize, lse):
    """Each example's main on the card at its JAX script's defaults, the
    launch counts reset just before each and read just after: quickstart
    (100 steps: finite losses that fall, checkpoints at 50 and 100), the
    Fig. 14 curves (the example asserts they coincide within 5e-3), the
    fault-tolerance demo (preempted after step 12, resumed to 30 on the same
    bits, the straggler alert; the example asserts each), serve_batched's
    fused default, paged shared-prefix and falcon-mamba-7b runs (every
    request served, prefix hits on the paged run), and the long-context
    demo on 1 x 2 gloo ranks (its ranks assert FPDT == Ulysses at 1e-4 and
    1e-3; each rank reads its own launch counts, ``_long_context_ranks``).
    First B1-B3 at quickstart's head layout against their plain versions;
    after quickstart, one more of its steps profiled (``_profile_step``)."""
    from repro_torch.examples import convergence_fpdt as CV
    from repro_torch.examples import fault_tolerance_demo as FT
    from repro_torch.examples import quickstart as QS
    from repro_torch.examples import serve_batched as SB

    import tempfile

    K, SK = M.K, M.SK
    t_phase = time.perf_counter()
    out = {"layout": _quickstart_layout(torch, K, R, SoftmaxState, finalize, lse),
           "seconds": {}, "launches": {}}

    def drive(label, main, argv):
        _reset_counts(K, SK)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = main(argv)
        torch.cuda.synchronize()
        out["seconds"][label] = time.perf_counter() - t0
        out["launches"][label] = _counts(K, SK)
        print(f"example {label}: {out['seconds'][label]:.1f} s, launches "
              f"{out['launches'][label]} [{card}]", flush=True)
        return res

    with tempfile.TemporaryDirectory() as tmp:
        qs = drive("quickstart", QS.main, ["--steps", str(QUICKSTART_STEPS),
                                           "--ckpt-dir", os.path.join(tmp, "quickstart")])
        losses = [h["loss"] for h in qs["history"]]
        if len(losses) != QUICKSTART_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"quickstart: {len(losses)} losses, finite "
                                 f"{all(math.isfinite(x) for x in losses)}")
        if not qs["last"] < qs["first"]:
            raise AssertionError(f"quickstart: loss {qs['first']:.4f} -> {qs['last']:.4f}")
        if qs["checkpoints"] != [50, 100]:
            raise AssertionError(f"quickstart wrote checkpoints {qs['checkpoints']}")
        per_step = {k: n / QUICKSTART_STEPS for k, n in out["launches"]["quickstart"].items()}
        print(f"quickstart: loss {qs['first']:.4f} -> {qs['last']:.4f}, "
              f"{qs['seconds'] / QUICKSTART_STEPS * 1e3:.1f} ms a step (host clock, the "
              f"checkpoints included); launches a step {per_step} [{card}]")
        cfg, dev = QS.quickstart_config(), torch.device("cuda")
        params = M.T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        oc = M.TRAIN.adamw.OptConfig(lr=6e-4, warmup_steps=10, total_steps=QUICKSTART_STEPS)
        b, _, _, seq, _ = QUICKSTART_LAYOUT
        bf = M.DP.make_batch_fn(cfg, M.cfg_mod.ShapeConfig("quickstart", seq, b, "train"))
        print("quickstart's step, profiled: ", end="")
        out["profile"] = _profile_step(torch, M.TRAIN, M.TL, cfg, params, oc, bf, dev,
                                       M.TRAIN.adamw.init(oc, params), M.PL.host_offload(dev),
                                       card)
        del params
        cv = drive("convergence_fpdt", CV.main, ["--steps", "40"])
        print("convergence max |loss - baseline|: "
              + ", ".join(f"{k} {v:.5f}" for k, v in cv["deviations"].items()))
        ft = drive("fault_tolerance_demo", FT.main, ["--ckpt-dir", os.path.join(tmp, "ft")])
        print(f"fault tolerance: preempted at {ft['reached']}, ended at {ft['end']}, "
              f"checkpoints {ft['checkpoints']}, last loss {ft['losses'][-1]:.4f}")
    want = {label: ATTENTION_KERNELS for label in out["launches"]}
    for label, argv, kernels in EXAMPLE_SERVE:
        want[f"serve_batched {label}"] = kernels
        run = drive(f"serve_batched {label}", SB.main, argv)
        args = SB.parse_args(argv)
        if len(run["outs"]) != args.requests or not all(0 < len(o) <= args.gen
                                                        for o in run["outs"]):
            raise AssertionError(f"serve_batched {label}: {[len(o) for o in run['outs']]} "
                                 f"tokens for {args.requests} requests")
        if args.paged and not run["stats"]["prefix_hit_tokens"] > 0:
            raise AssertionError(f"serve_batched {label}: no prefix hit")
    label = "long_context_fpdt " + " ".join(EXAMPLE_LONG) + " (per rank)"
    out["seconds"][label], out["launches"][label] = _long_context_ranks(M, card)
    for label, kernels in want.items():
        missing = [k for k in kernels if out["launches"][label][k] <= 0]
        if missing:
            raise AssertionError(f"example {label} launched {missing} no time")
    total = time.perf_counter() - t_phase
    print(f"examples: {total:.1f} s (aim {EXAMPLES_S:.0f} s): "
          + ", ".join(f"{k} {v:.1f} s" for k, v in out["seconds"].items()) + f" [{card}]")
    return out


# ---------------------------------------------------------------------------
# continuous batching: the serve engines and host-streamed decode KV
# ---------------------------------------------------------------------------

# The engines' workloads, through the CLI's own functions (engine_prompts,
# run_engine): 4 slots, 64-token prefill chunks, 8 steps a dispatch; then
# requests, --prompt-len (the CLI draws each length in [prompt_len // 4,
# prompt_len] from seed 0) and new tokens a request.  fp32 weights, so
# that the chunked path and the solo FPDT prefill differ by fp32 rounding
# only and greedy tokens are comparable.
ENGINE_SLOTS, ENGINE_CHUNK, ENGINE_SEGMENT = 4, 64, 8
ENGINE_LLAMA = (8, 256, 16)
ENGINE_RECURRENT = (6, 128, 8)
# Host-streamed decode KV: rows, cache capacity, prompt, slabs, decode
# steps.  fp32 weights: a bf16 model's logits come out of a bf16 product,
# so the merge order alone moves some by a bf16 ulp (4e-3 of a logit), past
# FP32_LOGIT_RTOL, as phase_serve's decode-vs-prefill check runs in fp32
# for the same reason.  The prompt is prefilled in 4096-token FPDT chunks.
HOST_KV = (2, 65536, 32768, 16, 8)


def _fp32_cfg(M, arch, **over):
    return dataclasses.replace(M.cfg_mod.get_config(arch), param_dtype="float32",
                               remat="none", **over)


def _state_leaves(cache):
    """(name, leaf, batch axis) of every recurrent state leaf of a cache."""
    for key, blocks in cache.items():
        for i, bc in enumerate(blocks if key == "tail" else [blocks]):
            for name, leaf in bc.items():
                if name in ("conv", "h", "ssm"):
                    yield (f"tail/{i}/{name}" if key == "tail" else f"{key}/{name}",
                           leaf, 0 if key == "tail" else 1)


@contextlib.contextmanager
def _engine_probe(torch, M, states=False):
    """Records what a ServeEngine run computes, for the checks: each
    dispatch's schedule (``segment_schedule``'s return), each chunk step's
    logits and, with ``states``, a copy of every recurrent state leaf after
    each chunk step.  It wraps the module functions the engine calls and
    adds no host read."""
    rec = {"schedules": [], "logits": [], "states": []}
    real_sched, real_chunk = M.DL.segment_schedule, M.SV.chunk_step

    def sched(*a, **k):
        rec["schedules"].append(real_sched(*a, **k))
        return rec["schedules"][-1]

    def chunk(cfg, par, params, cache, *a, **k):
        logits, cache = real_chunk(cfg, par, params, cache, *a, **k)
        rec["logits"].append(logits)
        if states:
            rec["states"].append({n: leaf.clone() for n, leaf, _ in _state_leaves(cache)})
        return logits, cache

    M.DL.segment_schedule, M.SV.chunk_step = sched, chunk
    try:
        yield rec
    finally:
        M.DL.segment_schedule, M.SV.chunk_step = real_sched, real_chunk


@contextlib.contextmanager
def _sync_checked_first_segment(torch, M):
    """The engine's first segment (``mixed_segment``: its chunk and decode
    steps, sampling and state updates) under
    ``torch.cuda.set_sync_debug_mode("error")``, so that any host read of
    a device value inside it raises; the state's upload before it and the
    harvest after it stay outside."""
    real = M.DL.mixed_segment
    ran = {"segments": 0}

    def checked(*a, **k):
        if ran["segments"]:
            return real(*a, **k)
        ran["segments"] = 1
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    M.DL.mixed_segment = checked
    try:
        yield ran
    finally:
        M.DL.mixed_segment = real


def _prompt_ends(rec, engine, prompts, segment, cp):
    """request -> (index into rec["logits"], slot) of the chunk step that
    ended its prompt.  A request admitted before dispatch d (its
    request.admit event) into slot s prefills one chunk a step from that
    dispatch's first step, so its last chunk is global step d * segment +
    ceil(n / cp) - 1; the recorded chunk steps are the global steps whose
    schedule prefills."""
    chunk_of = {}
    for d, sched in enumerate(rec["schedules"]):
        for t, (any_pf, _) in enumerate(sched):
            if any_pf:
                chunk_of[d * segment + t] = len(chunk_of)
    ends = {}
    for e in engine.telemetry.tracer.events:
        if e["kind"] == "request.admit":
            g = e["step"] * segment + -(-len(prompts[e["request"]]) // cp) - 1
            ends[e["request"]] = (chunk_of[g], e["slot"])
    return ends


def _solo(torch, M, cfg, params, prompt, gen, dev, states=False):
    """One prompt alone: prefill_step at its exact length (one FPDT chunk)
    and decode_tokens, greedy.  Returns (its gen tokens, the prefill's
    logits [padded_vocab], the recurrent state leaves after the prompt)."""
    c1 = dataclasses.replace(cfg, fpdt_chunks=1, mlp_chunks=1)
    logits, cache = M.SV.prefill_step(c1, None, params,
                                      {"tokens": torch.tensor([prompt], device=dev)},
                                      max_len=len(prompt) + gen)
    st = {n: leaf.clone() for n, leaf, _ in _state_leaves(cache)} if states else None
    tok0 = torch.argmax(logits[:, : cfg.vocab_size], dim=-1).to(torch.int32)
    ids, _ = M.DL.decode_tokens(c1, None, params, cache, tok0[:, None], len(prompt),
                                num_steps=gen - 1)
    return [int(tok0[0])] + ids[0].tolist(), logits[0], st


def _rel_max(got, want) -> float:
    """max |got - want| / max |want|."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _trunc(g, stop):
    return g[: g.index(stop) + 1] if stop in g else g


def _engine_line(name, run, card):
    sm = run["summary"] or {}
    total = sum(len(o) for o in run["outs"])
    p50, p95, r50 = (sm.get(k, float("nan")) for k in ("steady_p50_ms", "refill_p95_ms",
                                                         "refill_p50_ms"))
    print(f"  {name}: {total} tokens in {run['ms']:.1f} ms, {len(run['engine'].last_stats['steps'])}"
          f" dispatches; steady p50 {p50:.2f} ms, refill-active p95 {p95:.2f} ms, "
          f"stall_factor_p50 {r50 / p50:.3f} [{card}]")
    return {"steady_p50_ms": p50, "refill_p95_ms": p95, "stall_factor_p50": r50 / p50}


def _serve_peak_gib(torch, cfg, b, S, cp, host_kv=False):
    """Peak device memory of a serving run, reckoned from the shapes: the
    weights, the cache (init_cache's leaves; under host_kv the
    full-attention k and v in pinned memory instead) and the largest
    transient of a step, which is the fp32 K and V expanded to the q heads
    over the cache (two [b, S, hq, dh]) and the scores of a cp-token window
    ([b, hq, cp, S] twice), or the MLP's fp32 [b, cp, d_ff] three times.
    An estimate printed beside the reading; the pinned bytes returned
    beside it."""
    item = getattr(torch, cfg.param_dtype).itemsize
    kinds = cfg.layer_kinds()
    kv = 2 * b * cfg.num_kv_heads * cfg.head_dim * item
    full = sum(k == "attn" for k in kinds) * S * kv
    ring = sum(k == "local_attn" for k in kinds) * min(cfg.window, S) * kv
    states = sum({"rglru": b * cfg.d_inner * ((cfg.d_conv - 1) * item + 4),
                  "ssm": b * cfg.d_inner * ((cfg.d_conv - 1) * item + 4 * cfg.ssm_state)
                  }.get(k, 0) for k in kinds)
    span = S if "attn" in kinds else min(cfg.window, S) if "local_attn" in kinds else 0
    attn = 4 * b * span * cfg.num_heads * (2 * cfg.head_dim + 2 * cp)
    mlp = 3 * 4 * b * cp * max(cfg.d_ff, cfg.d_inner * cfg.ssm_state)
    pinned = full if host_kv else 0
    dev = cfg.num_params() * item + full + ring + states - pinned + max(attn, mlp)
    return dev / 2**30, pinned / 2**30


def _init_fp32(torch, M, cfg, dev):
    t0 = time.perf_counter()
    params = M.T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    print(f"init_params {cfg.name} ({cfg.num_layers} layers, {cfg.num_params() / 1e9:.3f} B "
          f"params, fp32) in {time.perf_counter() - t0:.1f} s")
    return params


def phase_engine(torch, M, card):
    """llama3.2-1b at full width and depth in fp32 weights through the CLI's
    run_engine: ENGINE_LLAMA's 8 requests over 4 slots, prefill chunk 64,
    segment 8, greedy, 16 new tokens; the first segment under
    set_sync_debug_mode("error").  Each request's tokens equal its solo
    generation (prefill_step + decode_tokens) and its first-token logits the
    solo prefill's within FP32_LOGIT_RTOL; with a stop token from solo run
    0 every request is cut where its solo run would be.  Then the
    BlockingServeEngine on the same workload (bucket 256): the fused
    engine's tokens, and flash_fwd launched once a live chunk pair of each
    layer for each of its prefills (the batched one and every refill).  The
    weights, prompts and solo tokens go on to ``phase_paged``."""
    dev = torch.device("cuda")
    cfg = _fp32_cfg(M, "llama3.2-1b")
    params = _init_fp32(torch, M, cfg, dev)
    n_req, plen, gen = ENGINE_LLAMA
    prompts, lens = M.CLI.engine_prompts(cfg, n_req, plen)
    kw = dict(slots=ENGINE_SLOTS, bucket=plen, gen=gen, segment=ENGINE_SEGMENT,
              prefill_chunk=ENGINE_CHUNK)
    print(f"workload: {n_req} requests of {sorted(lens.tolist())} tokens, {gen} new each, "
          f"{ENGINE_SLOTS} slots, prefill chunk {ENGINE_CHUNK}, segment {ENGINE_SEGMENT}")
    M.CLI.run_engine(cfg, params, prompts[:2], **kw)  # warm-up: cuBLAS and the allocator

    torch.cuda.reset_peak_memory_stats()
    _reset_counts(M.K, M.SK)
    with _engine_probe(torch, M) as rec, _sync_checked_first_segment(torch, M) as checked:
        fused = M.CLI.run_engine(cfg, params, prompts, **kw)
    counts = _counts(M.K, M.SK)
    peak = torch.cuda.max_memory_allocated() / 2**30
    first = rec["schedules"][0]
    if checked["segments"] != 1:
        raise AssertionError("the first segment did not run under the sync check")
    print(f"segment 1 ({sum(p for p, _ in first)} chunk steps, "
          f"{sum(not p for p, _ in first)} decode steps) ran under "
          "set_sync_debug_mode('error'): no host read")
    S = fused["engine"].last_stats["capacity"]
    want_peak, _ = _serve_peak_gib(torch, cfg, ENGINE_SLOTS, S, ENGINE_CHUNK)
    summary = {"fused": _engine_line("fused", fused, card)}
    print(f"  launches {counts}; peak {peak:.2f} GiB (reckoned {want_peak:.2f}) [{card}]")

    ends = _prompt_ends(rec, fused["engine"], prompts, ENGINE_SEGMENT, ENGINE_CHUNK)
    solos, worst = [], 0.0
    for r, p in enumerate(prompts):
        toks, logits, _ = _solo(torch, M, cfg, params, p, gen, dev)
        solos.append(toks)
        k, slot = ends[r]
        worst = max(worst, _rel_max(rec["logits"][k][slot], logits))
        if fused["outs"][r] != toks:
            raise AssertionError(f"request {r}: engine {fused['outs'][r]} != solo {toks}")
    print(f"tokens of all {n_req} requests equal their solo generation; first-token logits "
          f"vs the solo prefill's: max |diff| / max |logit| = {worst:.3e} "
          f"(tolerance {FP32_LOGIT_RTOL})")
    if not worst <= FP32_LOGIT_RTOL:
        raise AssertionError("the engine's first-token logits disagree with the solo prefill")
    stop = solos[0][2]
    stopped = M.CLI.run_engine(cfg, params, prompts, stop_tokens=(stop,), **kw)["outs"]
    if stopped != [_trunc(g, stop) for g in solos]:
        raise AssertionError("with a stop token the engine does not cut as solo runs would")
    print(f"stop token {stop}: outputs of {[len(g) for g in stopped]} tokens, each cut where "
          "its solo run would be")

    _reset_counts(M.K, M.SK)
    blk = M.CLI.run_engine(cfg, params, prompts, blocking=True, **kw)
    bcounts = _counts(M.K, M.SK)
    refills = blk["engine"].last_stats["refills"]
    want = (1 + refills) * _prefill_launches(M, cfg, plen)
    summary["blocking"] = _engine_line("blocking", blk, card)
    print(f"  blocking: {refills} refills, launches {bcounts} (flash_fwd reckoned {want}: "
          f"{1 + refills} prefills of the {plen}-token bucket)")
    if refills != n_req - ENGINE_SLOTS or bcounts["flash_fwd"] != want:
        raise AssertionError("the blocking engine's prefills are not as reckoned")
    if blk["outs"] != fused["outs"]:
        raise AssertionError("the blocking engine's tokens differ from the fused engine's")
    print("blocking engine tokens == fused engine tokens; refill-active p95 / steady p50: "
          f"fused {summary['fused']['refill_p95_ms'] / summary['fused']['steady_p50_ms']:.2f}, "
          f"blocking {summary['blocking']['refill_p95_ms'] / summary['blocking']['steady_p50_ms']:.2f}"
          " (not gated)")
    del fused, blk, rec
    torch.cuda.empty_cache()
    return {"engine": counts, "blocking": bcounts, "summary": summary,
            "paged_inputs": {"cfg": cfg, "params": params, "prompts": prompts, "solos": solos}}


# The paged engines' phase: tokens a page, the shared system prompt of (b)
# to (d), the pool of (c) (it holds the first two of (b)'s requests, 38 + 48
# pages, not a third's 49, and four at once would take 173) and the spill
# tier of (c) and (d) (256 pages; (b) leaves ~150 in its tree)
PAGE_SIZE, SHARED_PREFIX, PRESSURE_PAGES, SPILL_PAGES = 16, 512, 120, 256
# (e): the SLO engine's segment, short enough that a prefill spans dispatches
SLO_SEGMENT = 2


def _page_bytes(cfg) -> int:
    """One page of the pool over every attention layer: k and v, and pkpos."""
    item = 4 if cfg.param_dtype == "float32" else 2
    layers = sum(k == "attn" for k in cfg.layer_kinds())
    return layers * PAGE_SIZE * (2 * cfg.num_kv_heads * cfg.head_dim * item + 4)


def _reserve(prompt, gen) -> int:
    """Pages a request reserves at admission: its prompt and budget."""
    return -(-(len(prompt) + gen) // PAGE_SIZE)


def _paged_line(name, run, card):
    st = run["engine"].last_stats
    sm = run["summary"] or {}
    print(f"  {name}: {sum(len(o) for o in run['outs'])} tokens in {run['ms']:.1f} ms, "
          f"{st['dispatches']} dispatches, steady p50 {sm.get('steady_p50_ms', float('nan')):.2f} "
          f"ms, refill-active p95 {sm.get('refill_p95_ms', float('nan')):.2f} ms; prefix hits "
          f"{st['prefix_hit_tokens']}/{st['prompt_tokens']}, {st['prefilled_tokens']} prefilled, "
          f"{st['cow_copies']} COW, {st['deferrals']} deferrals, pages peak "
          f"{st['pages_peak']}/{run['engine'].n_pages}, radix {st['radix_pages']}, spilled "
          f"{st['spilled_pages']}, promoted {st['spill_promotes']} [{card}]")


def phase_paged(torch, M, card, base):
    """The paged engines (``runtime/paged.py``) through the CLI's run_engine,
    llama3.2-1b at full width and depth in fp32, with phase_engine's
    weights and settings (4 slots, chunk 64, segment 8, 16 new tokens,
    greedy), PAGE_SIZE 16:
      (a) ENGINE_LLAMA's 8 requests through PagedServeEngine, its first
          segment under set_sync_debug_mode("error"): the fused engine's and
          the solo runs' tokens; pages_peak between the four first reserves
          and the pool; the pool's bytes and the device peak beside their
          reckoning (the peak gated within 10%);
      (b) 8 requests behind a 512-token shared prompt, radix on and off: the
          same tokens; the four refills each map the 512 shared tokens, so
          prefix_hit_tokens is 2048 and prefilled_tokens drops by as many;
      (c) the pool cut to PRESSURE_PAGES with a spill tier, (b)'s workload
          twice: (b)'s tokens both times; a deferral, a demotion and a
          promote from the tier;
      (d) (b)'s radix-on tree saved (save_kv_store) and restored into a new
          engine: (b)'s tokens, every admission hitting the restored prefix;
      (e) SLOPagedServeEngine at SLO_SEGMENT: one slot, a priority-1 request
          decoding preempted by a priority-0 arrival, both the solo tokens;
          fifo the same tokens without preempting; two slots and a prefill
          budget of 1: a pause, the solo tokens;
      (f) (b)'s workload, radix on, with the pool parked in pinned host
          memory (``_paged_host``).
    Launches are read around (a), (e) and (f)."""
    import tempfile

    cfg, params = base["cfg"], base["params"]
    prompts, solos = base["prompts"], base["solos"]
    n_req, plen, gen = ENGINE_LLAMA
    kw = dict(slots=ENGINE_SLOTS, bucket=plen, gen=gen, segment=ENGINE_SEGMENT,
              prefill_chunk=ENGINE_CHUNK)
    page = _page_bytes(cfg)
    print(f"a page: {page} B over {cfg.num_layers} layers (k, v {PAGE_SIZE} x "
          f"{cfg.num_kv_heads} x {cfg.head_dim} fp32 and pkpos)")

    # (a)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(M.K, M.SK)
    with _sync_checked_first_segment(torch, M) as checked:
        a = M.CLI.run_engine(cfg, params, prompts, paged=dict(page_size=PAGE_SIZE), **kw)
    counts = {"paged": _counts(M.K, M.SK)}
    peak = torch.cuda.max_memory_allocated() / 2**30
    eng, st = a["engine"], a["engine"].last_stats
    if checked["segments"] != 1:
        raise AssertionError("the first paged segment did not run under the sync check")
    if a["outs"] != solos:
        raise AssertionError(f"paged engine {a['outs']} != the solo and fused tokens {solos}")
    lo = sum(_reserve(p, gen) for p in prompts[:ENGINE_SLOTS])
    hi = min(eng.n_pages, sum(_reserve(p, gen) for p in prompts))
    S = st["max_pages"] * PAGE_SIZE
    dense_gib, _ = _serve_peak_gib(torch, cfg, ENGINE_SLOTS, S, ENGINE_CHUNK)
    want_gib = dense_gib + ((eng.n_pages + 1) * page - ENGINE_SLOTS * S * page // PAGE_SIZE) / 2**30
    _paged_line("(a) paged", a, card)
    print(f"  tokens equal the fused engine's and the solo runs'; segment 1 ran under "
          f"set_sync_debug_mode('error'); pages_peak {st['pages_peak']} in [{lo}, {hi}] "
          f"(the first four reserves, the pool or all reserves): {st['pages_peak'] * page / 2**20:.2f}"
          f" MiB of the pool's {(eng.n_pages + 1) * page / 2**20:.2f} MiB, against the dense "
          f"engine's {ENGINE_SLOTS} x {S} rows, {ENGINE_SLOTS * S * page / PAGE_SIZE / 2**20:.2f} "
          f"MiB; peak {peak:.3f} GiB (reckoned {want_gib:.3f}); launches {counts['paged']} [{card}]")
    if not lo <= st["pages_peak"] <= hi:
        raise AssertionError(f"pages_peak {st['pages_peak']} outside [{lo}, {hi}]")
    if not 0.9 <= peak / want_gib <= 1.1:
        raise AssertionError(f"peak {peak:.3f} GiB is not within 10% of the reckoned {want_gib:.3f}")
    del a, eng

    # (b)
    shared_prompts, lens = M.CLI.engine_prompts(cfg, n_req, plen, shared_prefix=SHARED_PREFIX)
    kw_b = dict(kw, bucket=plen + SHARED_PREFIX)
    print(f"(b) {n_req} requests of {SHARED_PREFIX} shared + {sorted(lens.tolist())} tokens")
    runs = {}
    for radix in (False, True):
        runs[radix] = M.CLI.run_engine(cfg, params, shared_prompts,
                                       paged=dict(page_size=PAGE_SIZE, radix=radix), **kw_b)
        _paged_line(f"(b) radix {'on' if radix else 'off'}", runs[radix], card)
    ref = runs[False]["outs"]
    on, off = runs[True]["engine"].last_stats, runs[False]["engine"].last_stats
    want_hits = SHARED_PREFIX * (n_req - ENGINE_SLOTS)
    if runs[True]["outs"] != ref:
        raise AssertionError("radix on and off give different tokens")
    if on["prefix_hit_tokens"] != want_hits or off["prefix_hit_tokens"] != 0:
        raise AssertionError(f"prefix hits {on['prefix_hit_tokens']} / {off['prefix_hit_tokens']}"
                             f", reckoned {want_hits} / 0")
    if off["prefilled_tokens"] - on["prefilled_tokens"] != want_hits:
        raise AssertionError("the prefilled tokens did not drop by the hits")
    print(f"  radix on and off: the same tokens; the four refills map {SHARED_PREFIX} tokens "
          f"each: {on['prefix_hit_tokens']} hits, prefilled {off['prefilled_tokens']} -> "
          f"{on['prefilled_tokens']}; run {runs[False]['ms']:.1f} -> {runs[True]['ms']:.1f} ms "
          f"(not gated) [{card}]")

    # (c)
    tight = M.CLI.make_engine(cfg, params, paged=dict(page_size=PAGE_SIZE, n_pages=PRESSURE_PAGES,
                                                      spill_pages=SPILL_PAGES), **kw_b)
    seen = []
    for rnd in (1, 2):
        c = M.CLI.run_engine(cfg, params, shared_prompts, engine=tight)
        _paged_line(f"(c) {PRESSURE_PAGES} pages, run {rnd}", c, card)
        if c["outs"] != ref:
            raise AssertionError(f"under pool pressure (run {rnd}) the tokens differ from (b)'s")
        seen.append({k: tight.last_stats[k]
                     for k in ("deferrals", "spilled_pages", "spill_promotes")})
    print(f"  both runs (b)'s tokens; per run {seen}; demotions "
          f"{tight.telemetry.registry.value('pool_demotions')}, evictions "
          f"{tight.telemetry.registry.value('pool_evictions')}")
    if not (seen[0]["deferrals"] >= 1 and seen[0]["spilled_pages"] >= 1
            and seen[1]["spill_promotes"] >= 1):
        raise AssertionError("pool pressure did not defer and spill (run 1) and promote (run 2)")
    del tight, c

    # (d)
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "kv.npz")
        t0 = time.perf_counter()
        saved = runs[True]["engine"].save_kv_store(store)
        t_save = time.perf_counter() - t0
        size = os.path.getsize(store)
        fresh = M.CLI.make_engine(cfg, params, paged=dict(page_size=PAGE_SIZE,
                                                          spill_pages=SPILL_PAGES), **kw_b)
        t0 = time.perf_counter()
        restored = fresh.restore_kv_store(store)
        t_restore = time.perf_counter() - t0
    d = M.CLI.run_engine(cfg, params, shared_prompts, engine=fresh)
    _paged_line("(d) restored", d, card)
    hits = [e["args"]["prefix_hit"] for e in fresh.telemetry.tracer.events
            if e["kind"] == "request.admit"]
    print(f"  saved {saved} pages ({size} B) in {t_save * 1e3:.1f} ms, restored {restored} in "
          f"{t_restore * 1e3:.1f} ms; prefix hit at each admission {hits} [{card}]")
    if d["outs"] != ref or restored != saved or min(hits) < SHARED_PREFIX:
        raise AssertionError("the restored store does not serve (b)'s prefix and tokens")
    del runs, fresh, d
    torch.cuda.empty_cache()

    # (f)
    counts["paged-host"] = _paged_host(torch, M, card, cfg, params, shared_prompts, kw_b, ref)

    # (e)
    _reset_counts(M.K, M.SK)
    short = min(range(n_req), key=lambda i: len(prompts[i]))
    long_ = max(range(n_req), key=lambda i: len(prompts[i]))
    other = next(i for i in range(n_req) if i not in (short, long_))
    slo = dict(page_size=PAGE_SIZE, spill_pages=SPILL_PAGES)
    kw_e = dict(kw, segment=SLO_SEGMENT)
    reqs = [M.DL.Request(tokens=tuple(prompts[short]), priority=1, arrival=0),
            M.DL.Request(tokens=tuple(prompts[other]), priority=0, arrival=2)]
    outs = {}
    for policy in ("slo", "fifo"):
        e = M.CLI.run_engine(cfg, params, reqs, paged=dict(slo, policy=policy, prefill_budget=0),
                             **dict(kw_e, slots=1))
        outs[policy] = e["outs"]
        est = e["engine"].last_stats
        print(f"  (e) {policy}, 1 slot: {e['ms']:.1f} ms, preemptions {est['preemptions']}, "
              f"request 0 preempted {est['requests'][0]['preemptions']}, prefix hits "
              f"{est['prefix_hit_tokens']} [{card}]")
        if e["outs"] != [solos[short], solos[other]]:
            raise AssertionError(f"{policy}: the scheduled tokens differ from the solo runs'")
        if (est["preemptions"] >= 1) != (policy == "slo"):
            raise AssertionError(f"{policy}: preemptions {est['preemptions']}")
    reqs = [M.DL.Request(tokens=tuple(prompts[short]), priority=0, arrival=0),
            M.DL.Request(tokens=tuple(prompts[long_]), priority=1, arrival=1)]
    e = M.CLI.run_engine(cfg, params, reqs, paged=dict(slo, policy="slo", prefill_budget=1),
                         **dict(kw_e, slots=2))
    est = e["engine"].last_stats
    print(f"  (e) slo, 2 slots, prefill budget 1: {e['ms']:.1f} ms, pauses "
          f"{est['prefill_pauses']} [{card}]")
    if est["prefill_pauses"] < 1 or e["outs"] != [solos[short], solos[long_]]:
        raise AssertionError("the budgeted prefill did not pause, or its tokens differ")
    counts["slo"] = _counts(M.K, M.SK)
    print(f"  launches {counts['slo']}")
    del e
    counts["mesh_inputs"] = {"cfg": cfg, "params": base.pop("params"), "prompts": shared_prompts,
                             "lens": sorted(lens.tolist()), "tokens": ref}
    return counts


# (f): the host-streamed pool's slab count (a flag: the pool streams page by
# page whatever it is; the JAX engines round S to whole slabs of it)
HOST_POOL_CHUNKS = 2


def _pool_traffic(cfg, schedules, tables, n_pages):
    """Bytes the parked pool moves over a run (to the card, back to the
    host), reckoned from the replayed schedules and the tables dispatched
    with them: a step, in every attention layer and for k and v, fetches
    each row's page at every logical page up to the rows' highest position
    (clipped to the table's pages), then each page a row's span touches
    that holds a real page (not unmapped, not the trash page), and writes
    back the span's positions of those pages."""
    layers = sum(k == "attn" for k in cfg.layer_kinds())
    row = cfg.num_kv_heads * cfg.head_dim * 4
    page = PAGE_SIZE * row
    to_card = to_host = 0
    for sched, tab in zip(schedules, tables):
        rows, max_pages = tab.shape
        last = max_pages * PAGE_SIZE - 1
        for _, spans in sched:
            spans = [(a, min(e, last)) for a, e in spans]
            hi = max((e for a, e in spans if a <= e), default=-1)
            pages = rows * (hi // PAGE_SIZE + 1) if hi >= 0 else 0
            written = 0
            for i, (a, e) in enumerate(spans):
                for j in range(a // PAGE_SIZE, e // PAGE_SIZE + 1) if a <= e else ():
                    if 0 <= tab[i, j] < n_pages:
                        pages += 1
                        written += min(e, j * PAGE_SIZE + PAGE_SIZE - 1) - max(a, j * PAGE_SIZE) + 1
            to_card += 2 * layers * pages * page
            to_host += 2 * layers * written * row
    return to_card, to_host


def _paged_host(torch, M, card, cfg, params, prompts, kw, ref):
    """(f): (b)'s workload (radix on) through PagedServeEngine with
    n_host_chunks: the pool's k and v parked in pinned host memory from
    the start and streamed, the live pages a layer in one fetch.  Held:
    (b)'s tokens; the pinned bytes (n_pages + 1) x a page of k and v over
    every layer, to the byte (HostOffload's held bytes), no pool k or v
    on the card and the peak within 10% of the weights, the device's
    pkpos, a layer's staging of the live pages (k and v) and a step's
    transient (the staged k and v expanded to the q heads and the scores,
    or the MLP's); the bytes fetched and written back as
    ``_pool_traffic`` reckons them from the replayed schedule; the first
    segment under set_sync_debug_mode("error"); flash_fwd 0.  The ms a
    step beside the bytes fetched over the host link's rate."""
    dev = torch.device("cuda")
    policy = M.PL.host_offload(dev)
    layers = sum(k == "attn" for k in cfg.layer_kinds())
    kv_page = 2 * layers * PAGE_SIZE * cfg.num_kv_heads * cfg.head_dim * 4
    gbps = _h2d_gbps(torch)
    torch.cuda.synchronize()
    policy.reset_counts()
    held0 = policy.held_bytes
    eng = M.CLI.make_engine(cfg, params, paged=dict(page_size=PAGE_SIZE),
                            n_host_chunks=HOST_POOL_CHUNKS, **kw)
    pinned = policy.held_bytes - held0
    kv = [leaf for key, leaf, _ in M.SV.pool_leaves(eng._pool) if not key.endswith("pkpos")]
    on_card = sum(t.numel() * t.element_size() for t in kv if t.device.type == "cuda")
    want_pinned = (eng.n_pages + 1) * kv_page
    print(f"(f) the pool parked: {eng.n_pages} + 1 pages x {kv_page} B of k and v = "
          f"{want_pinned} B reckoned; {pinned} B pinned (HostOffload), {on_card} B of the pool's "
          f"k and v on the card")
    if pinned != want_pinned or on_card or not all(t.is_pinned() for t in kv):
        raise AssertionError("the parked pool is not (n_pages + 1) pages of pinned k and v")
    tables, real = [], eng._dispatch

    def recorded(*a, **k):  # the table each segment plans from
        tables.append(eng.kv.table.copy())
        return real(*a, **k)

    eng._dispatch = recorded
    gc.collect()  # the earlier cases' engines (reference cycles) and their pools
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    policy.reset_counts()
    M.SV.reset_host_kv()
    _reset_counts(M.K, M.SK)
    with _engine_probe(torch, M) as rec, _sync_checked_first_segment(torch, M) as checked:
        run = M.CLI.run_engine(cfg, params, prompts, engine=eng)
    counts = _counts(M.K, M.SK)
    peak = torch.cuda.max_memory_allocated()
    st = eng.last_stats
    steps = sum(len(sc) for sc in rec["schedules"])
    want_card, want_host = _pool_traffic(cfg, rec["schedules"], tables, eng.n_pages)
    b, cp, hq, dh = kw["slots"], kw["prefill_chunk"], cfg.num_heads, cfg.head_dim
    pkpos = (eng.n_pages + 1) * layers * PAGE_SIZE * 4
    span = st["max_pages"] * PAGE_SIZE  # the live pages at most
    staging = 2 * b * span * cfg.num_kv_heads * dh * 4  # k and v
    attn = 4 * b * span * hq * (2 * dh + 2 * cp)
    mlp = 3 * 4 * b * cp * cfg.d_ff
    want_peak = cfg.num_params() * 4 + pkpos + staging + max(attn, mlp)
    fetched = policy.to_device_bytes
    _paged_line("(f) parked pool", run, card)
    print(f"  {steps} steps, {run['ms'] / steps:.2f} ms a step; fetched {fetched} B "
          f"({fetched / steps / 1e6:.2f} MB a step: {fetched / steps / gbps / 1e6:.3f} ms at the "
          f"host link's {gbps:.2f} GB/s), written back {policy.to_host_bytes} B (reckoned "
          f"{want_card} and {want_host}); {M.SV.host_pages['fetched']} pages; peak "
          f"{peak / 2**30:.3f} GiB (reckoned {want_peak / 2**30:.3f}; {base / 2**30:.3f} "
          f"allocated before the run); launches {counts} [{card}]")
    if run["outs"] != ref:
        raise AssertionError("the parked pool's tokens differ from (b)'s")
    if checked["segments"] != 1 or counts["flash_fwd"]:
        raise AssertionError("the sync check did not run, or flash_fwd launched")
    if (fetched, policy.to_host_bytes) != (want_card, want_host):
        raise AssertionError("the parked pool's traffic is not as reckoned")
    if not 0.9 <= peak / want_peak <= 1.1:
        raise AssertionError(f"peak {peak / 2**30:.3f} GiB not within 10% of the reckoned "
                             f"{want_peak / 2**30:.3f}")
    if (st["host_kv_bytes"], st["host_kv_pages"]) != (want_pinned, M.SV.host_pages["fetched"]):
        raise AssertionError("the engine's host KV figures are not the pool's")
    del eng, run, rec
    torch.cuda.empty_cache()
    return counts


# The serve mesh (runtime/paged.py and models/serve.py on a serve_mesh):
# (a) phase_paged's (b) workload on 1 x MESH_RANKS gloo ranks sharing the
# card, kv heads over model; (b) the replica tier in this process,
# tests/test_faults.py's engines (make_engine) and two-round session
# workload at full depth; (c) the serve CLI over MESH_CLI_REPLICAS replicas
# of 1 x MESH_RANKS at MESH_CLI_LAYERS layers (full width, bf16), a shared
# store: one replica runs its requests but answers past the dispatch timeout
# (a hang of MESH_CLI_HANG s), and dies, so that the survivors restore the
# pages of those very requests through the proxies and read them when the
# requests land there; beside it the same CLI with no fault on one replica
# (run at once), whose tokens the failover's must equal bit for bit.
MESH_RANKS = 2
MESH_JOIN_S = 300  # the ranks' whole run, start-up included
FAULT_ENGINE = dict(slots=2, bucket=24, max_new_tokens=4, page_size=4, segment=1,
                    spill_pages=32)
MESH_CLI_REPLICAS, MESH_CLI_LAYERS = 3, 4
MESH_CLI = (8, 256, 8)  # requests, --prompt-len, --gen
MESH_CLI_S = 300
MESH_CLI_HANG = 10  # s: --dispatch-timeout and the hang; a dispatch takes ~1-3 s
# so that the failover's bf16 tokens are the clean run's bit for bit: one slot
# (a request's steps then do not depend on the requests beside it: a step that
# mixes prefill and decode rows takes its decode rows through the chunk path)
# and --prefill-chunk at the page size (a prefix hit, whole pages, then leaves
# the chunk windows where a cold prefill puts them, so a window's merge of the
# cache's history and its own keys splits at the same position)
MESH_CLI_SLOTS, MESH_CLI_CHUNK = 1, 16


def _mesh_page_bytes(cfg, sp: int) -> int:
    """One page on a rank of 1 x sp with the kv heads split: its heads' k
    and v, and the whole pkpos, over every attention layer."""
    layers = sum(k == "attn" for k in cfg.layer_kinds())
    return layers * PAGE_SIZE * (2 * cfg.num_kv_heads // sp * cfg.head_dim * 4 + 4)


def _mesh_peak_gib(cfg, n_pages: int, max_pages: int, sp: int) -> float:
    """A 1 x sp rank's reckoned peak: the whole fp32 weight tree, its pool,
    and the larger transient of a chunk step over its q heads (the gathered
    pages' k and v expanded to them, the scores twice) or of the MLP."""
    S, hq = max_pages * PAGE_SIZE, cfg.num_heads // sp
    attn = 4 * ENGINE_SLOTS * S * hq * (2 * cfg.head_dim + 2 * ENGINE_CHUNK)
    mlp = 3 * 4 * ENGINE_SLOTS * ENGINE_CHUNK * cfg.d_ff
    return (cfg.num_params() * 4 + (n_pages + 1) * _mesh_page_bytes(cfg, sp)
            + max(attn, mlp)) / 2**30


@contextlib.contextmanager
def _gloo_staging_exempt(torch):
    """gloo stages a CUDA tensor through host memory inside the collective
    (a stream synchronise of its own): that call runs outside
    set_sync_debug_mode, so the sync check holds the port's code alone.
    Each call is timed on the host clock between two device synchronises
    (the work queued before it waits outside the timer): yields
    {"calls", "s"}."""
    import torch.distributed as dist

    real, timed = dist.all_gather_into_tensor, {"calls": 0, "s": 0.0}

    def staged(*a, **k):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **k)
            torch.cuda.synchronize()
            timed["calls"] += 1
            timed["s"] += time.perf_counter() - t0
            return out
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    dist.all_gather_into_tensor = staged
    try:
        yield timed
    finally:
        dist.all_gather_into_tensor = real


def _mesh_rank(rank, world, tmp, spawned_at):
    """One gloo rank of phase_serve_mesh's (a): llama3.2-1b at full depth in
    fp32 (phase_engine's seeded weights, made again here) on a 1 x world
    serve mesh, the paged engine over ``tmp/inputs.json``'s prompts, its
    first segment under set_sync_debug_mode("error"), its all-gathers
    timed; then the prefix store saved on the mesh (gather_pages, rank 0
    writing ``tmp/mesh_kv.npz``); writes its tokens, pool bytes, peak,
    launches, collectives, gathers' time, steps and store to
    ``tmp/rank<r>.json``."""
    import faulthandler

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    M = _modules()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      **{M.MESH.INIT_METHOD_ENV: f"file://{tmp}/store"})
    M.MESH.init_from_env("gloo")
    try:
        dev = M.MESH.rank_device("cuda", rank)
        torch.cuda.set_device(dev)
        par = M.MESH.serve_mesh(1, world)
        inp = json.loads(Path(tmp, "inputs.json").read_text())
        cfg = _fp32_cfg(M, "llama3.2-1b")
        params = M.T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        torch.cuda.synchronize()
        started = time.time() - spawned_at  # spawn to the weights on the card
        eng = M.PG.PagedServeEngine(cfg, params, par=par, slots=ENGINE_SLOTS,
                                    bucket=inp["bucket"], max_new_tokens=inp["gen"],
                                    segment=ENGINE_SEGMENT, prefill_chunk=ENGINE_CHUNK,
                                    page_size=PAGE_SIZE)
        steps = {"chunk": 0, "decode": 0}
        real = {"chunk": M.SV.chunk_step, "decode": M.SV.decode_step}

        def counted(kind):
            def run(*a, **k):
                steps[kind] += 1
                return real[kind](*a, **k)
            return run

        M.SV.chunk_step, M.SV.decode_step = counted("chunk"), counted("decode")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts(M.K, M.SK)
        M.P.reset_counts()
        with _sync_checked_first_segment(torch, M) as checked, \
                _gloo_staging_exempt(torch) as gathers:
            run = M.CLI.run_engine(cfg, params, inp["prompts"], engine=eng)
        st = eng.last_stats
        out = {"start-up": started, "tokens": run["outs"], "ms": run["ms"],
               "summary": run["summary"], "launches": _counts(M.K, M.SK),
               "collectives": {k: [M.P.calls[k], M.P.nbytes[k]] for k in M.P.COLLECTIVES
                               if M.P.calls[k]},
               "steps": dict(steps), "checked": checked["segments"], "gathers": gathers,
               "peak": torch.cuda.max_memory_allocated(),
               "pool": sum(x.numel() * x.element_size()
                           for _, x, _ in M.SV.pool_leaves(eng._pool)),
               "n_pages": eng.n_pages, "max_pages": st["max_pages"],
               "stats": {k: v for k, v in st.items() if isinstance(v, (int, float))}}
        M.P.reset_counts()
        t0 = time.perf_counter()
        saved = eng.save_kv_store(str(Path(tmp, "mesh_kv.npz")))
        out["store"] = {"saved": saved, "ms": (time.perf_counter() - t0) * 1e3,
                        "collectives": {k: [M.P.calls[k], M.P.nbytes[k]]
                                        for k in M.P.COLLECTIVES if M.P.calls[k]}}
        del eng, params, run
        torch.cuda.empty_cache()
        # the same ranks re-formed as a world x 1 mesh too: the data axis
        meshes = {(1, world): par, (world, 1): M.MESH.serve_mesh(world, 1)}
        for label, (cfg, prompts, kw, mesh) in _mesh_cases(M, inp).items():
            t0 = time.perf_counter()
            out[label] = _mesh_case(torch, M, meshes[mesh], dev, cfg, prompts, steps, kw)
            out[label]["s"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    Path(tmp, f"rank{rank}.part").write_text(json.dumps(out))
    os.replace(Path(tmp, f"rank{rank}.part"), Path(tmp, f"rank{rank}.json"))


# (a'): after the llama case, in the same spawn: the recurrent archs at full
# width (falcon-mamba-7b at FALCON_LAYERS, recurrentgemma-9b at two cycles)
# on ENGINE_RECURRENT's requests, their d_inner over model; llama3.2-1b at
# MESH_HOST_LAYERS with host-streamed KV (the pool parked, then the dense
# engine's at one kv head, so that its positions split over model), on
# (a)'s prompts; then the pool none of whose dims divides the ranks (one kv
# head, DEVICE_POOL_PAGE in-page positions, an odd page count: it stays on
# the card, as the JAX package keeps it); then on the same ranks as a
# MESH_RANKS x 1 mesh (the data axis), at llama's 8 kv heads: the pool
# parked by in-page positions over data (the first ENGINE_SLOTS prompts),
# one slot's dense host KV by each slab's positions over data (the first
# prompt), and a dense cache of DATA_WHOLE_GEN new tokens in 3 slabs (783
# positions, which 2 ranks do not divide: every rank parks the whole leaf
# and takes every row's new keys; the first DATA_WHOLE_PROMPTS prompts).
# One kv head only where a case needs it: an indivisible pool, positions
# over model.  The prompt counts are small: over gloo on one card the data
# shares' all-gathers cost ~1 s a prompt
MESH_RECURRENT = (("falcon-mamba-7b", FALCON_LAYERS), ("recurrentgemma-9b", 6))
MESH_HOST_LAYERS = 4
DEVICE_POOL_PAGE, DEVICE_POOL_CHUNK = 3, 48  # the chunk a multiple of the page
DATA_WHOLE_PROMPTS, DATA_WHOLE_GEN, DATA_WHOLE_CHUNKS = 2, 15, 3


def _mesh_cases(M, inp):
    """label -> (config, prompts, make_engine's keywords but ``par``, the
    (data, model) mesh) of the MESH_RANKS spawn's cases after its llama one
    (the parent runs each again on one rank)."""
    n_req, plen, gen = ENGINE_RECURRENT
    common = dict(slots=ENGINE_SLOTS, segment=ENGINE_SEGMENT, prefill_chunk=ENGINE_CHUNK)
    model, data = (1, MESH_RANKS), (MESH_RANKS, 1)
    cases = {}
    for arch, layers in MESH_RECURRENT:
        cfg = _fp32_cfg(M, arch, num_layers=layers)
        prompts, _ = M.CLI.engine_prompts(cfg, n_req, plen)
        cases[arch] = (cfg, [list(p) for p in prompts], dict(common, bucket=plen, gen=gen), model)
    cfg = _fp32_cfg(M, "llama3.2-1b", num_layers=MESH_HOST_LAYERS)
    one_head = dataclasses.replace(cfg, num_kv_heads=1)
    host = dict(common, bucket=inp["bucket"], gen=inp["gen"], n_host_chunks=HOST_POOL_CHUNKS)
    cases["paged-host"] = (cfg, inp["prompts"], dict(host, paged=dict(page_size=PAGE_SIZE)),
                           model)
    cases["dense-host"] = (one_head, inp["prompts"], host, model)
    pages = ENGINE_SLOTS * -(-(inp["bucket"] + inp["gen"]) // DEVICE_POOL_PAGE)
    pages += pages % 2  # an odd count of physical pages (pages + 1)
    cases["paged-device"] = (one_head, inp["prompts"], dict(
        host, prefill_chunk=DEVICE_POOL_CHUNK,
        paged=dict(page_size=DEVICE_POOL_PAGE, n_pages=pages)), model)
    cases["paged-host-data"] = (cfg, inp["prompts"][:ENGINE_SLOTS],
                                dict(host, paged=dict(page_size=PAGE_SIZE)), data)
    cases["dense-host-1slot-data"] = (cfg, inp["prompts"][:1], dict(host, slots=1), data)
    cases["dense-host-whole-data"] = (cfg, inp["prompts"][:DATA_WHOLE_PROMPTS], dict(
        host, gen=DATA_WHOLE_GEN, n_host_chunks=DATA_WHOLE_CHUNKS), data)
    return cases


def _mesh_case(torch, M, par, dev, cfg, prompts, steps, kw):
    """One of ``_mesh_cases`` on this rank of ``par``: its seeded weights,
    an engine (``make_engine``) run over ``prompts``; the tokens, launches,
    serve collectives, steps, the recurrent state leaves' shapes and bytes,
    the pinned bytes the run held, a paged engine's pool bytes on the card,
    the parked pool's share fetches (calls with pages live, and the live
    pages summed) and the warnings that a pool stays on the device."""
    params = M.T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    policy = M.PL.host_offload(dev)
    torch.cuda.synchronize()
    policy.reset_counts()
    held0 = policy.held_bytes
    shares, real_pages = {"calls": 0, "live": 0}, M.SV._stream_pages

    def pages(cache, plan, *a, **k):
        if plan.share is not None and plan.live:
            shares["calls"] += 1
            shares["live"] += plan.live
        return real_pages(cache, plan, *a, **k)

    M.SV._stream_pages = pages
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eng = M.CLI.make_engine(cfg, params, par=par, **kw)
            caches, begin = [], eng._begin
            eng._begin = lambda *a: caches.append(begin(*a)) or caches[-1]
            steps.update(chunk=0, decode=0)
            _reset_counts(M.K, M.SK)
            M.P.reset_counts()
            run = M.CLI.run_engine(cfg, params, prompts, engine=eng)
    finally:
        M.SV._stream_pages = real_pages
    pool = [x for _, x, _ in M.SV.pool_leaves(caches[0])]
    out = {"tokens": run["outs"], "ms": run["ms"], "launches": _counts(M.K, M.SK),
           "collectives": {k: [M.P.calls[k], M.P.nbytes[k]] for k in M.P.COLLECTIVES
                           if M.P.calls[k]},
           "steps": dict(steps), "pinned": policy.peak_held_bytes - held0,
           "states": {n: [list(x.shape), x.numel() * x.element_size()]
                      for n, x, _ in _state_leaves(caches[0])},
           "pool_on_card": sum(x.numel() * x.element_size() for x in pool
                               if x.device.type == "cuda"),
           "shares": shares,
           "warned": [str(w.message) for w in caught if "device memory" in str(w.message)],
           "stats": {k: v for k, v in eng.last_stats.items() if isinstance(v, (int, float))}}
    del eng, params, caches, run, pool
    torch.cuda.empty_cache()
    return out


def _parked_whole(cfg, kw, stats) -> int:
    """The bytes of a host case's whole parked tier: the pool's k and v, or
    the dense cache's, over every attention layer (fp32)."""
    layers = sum(k == "attn" for k in cfg.layer_kinds())
    row = 2 * layers * cfg.num_kv_heads * cfg.head_dim * 4  # a position's k and v
    if "paged" in kw:
        return (stats["n_pages"] + 1) * kw["paged"]["page_size"] * row
    return kw["slots"] * stats["capacity"] * row


def _check_mesh_cases(torch, M, card, ranks, inp):
    """The spawn's extra cases against one rank's run of each (this
    process, the same seeded weights): the tokens; for the recurrent archs
    each rank's state leaves at half of d_inner to the byte, its
    gather_channels calls and bytes (two a recurrent layer and step, a
    step's rows x window x d_inner / 2 in fp32) and linear_scan launched;
    for host-streamed KV each rank's pinned bytes as the JAX package parks
    the tier on a D x M mesh of n ranks (the whole tier over n where one of
    the pool's dims, or the dense cache's positions, divides n; a dense
    cache whole where they do not; nothing where no pool dim does: that
    pool stays on the card, whole, with one warning), held to the dry-run's
    reckoner (``rank_cache_bytes``) and the engine's ``host_kv_bytes``; with
    the positions over model gather_state (a layer and step: the rows'
    [hq, w, dh + 2] states in fp32); over data the parked shares'
    gather_parked (a pool layer and step with pages live: 2 x every row's
    live pages x its share of a page; a live slab of each layer: 2 x its
    share of the slab) and a whole leaf's gather_written (a layer and
    step: the rank's rows x window x (2 hkv dh fp32 + an int32 slot)).
    Returns each case's rank-0 launches."""
    dev = torch.device("cuda")
    out = {}
    for label, (cfg, prompts, kw, (dp, sp)) in _mesh_cases(M, inp).items():
        params = M.T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        one = M.CLI.run_engine(cfg, params, prompts, **{k: v for k, v in kw.items()
                                                         if k != "n_host_chunks"})
        del params
        torch.cuda.empty_cache()
        kinds = cfg.layer_kinds()
        rec = sum(k in ("ssm", "rglru") for k in kinds)
        b, cp, half = kw["slots"], kw["prefill_chunk"], cfg.d_inner // sp
        n, hkv, dh = dp * sp, cfg.num_kv_heads, cfg.head_dim
        for r, got in enumerate(ranks):
            c = got[label]
            n_chunk, n_dec = c["steps"]["chunk"], c["steps"]["decode"]
            print(f"  rank {r} {label} ({cfg.num_layers} layers, {dp} x {sp}): "
                  f"{sum(len(o) for o in c['tokens'])} tokens in {c['ms']:.1f} ms ({n_chunk} "
                  f"chunk, {n_dec} decode steps; the case {c['s']:.1f} s with its weights), "
                  f"one rank's run {one['ms']:.1f} ms; "
                  f"collectives {c['collectives']}; pinned {c['pinned']} B; launches "
                  f"{c['launches']} [{card}]")
            if c["tokens"] != one["outs"]:
                raise AssertionError(f"rank {r} {label}: the {dp} x {sp} tokens differ from one "
                                     "rank's")
            if rec:
                meta = M.SV.init_cache(cfg, b, c["stats"]["capacity"], "meta")
                want = {}
                for name, leaf, _ in _state_leaves(meta):
                    shape = list(leaf.shape)
                    shape[-2 if name.endswith("ssm") else -1] //= sp  # d_inner's dim
                    want[name] = [shape, math.prod(shape) * leaf.element_size()]
                calls = 2 * rec * (n_chunk + n_dec)
                nbytes = 2 * rec * (n_chunk * b * cp + n_dec * b) * half * 4
                print(f"    state leaves {c['states']} (reckoned {want}); gather_channels "
                      f"reckoned [{calls}, {nbytes}]")
                if c["states"] != want:
                    raise AssertionError(f"rank {r} {label}: the state leaves are not half of "
                                         "d_inner")
                if c["collectives"].get("gather_channels") != [calls, nbytes]:
                    raise AssertionError(f"rank {r} {label}: gather_channels not as reckoned")
                if c["launches"]["linear_scan"] <= 0:
                    raise AssertionError(f"rank {r} {label}: linear_scan launched no time")
                continue
            st = c["stats"]
            layers = sum(k == "attn" for k in kinds)
            paged = "paged" in kw
            ps = kw["paged"]["page_size"] if paged else 0
            whole = _parked_whole(cfg, kw, st)
            if paged:
                on_card = not any(x % n == 0 for x in (ps, hkv, st["n_pages"] + 1))
                want = 0 if on_card else whole // n
            else:
                on_card, want = False, (whole // n if st["capacity"] % n == 0 else whole)
            meta = (M.SV.init_paged_cache(cfg, b, st["n_pages"], ps, "meta") if paged else
                    M.SV.init_cache(cfg, b, st["capacity"], "meta"))
            device, host = M.SV.rank_cache_bytes(cfg, dp, sp, meta, kw["n_host_chunks"])
            print(f"    pinned reckoned {want} B (the whole tier {whole} B), the dry-run's "
                  f"host_cache_bytes {host} B; the engine's host KV {st['host_kv_bytes']} B")
            if c["pinned"] != want or st["host_kv_bytes"] != want or host != want:
                raise AssertionError(f"rank {r} {label}: pinned bytes not as reckoned")
            if on_card:  # the whole pool on the card: its k and v and pkpos
                pool = (st["n_pages"] + 1) * ps * layers * (2 * hkv * dh * 4 + 4)
                print(f"    the pool on the card {c['pool_on_card']} B (reckoned {pool}, the "
                      f"dry-run's cache_bytes {device}); warned {len(c['warned'])} time(s): "
                      f"{c['warned'][:1]}")
                if c["pool_on_card"] != pool or device != pool or len(c["warned"]) != 1:
                    raise AssertionError(f"rank {r} {label}: the pool is not on the card whole, "
                                         "or the warning was not given once")
            if sp > 1 and hkv % sp and (not paged or ps % sp == 0):  # positions over model
                merged = [layers * (n_chunk + n_dec), layers * (n_chunk * b * cp + n_dec * b)
                          * cfg.num_heads * (cfg.head_dim + 2) * 4]
                print(f"    gather_state reckoned {merged}")
                if c["collectives"].get("gather_state") != merged:
                    raise AssertionError(f"rank {r} {label}: gather_state not as reckoned")
            if dp == 1:
                continue
            rows = b // dp if b % dp == 0 else b  # a rank's rows
            if paged:  # every row's live pages, the rank's in-page share of each
                sh = c["shares"]
                wants = {"gather_parked": [sh["calls"],
                                           2 * b * sh["live"] * (ps // dp) * hkv * dh * 4]}
            elif want < whole:  # one slot: a live slab's share, each layer
                slabs, q = st["host_kv_slabs"], st["capacity"] // kw["n_host_chunks"] // dp
                wants = {"gather_parked": [slabs, slabs * 2 * b * q * hkv * dh * 4]}
            else:  # the whole leaf: every rank's rows' new keys, a layer and step
                wants = {"gather_written": [layers * (n_chunk + n_dec), layers * (
                    n_chunk * rows * cp + n_dec * rows) * (2 * hkv * dh * 4 + 4)]}
            print(f"    reckoned {wants}")
            for k, v in wants.items():
                if c["collectives"].get(k) != v or v[0] <= 0:
                    raise AssertionError(f"rank {r} {label}: {k} not as reckoned")
        out[label] = ranks[0][label]["launches"]
    return out


def _replica_tier(torch, M, card, cfg, params):
    """(b): tests/test_faults.py's seeded crash at full depth: two one-rank
    paged replicas (sharing the weights), two rounds of the four sessions,
    the first session's home replica dying on its second dispatch, a
    shared store; against the no-fault run of two fresh replicas."""
    import tempfile

    from repro_torch.launch import faults as FLT
    from repro_torch.launch import kvstore as KVS
    import numpy as np

    from repro_torch.launch import router as RT

    rng = np.random.default_rng(0)
    shared = [int(t) for t in rng.integers(0, cfg.vocab_size, 8)]
    prompts = [shared + [int(t) for t in rng.integers(0, cfg.vocab_size, 8)] for _ in range(4)]
    sessions = [f"tenant-{s}" for s in range(4)]

    def replicas():
        return [M.PG.PagedServeEngine(cfg, params, **FAULT_ENGINE) for _ in range(2)]

    t0 = time.perf_counter()
    ref_rt = RT.ReplicaRouter(replicas(), warn=lambda m: None)
    ref = [ref_rt.generate(prompts, sessions=sessions) for _ in range(2)]
    t_ref = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        engines = replicas()
        rt = RT.ReplicaRouter(engines, max_retries=1, kv_store=KVS.SharedKVStore(tmp),
                              warn=lambda m: None)
        victim = rt.home_of(prompts[0], sessions[0])
        rt.replicas[victim] = FLT.FaultyReplica(engines[victim], [FLT.Fault("raise", 1)],
                                                name=f"replica{victim}")
        t0 = time.perf_counter()
        got = [rt.generate(prompts, sessions=sessions) for _ in range(2)]
        t_got = time.perf_counter() - t0
    fo = rt.last_stats["failover"]
    print(f"(b) 2 replicas of 1 x 1 (full depth, fp32), 4 sessions x 2 rounds, replica {victim} "
          f"dying on its 2nd dispatch, a shared store: {fo['deaths']} death, "
          f"{fo['retries']} retries, {fo['rehomed_requests']} requests re-homed "
          f"({fo['rehomed_sessions']} sessions), {fo['recovered_pages']} pages restored, "
          f"{fo['recovered_prefix_tokens']} prefix tokens recovered; {t_got * 1e3:.1f} ms "
          f"against the no-fault run's {t_ref * 1e3:.1f} [{card}]")
    if got != ref:
        raise AssertionError(f"the failover run's tokens {got} != the no-fault run's {ref}")
    if not (fo["deaths"] == 1 and fo["rehomed_requests"] > 0 and fo["recovered_pages"] > 0
            and fo["recovered_prefix_tokens"] > 0):
        raise AssertionError(f"the failover did not recover through the store: {fo}")
    print("  every request got the no-fault tokens")
    return {"ms": t_got * 1e3, "no_fault_ms": t_ref * 1e3, **fo}


def _run_cli(argv, tmp):
    """Start the serve CLI with ``argv`` in ``tmp`` (its own session)."""
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve", *argv],
                            env=dict(os.environ, PYTHONPATH=str(SRC)), cwd=tmp,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)


def _cli_output(proc, label):
    """(stdout, seconds to its end) of a ``_run_cli`` process; raises if it
    outlives MESH_CLI_S or exits with another code than 0."""
    t0 = time.perf_counter()
    try:
        out, err = proc.communicate(timeout=MESH_CLI_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"the {label} CLI did not end within {MESH_CLI_S} s:\n{err[-3000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    for line in out.splitlines():
        print(f"  {label} | " + line)
    if proc.returncode != 0:
        raise AssertionError(f"the {label} CLI exited with {proc.returncode}:\n{err[-3000:]}")
    return out, time.perf_counter() - t0


def _mesh_cli(M, card):
    """(c): the serve CLI, MESH_CLI_REPLICAS replicas of 1 x MESH_RANKS
    (gloo ranks sharing the card), --paged, a shared store, the replica
    most requests route to running them but answering past the dispatch
    timeout (no retry: it dies), against the same CLI with no fault on one
    replica (at one slot a request's tokens are the same on any replica),
    both at once: the clean run's tokens (the sha256 each prints), one death and
    one timeout, the victim's requests re-homed, its pages saved and
    restored into the survivors through the proxies, and prefix tokens of
    the re-homed requests read from them (prompts of their own: a hit is a
    restored page, whose bytes the tokens then check: MESH_CLI_SLOTS)."""
    import tempfile

    from repro_torch.launch import router as RT

    n_req, plen, gen = MESH_CLI
    cfg = M.cfg_mod.get_config("llama3.2-1b", num_layers=MESH_CLI_LAYERS)
    prompts, _ = M.CLI.engine_prompts(cfg, n_req, plen)
    homes = [RT.ReplicaRouter([None] * MESH_CLI_REPLICAS).home_of(p) for p in prompts]
    victim = max(range(MESH_CLI_REPLICAS), key=homes.count)
    moved = homes.count(victim)
    argv = ["--arch", "llama3.2-1b", "--layers", str(MESH_CLI_LAYERS), "--engine", "--paged",
            "--mesh", f"1x{MESH_RANKS}", "--dist-backend", "gloo", "--requests", str(n_req), "--batch", str(MESH_CLI_SLOTS),
            "--prompt-len", str(plen), "--gen", str(gen), "--prefill-chunk", str(MESH_CLI_CHUNK)]
    faulty = ["--replicas", str(MESH_CLI_REPLICAS), "--fault-plan",
              f"{victim}:hang@0~{MESH_CLI_HANG}", "--dispatch-timeout", str(MESH_CLI_HANG),
              "--retry", "0"]
    with tempfile.TemporaryDirectory() as tmp, tempfile.TemporaryDirectory() as clean_tmp:
        print("(c) python -m repro_torch.launch.serve " + " ".join(
            argv + faulty + ["--shared-kv-store", tmp]) + ", and without the fault on one "
            "replica")
        t0 = time.perf_counter()
        procs = [_run_cli(argv + faulty + ["--shared-kv-store", tmp], tmp),
                 _run_cli(argv + ["--replicas", "1", "--shared-kv-store", clean_tmp],
                          clean_tmp)]
        try:
            out, secs = _cli_output(procs[0], "fault")
            clean, _ = _cli_output(procs[1], "clean")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.communicate()
        both = time.perf_counter() - t0

    def line(text, key):
        return next((ln for ln in text.splitlines() if key in ln), "")

    fo = line(out, "failover:")
    found = re.search(r"(\d+) prefix tokens recovered via the shared store \((\d+) pages", fo)
    hit, pages = (int(found.group(1)), int(found.group(2))) if found else (0, 0)
    sha, clean_sha = line(out, "tokens sha256"), line(clean, "tokens sha256")
    if not (f"{n_req} requests: {n_req * gen} tokens" in line(out, "mesh replicas")
            and f"1 deaths (dead=[{victim}])" in fo and "1 timeouts" in fo
            and f"{moved} requests re-homed" in fo and pages > 0 and hit > 0
            and "clean run" in line(clean, "failover:")):
        raise AssertionError(f"the CLI's run is not as reckoned ({n_req * gen} tokens, replica "
                             f"{victim} dead, {moved} requests re-homed, its pages restored "
                             f"through the store and read: prefix tokens recovered > 0)")
    if not sha or sha.split()[2] != clean_sha.split()[2]:
        raise AssertionError(f"the failover run's tokens differ from the clean run's: {sha!r} "
                             f"against {clean_sha!r}")
    print(f"  the CLI ran {secs:.1f} s (its ranks' start-up and the {MESH_CLI_HANG} s hang "
          f"included; both runs {both:.1f} s): the clean run's tokens, replica {victim} dead "
          f"past the timeout, {moved} requests re-homed, {pages} pages restored into the "
          f"survivors through the proxies, {hit} prefix tokens of the re-homed requests "
          f"read from them [{card}]")
    return {"s": secs, "both_s": both, "victim": victim, "rehomed": moved, "pages": pages,
            "recovered_prefix_tokens": hit}


def phase_serve_mesh(torch, M, card, base):
    """Serving over a mesh and the replica tier:
      (a) phase_paged's (b) workload (8 requests of 512 shared + 66–251
          tokens) on a 1 x MESH_RANKS serve mesh of gloo ranks sharing the
          card, llama3.2-1b at full depth in fp32, kv heads over model: the
          one-rank tokens; a rank's pool the reckoned (n_pages + 1) x its
          page (its heads' k and v, the whole pkpos: half of one rank's
          pool in k and v); its peak within 10% of the weights, the pool
          and a chunk step's transient; gather_heads one a layer a step at
          its reckoned bytes, no other serve collective; the first segment
          under set_sync_debug_mode("error") (gloo's staging exempt);
          flash_fwd 0 launches; the gloo all-gathers' share of the run;
          then the prefix store saved on the mesh (gather_pages at its
          reckoned calls and bytes, rank 0 writing whole pages) restored
          into a one-rank engine: the tokens, every admission a hit;
      (a') in the same spawn, ``_mesh_cases``: the recurrent archs and
          host-streamed KV on 1 x MESH_RANKS (a pool kept on the card
          too) and on MESH_RANKS x 1, held by ``_check_mesh_cases`` to
          one rank's runs after (b);
      (b) the replica tier (``_replica_tier``), once the ranks are done;
      (c) the serve CLI (``_mesh_cli``).
    Returns rank 0's launches of (a) and of each (a') case."""
    import multiprocessing
    import tempfile

    cfg, params = base["cfg"], base["params"]
    n_req, plen, gen = ENGINE_LLAMA
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    inputs = {"prompts": base["prompts"], "bucket": plen + SHARED_PREFIX, "gen": gen}
    with tempfile.TemporaryDirectory() as tmp:
        Path(tmp, "inputs.json").write_text(json.dumps(inputs))
        procs = [ctx.Process(target=_mesh_rank, args=(r, MESH_RANKS, tmp, time.time()))
                 for r in range(MESH_RANKS)]
        for p in procs:
            p.start()
        _join_ranks(procs, min(MESH_JOIN_S, BUDGET_S - (time.monotonic() - STARTED)), tmp)
        secs = time.perf_counter() - t0
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(MESH_RANKS)]
        fresh = M.CLI.make_engine(cfg, params, slots=ENGINE_SLOTS, bucket=plen + SHARED_PREFIX,
                                  gen=gen, segment=ENGINE_SEGMENT, prefill_chunk=ENGINE_CHUNK,
                                  paged=dict(page_size=PAGE_SIZE, spill_pages=SPILL_PAGES))
        restored = fresh.restore_kv_store(str(Path(tmp, "mesh_kv.npz")))
    d = M.CLI.run_engine(cfg, params, base["prompts"], engine=fresh)
    hits = [e["args"]["prefix_hit"] for e in fresh.telemetry.tracer.events
            if e["kind"] == "request.admit"]
    tier = _replica_tier(torch, M, card, cfg, params)
    del base["params"], params, fresh
    torch.cuda.empty_cache()
    one_page, page = _page_bytes(cfg), _mesh_page_bytes(cfg, MESH_RANKS)
    layers = cfg.num_layers
    print(f"(a) {n_req} requests of {SHARED_PREFIX} shared + {base['lens']} tokens on 1 x "
          f"{MESH_RANKS} (gloo ranks sharing the card, {cfg.num_kv_heads // MESH_RANKS} kv heads "
          f"a rank); the ranks took {secs:.1f} s alone on the card")
    for r, got in enumerate(ranks):
        n_pages, max_pages = got["n_pages"], got["max_pages"]
        want_pool = (n_pages + 1) * page
        want_peak = _mesh_peak_gib(cfg, n_pages, max_pages, MESH_RANKS)
        hb = ENGINE_SLOTS * (cfg.num_heads // MESH_RANKS) * cfg.head_dim * 4
        n_chunk, n_dec = got["steps"]["chunk"], got["steps"]["decode"]
        want_coll = {"gather_heads": [layers * (n_chunk + n_dec),
                                      layers * hb * (n_chunk * ENGINE_CHUNK + n_dec)]}
        st = got["stats"]
        sm = got["summary"] or {}
        print(f"  rank {r}: {sum(len(o) for o in got['tokens'])} tokens in {got['ms']:.1f} ms, "
              f"{st['dispatches']} dispatches ({n_chunk} chunk and {n_dec} decode steps), "
              f"steady p50 {sm.get('steady_p50_ms', float('nan')):.2f} ms, refill-active p95 "
              f"{sm.get('refill_p95_ms', float('nan')):.2f} ms; prefix hits "
              f"{st['prefix_hit_tokens']}/{st['prompt_tokens']}; pool {got['pool']} B "
              f"(reckoned {want_pool} = {n_pages + 1} x {page}; one rank's {(n_pages + 1) * one_page}"
              f"); peak {got['peak'] / 2**30:.3f} GiB (reckoned {want_peak:.3f}); collectives "
              f"{got['collectives']} (reckoned {want_coll}); launches {got['launches']}; spawn to "
              f"weights on the card {got['start-up']:.1f} s [{card}]")
        if got["tokens"] != base["tokens"]:
            raise AssertionError(f"rank {r}: the 1 x {MESH_RANKS} tokens differ from one rank's")
        if got["pool"] != want_pool or 2 * (page - layers * PAGE_SIZE * 4) != (
                one_page - layers * PAGE_SIZE * 4):
            raise AssertionError(f"rank {r}: the pool is not the reckoned half")
        if not 0.9 <= got["peak"] / 2**30 / want_peak <= 1.1:
            raise AssertionError(f"rank {r}: peak not within 10% of the reckoned {want_peak:.3f}")
        if got["collectives"] != want_coll:
            raise AssertionError(f"rank {r}: collectives {got['collectives']} != {want_coll}")
        if got["checked"] != 1 or any(got["launches"].values()):
            raise AssertionError(f"rank {r}: the sync check did not run or a kernel launched")
        g = got["gathers"]
        print(f"  rank {r}: the gloo all-gathers {g['calls']} calls, {g['s'] * 1e3:.1f} ms of the "
              f"run's {got['ms']:.1f} ms ({g['s'] * 1e3 / got['ms']:.1%}), each timed between two "
              f"device synchronises")
        sv = got["store"]
        slice_b = sv["saved"] * layers * PAGE_SIZE * (cfg.num_kv_heads // MESH_RANKS) * (
            cfg.head_dim * 4)
        want_pages = {"gather_pages": [2, 2 * slice_b]}  # pk and pv; pkpos is whole
        print(f"  rank {r}: the store saved on the mesh: {sv['saved']} pages in {sv['ms']:.1f} ms,"
              f" collectives {sv['collectives']} (reckoned {want_pages}) [{card}]")
        if g["calls"] != got["collectives"]["gather_heads"][0]:
            raise AssertionError(f"rank {r}: {g['calls']} all-gathers timed, not every gather")
        if sv["collectives"] != want_pages or sv["saved"] != ranks[0]["store"]["saved"]:
            raise AssertionError(f"rank {r}: the mesh's store save is not as reckoned")
    print(f"  both ranks: phase_paged (b)'s tokens; the first segment ran under "
          f"set_sync_debug_mode('error') (no host read but gloo's own staging); flash_fwd 0")
    _paged_line("(a) the mesh's store on one rank", d, card)
    print(f"  restored {restored} of the mesh's {ranks[0]['store']['saved']} pages; prefix hit at "
          f"each admission {hits}")
    if d["outs"] != base["tokens"] or restored != ranks[0]["store"]["saved"] or (
            min(hits) < SHARED_PREFIX):
        raise AssertionError("the store saved on the mesh does not serve (b)'s prefix and tokens "
                             "on one rank")
    del d
    t0 = time.perf_counter()
    archs = ", ".join(f"{a} ({n} layers)" for a, n in MESH_RECURRENT)
    print(f"(a') after (a), in the same spawn: {archs} at full width over "
          f"{ENGINE_RECURRENT[0]} requests, d_inner over model; llama3.2-1b "
          f"({MESH_HOST_LAYERS} layers) on (a)'s prompts with host-streamed KV, the pool parked "
          "and the dense engine's at one kv head (positions over model), a pool no dim of which "
          f"{MESH_RANKS} divides (kept on the card); on {MESH_RANKS} x 1 (8 kv heads) the pool "
          "parked by "
          "in-page positions over data, one slot's dense KV by a slab's positions, and a dense "
          "leaf parked whole")
    cases = _check_mesh_cases(torch, M, card, ranks, inputs)
    print(f"  one rank's runs and the checks {time.perf_counter() - t0:.1f} s")
    cli = _mesh_cli(M, card)
    return {"launches": ranks[0]["launches"], "cases": cases, "tier": tier, "cli": cli,
            "ranks_s": secs, "rank0": {k: ranks[0][k] for k in ("ms", "summary", "peak", "pool",
                                                                "collectives", "start-up",
                                                                "gathers", "store")}}


def phase_engine_recurrent(torch, M, card, arch):
    """``arch`` (recurrentgemma-9b, 38 layers; falcon-mamba-7b, 64) at full
    width and depth in fp32 weights through run_engine: ENGINE_RECURRENT's
    6 requests (no length a multiple of the chunk, so every prompt ends in
    a partial chunk: the state-at-length gather) over 4 slots, 8 new
    tokens.  Tokens equal solo generation; at the chunk step that ends
    each prompt, its logits and its slot's every recurrent state leaf
    (conv, h or ssm) are the solo prefill's within FP32_LOGIT_RTOL; the
    scan kernel launched."""
    dev = torch.device("cuda")
    cfg = _fp32_cfg(M, arch)
    params = _init_fp32(torch, M, cfg, dev)
    n_req, plen, gen = ENGINE_RECURRENT
    prompts, lens = M.CLI.engine_prompts(cfg, n_req, plen)
    if any(n % ENGINE_CHUNK == 0 for n in lens):
        raise AssertionError(f"prompt lengths {lens.tolist()}: one ends on a whole chunk")
    kw = dict(slots=ENGINE_SLOTS, bucket=plen, gen=gen, segment=ENGINE_SEGMENT,
              prefill_chunk=ENGINE_CHUNK)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(M.K, M.SK)
    with _engine_probe(torch, M, states=True) as rec:
        run = M.CLI.run_engine(cfg, params, prompts, **kw)
    counts = _counts(M.K, M.SK)
    peak = torch.cuda.max_memory_allocated() / 2**30
    S = run["engine"].last_stats["capacity"]
    want_peak, _ = _serve_peak_gib(torch, cfg, ENGINE_SLOTS, S, ENGINE_CHUNK)
    print(f"workload: {n_req} requests of {sorted(lens.tolist())} tokens, {gen} new each")
    _engine_line("fused", run, card)
    print(f"  launches {counts}; peak {peak:.2f} GiB (reckoned {want_peak:.2f} + the state "
          f"copies this check keeps) [{card}]")
    if counts["linear_scan"] <= 0:
        raise AssertionError(f"the {arch} engine launched linear_scan no time")
    ends = _prompt_ends(rec, run["engine"], prompts, ENGINE_SEGMENT, ENGINE_CHUNK)
    worst_logit, worst_state = 0.0, {}
    for r, p in enumerate(prompts):
        toks, logits, st = _solo(torch, M, cfg, params, p, gen, dev, states=True)
        if run["outs"][r] != toks:
            raise AssertionError(f"request {r}: engine {run['outs'][r]} != solo {toks}")
        k, slot = ends[r]
        worst_logit = max(worst_logit, _rel_max(rec["logits"][k][slot], logits))
        for name, leaf in rec["states"][k].items():
            ax = 0 if name.startswith("tail/") else 1
            rel = _rel_max(leaf.select(ax, slot), st[name].select(ax, 0))
            kind = name.rsplit("/", 1)[1]
            worst_state[kind] = max(worst_state.get(kind, 0.0), rel)
    del rec, run
    print(f"tokens of all {n_req} requests equal their solo generation; at each prompt's last "
          f"chunk, max |diff| / max |value| against the solo prefill: logits {worst_logit:.3e}, "
          + ", ".join(f"{k} {v:.3e}" for k, v in sorted(worst_state.items()))
          + f" (tolerance {FP32_LOGIT_RTOL})")
    if not max(worst_logit, *worst_state.values()) <= FP32_LOGIT_RTOL:
        raise AssertionError("the state at the prompt's length disagrees with the solo prefill")
    del params
    torch.cuda.empty_cache()
    return counts


def _h2d_gbps(torch, nbytes=1 << 30, reps=3) -> float:
    """The host link's rate (GB/s) from pinned memory, CUDA events around
    ``reps`` copies of ``nbytes``."""
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    dst.copy_(src, non_blocking=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        dst.copy_(src, non_blocking=True)
    end.record()
    end.synchronize()
    return reps * nbytes / (start.elapsed_time(end) / 1e3) / 1e9


def phase_host_kv(torch, M, card):
    """FPDT host-streamed decode KV: llama3.2-1b at full width and depth in
    fp32 weights, b2, cache capacity 65536, a 32768-token prompt prefilled
    by FPDT (4096-token chunks), then HOST_KV's 8 greedy decode steps with
    the full-attention k and v in pinned host memory, streamed in 16 slabs
    of 4096 positions, against on-device decode of the same cache: the
    same tokens, logits within FP32_LOGIT_RTOL, slabs 0..8 merged a layer
    and step (9 of 16; the rest skipped), the bytes fetched as reckoned, no
    k or v byte resident on the card; ms a step of both beside the host
    link's rate."""
    dev = torch.device("cuda")
    b, S, s, n, steps = HOST_KV
    cfg = _fp32_cfg(M, "llama3.2-1b", fpdt_chunks=s // LONG_CHUNK, mlp_chunks=16)
    params = _init_fp32(torch, M, cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    gbps = _h2d_gbps(torch)
    cs = S // n
    # step t decodes position s + t: slabs 0 .. (s + t) // cs are live
    live = [(s + t) // cs + 1 for t in range(steps)]
    n_full = sum(k == "attn" for k in cfg.layer_kinds())
    slab = b * cs * cfg.num_kv_heads * cfg.head_dim * 4
    step_bytes = max(live) * n_full * 2 * slab
    print(f"host link (pinned -> card, CUDA events): {gbps:.2f} GB/s; a streamed step fetches "
          f"{max(live)} slabs x {n_full} layers x 2 (k, v) x {slab} B = {step_bytes / 1e9:.3f} "
          f"GB, reckoned {step_bytes / gbps / 1e6:.1f} ms over the link [{card}]")

    _reset_counts(M.K, M.SK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = M.SV.prefill_step(cfg, None, params, {"tokens": tokens}, max_len=S)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts = _counts(M.K, M.SK)
    want = _prefill_launches(M, cfg, s)
    print(f"prefill b{b} {s} tokens (u={cfg.fpdt_chunks}) into a {S}-position cache: "
          f"{prefill_s:.2f} s, launches {counts} (flash_fwd reckoned {want}) [{card}]")
    if counts["flash_fwd"] != want:
        raise AssertionError("the prefill's flash_fwd launches are not as reckoned")
    tok0 = torch.argmax(logits[:, : cfg.vocab_size], dim=-1).to(torch.int32)[:, None]
    # the same cache with its full-attention k and v in pinned host memory
    host = {key: {name: leaf.clone() if name == "kpos" else leaf for name, leaf in bc.items()}
            for key, bc in cache.items()}
    t0 = time.perf_counter()
    M.SV.offload_kv(cfg, host, dev)
    torch.cuda.synchronize()
    kv = [bc[name] for bc in M.SV._full_attn_blocks(cfg, host) for name in ("k", "v")]
    pinned = sum(t.numel() * t.element_size() for t in kv)
    resident = sum(t.numel() * t.element_size() for t in kv if t.device.type == "cuda")
    print(f"offload_kv: {len(kv)} k and v tensors, {pinned / 2**30:.3f} GiB pinned in "
          f"{time.perf_counter() - t0:.2f} s, {resident} B of them on the card")
    if resident or not all(t.is_pinned() for t in kv):
        raise AssertionError("the host-streamed cache's k and v are not all in pinned memory")

    policy = M.PL.host_offload(dev)
    want_peak, _ = _serve_peak_gib(torch, cfg, b, S, 1, host_kv=True)
    print(f"reckoned peak of the streamed decode {want_peak:.2f} GiB (on-device: "
          f"{_serve_peak_gib(torch, cfg, b, S, 1)[0]:.2f})")
    runs, caches = {}, {"on-device": cache, "host-streamed": host}
    del cache, host
    for label, nh in (("on-device", 0), ("host-streamed", n)):
        c = caches.pop(label)
        M.DL.decode_tokens(cfg, None, params, c, tok0, s, num_steps=1, n_host_chunks=nh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        policy.reset_counts()
        M.SV.reset_host_kv()
        t0 = time.perf_counter()
        toks, aux = M.DL.decode_tokens(cfg, None, params, c, tok0, s, num_steps=steps,
                                       n_host_chunks=nh, collect_logits=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        runs[label] = (toks, aux["logits"], dict(M.SV.host_kv), policy.to_device_bytes,
                       policy.to_host_bytes)
        print(f"  decode {label}: {ms:.2f} ms a step, peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
              f" GiB, slabs {M.SV.host_kv}, {policy.to_device_bytes / steps / 1e9:.3f} GB a "
              f"step to the card, {policy.to_host_bytes} B written back [{card}]")
        del c, aux  # the on-device cache goes before the streamed run
        torch.cuda.empty_cache()
    (t_dev, l_dev, _, _, _), (t_host, l_host, slabs, fetched, _) = (runs["on-device"],
                                                                     runs["host-streamed"])
    rel = _rel_max(l_host, l_dev)
    print(f"host-streamed vs on-device: tokens {t_host.tolist()} "
          f"{'==' if torch.equal(t_host, t_dev) else '!='} {t_dev.tolist()}; logits max |diff| "
          f"/ max |logit| = {rel:.3e} (tolerance {FP32_LOGIT_RTOL})")
    want_slabs = {"fetched": n_full * sum(live), "skipped": n_full * (steps * n - sum(live))}
    if slabs != want_slabs:
        raise AssertionError(f"slabs {slabs}, reckoned {want_slabs}")
    if fetched != n_full * sum(live) * 2 * slab:
        raise AssertionError(f"{fetched} B fetched, reckoned {n_full * sum(live) * 2 * slab}")
    if not torch.equal(t_host, t_dev) or not rel <= FP32_LOGIT_RTOL:
        raise AssertionError("host-streamed decode disagrees with on-device decode")
    del params
    torch.cuda.empty_cache()
    return counts


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
# trainings are cut in depth and steps (one step each since the serve
# engines' phases needed the room) and keep every check.  llama3.2-1b runs 4 layers here and
# on 2 x 1 (8 gave the script 770-800 s of its 800 s aim, the gloo steps
# spreading 40 s between calls; at 2 the first batch's bf16 gradient of the
# final norm read 5.39e-4 from one rank's, past FPDT_GRAD_RTOL).
DIST_LLAMA_LAYERS = 4
DIST_STEPS = (("ulysses", 1), ("cp", 1))
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
# local_attn) cycle is 2.60 B parameters, 29 GiB of state; falcon-mamba-7b
# at 2 layers (4, 0.95 B and 11 GiB, until the serve mesh's phase 5d needed
# the room).  Their fp32-weight checks run at the same depth.
DIST_RECURRENT = (("recurrentgemma-9b", 3, 1), ("falcon-mamba-7b", 2, 1))
# granite-moe-1b-a400m trained on 1 x DIST_RANKS the same way (ulysses: 8 q
# / 4 kv heads a rank), cut to 2 of its 24 layers (6, then 3, until the serve
# mesh's phase 5d needed the room): each MoE chunk (mlp_chunks
# 2u) is one rank's 1024-token span, so every group is local and no counts
# are gathered; full depth would add ~2 GB of gloo gradient all-reduce a
# step and nothing this phase does not already show.
# It runs expert-parallel (its 32 experts split over the two model ranks):
# every layer moves its chunks' [e, G, cap, d] slots through gloo
# (``dryrun.slot_collectives``: 11.9 GB a bf16 step at 6 layers, twice that for
# the fp32 first batch), so it takes one step (with two, the script read
# 848 s on an H100 80GB HBM3 at 700 W, past its 800 s aim).  The step's
# seconds predicted before the first run on the card, printed beside the
# reading, not gated.
DIST_MOE = (("granite-moe-1b-a400m", 2, 1),)
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
    c, n = M.D.fpdt_collectives(cfg, "ulysses", 1, 1, DIST_NCCL_SEQ, 1, 2)
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
    want.update(M.D.slot_collectives(cfg, par.dp, par.sp, 1, MAVERICK_SEQ, 1, False))
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
            c, nb = M.D.mixer_collectives(cfg, "rglru" if mixer == "rglru" else "ssm", par.sp, 1,
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
            c, nb = M.D.fpdt_collectives(cfg, kind, par.sp, 1, DIST_SEQ, 1, x_bytes)
            c0, nb0 = M.D.fpdt_collectives(dataclasses.replace(cfg, fpdt_offload=False), kind,
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
    pairs = M.D.live_off_diagonal(cfg, DIST_SEQ, 0) + u
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
    reckoned = M.D.reckoned_peak_gib(cfg, par.sp, seq, par.dp, batch)
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
    c, nb = M.D.train_collectives(cfg, kind, par.dp, par.sp, batch // par.dp, seq)
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
    c, nb = M.D.train_collectives(cfg, M.T.attn_kind(cfg, zpar), zpar.dp, zpar.sp,
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
    from repro_torch.launch.dryrun import live_pairs

    live = live_pairs(sq, sk, q_offset, k_offset, window)
    flops = 4 * d * live * b * hq
    nbytes = in_bytes * (b * hq * sq * d + 2 * b * hkv * sk * d) + 4 * (b * hq * sq * (d + 2))
    if carry:
        nbytes += 4 * (b * hq * sq * (d + 2))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _bwd_bound(which, b, hq, hkv, sq, sk, d, in_bytes, q_offset, k_offset, window=0):
    """Least time of flash_bwd_dq ("dq") or flash_bwd_dkv ("dkv") on the card:
    (ms, "bytes"|"operations").  Operations: 6 d (dq) or 8 d (dkv) per live
    causal pair and q-head; bytes: q, k, v, do, L, delta read once, the
    outputs written once."""
    from repro_torch.launch.dryrun import live_pairs

    live = live_pairs(sq, sk, q_offset, k_offset, window)
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

    from repro_torch.launch.dryrun import live_pairs

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
        live = live_pairs(sq, sk, qo, ko, window)
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
    from repro_torch.launch import dryrun as D
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
    from repro_torch.runtime import decode_loop as DL
    from repro_torch.runtime import paged as PG
    from repro_torch.runtime import placement as PL
    from repro_torch.runtime import train_loop as TL

    return types.SimpleNamespace(K=K, SK=SK, cfg_mod=cfg_mod, T=T, F=F, TR=TR, TL=TL, PL=PL, DL=DL,
                                 DP=DP, TRAIN=TRAIN, CLI=CLI, SV=SV, MB=MB, R=R, L=L, P=P,
                                 MESH=MESH, MOE=MOE, SH=SH, CKPT=CKPT, C=C, PG=PG, D=D)


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
    phase("dry-run sweep (launch/dryrun.py --all --mesh both)", phase_dryrun, M, card)
    errs = phase("kernel vs plain", phase_kernel, torch, K, R, SoftmaxState, finalize)
    bwd = phase("backward kernels vs plain", phase_kernel_bwd, torch, K, R, F, SoftmaxState, lse,
                finalize)
    scan = phase("linear_scan vs plain", phase_scan, torch, SK, SR, SO)
    serve = {arch: phase(f"serve {arch}", phase_serve, torch, M, arch, card)
             for arch in ("llama3.2-1b", "recurrentgemma-9b", "falcon-mamba-7b", GRANITE,
                          *FRONTEND_ARCHS)}
    engines = phase("engines llama3.2-1b (fused, blocking)", phase_engine, torch, M, card)
    paged = phase("paged engines llama3.2-1b", phase_paged, torch, M, card,
                  engines.pop("paged_inputs"))
    mesh = phase("serve mesh llama3.2-1b (1 x 2 ranks, the replica tier, the CLI)",
                 phase_serve_mesh, torch, M, card, paged.pop("mesh_inputs"))
    serve_paths = {"engine llama3.2-1b": engines["engine"],
                   "blocking llama3.2-1b": engines["blocking"],
                   "paged llama3.2-1b": paged["paged"], "slo llama3.2-1b": paged["slo"],
                   "paged-host llama3.2-1b": paged["paged-host"],
                   "mesh 1x2 llama3.2-1b": mesh["launches"],
                   **{f"mesh {'2x1' if label.endswith('-data') else '1x2'} {label}"
                      + ("" if label in dict(MESH_RECURRENT) else " llama3.2-1b"): counts
                      for label, counts in mesh["cases"].items()},
                   **{f"engine {arch}": phase(f"engine {arch}", phase_engine_recurrent, torch,
                                              M, card, arch)
                      for arch in ("recurrentgemma-9b", "falcon-mamba-7b")},
                   "host-kv llama3.2-1b": phase("host-streamed decode KV llama3.2-1b",
                                                phase_host_kv, torch, M, card)}
    for path, kname in (("blocking llama3.2-1b", "flash_fwd"), ("host-kv llama3.2-1b", "flash_fwd"),
                        ("engine recurrentgemma-9b", "linear_scan"),
                        ("engine falcon-mamba-7b", "linear_scan"),
                        ("mesh 1x2 recurrentgemma-9b", "linear_scan"),
                        ("mesh 1x2 falcon-mamba-7b", "linear_scan")):
        if serve_paths[path][kname] <= 0:
            fail(f"the {path} path launched {kname} no time")
    train_ref = {}
    train = phase("train llama3.2-1b", phase_train, torch, M, card, train_ref)
    cli = phase("train CLI llama3.2-1b --compress-grads --trace-out --metrics-out",
                phase_train_cli, torch, M, card, train_ref)
    hybrid = phase("train recurrentgemma-9b (8 layers)", phase_train_hybrid, torch, M, card)
    gpt = phase("train gpt-2.7b", phase_train_gpt, torch, M, card)
    falcon = phase(f"train falcon-mamba-7b ({FALCON_TRAIN_LAYERS} layers)", phase_train_falcon,
                   torch, M, card)
    phase("granite MoE layer under set_sync_debug_mode('error')", phase_moe_layer, torch, M, card)
    granite = phase(f"train {GRANITE}", phase_train_granite, torch, M, card)
    frontends = {arch: phase(f"train {arch}", phase_train_frontend, torch, M, card, arch)
                 for arch in FRONTEND_ARCHS}
    qwen = phase(f"train {QWEN} ({QWEN_LAYERS} layers)", phase_train_qwen, torch, M, card)
    examples = phase("examples", phase_examples, torch, M, card, R, SoftmaxState, finalize, lse)
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
    qs_layout = examples["layout"]
    entries = [
        ("flash_fwd", flash + "flash_fwd.cu", replaces + "134",
         max(*errs.values(), *(p["fwd"] for p in pairs.values())),
         {"max_err_fp32": errs["float32"], "max_err_bf16": errs["bfloat16"],
          **{f"max_err_{m}_pairs": p["fwd"] for m, p in pairs.items()},
          **{f"max_acc_rel_err_{m}_pairs": p["fwd_acc"] for m, p in pairs.items()},
          **{f"tc_rel_err_acc_{m}_pairs": p["fwd_tc"]["acc"] for m, p in pairs.items()},
          **{f"max_err_dist_pairs_{k}": w["fwd"] for k, w in bwd["dist"].items()},
          **{f"max_err_{a}_layout_pair": w["fwd"] for a, w in layouts.items()},
          **{f"max_err_quickstart_layout_{k}": w["fwd"] for k, w in qs_layout.items()},
          **{f"tc_rel_err_acc_{a}_layout_pair": w["fwd_tc"] for a, w in layouts.items()},
          "library": timing["flash_fwd"]["library"],
          **at("flash_fwd_gpt_diagonal", "gpt_diagonal_pair"),
          **at("flash_fwd_train", "llama_train_pair"), **at("flash_fwd_hybrid", "hybrid_pair"),
          **at("flash_fwd_serve", "serve")}),
        ("flash_bwd_dq", flash + "flash_bwd.cu", replaces + "273", bwd["abs"]["dq"],
         {"max_rel_err": bwd["rel"]["dq"],
          **{f"max_rel_err_quickstart_layout_{k}": w["dq"] for k, w in qs_layout.items()},
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
          **{f"max_rel_err_{p}_quickstart_layout_{k}": w[p] for k, w in qs_layout.items()
             for p in ("dk", "dv")},
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
                   **{path: counts[kname] for path, counts in serve_paths.items()},
                   "train llama3.2-1b": train[kname], "train llama3.2-1b compress": cli[kname],
                   "train recurrentgemma-9b": hybrid[kname],
                   "train gpt-2.7b": gpt[kname], "train falcon-mamba-7b": falcon[kname],
                   f"train {GRANITE}": granite[kname],
                   **{f"train {arch}": d[kname] for arch, d in frontends.items()},
                   f"train {QWEN}": qwen[kname],
                   **{f"example {label}": d[kname] for label, d in examples["launches"].items()},
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
