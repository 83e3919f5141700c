"""The benchmark's own arithmetic: the chip's peaks, model FLOPs, each
kernel call's least time, and the interval sums of a profiler trace.

Frozen copies, so that a change to the program cannot move the yardstick:
``model_flops`` and ``live_pairs`` of ``repro_torch/launch/dryrun.py``
(with the parameter count of ``repro_torch/configs::_count_params`` for
the dense and ssm families), ``call_bound`` and ``bwd_bound`` of
``chip_smoke.py::_bound`` / ``_bwd_bound``, and ``PROFILE_GROUPS``,
``group_of``, ``merged``, ``length`` and ``overlap`` of ``chip_smoke.py``'s
profiled step.  ``bench/tests`` holds each copy to its original.
"""
from __future__ import annotations

import functools

# NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES = 3.35e12


# ---------------------------------------------------------------------------
# model FLOPs
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def live_pairs(sq: int, sk: int, q_offset: int, k_offset: int, window: int = 0) -> int:
    """Causal (q, k) pairs these offsets leave live; with window > 0 only
    keys with qpos - kpos < window."""
    live = 0
    for r in range(sq):
        qpos = q_offset + r
        hi = min(sk - 1, qpos - k_offset)  # last key index the row sees
        lo = max(0, qpos - window + 1 - k_offset) if window > 0 else 0
        live += max(0, hi - lo + 1)
    return live


def num_params(m: dict) -> int:
    """Parameters of a dense (attention + MLP) or ssm (Mamba-1) model,
    ``m`` a configuration's ``model`` object; the embedding counted once
    if tied."""
    d, dff, layers = m["d_model"], m["d_ff"], m["num_layers"]
    total = 0
    if m["family"] == "ssm":
        di = m["expand"] * d
        ds, dtr = m["ssm_state"], m["dt_rank"] or -(-d // 16)
        per = (d * 2 * di + di * m["d_conv"] + di + di * (dtr + 2 * ds) + dtr * di + di
               + di * ds + di + di * d)
        total += layers * per
    elif m["family"] == "dense":
        q, kv = m["num_heads"] * m["head_dim"], m["num_kv_heads"] * m["head_dim"]
        per = d * q + 2 * d * kv + q * d + (q + 2 * kv if m.get("qkv_bias") else 0)
        per += (3 if m["mlp_act"] == "swiglu" else 2) * d * dff + 2 * d
        total += layers * per
    else:
        raise ValueError(f"no parameter count for family {m['family']!r}")
    total += m["vocab_size"] * d
    if not m.get("tie_embeddings"):
        total += m["vocab_size"] * d
    return total + d


def model_flops(m: dict, b: int, s: int) -> int:
    """Model FLOPs of one training step over b rows of s tokens: 6 N per
    token plus, in each attention layer, 12 d per live causal (q, k) pair
    and q-head (4 d forward, 8 d backward).  A recomputed operation is not
    counted; the selective scan's elementwise work is not counted."""
    attn = 0
    if m["family"] == "dense":
        attn = m["num_layers"] * 12 * m["head_dim"] * m["num_heads"] * live_pairs(s, s, 0, 0) * b
    return 6 * num_params(m) * b * s + attn


# ---------------------------------------------------------------------------
# a kernel call's least time
# ---------------------------------------------------------------------------


def _least(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least seconds: the larger of operations over the peak rate and
    bytes over the memory's rate."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)


def call_bound(b, hq, hkv, sq, sk, d, in_bytes, q_offset, k_offset, carry, window=0) -> float:
    """Least seconds of one ``flash_fwd`` call: 4 d operations per live
    causal (q, k) pair and q-head (q.k and p.v); q, k, v (and a carry) read
    once and (acc, m, l) written once."""
    live = live_pairs(sq, sk, q_offset, k_offset, window)
    flops = 4 * d * live * b * hq
    nbytes = in_bytes * (b * hq * sq * d + 2 * b * hkv * sk * d) + 4 * (b * hq * sq * (d + 2))
    if carry:
        nbytes += 4 * (b * hq * sq * (d + 2))
    return _least(flops, nbytes, PEAK_BF16_FLOPS if in_bytes == 2 else PEAK_FP32_FLOPS)


def bwd_bound(which, b, hq, hkv, sq, sk, d, in_bytes, q_offset, k_offset, window=0) -> float:
    """Least seconds of one ``flash_bwd_dq`` ("dq") or ``flash_bwd_dkv``
    ("dkv") call: 6 d (dq) or 8 d (dkv) operations per live causal pair and
    q-head; q, k, v, do, L, delta read once, the outputs written once."""
    live = live_pairs(sq, sk, q_offset, k_offset, window)
    flops = (6 if which == "dq" else 8) * d * live * b * hq
    nbytes = in_bytes * (b * hq * sq * d + 2 * b * hkv * sk * d) + 4 * b * hq * sq * (d + 2)
    nbytes += 4 * (b * hq * sq * d if which == "dq" else 2 * b * hkv * sk * d)
    return _least(flops, nbytes, PEAK_BF16_FLOPS if in_bytes == 2 else PEAK_FP32_FLOPS)


def scan_bound(n_el: int, a_bytes: int, b_bytes: int, h0_el: int) -> float:
    """Least seconds of one ``linear_scan`` call over n_el elements: a and
    b read once, h0 read once, h written once (fp32); one multiply and one
    add an element in fp32."""
    return _least(2 * n_el, n_el * (a_bytes + b_bytes + 4) + 4 * h0_el, PEAK_FP32_FLOPS)


def scan_bwd_bound(n_el: int, a_bytes: int, db_bytes: int, h0_el: int) -> float:
    """Least seconds of one ``linear_scan_bwd`` call over n_el elements: a,
    h and dout read once (h and dout fp32), da and db written once, h0 read
    and dh0 written once; a multiply-add and the da multiply an element."""
    return _least(3 * n_el, n_el * (a_bytes + 8 + a_bytes + db_bytes) + 8 * h0_el,
                  PEAK_FP32_FLOPS)


# ---------------------------------------------------------------------------
# a profiler trace
# ---------------------------------------------------------------------------

PROFILE_GROUPS = (  # first match wins; matched against the lower-cased kernel name
    ("flash_bwd_dkv", ("flash_bwd_dkv", "flash_bwd_round_do")),
    ("flash_bwd_dq", ("flash_bwd_dq",)),
    ("flash_fwd", ("flash_fwd",)),
    ("linear_scan", ("linear_scan_",)),
    ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
    ("copy", ("memcpy", "memset")),
)
GROUPS = tuple(g for g, _ in PROFILE_GROUPS) + ("other",)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in PROFILE_GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def merged(intervals):
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out = []
    for s0, e0 in sorted(intervals):
        if out and s0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e0)
        else:
            out.append([s0, e0])
    return out


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def overlap(a, b) -> float:
    """Length of the intersection of two merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def gaps(intervals, start, end):
    """The [s, e) stretches of [start, end) that no merged interval covers."""
    out, t = [], start
    for s0, e0 in intervals:
        if s0 > t:
            out.append((t, min(s0, end)))
        t = max(t, e0)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]
