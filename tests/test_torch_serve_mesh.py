"""Serving over a mesh: the port's sharded engines against the JAX
package's single-device engines, and the serve CLI's mesh path.

In this process JAX runs the cells of tests/distributed/check_serve_mesh.py
(``tests/_torch_dist.py::SERVE_CELLS``; reduced configs in fp32) on one
device: each engine's greedy tokens, the direct ``chunk_step`` and
``decode_step`` logits, and the paged cells' prefix store.  One spawn of 4
gloo ranks runs the port on a 2 x 2 mesh (kv heads, else positions, over
model; the two slots over data) from the same weights, then 2 replicas of
1 x 2 with rank 0 routing through the CLI's proxies.  Held:

* every cell's tokens equal JAX's (paged with heads split, its second run
  a radix hit; the in-page fallback at hkv 1, page_size 4; the dense
  engine with heads and with positions split; a tight pool that demotes
  and promotes; granite's MoE FFN; falcon-mamba's states over channels
  on the paged engine; recurrentgemma's rglru channels and its local_attn
  ring split by position on the dense engine; the pool parked on the
  host, held to JAX's page-by-page pass (``n_host_chunks=2`` with no
  ``ParallelContext``); dense host KV split by position, held to JAX's
  host-chunked engine likewise), the step logits within 1e-5, and a
  temperature's samples equal the one-rank port engine's;
* each rank's cache leaves have the shapes and bytes of the port's
  ``cache_shardings`` plan, and that plan equals JAX's ``cache_shardings``
  specs (called with a stub context, as tests/test_torch_shardings.py
  does for ``param_spec``) on every arch and mesh;
* the serve collectives' calls and bytes equal their reckoning from the
  steps taken;
* a store JAX wrote restores on the mesh (the tokens, prefix hits), and
  the mesh's store (slices gathered) restores into a one-rank port engine
  and a JAX engine;
* the replica tier: the first session's home replica dies on its second
  dispatch, a shared store: every request the no-fault tokens, one death,
  recovered prefix tokens;
* a recurrent layout on the dense engine gives JAX's tokens on the mesh;
  the CLI's mesh checks exit as the JAX CLI's; the CLI runs ``--mesh 1x2
  --replicas 2 --fault-plan`` on the CPU to the tokens of ``--mesh 1x1``.
"""
import contextlib
import io
import json
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import (FAULT_KW, SERVE_CELLS, SERVE_COLLECTIVES, SERVE_KW, SERVE_STEP_TOKENS,
                         SERVE_STORES, STORE_SPILL, _env, fault_workload, run_ranks, serve_cfg,
                         serve_prompts, serve_step_inputs)
from repro import configs as jconfigs
from repro.launch import serve as JCLI
from repro.models import serve as JSV
from repro.models import transformer as JT
from repro.runtime import decode_loop as JDL
from repro.runtime import paged as JPG
from repro_torch import configs
from repro_torch.convert import from_jax_params
from repro_torch.launch import router as R
from repro_torch.launch import serve as CLI
from repro_torch.models import serve as SV
from repro_torch.runtime import paged as PG
from repro_torch.tree import tree_leaves_with_path, tree_map

TOL = 1e-5
DP, SP = 2, 2
CELLS = {c[0]: c for c in SERVE_CELLS}
GREEDY = [c[0] for c in SERVE_CELLS if c[5] != "sampled"]
STORES = SERVE_STORES


def _jax_engine(jc, params, kind, ekw):
    """JAX's single-device engine of a cell; with ``n_host_chunks`` and no
    ``ParallelContext`` its host-streamed passes run (slab by slab, page by
    page) with nothing parked."""
    return (JPG.PagedServeEngine(jc, params, **SERVE_KW, **ekw) if kind == "paged"
            else JDL.ServeEngine(jc, params, **SERVE_KW, **ekw))


def _jax_steps(jc, params, ps, nh=0):
    """JAX's direct steps on one device: a chunk from offset 0, then a
    decode of its argmax (``nh``: host-streamed, as ``_jax_engine``)."""
    toks, table = serve_step_inputs(jc.vocab_size, ps or SERVE_STEP_TOKENS)
    tab = jnp.asarray(table, jnp.int32) if ps else None
    cache = (JSV.init_paged_cache(jc, 2, 8, ps) if ps else
             JSV.init_cache(jc, 2, SERVE_STEP_TOKENS + 4))
    lg, cache = JSV.chunk_step(jc, None, params, cache, jnp.asarray(toks, jnp.int32),
                               jnp.zeros(2, jnp.int32), jnp.full(2, SERVE_STEP_TOKENS, jnp.int32),
                               n_host_chunks=nh, table=tab)
    lg2, _ = JSV.decode_step(jc, None, params, cache,
                             {"tokens": jnp.argmax(lg, -1, keepdims=True)},
                             jnp.full(2, SERVE_STEP_TOKENS, jnp.int32), n_host_chunks=nh,
                             table=tab)
    return np.asarray(lg), np.asarray(lg2)


def _no_fault():
    """The replica tier's no-fault tokens: two one-rank port replicas."""
    cfg = serve_cfg(configs, "llama3.2-1b")
    jc = serve_cfg(jconfigs, "llama3.2-1b")
    params = from_jax_params(jax.device_get(JT.init_params(jc, jax.random.PRNGKey(0))), "cpu")
    prompts, sessions = fault_workload(cfg.vocab_size)
    rt = R.ReplicaRouter([PG.PagedServeEngine(cfg, params, **FAULT_KW) for _ in range(2)],
                         warn=lambda m: None)
    return [rt.generate(prompts, sessions=sessions) for _ in range(2)]


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_mesh")
    ref, want = {}, {}
    for label, arch, over, kind, ekw, workload in SERVE_CELLS:
        jc = serve_cfg(jconfigs, arch, over)
        params = JT.init_params(jc, jax.random.PRNGKey(0))
        ref.update({f"{label}/p{i}": np.asarray(x)
                    for i, x in enumerate(jax.tree.leaves(params))})
        lg, lg2 = _jax_steps(jc, params, ekw.get("page_size", 0), ekw.get("n_host_chunks", 0))
        want[label] = {"chunk": lg.tolist(), "decode": lg2.tolist()}
        if workload == "sampled":
            continue
        prompts, evictors = serve_prompts(jc.vocab_size, workload)
        e0 = _jax_engine(jc, params, kind, ekw)
        runs = [e0.generate(prompts)]
        if workload == "twice":
            runs.append(e0.generate(prompts))
        if workload == "spill":
            runs += [e0.generate(evictors), e0.generate(prompts)]
        want[label]["tokens"] = runs
        if label in STORES:
            e0.save_kv_store(str(tmp / f"{label}-jax.npz"))
    np.savez(tmp / "serve_mesh.npz", **ref)
    (tmp / "serve_mesh.json").write_text(json.dumps(want))
    no_fault = _no_fault()
    return run_ranks("serve_mesh", 4, tmp, timeout=300), want, no_fault, tmp


@pytest.mark.parametrize("cell", GREEDY)
def test_tokens_equal_jax(readings, cell):
    ranks, want, _, _ = readings
    for got in ranks:
        assert got[cell]["tokens"] == want[cell]["tokens"]
    st = ranks[0][cell]["stats"]
    if CELLS[cell][5] == "twice":  # the second run maps the first's pages
        assert st["prefix_hit_tokens"] > 0
    if CELLS[cell][5] == "spill":
        assert st["spill_promotes"] > 0


@pytest.mark.parametrize("cell", list(CELLS))
def test_step_logits_within_1e5(readings, cell):
    ranks, want, _, _ = readings
    for got in ranks:
        r0, r1 = got[cell]["step"]["rows"]
        for kind in ("chunk", "decode"):
            np.testing.assert_allclose(np.array(got[cell]["step"][kind]),
                                       np.array(want[cell][kind])[r0:r1], rtol=TOL, atol=TOL)


def test_sampled_tokens_equal_one_rank(readings):
    ranks, _, _, _ = readings
    for got in ranks:
        assert got["sampled"]["tokens"] == [got["sampled"]["one_rank"]]
        assert len({tuple(t) for t in got["sampled"]["one_rank"]}) > 1


def _meta(cfg, kind, ekw, S):
    if kind == "paged":
        return SV.init_paged_cache(cfg, SERVE_KW["slots"], ekw["n_pages"], ekw["page_size"],
                                   "meta")
    return SV.init_cache(cfg, SERVE_KW["slots"], S, "meta")


@pytest.mark.parametrize("cell", list(CELLS))
def test_cache_bytes_are_the_plan(readings, cell):
    ranks, _, _, _ = readings
    _, arch, over, kind, ekw, _ = CELLS[cell]
    cfg = serve_cfg(configs, arch, over)
    meta = _meta(cfg, kind, ekw, ranks[0][cell].get("capacity"))
    plans = {"/".join(p): d for p, d in _dims(SV.cache_shardings(cfg, DP, SP, meta))}
    want = {}
    for path, leaf in tree_leaves_with_path(meta):
        key = "/".join(path)
        shape = SV.local_shape(leaf.shape, plans[key], DP, SP)
        want[key] = [list(shape), int(np.prod(shape)) * leaf.element_size()]
    for got in ranks:
        assert got[cell]["cache"] == want
    assert any(m is not None for _, m in plans.values()), "no leaf splits over model"


def _dims(tree, path=()):
    """(path, (data dim, model dim)) of a plan tree's leaves."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _dims(tree[k], path + (str(k),))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _dims(v, path + (str(i),))]
    return [(path, tree)]


class _Spec:
    def __init__(self, *axes):
        self.axes = axes


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1), (2, 2), (1, 4), (4, 1)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-1b-a400m", "falcon-mamba-7b",
                                  "recurrentgemma-9b", "internvl2-2b"])
def test_plan_equals_jax_cache_shardings(arch, mesh):
    """Dense caches at two lengths and paged pools at two page sizes, each
    at two kv-head counts: every leaf's (data dim, model dim) is JAX's
    spec."""
    dp, sp = mesh
    stub = types.SimpleNamespace(dp_axes="data", dp=dp, sp_axis="model", sp=sp, ns=_Spec)
    for hkv in (1, 2):
        jc = serve_cfg(jconfigs, arch, {"num_kv_heads": hkv})
        tc = serve_cfg(configs, arch, {"num_kv_heads": hkv})
        caches = [(jax.eval_shape(lambda: JSV.init_cache(jc, 2, S)),
                   SV.init_cache(tc, 2, S, "meta")) for S in (12, 13)]
        caches += [(jax.eval_shape(lambda: JSV.init_paged_cache(jc, 2, 5, ps)),
                    SV.init_paged_cache(tc, 2, 5, ps, "meta")) for ps in (4, 3)]
        for jcache, tcache in caches:
            specs = jax.tree_util.tree_flatten_with_path(
                JSV.cache_shardings(jc, stub, jcache), is_leaf=lambda x: isinstance(x, _Spec))[0]
            jspec = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): s.axes
                     for p, s in specs}
            leaves = dict(tree_leaves_with_path(tcache))
            for path, (d, m) in _dims(SV.cache_shardings(tc, dp, sp, tcache)):
                key = "/".join(path)
                axes = [None] * leaves[path].dim()
                if d is not None:
                    axes[d] = "data"
                if m is not None:
                    axes[m] = "model"
                j = list(jspec[key]) + [None] * (len(axes) - len(jspec[key]))
                assert axes == j, (arch, hkv, key, axes, j)


def _reckon(cfg, cell, got):
    """The serve collectives of a cell's runs on 2 x 2, from the steps
    taken: a rank steps one of the two slots.  An attention layer gathers
    its heads or its positions' states (and a pool layer its writes); a
    recurrent layer gathers its channels twice (before the projections
    that read every channel and before ``w_out``)."""
    _, _, _, kind, ekw, workload = CELLS[cell]
    kinds = cfg.layer_kinds()
    L = sum(k in ("attn", "local_attn") for k in kinds)
    rec = sum(k in ("ssm", "rglru") for k in kinds)
    pool = sum(k == "attn" for k in kinds)
    b, cp, dh = 1, SERVE_KW["prefill_chunk"], cfg.head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    heads = hkv % SP == 0
    n = {"chunk": got["steps"]["chunk"], "decode": got["steps"]["decode"]}
    want = dict.fromkeys(SERVE_COLLECTIVES, (0, 0))

    def add(name, calls, nbytes):
        c, nb = want[name]
        want[name] = (c + calls, nb + nbytes)

    for step, w in (("chunk", cp), ("decode", 1)):
        k = n[step]
        if heads:
            add("gather_heads", L * k, L * k * b * w * (hq // SP) * dh * 4)
        else:
            add("gather_state", L * k, L * k * b * hq * w * (dh + 2) * 4)
        add("gather_channels", 2 * rec * k, 2 * rec * k * b * w * (cfg.d_inner // SP) * 4)
        if kind == "paged":  # the pool's writes of every row
            hl = hkv // SP if heads else hkv
            add("gather_rows", pool * k, pool * k * b * w * (2 * hl * dh + 1) * 4)
        if cfg.num_experts:  # the MoE FFN on every row
            add("gather_rows", L * k, L * k * b * w * cfg.d_model * 4)
        if workload == "sampled":  # the batch's logits, for one generator
            add("gather_rows", k, k * b * cfg.vocab_size * 4)
    d = got["dispatches"]  # a harvest a segment, every row's state and outputs
    add("gather_harvest", d, d * b * (5 + 2 * SERVE_KW["segment"]) * 4)
    return {k: list(v) for k, v in want.items()}


@pytest.mark.parametrize("cell", list(CELLS))
def test_collectives_as_reckoned(readings, cell):
    ranks, _, _, _ = readings
    _, arch, over, *_ = CELLS[cell]
    cfg = serve_cfg(configs, arch, over)
    for got in ranks:
        assert got[cell]["counts"] == _reckon(cfg, cell, got[cell])
        assert got[cell]["steps"]["chunk"] > 0 and got[cell]["steps"]["decode"] > 0


@pytest.mark.parametrize("cell", STORES)
def test_store_crosses_meshes(readings, cell):
    """JAX's one-device store restored on 2 x 2; the 2 x 2 store restored
    on one rank of the port and in JAX."""
    ranks, want, _, tmp = readings
    _, arch, over, kind, ekw, _ = CELLS[cell]
    for got in ranks:
        st = got[cell]["store"]
        assert st["restored"] > 0 and st["hits"] > 0
        assert st["tokens"] == want[cell]["tokens"][0]
        assert st["saved"] == st["restored"]
    cfg, jc = serve_cfg(configs, arch, over), serve_cfg(jconfigs, arch, over)
    jparams = JT.init_params(jc, jax.random.PRNGKey(0))
    prompts, _ = serve_prompts(cfg.vocab_size)
    for eng in (PG.PagedServeEngine(cfg, from_jax_params(jax.device_get(jparams), "cpu"),
                                    **SERVE_KW, **ekw, spill_pages=STORE_SPILL),
                JPG.PagedServeEngine(jc, jparams, **SERVE_KW, **ekw, spill_pages=STORE_SPILL)):
        assert eng.restore_kv_store(str(tmp / f"{cell}-mesh.npz")) == ranks[0][cell]["store"][
            "saved"]
        assert eng.generate(prompts) == want[cell]["tokens"][0]
        assert eng.last_stats["prefix_hit_tokens"] > 0


@pytest.mark.parametrize("cell", STORES)
def test_full_cover_and_restored_logits_equal_one_rank(readings, cell):
    """Every chunk step of the cell's two runs (the second a full-cover
    radix hit: a COW copy, prefill resumed at the last prompt token) and
    of the run on the restored JAX store (the pages promoted from the
    spill tier, the last one's tail dropped) on 2 x 2: each rank's live
    rows' logits equal a one-rank port engine's at 1e-5."""
    ranks, _, _, _ = readings
    for got in ranks:
        mesh, one = got[cell]["logits"]["mesh"], got[cell]["logits"]["one"]
        rows = 0
        for m_run, o_run in zip(mesh, one, strict=True):
            assert len(m_run) == len(o_run) > 0
            for m, o in zip(m_run, o_run):
                assert set(m) <= set(o)
                for row, lg in m.items():
                    np.testing.assert_allclose(lg, o[row], rtol=TOL, atol=TOL)
                rows += len(m)
        assert rows > 0
        assert got[cell]["stats"]["cow_copies"] > 0 and got[cell]["store"]["hits"] > 0


def _fill(rng):
    def fill(leaf):
        if leaf.dtype == jnp.int32:
            return jnp.asarray(rng.integers(-1, 20, leaf.shape), jnp.int32)
        return jnp.asarray(rng.standard_normal(leaf.shape), leaf.dtype)
    return fill


@pytest.mark.parametrize("keep", range(5))
@pytest.mark.parametrize("program", ["copy", "promote"])
def test_page_programs_on_inpage_slices(program, keep):
    """``copy_page`` and ``promote_page`` on each model rank's slice of a
    pool that splits its in-page positions over 1 x 2 (hkv 1, page_size 4:
    offsets [0, 2) and [2, 4), each rank given its base), put back
    together, equal JAX's program on the whole pool: only the entries at
    offsets >= ``keep`` are invalidated, on every rank."""
    over = {"num_kv_heads": 1}
    jc, cfg = serve_cfg(jconfigs, "llama3.2-1b", over), serve_cfg(configs, "llama3.2-1b", over)
    jcache = jax.tree.map(_fill(np.random.default_rng(keep)), JSV.init_paged_cache(jc, 2, 5, 4))
    whole = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), jcache)
    plan = SV.cache_shardings(cfg, 1, SP, whole)
    rows = SV.page_rows(whole, 4)
    if program == "copy":
        want = JPG.copy_page(jcache, 3, 0, keep)
    else:
        want = JPG.promote_page(jcache, 2, {k: jnp.asarray(v.numpy()) for k, v in rows.items()},
                                keep)
    parts = []
    for m in range(SP):
        part = tree_map(lambda x, d: x.narrow(d[1], m * 2, 2).clone(), whole, plan)
        if program == "copy":
            PG.copy_page(part, 3, 0, keep, base=m * 2)
        else:
            dims = {"/".join(p): d for p, d in _dims(plan)}  # a row has no page dim
            PG.promote_page(part, 2, {k: v.narrow(dims[k][1] - 1, m * 2, 2)
                                      for k, v in rows.items()}, keep, base=m * 2)
        parts.append(part)
    got = tree_map(lambda a, b, d: torch.cat([a, b], d[1]), *parts, plan)
    for path, leaf in tree_leaves_with_path(got):
        w = want
        for k in path:
            w = w[int(k)] if isinstance(w, list) else w[k]
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(w), err_msg="/".join(path))


def test_replica_tier_seeded_crash(readings):
    ranks, _, no_fault, _ = readings
    rep = ranks[0]["replicas"]
    assert rep["rounds"] == no_fault
    fo = rep["failover"]
    assert fo["deaths"] == 1 and fo["rehomed_requests"] > 0
    assert fo["recovered_pages"] > 0 and fo["recovered_prefix_tokens"] > 0
    assert rep["telemetry"] == ["engine", "engine"]  # each replica's, handed to rank 0


def test_recurrent_layout_refuses_the_mesh(readings):
    """No longer refused: falcon-mamba on the dense engine over 2 x 2 (its
    d_inner over model, the slots over data) gives JAX's tokens, those of
    its paged engine (radix off: per-slot states)."""
    ranks, want, _, _ = readings
    for got in ranks:
        assert got["recurrent"] == want["ssm-paged"]["tokens"][0]


ARGS = ["--arch", "llama3.2-1b", "--reduced", "--requests", "3", "--batch", "2",
        "--prompt-len", "8", "--gen", "2", "--prefill-chunk", "4", "--page-size", "4"]


def _exit(fn):
    err = io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
        try:
            fn()
        except SystemExit as e:
            return e.code, err.getvalue().strip().splitlines()[-1:]
    return None, []


@pytest.mark.parametrize("extra", [
    ["--engine", "--paged", "--sched", "slo", "--mesh", "1x2"],
    ["--engine", "--fault-plan", "0:raise@0"],
    ["--engine", "--shared-kv-store", "kv"],
    ["--mesh", "1x2"],
    ["--engine", "--mesh", "2by2"],
    ["--engine", "--paged", "--mesh", "1x1", "--fault-plan", "1:raise@0"],
    ["--engine", "--mesh", "1x1", "--shared-kv-store", "kv"],
], ids=["sched-mesh", "faults-no-mesh", "store-no-mesh", "mesh-no-engine", "bad-mesh",
        "replica-past-replicas", "store-no-paged"])
def test_cli_checks_exit_as_jax(extra, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve", *ARGS, *extra])
    jax_code, jax_msg = _exit(JCLI.main)
    code, msg = _exit(lambda: CLI.main([*ARGS, *extra, "--device", "cpu"]))
    assert code == jax_code and code not in (None, 0)
    if code == 2:  # argparse: the same last line
        assert msg == jax_msg


def test_cli_replicas_with_a_fault_match_one_engine(tmp_path):
    """``--mesh 1x2 --replicas 2 --fault-plan R:raise@0 --shared-kv-store``
    (4 gloo ranks, R a replica the workload routes to) to the tokens of
    ``--mesh 1x1``, one death and the re-homed requests printed."""
    base = [*ARGS, "--requests", "6", "--engine", "--paged", "--device", "cpu"]
    one = io.StringIO()
    with contextlib.redirect_stdout(one):
        CLI.main([*base, "--mesh", "1x1", "--replicas", "2"])
    lines = one.getvalue().splitlines()
    busy = [ln for ln in lines if ln.startswith("  replica ") and " 0 requests" not in ln]
    victim = int(busy[-1].split()[1].rstrip(":"))
    digest = next(ln for ln in lines if "tokens sha256" in ln)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *base, "--mesh", "1x2",
         "--replicas", "2", "--fault-plan", f"{victim}:raise@0", "--shared-kv-store",
         str(tmp_path / "kv")], env=_env(), capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert digest in proc.stdout, proc.stdout
    fo = next(ln for ln in proc.stdout.splitlines() if "failover:" in ln)
    assert "1 deaths" in fo and f"dead=[{victim}]" in fo and " 0 requests re-homed" not in fo
