"""The port's paged KV pool (``runtime/paged.py`` and the paged twins in
``models/serve.py``) against the JAX package, on reduced configs in fp32
with the same (converted) parameters:

* the host metadata (PagePool, SpillPool, RadixTree, PagedCacheManager)
  driven by the same seeded op sequences in both packages: tables,
  refcounts, free lists, admit plans, eviction order, spill slots and
  payloads equal after every op;
* the page programs (``paged_reset``, ``copy_page``, ``promote_page``) and
  ``page_rows`` exactly, over a layout with a stacked and a tail pool;
* paged ``chunk_step`` / ``decode_step`` against JAX's and the port's
  dense steps at page sizes 2 and 8 (1e-5), and no dead or unmapped write
  reaching a live page;
* the ``.npz`` prefix store written by either package read by the other,
  fp32 and bf16, bit for bit;
* ``PagedServeEngine`` greedy tokens and ``last_stats`` equal to JAX's:
  three layouts on the staggered workload with a stop token, prefix
  reuse, COW, deferral, demote and promote, the store round trip;
* the host-streamed pool (``n_host_chunks > 0``, the pool parked): its
  steps and engine against JAX's page-by-page pass (a JAX engine or step
  with ``n_host_chunks`` and no ``ParallelContext`` runs that pass with
  nothing parked: ROADMAP Queue C), the parked pool against the device
  pool bit for bit, demotion, promotion and the store through it;
* the serve CLI's paged flags.

The other JAX engines run with ``n_host_chunks=0``."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.models import serve as JSV
from repro.models import transformer as JT
from repro.runtime import decode_loop as JDL
from repro.runtime import paged as JPG
from repro_torch.configs import get_config, reduced
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve as CLI
from repro_torch.models import serve as SV
from repro_torch.runtime import decode_loop as DL
from repro_torch.runtime import paged as PG

TOL = 1e-5
# last_stats keys the paged engine adds, held equal to JAX's
PAGED_STATS = ("page_size", "n_pages", "max_pages", "radix", "prompt_tokens",
               "prefilled_tokens", "prefix_hit_tokens", "cow_copies", "deferrals",
               "pages_peak", "radix_pages", "spill_pages", "spill_promotes", "spilled_pages",
               "resets", "dispatches", "capacity", "pending_len")
# a layout with a stacked pool (cycle position 0) and a tail pool, beside
# a per-slot recurrent state: every kind of leaf the page programs touch
TAIL_LAYOUT = dict(num_layers=3, block_pattern=("attn", "rglru"))


@functools.lru_cache(maxsize=None)
def _model(arch, layout=()):
    """(JAX config, port config, JAX params, port params) of the reduced
    ``arch`` in fp32."""
    kw = dict(param_dtype="float32", remat="none", **dict(layout))
    jc = dataclasses.replace(j_reduced(j_get_config(arch)), **kw)
    tc = dataclasses.replace(reduced(get_config(arch)), **kw)
    jparams = JT.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jparams, from_jax_params(jax.device_get(jparams), "cpu")


def _prompts(n_vocab, lens, seed, prefix=()):
    rng = np.random.default_rng(seed)
    return [list(prefix) + rng.integers(0, n_vocab, size=n).tolist() for n in lens]


def _stats(engine):
    return {k: engine.last_stats[k] for k in PAGED_STATS}


# ---------------------------------------------------------------------------
# host metadata
# ---------------------------------------------------------------------------


def _tree_dump(tree):
    """Every node of a radix tree (children in insertion order): depth,
    key, page, spill slot, stamp."""
    out, stack = [], [(tree.root, 0)]
    while stack:
        nd, d = stack.pop()
        if nd is not tree.root:
            out.append((d, nd.key, nd.page, nd.spill, nd.last_used))
        stack.extend((c, d + 1) for c in reversed(list(nd.children.values())))
    return out


def _manager_state(mgr):
    spill = mgr.spill
    return (mgr.table.tolist(), mgr.pool.refcount.tolist(), list(mgr.pool._free),
            [list(p) for p in mgr._slot_pages], mgr.radix.pages, _tree_dump(mgr.radix),
            list(spill._free), spill.demotions,
            {k: np.asarray(v).tolist() for k, v in spill.data.items()})


def _manager_trace(mod, seed, rows_of):
    """A seeded sequence of admits (shared prefixes, so radix hits, COW and
    promotes happen), publishes, releases and forced COWs on a small pool
    with a spill tier; returns what each op gave and the state after it."""
    rng = np.random.default_rng(seed)
    mgr = mod.PagedCacheManager(11, 2, use_radix=True, spill_pages=4)
    mgr.set_page_reader(rows_of)
    mgr.begin(3, max_pages=7)
    prefixes = [rng.integers(0, 4, size=6).tolist() for _ in range(2)]
    tokens = [[] for _ in range(3)]
    trace = []
    for _ in range(90):
        op = int(rng.choice(4, p=[0.35, 0.25, 0.25, 0.15]))
        s = int(rng.integers(0, 3))
        rec = None
        if op == 0 and not mgr._slot_pages[s]:
            toks = prefixes[int(rng.integers(0, 2))]
            if rng.integers(0, 3):  # a prefix and a suffix of its own
                toks = toks[: int(rng.integers(0, 7))] + rng.integers(
                    0, 4, size=int(rng.integers(1, 6))).tolist()
            else:  # whole pages of a prefix: a full-cover match takes COW
                toks = toks[: 2 * int(rng.integers(1, 4))]
            try:
                plan = mgr.admit(s, toks, int(rng.integers(0, 4)), label=f"request {s}")
            except mod.PoolExhausted as e:
                rec = ("exhausted", str(e))
            else:
                for sid in plan.free_spill:  # as the engine does once the promotes ran
                    mgr.spill.free(sid)
                tokens[s] = toks
                rec = dataclasses.asdict(plan)
        elif op == 1 and mgr._slot_pages[s]:
            rec = mgr.complete_prefill(s, tokens[s])
        elif op == 2 and mgr._slot_pages[s]:
            mgr.release(s)
            rec = "released"
        elif op == 3 and mgr._slot_pages[s]:
            try:
                rec = mgr.ensure_writable(s, int(rng.integers(0, len(mgr._slot_pages[s]))))
            except mod.PoolExhausted as e:
                rec = ("exhausted", str(e))
        trace.append((rec, _manager_state(mgr)))
    return trace


@pytest.mark.parametrize("seed", range(6))
def test_manager_ops_match_jax(seed):
    """Admission (with eviction, demotion into the spill tier, promotion
    and full-cover COW), publish, release and ensure_writable give the
    JAX manager's plans, tables, refcounts, free lists, tree and spill
    tier after every op; the demoted payloads are the pages read."""
    def rows(pid, full):
        return {"pos0/pk": full(pid), "pos0/pkpos": full(-pid)}

    got = _manager_trace(PG, seed, lambda pid: rows(
        pid, lambda v: torch.full((2, 2), float(v))))
    want = _manager_trace(JPG, seed, lambda pid: rows(
        pid, lambda v: np.full((2, 2), float(v), np.float32)))
    assert got == want
    assert any(isinstance(r, dict) and r["hit_pages"] for r, _ in got)


def test_manager_traces_reach_every_branch():
    """Over the six seeds the traces above take every path: promotes from
    the spill tier, full-cover COW, exhaustion, a forced COW copy and
    demotion."""
    seen = set()
    for seed in range(6):
        trace = _manager_trace(PG, seed, lambda pid: {"pos0/pk": torch.full((2,), float(pid))})
        for rec, state in trace:
            if isinstance(rec, dict):
                seen |= {k for k in ("promote", "cow") if rec[k]}
            elif isinstance(rec, tuple):
                seen.add("exhausted" if rec[0] == "exhausted" else "ensure_writable")
        seen |= {"demoted"} if trace[-1][1][7] else set()
    assert seen == {"promote", "cow", "exhausted", "ensure_writable", "demoted"}


@pytest.mark.parametrize("seed", range(3))
def test_pool_and_spill_ops_match_jax(seed):
    """PagePool alloc / share / release and SpillPool alloc / free traces,
    misuse included: the same pages, refcounts, free lists and errors."""
    def run(mod):
        rng = np.random.default_rng(seed)
        pool, spill, out = mod.PagePool(5), mod.SpillPool(3), []
        for _ in range(50):
            op, pid = int(rng.integers(0, 5)), int(rng.integers(0, 5))
            try:
                r = [pool.alloc, lambda: pool.share(pid), lambda: pool.release(pid),
                     spill.alloc, lambda: spill.free(pid % 3)][op]()
            except ValueError as e:
                r = (type(e).__name__, str(e))
            out.append((r, pool.refcount.tolist(), list(pool._free), list(spill._free)))
        return out

    assert run(PG) == run(JPG)


# ---------------------------------------------------------------------------
# page programs
# ---------------------------------------------------------------------------


def _random_pools(seed, n_pages=5, ps=2, b=2):
    """A JAX paged cache of the TAIL_LAYOUT model with random contents, and
    the port's copy of it."""
    jc = dataclasses.replace(j_reduced(j_get_config("recurrentgemma-9b")),
                             param_dtype="float32", **TAIL_LAYOUT)
    rng = np.random.default_rng(seed)
    jcache = JSV.init_paged_cache(jc, b, n_pages, ps)

    def fill(leaf):
        if leaf.dtype == jnp.int32:
            return jnp.asarray(rng.integers(-1, 20, leaf.shape), jnp.int32)
        return jnp.asarray(rng.standard_normal(leaf.shape), leaf.dtype)

    jcache = jax.tree.map(fill, jcache)
    return jcache, jax.tree.map(lambda x: torch.from_numpy(np.array(x)), jcache)


def _assert_same_cache(tcache, jcache):
    jl, tl = dict(_flat(jcache)), dict(_flat(tcache))
    assert jl.keys() == tl.keys()
    for k in jl:
        np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]), err_msg=k)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_page_programs_match_jax():
    """paged_reset (the real fresh pages here, the JAX engine's padded ids
    there), copy_page with a dropped tail, promote_page with a kept prefix
    and page_rows give JAX's pools exactly, stacked and tail leaves alike;
    the rows are keyed by JAX's pool_leaf_key."""
    jcache, tcache = _random_pools(0)
    n_pages = 5
    ids = np.full(n_pages, n_pages + 1, np.int32)
    ids[:2] = [3, 1]
    jcache = JPG.paged_reset(jcache, 1, jnp.asarray(ids))
    PG.paged_reset(tcache, 1, [3, 1])
    _assert_same_cache(tcache, jcache)
    jcache = JPG.copy_page(jcache, 3, 0, 1)
    PG.copy_page(tcache, 3, 0, 1)
    _assert_same_cache(tcache, jcache)
    jrows = JSV.page_rows(jcache, 4)
    trows = SV.page_rows(tcache, 4)
    assert sorted(trows) == sorted(jrows) == ["pos0/pk", "pos0/pkpos", "pos0/pv", "tail/0/pk",
                                              "tail/0/pkpos", "tail/0/pv"]
    for k in jrows:
        np.testing.assert_array_equal(trows[k].numpy(), jrows[k])
    jcache = JPG.promote_page(jcache, 2, {k: jnp.asarray(v) for k, v in jrows.items()}, 1)
    PG.promote_page(tcache, 2, trows, 1)
    _assert_same_cache(tcache, jcache)


# ---------------------------------------------------------------------------
# paged steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ps", [2, 8])
def test_paged_steps_match_jax_and_dense(ps):
    """tests/test_paged.py::test_chunk_step_paged_logit_parity through both
    packages: chunked prefill of lengths 9 and 6 then a decode step through
    the page pool give JAX's paged logits and the port's dense ones, and
    the pool JAX's (every page but the trash page)."""
    jc, tc, jparams, tparams = _model("llama3.2-1b")
    rng = np.random.default_rng(3)
    b, cp, lens = 2, 4, [9, 6]
    toks = rng.integers(0, jc.vocab_size, size=(b, 9)).astype(np.int32)
    mgr = PG.PagedCacheManager(16, ps, use_radix=False)
    mgr.begin(b, max_pages=-(-16 // ps))
    for s, n in enumerate(lens):
        mgr.admit(s, toks[s, :n].tolist(), 16 - n)
    jtable = jnp.asarray(mgr.table)
    table = torch.as_tensor(mgr.table, dtype=torch.long)
    jpaged = JSV.init_paged_cache(jc, b, 16, ps)
    paged = SV.init_paged_cache(tc, b, 16, ps, "cpu")
    dense = SV.init_cache(tc, b, 16, "cpu")
    pfill, plen = np.zeros(b, np.int64), np.asarray(lens)
    while (pfill < plen).any():
        live = np.clip(plen - pfill, 0, cp)
        chunk = toks[np.arange(b)[:, None], np.clip(pfill[:, None] + np.arange(cp), 0, 8)]
        jl, jpaged = JSV.chunk_step(jc, None, jparams, jpaged, jnp.asarray(chunk),
                                    jnp.asarray(pfill, jnp.int32), jnp.asarray(live, jnp.int32),
                                    table=jtable)
        args = (torch.from_numpy(chunk), torch.from_numpy(pfill), torch.from_numpy(live))
        lp, _ = SV.chunk_step(tc, None, tparams, paged, *args, table=table)
        ld, _ = SV.chunk_step(tc, None, tparams, dense, *args)
        np.testing.assert_allclose(lp.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(lp.numpy(), ld.numpy(), rtol=TOL, atol=TOL)
        pfill += live
    nxt = torch.argmax(ld[:, : tc.vocab_size], -1)[:, None]
    jl, jpaged = JSV.decode_step(jc, None, jparams, jpaged, {"tokens": jnp.asarray(nxt.numpy())},
                                 jnp.asarray(plen, jnp.int32), table=jtable)
    lp, _ = SV.decode_step(tc, None, tparams, paged, {"tokens": nxt}, torch.from_numpy(plen),
                           table=table)
    ld, _ = SV.decode_step(tc, None, tparams, dense, {"tokens": nxt}, torch.from_numpy(plen))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lp.numpy(), ld.numpy(), rtol=TOL, atol=TOL)
    for (k, got), (_, want) in zip(_flat(paged), _flat(jpaged)):
        tol = 0 if k.endswith("pkpos") else TOL
        np.testing.assert_allclose(got.numpy()[:, :-1], np.asarray(want)[:, :-1], rtol=tol,
                                   atol=tol, err_msg=k)


def test_dead_and_unmapped_writes_never_reach_a_live_page():
    """A chunk step with a live row of 1 token whose dead columns fall on
    its own mapped page and on unmapped entries, a FREE row on the trash
    row and a decoding row, then a decode step: every entry of every page
    but the trash page keeps its value, except the live tokens' own."""
    _, tc, _, tparams = _model("llama3.2-1b")
    n_pages, ps, cp = 6, 2, 4
    pool = SV.init_paged_cache(tc, 3, n_pages, ps, "cpu")
    g = torch.Generator().manual_seed(0)
    for _, leaf, _ in SV.pool_leaves(pool):
        # positions no step here writes, so every write shows
        leaf.copy_(torch.randint(10, 20, leaf.shape, generator=g) if leaf.dtype == torch.int32
                   else torch.randn(leaf.shape, generator=g))
    trash = n_pages
    table = torch.tensor([[0, 1, 2, -1], [trash] * 4, [3, 4, -1, -1]])
    before = {k: leaf.clone() for k, leaf, _ in SV.pool_leaves(pool)}
    toks = torch.randint(0, tc.vocab_size, (3, cp), generator=g)
    # row 0: position 4 live, 5 (its own page 2) and 6, 7 (unmapped) dead;
    # row 1: FREE; row 2: one token at position 1
    SV.chunk_step(tc, None, tparams, pool, toks, torch.tensor([4, 0, 1]),
                  torch.tensor([1, 0, 1]), table=table)
    SV.decode_step(tc, None, tparams, pool, {"tokens": toks[:, :1]}, torch.tensor([5, 3, 2]),
                   table=table)
    written = {(2, 0), (3, 1), (2, 1), (4, 0)}  # chunk: pos 4, 1; decode: pos 5, 2
    for k, leaf, _ in SV.pool_leaves(pool):
        changed = (leaf != before[k]).reshape(*leaf.shape[:3], -1).any(-1)  # [C, page, off]
        hit = {(int(p), int(o)) for _, p, o in changed.nonzero().tolist() if p != trash}
        assert hit <= written, (k, hit)
    assert {(2, 0), (3, 1), (2, 1), (4, 0)} == {
        (int(p), int(o)) for _, p, o in (pool["pos0"]["pkpos"] != before["pos0/pkpos"])
        .nonzero().tolist() if p != trash}


# ---------------------------------------------------------------------------
# the .npz prefix store
# ---------------------------------------------------------------------------


def _store_tree(mod, rows_of):
    """Two radix chains on a page pool with a spill tier, one page demoted:
    a store of resident and spilled payloads."""
    pool = mod.PagePool(6)
    tree = mod.RadixTree(2, pool, spill=mod.SpillPool(4))
    tree.read_page = rows_of
    for toks in ([1, 2, 3, 4], [1, 2, 7, 7], [5, 6]):
        have = len(tree.match(toks))
        pids = [pool.alloc() for _ in range(len(toks) // 2 - have)]
        tree.insert(toks, tree.match(toks)[:have] + pids)
        for p in pids:
            pool.release(p)
    tree.match([1, 2, 3, 4])
    assert tree.evict(1) == 1 and tree.spilled == 1
    return tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_store_crosses_packages(tmp_path, dtype):
    """A store saved by either package restores in the other with the same
    tree and the saved bits (bf16 through JAX's uint16 + dtype-name
    format; ml_dtypes only on the JAX side)."""
    bits = np.random.default_rng(0).integers(0, 2**16, (7, 3, 2), dtype=np.uint16)
    if dtype == "float32":
        bits = np.random.default_rng(0).standard_normal((7, 3, 2)).astype(np.float32)

    def jrows(pid):
        pk = bits[pid].view(ml_dtypes.bfloat16) if dtype == "bfloat16" else bits[pid]
        return {"pos0/pk": pk, "pos0/pkpos": np.full(2, pid, np.int32)}

    def trows(pid):
        r = jrows(pid)
        pk = (torch.from_numpy(bits[pid].view(np.int16)).view(torch.bfloat16)
              if dtype == "bfloat16" else torch.from_numpy(r["pos0/pk"]))
        return {"pos0/pk": pk, "pos0/pkpos": torch.from_numpy(r["pos0/pkpos"])}

    def as_bits(x):
        if isinstance(x, torch.Tensor):
            x = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
        return np.asarray(x).view(np.uint16 if x.dtype.itemsize == 2 else x.dtype)

    stores = {}
    for name, mod, rows in (("jax", JPG, jrows), ("port", PG, trows)):
        stores[name] = str(tmp_path / f"{name}.npz")
        assert _store_tree(mod, rows).save(stores[name]) == 4
    for src in ("jax", "port"):
        trees = {}
        for name, mod in (("jax", JPG), ("port", PG)):
            trees[name] = mod.RadixTree(2, mod.PagePool(4), spill=mod.SpillPool(8))
            assert trees[name].restore(stores[src]) == 4
        assert _tree_dump(trees["jax"]) == _tree_dump(trees["port"])
        for _, _, _, sid, _ in _tree_dump(trees["jax"]):
            want, got = trees["jax"].spill.read(sid), trees["port"].spill.read(sid)
            for k in want:
                assert np.array_equal(as_bits(got[k]), as_bits(want[k])), (src, k)
        assert str(trees["port"].spill.data["pos0/pk"].dtype) == f"torch.{dtype}"


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


STAGGERED = dict(slots=2, bucket=8, max_new_tokens=5, segment=2, prefill_chunk=4,
                 page_size=4)


@functools.lru_cache(maxsize=None)
def _staggered_jax(arch, stop):
    jc, _, jparams, _ = _model(arch)
    eng = JPG.PagedServeEngine(jc, jparams, stop_tokens=(stop,), **STAGGERED)
    out = eng.generate(_prompts(jc.vocab_size, (3, 8, 5, 12, 6), 0))
    return out, _stats(eng)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "falcon-mamba-7b", "recurrentgemma-9b"])
def test_paged_engine_matches_jax(arch):
    """The staggered workload (queue > slots, a prompt longer than the
    bucket, a stop token from request 0's third token): JAX's tokens and
    stats, the dense engine's tokens, pages_peak within the pool; radix
    only for the pure-attention layout."""
    jc, tc, _, tparams = _model(arch)
    prompts = _prompts(jc.vocab_size, (3, 8, 5, 12, 6), 0)
    stop = PG.PagedServeEngine(tc, tparams, **STAGGERED).generate(prompts)[0][2]
    eng = PG.PagedServeEngine(tc, tparams, stop_tokens=(stop,), **STAGGERED)
    got = eng.generate(prompts)
    want, want_stats = _staggered_jax(arch, stop)
    assert got == want
    assert _stats(eng) == want_stats
    kw = {k: v for k, v in STAGGERED.items() if k != "page_size"}
    assert got == DL.ServeEngine(tc, tparams, stop_tokens=(stop,), **kw).generate(prompts)
    assert eng.last_stats["pages_peak"] <= eng.n_pages
    assert eng.radix_enabled == (arch == "llama3.2-1b")


def test_prefix_reuse_matches_jax():
    """tests/test_paged.py::test_prefix_reuse_matches_full_recompute: radix
    on and off give JAX's tokens and stats and the dense engine's tokens;
    the hits cut the prefilled tokens; the pool, prefixes and all,
    persists into the next workload."""
    jc, tc, jparams, tparams = _model("llama3.2-1b")
    shared = _prompts(jc.vocab_size, (16,), 7)[0]
    prompts = _prompts(jc.vocab_size, (3, 5, 7, 2, 6, 4), 8, prefix=shared)
    kw = dict(slots=2, bucket=32, max_new_tokens=4, segment=2, prefill_chunk=4)
    ref = DL.ServeEngine(tc, tparams, **kw).generate(prompts)
    for radix in (False, True):
        eng = PG.PagedServeEngine(tc, tparams, page_size=4, n_pages=32, radix=radix, **kw)
        jeng = JPG.PagedServeEngine(jc, jparams, page_size=4, n_pages=32, radix=radix, **kw)
        assert eng.generate(prompts) == jeng.generate(prompts) == ref
        assert _stats(eng) == _stats(jeng)
        st = eng.last_stats
        assert st["prefilled_tokens"] == st["prompt_tokens"] - st["prefix_hit_tokens"]
        assert (st["prefix_hit_tokens"] >= 16 * (len(prompts) - 2)) == radix
    assert eng.generate(prompts[:2]) == jeng.generate(prompts[:2]) == ref[:2]
    assert _stats(eng) == _stats(jeng) and eng.last_stats["prefix_hit_tokens"] >= 16


def test_cow_on_identical_prompts_matches_jax():
    """Identical 16-token prompts at page size 4: the match covers the
    whole prompt, so the resumed last-token prefill copies the final page
    (COW); JAX's tokens and stats, the dense engine's tokens."""
    jc, tc, jparams, tparams = _model("llama3.2-1b")
    prompt = _prompts(jc.vocab_size, (16,), 8)[0]
    kw = dict(slots=2, bucket=16, max_new_tokens=4, segment=2, prefill_chunk=4)
    eng = PG.PagedServeEngine(tc, tparams, page_size=4, n_pages=32, **kw)
    jeng = JPG.PagedServeEngine(jc, jparams, page_size=4, n_pages=32, **kw)
    got = eng.generate([prompt] * 3)
    assert got == jeng.generate([prompt] * 3)
    assert got == DL.ServeEngine(tc, tparams, **kw).generate([prompt] * 3)
    assert _stats(eng) == _stats(jeng) and eng.last_stats["cow_copies"] >= 1


def test_pool_pressure_defers_as_jax():
    """A pool of 3 pages drains a 3-request queue by deferring: JAX's
    tokens and deferral count, the dense engine's tokens; a request the
    pool could never hold raises, naming it."""
    jc, tc, jparams, tparams = _model("llama3.2-1b")
    prompts = _prompts(jc.vocab_size, (7, 6, 8), 9)
    kw = dict(slots=2, bucket=8, max_new_tokens=4, segment=2, prefill_chunk=4)
    eng = PG.PagedServeEngine(tc, tparams, page_size=4, n_pages=3, radix=False, **kw)
    jeng = JPG.PagedServeEngine(jc, jparams, page_size=4, n_pages=3, radix=False, **kw)
    got = eng.generate(prompts)
    assert got == jeng.generate(prompts) == DL.ServeEngine(tc, tparams, **kw).generate(prompts)
    assert _stats(eng) == _stats(jeng) and eng.last_stats["deferrals"] > 0
    small = PG.PagedServeEngine(tc, tparams, page_size=4, n_pages=2, **kw)
    with pytest.raises(ValueError, match="request 1"):
        small.generate([[1, 2, 3], [4] * 32])


def test_paged_engine_refusals():
    """JAX's refusals (chunk and page size that do not divide, page size
    0); the host-streamed pool, once refused, runs: its engine gives the
    device pool's tokens and a decode step through it the device pool's
    logits (within 1e-5: page by page against one gather)."""
    _, tc, _, tparams = _model("llama3.2-1b")
    kw = dict(slots=2, bucket=8, max_new_tokens=4, segment=2)
    with pytest.raises(ValueError, match="prefill_chunk=6 and page_size=4"):
        PG.PagedServeEngine(tc, tparams, prefill_chunk=6, page_size=4, **kw)
    with pytest.raises(ValueError, match="page_size must be >= 1"):
        PG.PagedServeEngine(tc, tparams, prefill_chunk=4, page_size=0, **kw)
    prompts = _prompts(tc.vocab_size, (3, 7, 5), 4)
    assert (PG.PagedServeEngine(tc, tparams, prefill_chunk=4, page_size=4, n_host_chunks=2,
                                **kw).generate(prompts)
            == PG.PagedServeEngine(tc, tparams, prefill_chunk=4, page_size=4,
                                   **kw).generate(prompts))
    lg = [SV.decode_step(tc, None, tparams, SV.init_paged_cache(tc, 1, 2, 4, "cpu", host=nh > 0),
                         {"tokens": torch.zeros((1, 1), dtype=torch.long)}, 0, n_host_chunks=nh,
                         table=torch.tensor([[0, 1]]), host_table=np.array([[0, 1]]))[0]
          for nh in (2, 0)]
    np.testing.assert_allclose(lg[0].numpy(), lg[1].numpy(), rtol=TOL, atol=TOL)
    # a table no manager makes: one page at two logical pages a row may write
    with pytest.raises(ValueError, match="two logical pages"):
        SV.decode_step(tc, None, tparams, SV.init_paged_cache(tc, 1, 2, 4, "cpu", host=True),
                       {"tokens": torch.zeros((1, 1), dtype=torch.long)}, 0, n_host_chunks=2,
                       table=torch.zeros((1, 2), dtype=torch.long),
                       host_table=np.zeros((1, 2), np.int64))
    # the plan comes from the host's table, never from a device read
    with pytest.raises(ValueError, match="host_table"):
        SV.decode_step(tc, None, tparams, SV.init_paged_cache(tc, 1, 2, 4, "cpu", host=True),
                       {"tokens": torch.zeros((1, 1), dtype=torch.long)}, 0, n_host_chunks=2,
                       table=torch.tensor([[0, 1]]))


# ---------------------------------------------------------------------------
# the host-streamed pool
# ---------------------------------------------------------------------------


def _pool_pages(cache):
    """Every pool leaf but its trash page (the last), by key, as numpy."""
    return {k: (leaf[:, :-1] if stacked else leaf[:-1]).numpy()
            for k, leaf, stacked in SV.pool_leaves(cache)}


def test_host_pool_engine_matches_jax():
    """The staggered workload (a stop token: a row goes FREE mid-segment
    and goes on writing at its frozen position) on the parked pool:
    JAX's PagedServeEngine(n_host_chunks=2) tokens and stats (its
    page-by-page pass; the port's engine fetches the live pages at once),
    the device
    pool's tokens; the parked pool then holds the device pool's positions
    exactly and its keys within 1e-5 on every page but the trash page;
    the engine reports the pool's bytes and the pages it fetched."""
    jc, tc, jparams, tparams = _model("llama3.2-1b")
    prompts = _prompts(jc.vocab_size, (3, 8, 5, 12, 6), 0)
    kw = dict(STAGGERED, n_pages=24)
    dev = PG.PagedServeEngine(tc, tparams, **kw)
    stop = dev.generate(prompts)[0][2]
    dev = PG.PagedServeEngine(tc, tparams, stop_tokens=(stop,), **kw)
    eng = PG.PagedServeEngine(tc, tparams, stop_tokens=(stop,), n_host_chunks=2, **kw)
    jeng = JPG.PagedServeEngine(jc, jparams, stop_tokens=(stop,), n_host_chunks=2, **kw)
    got = eng.generate(prompts)
    assert got == jeng.generate(prompts) == dev.generate(prompts)
    assert _stats(eng) == _stats(jeng)
    assert any(len(g) < kw["max_new_tokens"] for g in got)  # the stop fired
    want, have = _pool_pages(dev._pool), _pool_pages(eng._pool)
    assert sorted(want) == sorted(have) and want
    for k in want:  # a later layer's keys carry the merge order's last bits
        tol = 0 if k.endswith("pkpos") else TOL
        np.testing.assert_allclose(have[k], want[k], rtol=tol, atol=tol, err_msg=k)
    st = eng.last_stats
    page = tc.num_layers * 4 * 2 * tc.num_kv_heads * tc.head_dim * 4
    assert st["host_kv_bytes"] == (eng.n_pages + 1) * page and st["host_kv_pages"] > 0


@pytest.mark.parametrize("ps", [2, 8])
def test_host_pool_steps_match_jax(ps):
    """test_paged_steps_match_jax_and_dense's steps with n_host_chunks=2,
    the pool parked and each step given its rows' spans and the host's
    table (every live page fetched and merged at once): JAX's
    host-streamed (page-by-page) logits and the device pool's within
    1e-5, and the parked pool JAX's (every page but the trash page)."""
    jc, tc, jparams, tparams = _model("llama3.2-1b")
    rng = np.random.default_rng(3)
    b, cp, lens = 2, 4, [9, 6]
    toks = rng.integers(0, jc.vocab_size, size=(b, 9)).astype(np.int32)
    mgr = PG.PagedCacheManager(16, ps, use_radix=False)
    mgr.begin(b, max_pages=-(-16 // ps))
    for s, n in enumerate(lens):
        mgr.admit(s, toks[s, :n].tolist(), 16 - n)
    jtable = jnp.asarray(mgr.table)
    table = torch.as_tensor(mgr.table, dtype=torch.long)
    jpaged = JSV.init_paged_cache(jc, b, 16, ps)
    parked = SV.init_paged_cache(tc, b, 16, ps, "cpu", host=True)
    paged = SV.init_paged_cache(tc, b, 16, ps, "cpu")
    pfill, plen = np.zeros(b, np.int64), np.asarray(lens)
    host = dict(n_host_chunks=2, table=table, host_table=mgr.table)
    while (pfill < plen).any():
        live = np.clip(plen - pfill, 0, cp)
        chunk = toks[np.arange(b)[:, None], np.clip(pfill[:, None] + np.arange(cp), 0, 8)]
        jl, jpaged = JSV.chunk_step(jc, None, jparams, jpaged, jnp.asarray(chunk),
                                    jnp.asarray(pfill, jnp.int32), jnp.asarray(live, jnp.int32),
                                    n_host_chunks=2, table=jtable)
        args = (torch.from_numpy(chunk), torch.from_numpy(pfill), torch.from_numpy(live))
        spans = [(int(a), int(a + n - 1)) for a, n in zip(pfill, live)]
        lh, _ = SV.chunk_step(tc, None, tparams, parked, *args, bounds=spans, **host)
        lp, _ = SV.chunk_step(tc, None, tparams, paged, *args, table=table)
        np.testing.assert_allclose(lh.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(lh.numpy(), lp.numpy(), rtol=TOL, atol=TOL)
        pfill += live
    nxt = torch.argmax(lp[:, : tc.vocab_size], -1)[:, None]
    jl, jpaged = JSV.decode_step(jc, None, jparams, jpaged, {"tokens": jnp.asarray(nxt.numpy())},
                                 jnp.asarray(plen, jnp.int32), n_host_chunks=2, table=jtable)
    lh, _ = SV.decode_step(tc, None, tparams, parked, {"tokens": nxt}, torch.from_numpy(plen),
                           bounds=[(int(p), int(p)) for p in plen], **host)
    np.testing.assert_allclose(lh.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    for (k, got), (_, want) in zip(_flat(parked), _flat(jpaged)):
        tol = 0 if k.endswith("pkpos") else TOL
        np.testing.assert_allclose(got.numpy()[:, :-1], np.asarray(want)[:, :-1], rtol=tol,
                                   atol=tol, err_msg=k)


def test_page_programs_on_the_parked_pool():
    """paged_reset, copy_page with a dropped tail, promote_page with a kept
    prefix and page_rows on a parked pool (``host=True``) and on a device
    one filled alike: the same bits."""
    tc = dataclasses.replace(reduced(get_config("llama3.2-1b")), param_dtype="float32",
                             **TAIL_LAYOUT)
    pools = [SV.init_paged_cache(tc, 2, 5, 2, "cpu", host=host) for host in (True, False)]
    g = torch.Generator().manual_seed(0)
    for pool in pools:
        g.manual_seed(0)
        for _, leaf, _ in SV.pool_leaves(pool):
            leaf.copy_(torch.randint(-1, 20, leaf.shape, generator=g) if leaf.dtype == torch.int32
                       else torch.randn(leaf.shape, generator=g))
        PG.paged_reset(pool, 1, [3, 1])
        PG.copy_page(pool, 3, 0, 1)
        PG.promote_page(pool, 2, SV.page_rows(pool, 4), 1)
    rows = [SV.page_rows(pool, 2) for pool in pools]
    assert sorted(rows[0]) == sorted(rows[1])
    for k in rows[0]:
        np.testing.assert_array_equal(rows[0][k].numpy(), rows[1][k].numpy(), err_msg=k)
    for (k, a), (_, b) in zip(_flat(pools[0]), _flat(pools[1])):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)


SPILL_KW = dict(slots=2, bucket=24, max_new_tokens=4, segment=2, prefill_chunk=4,
                page_size=4, n_pages=16)


def test_host_pool_spill_and_store(tmp_path):
    """test_demote_promote_matches_jax's workloads on the parked pool: the
    dense engine's tokens, demotions and promotions; the store saved from
    the parked pool restores into a JAX engine and into a port engine
    with a parked pool, which serve workload A alike from its prefix."""
    jc, tc, jparams, tparams = _model("llama3.2-1b")
    wl_a, wl_b = _spill_workloads(jc.vocab_size)
    kw = {k: v for k, v in SPILL_KW.items() if k not in ("page_size", "n_pages")}
    dense = DL.ServeEngine(tc, tparams, **kw)
    eng = PG.PagedServeEngine(tc, tparams, spill_pages=32, n_host_chunks=2, **SPILL_KW)
    refs = {}
    for i, wl in enumerate((wl_a, wl_b, wl_a)):
        refs.setdefault(i % 2, dense.generate(wl))
        assert eng.generate(wl) == refs[i % 2]
    assert eng.last_stats["spill_promotes"] > 0 and eng.kv.spilled_pages > 0
    store = str(tmp_path / "kv.npz")
    saved = eng.save_kv_store(store)
    fresh = PG.PagedServeEngine(tc, tparams, spill_pages=64, n_host_chunks=2, **SPILL_KW)
    jfresh = JPG.PagedServeEngine(jc, jparams, spill_pages=64, **SPILL_KW)
    assert fresh.restore_kv_store(store) == jfresh.restore_kv_store(store) == saved > 0
    assert fresh.generate(wl_a) == jfresh.generate(wl_a) == refs[0]
    assert _stats(fresh) == _stats(jfresh) and fresh.last_stats["spill_promotes"] > 0


def _spill_workloads(vocab):
    rng = np.random.default_rng(11)
    shared = rng.integers(0, vocab, size=16).tolist()
    wl_a = [shared + rng.integers(0, vocab, size=k).tolist() for k in (3, 5)]
    wl_b = [rng.integers(0, vocab, size=20).tolist() for _ in range(3)]
    return wl_a, wl_b


def test_demote_promote_matches_jax(tmp_path):
    """tests/test_paged.py::test_spill_demote_promote_engine_parity: a tight
    pool demotes workload A's radix pages while B runs and re-serving A
    promotes them: JAX's tokens, stats, tree and spill payloads after each
    workload, the dense engine's tokens; the port's store of the result
    restores into a fresh port engine and a fresh JAX engine, which serve
    A from it alike (the first wave's prefix promoted from the tier)."""
    jc, tc, jparams, tparams = _model("llama3.2-1b")
    wl_a, wl_b = _spill_workloads(jc.vocab_size)
    kw = {k: v for k, v in SPILL_KW.items() if k not in ("page_size", "n_pages")}
    dense = DL.ServeEngine(tc, tparams, **kw)
    eng = PG.PagedServeEngine(tc, tparams, spill_pages=32, **SPILL_KW)
    jeng = JPG.PagedServeEngine(jc, jparams, spill_pages=32, **SPILL_KW)
    for wl in (wl_a, wl_b, wl_a):
        got = eng.generate(wl)
        assert got == jeng.generate(wl) == dense.generate(wl)
        assert _stats(eng) == _stats(jeng)
        assert _tree_dump(eng.kv.radix) == _tree_dump(jeng.kv.radix)
    assert eng.last_stats["spill_promotes"] > 0 and eng.last_stats["prefix_hit_tokens"] >= 16
    for k, buf in jeng.kv.spill.data.items():
        used = [sid for *_, sid, _ in _tree_dump(jeng.kv.radix) if sid >= 0]
        np.testing.assert_allclose(eng.kv.spill.data[k].numpy()[used], buf[used], rtol=TOL,
                                   atol=TOL, err_msg=k)
    store = str(tmp_path / "kv.npz")
    saved = eng.save_kv_store(store)
    assert saved == eng.kv.radix.pages + eng.kv.spilled_pages > 0
    assert eng.telemetry.registry.value("kvstore_saved_pages") == saved
    fresh = PG.PagedServeEngine(tc, tparams, spill_pages=64, **SPILL_KW)
    jfresh = JPG.PagedServeEngine(jc, jparams, spill_pages=64, **SPILL_KW)
    assert fresh.restore_kv_store(store) == jfresh.restore_kv_store(store) == saved
    assert fresh.kv.spilled_pages == saved
    got = fresh.generate(wl_a)
    assert got == jfresh.generate(wl_a) == dense.generate(wl_a)
    assert _stats(fresh) == _stats(jfresh)
    assert fresh.last_stats["prefix_hit_tokens"] >= 16 and fresh.last_stats["spill_promotes"] > 0
    with pytest.raises(ValueError, match="page_size"):
        PG.PagedServeEngine(tc, tparams, spill_pages=8,
                            **dict(SPILL_KW, page_size=8, prefill_chunk=8)).restore_kv_store(store)
    with pytest.raises(ValueError, match="spill"):
        PG.PagedServeEngine(tc, tparams, **SPILL_KW).restore_kv_store(store)
    bare = PG.PagedCacheManager(8, 4)
    bare.begin(1, 4)
    bare.admit(0, list(range(8)), 0)
    bare.complete_prefill(0, list(range(8)))
    with pytest.raises(ValueError, match="read_page"):
        bare.save(str(tmp_path / "bare.npz"))


def test_engines_take_requests():
    """Every engine's generate takes Requests as well as raw prompts."""
    _, tc, _, tparams = _model("llama3.2-1b")
    prompts = _prompts(tc.vocab_size, (3, 7, 5), 4)
    reqs = [DL.Request(tokens=tuple(p), priority=i) for i, p in enumerate(prompts)]
    kw = dict(slots=2, bucket=8, max_new_tokens=3, segment=2)
    for eng in (DL.ServeEngine(tc, tparams, prefill_chunk=4, **kw),
                DL.BlockingServeEngine(tc, tparams, **kw),
                PG.PagedServeEngine(tc, tparams, prefill_chunk=4, page_size=4, **kw)):
        assert eng.generate(reqs) == eng.generate(prompts)
    assert DL.as_request(prompts[0]) == DL.Request(tokens=tuple(prompts[0]))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


PAGED_ARGV = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--engine", "--batch",
              "2", "--prompt-len", "16", "--gen", "4", "--requests", "5", "--segment", "2",
              "--prefill-chunk", "4", "--page-size", "4", "--shared-prefix", "8"]


def test_cli_paged_on_cpu(tmp_path, capsys):
    """--paged: the dense engine's tokens, the pool's figures printed;
    --kv-store saves after the run and a second run restores it and hits
    the stored prefixes; --sched slo and fifo give the same tokens."""
    dense = CLI.main(PAGED_ARGV)["outs"]
    capsys.readouterr()
    store = str(tmp_path / "kv.npz")
    run = CLI.main([*PAGED_ARGV, "--paged", "--kv-store", store])
    text = capsys.readouterr().out
    assert run["outs"] == dense and run["name"].startswith("paged pool (page_size=4")
    assert "paged pool: prefix hits" in text and "saved" in text and "spill tier:" in text
    again = CLI.main([*PAGED_ARGV, "--paged", "--kv-store", store, "--spill-pages", "32"])
    text = capsys.readouterr().out
    assert again["outs"] == dense and "[kv-store] restored" in text
    assert again["engine"].last_stats["spill_promotes"] > 0
    outs = {}
    for sched in ("slo", "fifo"):
        r = CLI.main([*PAGED_ARGV, "--paged", "--sched", sched, "--prefill-budget", "1"])
        outs[sched] = r["outs"]
        assert f"scheduler [{sched}]" in capsys.readouterr().out
    assert outs["slo"] == outs["fifo"] == dense


@pytest.mark.parametrize("argv, code, msg", [
    (["--paged", "--host-kv-chunks", "4"], 2, "host-streamed page pool is not yet ported"),
    (["--sched", "slo"], 2, "--sched requires --paged")])
def test_cli_paged_refusals(capsys, argv, code, msg):
    """--sched without --paged exits as the JAX CLI does; --paged
    --host-kv-chunks, once refused, serves the device pool's tokens and
    prints the parked pool's bytes and the pages fetched."""
    if "--host-kv-chunks" in argv:
        run = CLI.main([*PAGED_ARGV, *argv])
        text = capsys.readouterr().out
        assert run["outs"] == CLI.main([*PAGED_ARGV, "--paged"])["outs"]
        st = run["engine"].last_stats
        assert (f"host KV: {st['host_kv_bytes']} B parked on the host, {st['host_kv_pages']} "
                "pages fetched") in text and st["host_kv_pages"] > 0
        return
    with pytest.raises(SystemExit) as ex:
        CLI.main([*PAGED_ARGV, *argv])
    assert ex.value.code == code
    assert msg in capsys.readouterr().err


@pytest.mark.parametrize("page_size, hkv, n_pages, dim", [
    (2, 1, 4, None),  # no dim divides the 4 ranks: kept on the device
    (2, 1, 7, 0),  # the model slice's one entry and one head: its 8 pages over data
    (4, 1, 4, 1),  # 4 entries, 2 a model rank: 1 a data rank
    (2, 4, 4, 2),  # 4 heads, 2 a model rank: 1 a data rank
])
def test_parked_pool_share_on_a_mesh(page_size, hkv, n_pages, dim):
    """On a 2 x 2 mesh a rank parks its data share of its model slice of the
    pool along the in-page positions, else the kv heads, else the pages (the
    JAX ``_offload_pool``'s order; ``pool_share_dim``); a pool none of whose
    dims divides the mesh's 4 ranks stays on the device at its model slice,
    as the JAX package keeps it, with one warning naming the dims, and
    parks nothing."""
    from repro_torch.core.parallel import ParallelContext
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as T
    from repro_torch.runtime import placement as PL

    cfg = dataclasses.replace(reduced(get_config("llama3.2-1b")), param_dtype="float32",
                              num_kv_heads=hkv)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    par = ParallelContext(Mesh(2, 2, 0, "gloo", None, None))
    kw = dict(slots=2, bucket=4, max_new_tokens=2, page_size=page_size, n_pages=n_pages,
              prefill_chunk=2, n_host_chunks=2, par=par)
    whole = (n_pages + 1, page_size, hkv, cfg.head_dim)
    model = 2 if hkv % 2 == 0 else 1  # kv heads over model, else in-page positions
    want = list(whole)
    want[model] //= 2
    if dim is None:
        PL._WARNED.clear()
        with pytest.warns(RuntimeWarning, match="the pool stays in device memory") as rec:
            eng = PG.PagedServeEngine(cfg, params, **kw)
            PG.PagedServeEngine(cfg, params, **kw)  # once a process
        assert len(rec) == 1 and "page_size=2" in str(rec[0].message)
        assert "kv_heads=1" in str(rec[0].message) and "pages+1=5" in str(rec[0].message)
        assert eng.pool_on_device and eng.n_host_chunks == 0 and eng.slab_chunks == 2
        meta = SV.init_paged_cache(cfg, 2, n_pages, page_size, "meta")
        assert SV.rank_cache_bytes(cfg, 2, 2, meta, 2)[1] == 0
    else:
        want[dim] //= 2
        eng = PG.PagedServeEngine(cfg, params, **kw)
        assert not eng.pool_on_device
    assert tuple(eng._pool["pos0"]["pk"].shape[1:]) == tuple(want)
    assert SV.pool_share_dim(2, 2, page_size, hkv, n_pages + 1) == (
        SV.POOL_ON_DEVICE if dim is None else dim)
