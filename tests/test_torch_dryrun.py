"""The port's dry-run (``launch/{steps, specs, dryrun}.py`` and the shape set
of ``configs``) against the JAX package's, with no compile on either side.

Held, for every arch x shape cell the JAX sweep runs (``ASSIGNED_ARCHS``
x ``SHAPES`` where ``shape_applicable``) on JAX's production meshes,
single dp 16 x sp 16 and multi dp 32 (pod x data) x sp 16:

* the shape set, ``shape_applicable`` and the arch list equal JAX's;
* ``tuned_config`` equals JAX's (u, offload, mlp_chunks) for every cell
  and under ``chunks`` / ``offload`` overrides;
* ``input_specs``'s meta tensors equal JAX's ``input_specs``
  ``ShapeDtypeStruct`` leaf for leaf, by path, shape and dtype, the decode
  caches included; ``params_spec`` and ``opt_spec`` are the JAX trees;
* a training rank's reckoned ``param_bytes`` equal its bytes under JAX's
  ``param_spec`` (called with a stub context, as
  tests/test_torch_shardings.py does; dp_axes ("pod", "data") on multi),
  and a serve rank's the whole tree's;
* a serve rank's ``cache_bytes`` equal its bytes under JAX's
  ``cache_shardings``, and for llama3.2-1b's ``long_500k`` host-KV cell its
  ``host_cache_bytes`` equal JAX's host spec (S over every axis): the
  cache's k and v over 256 ranks (single), 512 (multi);
* the CLI writes, for every cell (and for one under ``--chunks
  --offload``), JAX's file name and the config keys JAX's ``run_cell``
  derives (its own code, run with a stub in place of the lower and compile);
  ``--all --mesh both`` exits 0 with 66 records, all ok;
* ``data/pipeline.make_batch_fn``'s batch matches ``input_specs`` at a
  reduced config.
"""
import ast
import dataclasses
import functools
import json
import math
import os
import time
import traceback
import types
from pathlib import Path

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.launch import shardings as JSH
from repro.launch import specs as JSP
from repro.launch import steps as JST
from repro.models import serve as JSV
from repro.optim import adamw as JADAMW
from repro_torch import configs
from repro_torch.data import pipeline as DP
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as SP
from repro_torch.launch import steps as ST
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_leaves_with_path

ROOT = Path(__file__).resolve().parent.parent
CELLS = [(a, s) for a in jconfigs.ASSIGNED_ARCHS for s in jconfigs.SHAPES
         if jconfigs.shape_applicable(a, s)]
MESHES = {"single": ("data", 16, 16), "multi": (("pod", "data"), 32, 16)}
CONFIG_KEYS = ("arch", "shape", "mesh", "kind", "chunks", "offload", "n_host_chunks", "seq_len",
               "global_batch", "params", "active_params")


def _key(p) -> str:
    return str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))


def _jax_leaves(tree):
    """{path: (shape, dtype name)} of a JAX tree of ShapeDtypeStructs."""
    return {"/".join(_key(p) for p in path): (tuple(x.shape), np.dtype(x.dtype).name)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree):
    return {"/".join(path): (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for path, t in tree_leaves_with_path(tree)}


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    """JAX's parameter tree of ``arch`` at size (``jax.eval_shape``)."""
    return JSP.params_spec(jconfigs.get_config(arch))


def _stub(mesh):
    dp_axes, dp, sp = MESHES[mesh]
    return types.SimpleNamespace(dp_axes=dp_axes, dp=dp, sp_axis="model", sp=sp, ns=_Spec)


class _Spec:
    def __init__(self, *axes):
        self.axes = axes


def _rank_bytes(leaf, axes, mesh) -> int:
    """A rank's bytes of ``leaf`` under spec entries ``axes``."""
    dp_axes, dp, sp = MESHES[mesh]
    shape = list(leaf.shape)
    for i, a in enumerate(axes):
        if a is not None:
            shape[i] //= sp if a == "model" else dp
    return math.prod(shape) * np.dtype(leaf.dtype).itemsize


@functools.lru_cache(maxsize=None)
def _reckoned(arch, shape, mesh):
    cfg = ST.tuned_config(configs.get_config(arch), configs.SHAPES[shape])
    _, dp, sp = MESHES[mesh]
    n = D.host_kv_chunks(cfg, configs.SHAPES[shape], None)
    return D.reckon(cfg, configs.SHAPES[shape], dp, sp, n)


def test_shape_set_is_jax_s():
    assert configs.SHAPES.keys() == jconfigs.SHAPES.keys()
    for name, s in configs.SHAPES.items():
        assert dataclasses.astuple(s) == dataclasses.astuple(jconfigs.SHAPES[name])
    assert configs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert configs.LONG_CTX_ARCHS == jconfigs.LONG_CTX_ARCHS
    assert configs.EXTRA_LONG_CTX_ARCHS == jconfigs.EXTRA_LONG_CTX_ARCHS
    for a in jconfigs.list_configs():
        for s in jconfigs.SHAPES:
            assert configs.shape_applicable(a, s) == jconfigs.shape_applicable(a, s)
    assert len(CELLS) == 33


OVERRIDES = ((None, None), (4, None), (4, False), (3, True), (1, True), (7, None))


@pytest.mark.parametrize("arch, shape", CELLS)
def test_tuned_config_is_jax_s(arch, shape):
    for chunks, offload in OVERRIDES:
        got = ST.tuned_config(configs.get_config(arch), configs.SHAPES[shape], chunks, offload)
        want = JST.tuned_config(jconfigs.get_config(arch), jconfigs.SHAPES[shape], chunks,
                                offload)
        for f in ("fpdt_chunks", "fpdt_offload", "mlp_chunks"):
            assert getattr(got, f) == getattr(want, f), (chunks, offload, f)
        assert got.num_params() == want.num_params()


@pytest.mark.parametrize("arch, shape", CELLS)
def test_input_specs_are_jax_s(arch, shape):
    cfg = ST.tuned_config(configs.get_config(arch), configs.SHAPES[shape])
    jc = JST.tuned_config(jconfigs.get_config(arch), jconfigs.SHAPES[shape])
    kind, got = SP.input_specs(cfg, configs.SHAPES[shape])
    jkind, want = JSP.input_specs(jc, jconfigs.SHAPES[shape])
    assert kind == jkind
    assert all(t.device.type == "meta" for t in tree_leaves(got))
    assert _port_leaves(got) == _jax_leaves(want)


@pytest.mark.parametrize("arch", jconfigs.ASSIGNED_ARCHS)
def test_params_and_opt_specs_are_jax_s(arch):
    cfg = configs.get_config(arch)
    params = SP.params_spec(cfg)
    assert _port_leaves(params) == _jax_leaves(_jax_params(arch))
    opt = SP.opt_spec(cfg, adamw.OptConfig(state_dtype=cfg.opt_state_dtype), params)
    jc = jconfigs.get_config(arch)
    want = JSP.opt_spec(jc, JADAMW.OptConfig(state_dtype=jc.opt_state_dtype), _jax_params(arch))
    for field in ("step", "m", "v"):
        assert _port_leaves({field: getattr(opt, field)}) == _jax_leaves(
            {field: getattr(want, field)})
    assert all(t.device.type == "meta" for t in tree_leaves([opt.step, opt.m, opt.v]))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch, shape", CELLS)
def test_param_bytes_are_param_spec_s(arch, shape, mesh):
    """A training rank holds its shards under JAX's ``param_spec`` (ZeRO-3);
    a serve rank the whole tree."""
    stub = _stub(mesh)
    train = configs.SHAPES[shape].kind == "train"
    want = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(_jax_params(arch))[0]:
        names = [_key(p) for p in path]
        axes = tuple(JSH.param_spec(None, stub, names, leaf)) if train else ()
        want += _rank_bytes(leaf, axes, mesh)
    assert _reckoned(arch, shape, mesh)["param_bytes"] == want


SERVE = [(a, s) for a, s in CELLS if jconfigs.SHAPES[s].kind != "train"]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch, shape", SERVE)
def test_cache_bytes_are_cache_shardings(arch, shape, mesh):
    """A serve rank's device cache is its shard under JAX's
    ``cache_shardings``; the long_500k host-KV cell's k and v are parked
    as JAX's host spec places them, S over every axis."""
    jc = JST.tuned_config(jconfigs.get_config(arch), jconfigs.SHAPES[shape])
    s = jconfigs.SHAPES[shape]
    cache = jax.eval_shape(lambda: JSV.init_cache(jc, s.global_batch, s.seq_len))
    specs = jax.tree_util.tree_flatten_with_path(
        JSV.cache_shardings(jc, _stub(mesh), cache), is_leaf=lambda x: isinstance(x, _Spec))[0]
    leaves = jax.tree_util.tree_flatten_with_path(cache)[0]
    got = _reckoned(arch, shape, mesh)
    host = (arch, shape) == ("llama3.2-1b", "long_500k")
    parked = ("k", "v") if host else ()
    _, dp, sp = MESHES[mesh]
    dev = sum(_rank_bytes(x, sp_.axes, mesh) for (p, x), (_, sp_) in zip(leaves, specs)
              if _key(p[-1]) not in parked)
    whole = sum(math.prod(x.shape) * np.dtype(x.dtype).itemsize for p, x in leaves
                if _key(p[-1]) in parked)
    assert got["cache_bytes"] == dev
    # JAX's host spec (src/repro/launch/steps.py:93-109): S over every axis
    # where the leaf's S divides the mesh, else whole
    assert got["host_cache_bytes"] == whole // (dp * sp)
    if host:
        assert got["host_cache_bytes"] > 0 and whole == got["host_cache_bytes"] * (
            256 if mesh == "single" else 512)


def _jax_run_cell():
    """JAX's own ``run_cell`` (src/repro/launch/dryrun.py), compiled from its
    source with a stub ``build`` that refuses: it derives the record's config
    keys and writes its file, and lowers and compiles nothing.  The module
    itself is not imported: it sets XLA_FLAGS and a compilation cache at
    import."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    mod = ast.Module(body=[fn], type_ignores=[])

    def build(*a, **k):
        raise RuntimeError("not compiled")

    ns = {"os": os, "json": json, "time": time, "traceback": traceback, "jax": jax,
          "get_config": jconfigs.get_config, "dp_axes_of": lambda m: (),
          "make_production_mesh": lambda multi_pod: types.SimpleNamespace(
              devices=np.array([None], dtype=object)),
          "PlacementPolicy": types.SimpleNamespace(probe=lambda *a, **k: None),
          "ParallelContext": lambda **k: None,
          "ST": types.SimpleNamespace(tuned_config=JST.tuned_config, build=build),
          "print": lambda *a, **k: None}
    exec(compile(mod, "dryrun.py", "exec"), ns)
    return ns["run_cell"]


def _records(d):
    return {p.name: json.loads(p.read_text()) for p in Path(d).glob("*.json")}


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    out = tmp_path_factory.mktemp("dry")
    with pytest.raises(SystemExit) as e:
        D.main(["--all", "--mesh", "both", "--out", str(out)])
    return e.value.code, _records(out)


def test_all_cells_ok(sweep):
    code, recs = sweep
    assert code == 0
    assert len(recs) == 66 and all(r["ok"] for r in recs.values())
    for r in recs.values():
        assert r["reckon_s"] >= 0 and set(r["reckoned"]) >= {"param_bytes", "input_bytes"}
        if r["kind"] == "train":
            red = r["reckoned"]
            assert red["peak_bytes"] > red["param_bytes"] + red["opt_state_bytes"]
            assert red["model_flops"] > 6 * r["active_params"] * r["seq_len"]
            assert red["collectives"]["gather_params"]["count"] > 0


def test_file_names_and_config_keys_are_jax_s(sweep, tmp_path):
    """Every cell's record: JAX's file name and JAX's config keys."""
    _, recs = sweep
    run_cell = _jax_run_cell()
    for arch, shape in CELLS:
        for mp in (False, True):
            run_cell(arch, shape, mp, outdir=str(tmp_path))
    jax_recs = _records(tmp_path)
    assert sorted(recs) == sorted(jax_recs)
    for name, want in jax_recs.items():
        assert not want["ok"] and "not compiled" in want["error"]
        assert {k: recs[name][k] for k in CONFIG_KEYS} == {k: want[k] for k in CONFIG_KEYS}


def test_cli_one_cell_with_overrides(tmp_path, capsys):
    """One cell through the CLI with ``--chunks --offload``: JAX's file
    names (the ``_u4off`` suffix) and keys, one status line a mesh."""
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "llama3.2-1b", "--shape", "long_500k", "--chunks", "4", "--offload",
                "--out", str(ours)])
    assert e.value.code == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert sum(x.startswith("[OK ]") for x in lines) == 2 and lines[-1] == "2 ok, 0 failed"
    run_cell = _jax_run_cell()
    for mp in (False, True):
        run_cell("llama3.2-1b", "long_500k", mp, chunks=4, offload=True, outdir=str(theirs))
    got, want = _records(ours), _records(theirs)
    assert sorted(got) == sorted(want) == ["llama3.2-1b_long_500k_multi_u4off.json",
                                          "llama3.2-1b_long_500k_single_u4off.json"]
    for name in got:
        assert {k: got[name][k] for k in CONFIG_KEYS} == {k: want[name][k] for k in CONFIG_KEYS}
        assert got[name]["n_host_chunks"] == 4


def test_chunks_not_dividing_the_cache_raise_jax_s_error(tmp_path):
    with pytest.raises(ValueError, match="does not divide the decode cache length") as e:
        D.run_cell("llama3.2-1b", "long_500k", False, chunks=3, outdir=str(tmp_path))
    with pytest.raises(ValueError) as j:
        _jax_run_cell()("llama3.2-1b", "long_500k", False, chunks=3, outdir=str(tmp_path))
    assert str(e.value).split(";")[0] == str(j.value).split(";")[0]


@pytest.mark.parametrize("arch", jconfigs.ASSIGNED_ARCHS)
def test_batches_match_input_specs(arch):
    """``make_batch_fn``'s batch has ``input_specs``'s keys and shapes (and its
    integer dtypes; the frontends' stub embeddings are fp32, cast by the
    model) at a reduced config."""
    cfg = configs.reduced(configs.get_config(arch))
    for kind in ("train", "prefill"):
        shape = configs.ShapeConfig("t", 64, 2, kind)
        _, specs = SP.input_specs(cfg, shape)
        batch = DP.make_batch_fn(cfg, configs.ShapeConfig("t", 64, 2, "train"))(0)
        if kind == "prefill":
            batch.pop("labels")
        assert sorted(batch) == sorted(specs["batch"])
        for k, t in specs["batch"].items():
            assert batch[k].shape == tuple(t.shape), (k, batch[k].shape)
            if not t.dtype.is_floating_point:
                assert str(batch[k].dtype) == str(t.dtype).replace("torch.", "")
