"""The port's mesh, collectives and data sharding (``core/parallel.py``,
``launch/mesh.py``, ``data/pipeline.py::shard_batch``).

One spawn of 8 gloo ranks on the CPU (``tests/_torch_dist.py``, torch
only) builds ``make_mesh(2, 4)``; its rank grid and groups must be the
device order of the JAX package's ``make_compat_mesh((2, 4), ("data",
"model"))`` (read in a subprocess with 8 host devices), and every
collective must give what it is defined to give on a model group (4 ranks)
and a data group (2), with ``seq_to_heads`` and ``heads_to_seq`` inverting
each other, ``gather_spans`` putting every rank's spans in global order
and its backward summing each rank's block, ``gather_counts`` stacking
every rank's integer counts in rank order, ``all_reduce_max`` the
elementwise maximum, ``gather_params``
concatenating every rank's shard along its split dimension and its
backward summing each rank's block, and the call and byte counts as
written.  ``shard_batch`` must
cover every token of the global batch exactly once, at the global
positions of the chunk-interleaved layout that FPDT ropes with."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_dist import ROOT, run_ranks
from repro_torch.configs import get_config, reduced
from repro_torch.core import fpdt as F
from repro_torch.core.parallel import ParallelContext
from repro_torch.data.pipeline import shard_batch, token_positions
from repro_torch.launch.mesh import Mesh, parse_mesh


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("parallel", 8, tmp_path_factory.mktemp("parallel"))


@pytest.fixture(scope="module")
def jax_grid():
    """Device ids of make_compat_mesh((2, 4)) over 8 host devices."""
    code = ("import json; from repro.launch.mesh import make_compat_mesh; "
            "m = make_compat_mesh((2, 4), ('data', 'model')); "
            "print(json.dumps([[d.id for d in row] for row in m.devices]))")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_mesh_rank_order_is_the_jax_device_order(ranks, jax_grid):
    for r, got in enumerate(ranks):
        assert got["ranks"] == jax_grid
        d, m = got["data_rank"], got["model_rank"]
        assert jax_grid[d][m] == r
        assert got["model_group"] == jax_grid[d]  # sequence-parallel: one data row
        assert got["data_group"] == [row[m] for row in jax_grid]


@pytest.mark.parametrize("group", ["model", "data"])
@pytest.mark.parametrize("what", ["seq_to_heads", "heads_to_seq inverts it", "gather_seq",
                                  "reduce_scatter_seq", "all_reduce_sum", "all_reduce_max",
                                  "gather_spans",
                                  "gather_spans adjoint", "gather_counts", "gather_params",
                                  "gather_params adjoint", "counts"])
def test_collectives(ranks, group, what):
    assert all(r["ok"][f"{group} {what}"] for r in ranks)


def _par(data, model, rank):
    return ParallelContext(Mesh(data, model, rank, "gloo", None, None))


@pytest.mark.parametrize("shape", [(1, 1), (1, 4), (2, 2), (2, 4)])
@pytest.mark.parametrize("u", [1, 4])
def test_shard_batch_covers_every_token_once(shape, u):
    data, model = shape
    b, s = 4, 32
    pos = np.broadcast_to(np.arange(s), (b, s))
    batch = {"tokens": pos + 1000 * np.arange(b)[:, None], "labels": pos.copy()}
    seen = np.zeros((b, s), dtype=int)
    for r in range(data * model):
        par = _par(data, model, r)
        part = shard_batch(batch, par, u)
        rows, cols = part["tokens"] // 1000, part["tokens"] % 1000
        assert part["tokens"].shape == (b // data, s // model)
        np.testing.assert_array_equal(part["labels"], cols)
        assert (rows == np.arange(par.dp_rank * (b // data), (par.dp_rank + 1) * (b // data))
                [:, None]).all()
        np.add.at(seen, (rows, cols), 1)
        # the layout: C/sp tokens of each chunk, model rank m the m-th block
        chunk, c = s // u, s // u // model
        want = [i * chunk + par.sp_rank * c + t for i in range(u) for t in range(c)]
        assert cols[0].tolist() == want == token_positions(s, model, par.sp_rank, u).tolist()
    assert (seen == 1).all()


@pytest.mark.parametrize("model", [1, 2, 4])
def test_fpdt_ropes_at_the_layout_positions(model):
    """FPDT's per-chunk positions on each rank are shard_batch's."""
    cfg = reduced(get_config("llama3.2-1b"))
    s, u = 64, 4
    for m in range(model):
        par = _par(1, model, m)
        kind = "local" if model == 1 else "ulysses"
        plan = F._Plan(cfg, 0, 0, u, s // u, None, kind, par if model > 1 else None)
        got = torch.cat([plan.positions(i, "cpu") for i in range(u)]).tolist()
        assert got == token_positions(s, model, m, u).tolist()


def test_parse_mesh():
    assert parse_mesh("host8") == (2, 4)
    assert parse_mesh("1x2") == (1, 2)
    for bad in ("2", "0x4", "axb"):
        with pytest.raises(ValueError):
            parse_mesh(bad)


@pytest.mark.parametrize("hq,hkv,sp,want", [
    (4, 2, 4, [(0,), (0,), (1,), (1,)]),  # one kv head a rank
    (16, 1, 2, [(0,), (0,)]),  # the hybrid's MQA
    (8, 2, 4, [(0,), (0,), (1,), (1,)]),
    # ragged: where a rank's q heads straddle kv heads unevenly, one a q head
    (12, 3, 4, [(0,), (0, 1, 1), (1, 1, 2), (2,)]),
])
def test_kv_heads_read(hq, hkv, sp, want):
    assert [F.kv_heads_read(hq, hkv, sp, m) for m in range(sp)] == want
