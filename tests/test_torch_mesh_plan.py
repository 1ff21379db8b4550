"""MeshPlan placement and make_mesh against the JAX package's, on the
conftest's virtual 8-device CPU mesh.

The JAX plan places a state and a dataset on devices; the port's plan
answers, for the rank at the same grid position, which islands and which
rows it holds. They must agree block for block: the port's
``place_state`` / ``place_data`` of the same full state and data give
each JAX device's shard exactly. ``make_mesh`` refuses a shape that does
not fit the devices with the JAX package's message.
"""

import jax
import numpy as np
import pytest

import symbolicregression_jl_tpu as J
from symbolicregression_jl_tpu.evolve.engine import Engine as JEngine
from symbolicregression_jl_tpu.mesh import MeshPlan as JMeshPlan
from symbolicregression_jl_tpu.parallel.mesh import make_mesh as j_make_mesh
from symbolicregression_jl_tpu_torch import interop
from symbolicregression_jl_tpu_torch.mesh import MeshPlan
from symbolicregression_jl_tpu_torch.parallel.mesh import DATA_AXIS, ISLAND_AXIS, RankMesh
from symbolicregression_jl_tpu_torch.parallel.mesh import make_mesh

from torch_parity import numpy_state, to_np

ROWS = 48


@pytest.fixture(scope="module")
def jax_state():
    rng = np.random.default_rng(7)
    X = rng.uniform(-2, 2, (ROWS, 2)).astype(np.float32)
    y = (X[:, 0] * X[:, 1]).astype(np.float32)
    o = J.Options(binary_operators=["+", "*"], unary_operators=[], maxsize=6, populations=8,
                  population_size=4, tournament_selection_n=2, save_to_file=False)
    ds = J.make_dataset(X, y)
    ds.update_baseline_loss(o.elementwise_loss)
    return JEngine(o, 2).init_state(jax.random.key(0), ds.data, 8), ds


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_placement_matches_jax(shape, jax_state):
    assert len(jax.devices()) == 8, "conftest virtual mesh not engaged"
    a, b = shape
    js, ds = jax_state
    jplan = JMeshPlan.build(jax.devices(), n_island_shards=a, n_data_shards=b)
    placed = jplan.place_state(js)
    dplaced = jplan.place_data(ds.data)
    full = interop.search_state(numpy_state(js), device="cpu")
    pdata = interop.device_data(jax.tree.map(np.asarray, ds.data), device="cpu")
    grid = np.arange(8).reshape(a, b)
    dev_pos = {d.id: tuple(int(v) for v in np.argwhere(jplan.mesh.devices == d)[0])
               for d in jax.devices()}
    for shard in placed.pops.cost.addressable_shards:
        i, d = dev_pos[shard.device.id]
        plan = MeshPlan(mesh=RankMesh(grid=grid, rank=int(grid[i, d])), n_island_shards=a,
                        n_data_shards=b)
        assert (plan.island_index, plan.data_index) == (i, d)
        lo, hi = plan.islands_of(8)
        assert (shard.index[0].start or 0, shard.index[0].stop or 8) == (lo, hi)
        mine = plan.place_state(full)
        np.testing.assert_array_equal(mine.pops.cost.numpy(), np.asarray(shard.data))
        assert np.array_equal(mine.hof.cost.numpy(), to_np(js.hof.cost), equal_nan=True)
        for xs in dplaced.Xt.addressable_shards:
            if xs.device.id == shard.device.id:
                rlo, rhi = plan.rows_of(ROWS)
                assert (xs.index[1].start or 0, xs.index[1].stop or ROWS) == (rlo, rhi)
                if b > 1:
                    pd = plan_data(plan, pdata)
                    np.testing.assert_array_equal(pd.Xt.numpy(), np.asarray(xs.data))
                    assert pd.row_shard.n_rows == ROWS and pd.row_shard.count == b
    assert plan.describe()["axes"] == {ISLAND_AXIS: a, DATA_AXIS: b}
    assert jplan.describe()["axes"] == plan.describe()["axes"]
    if a > 1:
        vol = plan.exchange_bytes(plan.place_state(full))
        assert vol["pops_bytes"] > 0 and vol["best_seen_bytes"] > 0


def plan_data(plan, data):
    """place_data without a process group: the row block (its group is
    made only by a group's ranks)."""
    plan.mesh._groups = (None, None)
    plan.mesh._all = None
    return plan.place_data(data)


@pytest.mark.parametrize("shape", [(3, 2), (5, 1), (2, 3)])
def test_make_mesh_errors_match_jax(shape):
    with pytest.raises(ValueError) as jerr:
        j_make_mesh(jax.devices(), n_island_shards=shape[0], n_data_shards=shape[1])
    with pytest.raises(ValueError) as serr:
        make_mesh(list(range(8)), n_island_shards=shape[0], n_data_shards=shape[1])
    assert str(serr.value) == str(jerr.value)


def test_default_mesh_puts_every_rank_on_the_island_axis():
    m = make_mesh(list(range(8)))
    assert m.shape == {ISLAND_AXIS: 8, DATA_AXIS: 1}
    assert m.shape == dict(j_make_mesh(jax.devices()).shape)
    m2 = make_mesh(list(range(8)), n_data_shards=2)
    assert m2.coords(5) == (2, 1) and m2.ranks == tuple(range(8))
    with pytest.raises(ValueError, match="not in the mesh"):
        m2.coords(9)
