"""The port's meshes (``edl_tpu_torch/parallel/mesh.py``) against the
JAX package's: ``MeshSpec.resolve``/``resolve_hybrid`` and
``dcn_axis_of`` over a grid of specs and topologies (the same sizes, or
the same error), the rank grid of the flat and the hybrid meshes (the JAX
mesh's device order, on conftest's virtual CPU devices, device i standing
for rank i), each rank's coordinates on it, and the batch slice a rank
takes (``shard_batch``), which is the one ``P(("dp", "fsdp"))`` places on
its device."""

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding

from edl_tpu.parallel import mesh as jmesh
from edl_tpu_torch.parallel import mesh as tmesh

SPECS = [{"dp": -1}, {"fsdp": -1}, {"dp": 2, "fsdp": -1},
         {"dp": -1, "tp": 2}, {"ep": -1}, {"dp": 4}, {"dp": -1, "fsdp": -1},
         {"fsdp": 2, "tp": 2}, {"dp": 3, "fsdp": -1}, {"ep": 2, "dp": -1}]
TOPOLOGIES = [(1, 8), (2, 4), (4, 2), (8, 1), (2, 2), (3, 2)]


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as exc:
        return ("error", str(exc))


@pytest.mark.parametrize("axes", SPECS, ids=str)
@pytest.mark.parametrize("n", [1, 2, 4, 8, 6])
def test_resolve_is_the_jax_package_s(axes, n):
    assert _outcome(lambda: tmesh.MeshSpec(axes).resolve(n)) == _outcome(
        lambda: jmesh.MeshSpec(axes).resolve(n))


@pytest.mark.parametrize("axes", SPECS, ids=str)
@pytest.mark.parametrize("topo", TOPOLOGIES, ids=str)
def test_resolve_hybrid_is_the_jax_package_s(axes, topo):
    got = _outcome(lambda: tmesh.MeshSpec(axes).resolve_hybrid(
        tmesh.SliceTopology(*topo)))
    want = _outcome(lambda: jmesh.MeshSpec(axes).resolve_hybrid(
        jmesh.SliceTopology(*topo)))
    assert got == want
    assert tmesh.dcn_axis_of(axes) == jmesh.dcn_axis_of(axes)


def _ids(mesh) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(mesh.devices)


@pytest.mark.parametrize("axes,topo", [
    ({"dp": -1}, (2, 4)), ({"dp": -1, "fsdp": 2}, (2, 4)),
    ({"fsdp": 2, "dp": -1}, (4, 2)), ({"ep": -1}, (2, 4)),
    ({"dp": 2, "tp": -1}, (2, 4)), ({"dp": -1}, (1, 8))], ids=str)
def test_rank_grid_and_coordinates_are_the_jax_mesh_s(axes, topo):
    devices = jax.devices()[:8]
    want = (jmesh.make_hybrid_mesh(jmesh.MeshSpec(axes),
                                   jmesh.SliceTopology(*topo), devices)
            if topo[0] > 1 else jmesh.make_mesh(jmesh.MeshSpec(axes),
                                                devices=devices))
    spec = tmesh.MeshSpec(axes)
    if topo[0] > 1:
        grid, names = tmesh.hybrid_device_grid(
            spec, tmesh.SliceTopology(*topo), list(range(8)))
    else:
        sizes = spec.resolve(8)
        grid = np.arange(8).reshape(tuple(sizes.values()))
        names = tuple(sizes)
    ids = _ids(want)
    assert names == tuple(want.axis_names)
    np.testing.assert_array_equal(grid, ids)
    for rank in range(8):
        m = tmesh.Mesh(grid, names, rank=rank)
        where = tuple(int(i) for i in np.argwhere(ids == rank)[0])
        assert tuple(m.coords[a] for a in names) == where
        assert m.shape == dict(want.shape)


@pytest.mark.parametrize("axes", [{"dp": -1}, {"fsdp": -1},
                                  {"dp": 2, "fsdp": -1},
                                  {"fsdp": 2, "dp": -1},
                                  {"dp": 2, "tp": -1}], ids=str)
def test_shard_batch_takes_the_rows_jax_places_on_the_rank(axes):
    jm = jmesh.make_mesh(jmesh.MeshSpec(axes), devices=jax.devices()[:8])
    batch = {"x": np.arange(16 * 3, dtype=np.float32).reshape(16, 3)}
    placed = jmesh.shard_batch(jm, batch)["x"]
    by_device = {s.device.id: np.asarray(s.data)
                 for s in placed.addressable_shards}
    sizes = tmesh.MeshSpec(axes).resolve(8)
    grid = np.arange(8).reshape(tuple(sizes.values()))
    for rank in range(8):
        m = tmesh.Mesh(grid, tuple(sizes), rank=rank)
        got = tmesh.shard_batch(m, batch)["x"].numpy()
        np.testing.assert_array_equal(got, by_device[rank])
    assert tmesh.dp_size(tmesh.Mesh(grid, tuple(sizes))) == jmesh.dp_size(jm)
    assert isinstance(jmesh.data_sharding(jm), NamedSharding)


def test_a_world_of_one_is_a_mesh_of_one_rank():
    m = tmesh.make_mesh(tmesh.MeshSpec({"dp": -1}))
    assert m.size == 1 and m.coords == {"dp": 0} and m.group("dp") is None
    assert tmesh.make_hybrid_mesh(tmesh.MeshSpec({"fsdp": -1})).shape == {
        "fsdp": 1}
    batch = {"x": np.ones((4, 2), np.float32)}
    assert tmesh.form_global_batch(m, batch)["x"].shape == (4, 2)
    assert tmesh.replicate_host_tree(m, batch)["x"].shape == (4, 2)
    with pytest.raises(ValueError, match="over a world of 1"):
        tmesh.make_mesh(tmesh.MeshSpec({"dp": 2}), devices=[0, 1])
