"""The port's parallel/multihost.py in a spawned world of 2 gloo ranks on
the CPU (tests/torch_mesh_world.py): the counterpart of
tests/test_multihost.py.  ``init`` a second time is a no-op;
``global_mesh`` puts the model axis across every rank, or the data axis
across hosts; ``from_global`` materialises only a rank's stripe, column
slice or copy of an ``np.load(mmap_mode="r")`` table and reads no other
rows; ``gather_to_host`` gives every rank every rank's piece."""

import numpy as np
import pytest

from recom_tpu.parallel.sharded_lookup import pad_rows_to_multiple, stripe_rows

from torch_mesh_world import World


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(2, tmp_path_factory.mktemp("multihost_world"))
    yield w
    w.close()


@pytest.mark.parametrize("rows", [10, 11])
def test_multihost_pieces_in_a_world_of_two(world, tmp_path, rows):
    rng = np.random.default_rng(rows)
    table = rng.standard_normal((rows, 6)).astype(np.float32)
    path = str(tmp_path / "table.npy")
    np.save(path, table)
    res = world.run("multihost", table_path=path, shape=(1, 2),
                    local_world=1)
    phys = stripe_rows(pad_rows_to_multiple(table, 2), 2)
    per = phys.shape[0] // 2
    for r, out in enumerate(res):
        assert out["shape"] == {"data": 1, "model": 2}
        # one rank a host: the data axis across the two hosts
        assert out["dp_shape"] == {"data": 2, "model": 1}
        assert out["coords"] == ((0, r), (r, 0))
        np.testing.assert_array_equal(out["replicated"]["part"], table)
        # a rank's stripe is stripe_rows' block r, read as one strided slice
        np.testing.assert_array_equal(out["striped"]["part"],
                                      phys[r * per:(r + 1) * per])
        assert out["striped"]["reads"] == [repr(slice(r, None, 2))]
        np.testing.assert_array_equal(out["columns"]["part"],
                                      table[:, 3 * r:3 * (r + 1)])
        np.testing.assert_array_equal(out["striped"]["gathered"], phys)
        np.testing.assert_array_equal(
            out["columns"]["gathered"],
            np.concatenate([table[:, :3], table[:, 3:]]))
        np.testing.assert_array_equal(out["replicated"]["gathered"],
                                      np.concatenate([table, table]))
        np.testing.assert_array_equal(out["by_mesh"], [0, 0, 1, 1])


def test_init_is_a_noop_once_a_group_exists_and_global_mesh_spans_ranks(
        world, tmp_path):
    np.save(str(tmp_path / "t.npy"), np.zeros((4, 2), np.float32))
    res = world.run("multihost", table_path=str(tmp_path / "t.npy"),
                    shape=(2, 1), local_world=2)
    for r, out in enumerate(res):
        # two ranks on one host: the host-split mesh is the model axis
        assert out["dp_shape"] == {"data": 1, "model": 2}
        assert out["coords"] == ((0, r), (0, r))
        # a (2, 1) mesh has no model split: every part is the whole table
        np.testing.assert_array_equal(out["striped"]["part"],
                                      np.zeros((4, 2), np.float32))


def test_from_global_rejects_an_unknown_layout():
    from recom_tpu_torch.parallel import multihost

    class FakeMesh:
        axis_names = ("data", "model")
        shape = {"data": 1, "model": 2}

        @staticmethod
        def axis_index(axis):
            return 0

    with pytest.raises(ValueError, match="layout 'rows'"):
        multihost.from_global(FakeMesh(), "rows", np.zeros((2, 2)))
