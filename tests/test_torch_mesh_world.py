"""The mesh tests' world of ranks (tests/torch_mesh_world.py) under the
environment the JAX TF tests leave: tests/test_tf_import_real.py and
test_tf_ground_truth.py set ``CUDA_VISIBLE_DEVICES=-1`` in the process
that collects them, and a rank spawned after that inherits it.  A card
world's ranks start with the card visible; a CPU world's inherit the
environment as it is; and the test process keeps its own."""

import pytest

from torch_mesh_world import World


@pytest.mark.parametrize("device,want", [("cuda:0", None), ("cpu", "-1")])
def test_card_world_ranks_see_the_card_after_the_tf_tests_hid_it(
        tmp_path, monkeypatch, device, want):
    import os

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "-1")
    world = World(1, tmp_path, device=device)
    try:
        assert world.run("visible_devices") == [want]
    finally:
        world.close()
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "-1"
