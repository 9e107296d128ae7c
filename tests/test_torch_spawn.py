"""``recom_tpu_torch.parallel.multihost.spawn``: the ranks of a spawned world
meet through a ``FileStore`` in a temporary directory of their own, so two
worlds started at once (as parallel test workers start them) never take
each other's rendezvous, and no port is picked, freed and bound again."""

import os
import threading

import pytest

from recom_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _demo_argv():
    return ["-m", "recom_tpu_torch.tools.multihost_demo", "--num-processes",
            "2", "--backend", "gloo", "--device", "cpu", "--process-id",
            "-1"]


def test_two_spawned_worlds_at_once_both_print_ok(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    results = [None, None]

    def run(i):
        results[i] = multihost.spawn(_demo_argv(), 2, timeout_s=240)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for res in results:
        assert [rc for rc, _ in res] == [0, 0], "\n".join(
            text[-2000:] for _, text in res)
        assert "MULTIHOST OK: 2 processes" in res[0][1]


def test_spawned_ranks_get_a_store_and_no_port(monkeypatch, tmp_path):
    """Each rank sees its world's ``file://`` store under
    RECOM_TORCH_INIT_METHOD, torchrun's rank variables, and no
    MASTER_PORT; two calls get two stores, and each store's directory is
    gone once its world has ended."""
    monkeypatch.setenv("MASTER_PORT", "1")
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import os\n"
        f"v = os.environ[{multihost.SPAWN_INIT!r}]\n"
        "print(v, os.environ['RANK'], os.environ['WORLD_SIZE'],\n"
        "      os.environ.get('MASTER_PORT'), os.path.isdir(v[7:-6]))\n")
    first = multihost.spawn([str(probe)], 2)
    second = multihost.spawn([str(probe)], 1)
    stores = set()
    for res, n in ((first, 2), (second, 1)):
        for rank, (rc, text) in enumerate(res):
            assert rc == 0, text
            store, r, world, port, there = text.split()
            assert store.startswith("file://") and store.endswith("/store")
            assert (int(r), int(world), port, there) == (rank, n, "None",
                                                        "True")
            stores.add(store)
            assert not os.path.exists(store[7:-6])
    assert len(stores) == 2


def test_init_from_env_without_a_world_names_torchrun_and_spawn(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              multihost.SPAWN_INIT):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun.*--spawn"):
        multihost.init_from_env("gloo")
