"""A fleet of the port's ModelServers driven by the JAX package's unchanged
rollout coordinator (``tools/rollout.py``), on the CPU.

- ``run_rollout`` with ``client_factory=`` the port's ``ServingClient``
  promotes the canary first, and a gate that PAGEs on a later replica rolls
  every swapped replica back, in reverse.
- The reference's live-push no-drop drill, cut to one process with two
  in-process servers: a storm of clients over both replicas, three
  canary-gated swaps and one paged generation; every request settles, and
  the fleet ends on the newest good generation.
"""

import threading
import time

import numpy as np

from incubator_mxnet_tpu_torch import serving
from incubator_mxnet_tpu_torch.models.bert import BERTModel
from tools import rollout

BERT_CFG = dict(vocab_size=40, units=8, hidden_size=16, num_layers=1,
                num_heads=2, max_length=32)


def _fleet(tmp_path, generations, replicas=2):
    d = str(tmp_path / "ckpt")
    for g in range(generations):
        serving.export_for_serving(
            d, "bert_encoder", BERT_CFG,
            BERTModel(device="cpu", dropout=0.0, seed=g, **BERT_CFG))
    servers = [serving.ModelServer(device="cpu").load(
        "bert", directory=d, generation=0, max_wait_ms=5,
        buckets=(8,)).start() for _ in range(replicas)]
    return d, servers, ["%s:%d" % tuple(s.addr) for s in servers]


def _generations(servers):
    return [s.generations()["bert"]["generation"] for s in servers]


def test_rollout_drives_port_servers_canary_first_and_rolls_back(tmp_path):
    _d, servers, addrs = _fleet(tmp_path, 3)
    try:
        gates = []
        summary = rollout.run_rollout(
            addrs, "bert", generation=1, bake_s=0,
            gate=lambda r: gates.append(r) or 0,
            client_factory=serving.ServingClient)
        assert summary["status"] == "promoted"
        assert gates == addrs               # every replica, canary first
        assert [e["canary"] for e in summary["walk"]] == [True, False]
        assert _generations(servers) == [1, 1]
        # the gate PAGEs on the second replica: both roll back, in reverse
        summary = rollout.run_rollout(
            addrs, "bert", generation=2, bake_s=0,
            gate=lambda r: 2 if r == addrs[1] else 0,
            client_factory=serving.ServingClient)
        assert summary["status"] == "rolled_back"
        assert "gate exit 2" in summary["reason"]
        back = [e for e in summary["walk"] if e["action"] == "rollback"]
        assert [e["replica"] for e in back] == [addrs[1], addrs[0]]
        assert [e["generation"] for e in back] == [1, 1]
        assert _generations(servers) == [1, 1]
        # the pointer-following default: no generation named
        summary = rollout.run_rollout(addrs, "bert", bake_s=0,
                                      gate=lambda r: 0,
                                      client_factory=serving.ServingClient)
        assert summary["status"] == "promoted"
        assert _generations(servers) == [2, 2]
    finally:
        for s in servers:
            s.stop()


def test_live_weight_push_no_drop_drill(tmp_path):
    _d, servers, addrs = _fleet(tmp_path, 5)
    stop = threading.Event()
    errors, lock, counts = [], threading.Lock(), {"ok": 0}

    def storm(seed):
        rs = np.random.RandomState(seed)
        n = 0
        try:
            with serving.ServingClient(list(addrs), timeout=60) as c:
                while not stop.is_set():
                    ids = rs.randint(1, 40, (1, 6)).astype(np.int32)
                    out = c.infer("bert", {"token_ids": ids},
                                  deadline_ms=30000)
                    assert out["pooled"].shape == (1, BERT_CFG["units"])
                    n += 1
        except Exception as e:  # noqa: BLE001 - asserted on the main thread
            errors.append(repr(e))
        finally:
            with lock:
                counts["ok"] += n

    threads = [threading.Thread(target=storm, args=(i,)) for i in range(3)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.2)                 # the storm in full swing
        for g in (1, 2, 3):
            summary = rollout.run_rollout(
                addrs, "bert", generation=g, bake_s=0.1, gate=lambda r: 0,
                client_factory=serving.ServingClient)
            assert summary["status"] == "promoted", summary
        # a bad generation: the canary's gate PAGEs, the fleet rolls back
        summary = rollout.run_rollout(
            addrs, "bert", generation=4, bake_s=0.05, gate=lambda r: 2,
            client_factory=serving.ServingClient)
        assert summary["status"] == "rolled_back", summary
        assert [e["action"] for e in summary["walk"]] == ["deploy",
                                                          "rollback"]
        assert _generations(servers) == [3, 3]
        stop.set()
        for t in threads:
            t.join(60)
        assert not errors, errors       # every request settled: no drops
        assert counts["ok"] > 0
    finally:
        stop.set()
        for s in servers:
            s.stop()
