"""The port's CUDA topology (``cluster/topology.py``) and its lease
bookkeeping in ``ClusterState``, beside the JAX package's: the CPU
topology has the JAX ``as_dict()`` shape, leases and releases move the
same chips, and with no CUDA device ``detect_topology()`` raises."""

import pytest
import torch

from _torch_parity import few_torch_threads  # noqa: F401
from bioengine_tpu.cluster import state as jax_state
from bioengine_tpu.cluster import topology as jax_topology
from bioengine_tpu_torch.cluster import state as torch_state
from bioengine_tpu_torch.cluster.topology import ChipInfo, TpuTopology, detect_topology


def _jax_cpu_topology(n):
    chips = tuple(
        jax_topology.ChipInfo(device_id=i, platform="cpu", kind="cpu", process_index=0)
        for i in range(n)
    )
    return jax_topology.TpuTopology(chips=chips, n_hosts=1, platform="cpu")


@pytest.mark.parametrize("n", [1, 4, 8])
def test_cpu_topology_as_dict_matches_jax(n):
    ours = detect_topology(device="cpu", n_devices=n)
    assert ours.as_dict() == _jax_cpu_topology(n).as_dict()
    assert ours.n_chips == n and ours.chips_per_host == n and ours.platform == "cpu"
    assert ours.default_mesh_axes() == {"dp": n}
    assert [c.device_id for c in ours.local_chips()] == list(range(n))


def test_cpu_topology_defaults_to_one_chip():
    assert detect_topology(device="cpu").n_chips == 1


def test_chip_keys_match_jax():
    ours = detect_topology(device="cpu", n_devices=1).as_dict()["chips"][0]
    assert list(ours) == ["device_id", "platform", "kind", "process_index",
                          "hbm_bytes", "hbm_used_bytes"]


def test_detect_topology_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ("cuda", "cuda:0", None):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            detect_topology(device) if device is not None else detect_topology()
    with pytest.raises(ValueError):
        detect_topology("meta")


def test_cluster_state_without_topology_detects_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state = torch_state.ClusterState()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        state.free_chips()


def test_detect_topology_reads_the_cuda_devices(monkeypatch):
    """The CUDA path through stand-ins for the four torch.cuda calls."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: f"card {i}")
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda i: (60 << 30, 80 << 30))
    topo = detect_topology()
    assert topo.platform == "gpu" and topo.n_hosts == 1 and topo.n_chips == 2
    assert topo.chips[1] == ChipInfo(device_id=1, platform="gpu", kind="card 1", process_index=0,
                                     hbm_bytes=80 << 30, hbm_used_bytes=20 << 30)
    assert detect_topology("cuda", n_devices=1).n_chips == 1
    with pytest.raises(ValueError, match="2 CUDA device"):
        detect_topology("cuda", n_devices=3)


@pytest.mark.parametrize("n_chips", [1, 8])
def test_lease_bookkeeping_matches_jax(n_chips):
    ours = torch_state.ClusterState(detect_topology(device="cpu", n_devices=n_chips))
    ref = jax_state.ClusterState(_jax_cpu_topology(n_chips))
    for state in (ours, ref):
        state.register_replica("app", "rt", "rt-1", [])
    leased = [s.acquire_chips("rt-1", 1) for s in (ours, ref)]
    assert leased[0] == leased[1] == [0]
    assert ours.free_chips() == ref.free_chips() == n_chips - 1
    assert ours.snapshot()["chips"][0]["in_use_by"] == ref.snapshot()["chips"][0]["in_use_by"] == "rt-1"
    if n_chips == 1:
        errors = []
        for s in (ours, ref):
            with pytest.raises(RuntimeError) as err:
                s.acquire_chips("rt-2", 1)
            errors.append(str(err.value))
        assert errors[0] == errors[1]
    for s in (ours, ref):
        s.add_pending("app/rt", {"chips": 1})
        s.release_chips("rt-1")
    assert ours.free_chips() == ref.free_chips() == n_chips
    assert [p.workload_id for p in ours.pending()] == [p.workload_id for p in ref.pending()] == ["app/rt"]


def test_snapshot_keys_match_jax():
    ours = torch_state.ClusterState(detect_topology(device="cpu", n_devices=2)).snapshot()
    ref = jax_state.ClusterState(_jax_cpu_topology(2)).snapshot()
    assert sorted(ours) == sorted(ref)
    assert sorted(ours["memory"]) == sorted(ref["memory"])
    assert ours["chips"] == ref["chips"]


def test_snapshot_memory_is_psutils():
    import psutil

    ours = torch_state.ClusterState(detect_topology(device="cpu")).snapshot()
    ref = jax_state.ClusterState(_jax_cpu_topology(1)).snapshot()
    assert ours["memory"]["total_bytes"] == ref["memory"]["total_bytes"] == psutil.virtual_memory().total
    assert ours["n_chips_free"] == ref["n_chips_free"] == 1


def test_topology_types_keep_the_jax_names():
    assert TpuTopology.__name__ == jax_topology.TpuTopology.__name__
    assert [f for f in ChipInfo.__dataclass_fields__] == list(jax_topology.ChipInfo.__dataclass_fields__)
