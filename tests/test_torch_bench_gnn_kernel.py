"""The port's GNN kernel bench (counterpart of tools/bench_gnn_kernel.py) on
the CPU, where every fused variant runs its plain PyTorch version: the
entry point runs end to end on the committed nr_2_0_4 checkpoints, holds
each of the six variants against the module's forward, and names the
kernel each stands for."""
import pytest
import torch

from ldpc_tpu_torch.ops import fused_gnn
from ldpc_tpu_torch.tools import bench_gnn_kernel as bench


@pytest.fixture
def one_round(monkeypatch):
    """One timing round, on two threads (the plain versions' many small
    operations contend across the suite's workers)."""
    monkeypatch.setattr(bench, "ROUNDS", 1)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_main_on_the_checkpoints(one_round):
    launches = dict(fused_gnn.LAUNCHES)
    out = bench.main(["--device", "cpu", "--batch", "4"])
    assert fused_gnn.LAUNCHES == launches  # the CPU runs the plain versions
    assert out["device"] == "cpu" and out["iterations"] == 5 and out["hidden_dim"] == 64
    assert set(out["module"]) == {"message_gnn", "corrected_gnn"}
    kernels = {name: v["kernel"] for name, v in out["variants"].items()}
    assert kernels == {"message_gnn/fused_v1": "msg_gnn", "message_gnn/fused_v2": "msg_gnn_v2",
                       "message_gnn/fused_v3": "msg_gnn_v3", "message_gnn/fused_v4": "msg_gnn_v4",
                       "corrected_gnn/fused": "corrected", "corrected_gnn/fused_v2": "corrected_v2"}
    for name, v in out["variants"].items():
        assert v["decision_agreement"] >= 0.999, name
        assert v["max_abs_diff"] < 0.1 and v["bits_per_s"] > 0 and v["mfu"] > 0, name
    assert out["roofline"]["mxu_bound_bits_per_s"] > 0


def test_fresh_params_and_kernel_filter(one_round):
    """--fresh benches untrained parameters (the message GNN alone, whose
    zero output projection makes every variant the channel's decision);
    --kernels keeps the named variants."""
    out = bench.main(["--device", "cpu", "--batch", "2", "--iters", "2", "--fresh",
                      "--kernels", "v3,v4"])
    assert set(out["variants"]) == {"message_gnn/fused_v3", "message_gnn/fused_v4"}
    assert all(v["decision_agreement"] == 1.0 for v in out["variants"].values())


def test_raising_paths():
    with pytest.raises(ValueError, match="--hidden in"):
        bench.main(["--device", "cpu", "--hidden", "32"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
