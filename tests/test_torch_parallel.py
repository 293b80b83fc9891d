"""The port's data-parallel layer on two gloo ranks on the CPU.

Two child processes (this file run as a script) join one process group
through ``init_method=file://`` under the test's temporary directory, so
that parallel test workers never race for a port.  They run every case once
and save what they saw; each test below reads one case.  At toy_4x8 Z=4:

* the sharded ``mc_sweep`` equals the 1-rank sweep bit for bit;
* ``shard_decode`` of ``make_fused_minsum(..., device="cpu")`` (the plain
  version of ``fused_retire``) equals the unsharded ``(bits, conv_iter)``;
* the data-parallel train step's losses equal the 1-rank step's within
  ``rtol=1e-5``, the JAX package's bar (``tests/test_parallel.py``), on SGD
  and on Adam, for the tied neural min-sum and the message GNN (the second
  step's loss is that of the updated parameters); the tied decoder's
  parameters too, each within ``rtol=1e-5``.  The message GNN's parameters
  are not held one by one: where a gradient component nearly cancels, the
  order of its sums moves it by a larger share (Adam divides by it; one
  bias of its 921 parameters differs by 2.2e-4 relative after two steps);
  every rank holds the same parameters either way;
* ``ComparativeEvaluator`` under the mesh gives the 1-rank results, its
  ``avg_iterations`` included, and so does ``cli compare --mesh-data 2``,
  whose files only rank 0 writes;
* ``make_mesh`` raises on a size mismatch and on ``model=2``; a batch that
  does not divide by the data axis raises; ``distributed_init`` is
  idempotent, and fails loudly within its timeout where the world never
  forms.

The unsharded plain path is held against the JAX package's kernels in
``tests/test_torch_minsum_retire.py``.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
WORLD = 2
RTOL = 1e-5  # tests/test_parallel.py::test_dp_matches_single_device_loss
TRAIN_MODELS = ("tied", "message_gnn")


# ---------------------------------------------------------------------------
# The ranks (run as: python tests/test_torch_parallel.py RANK STORE OUT)
# ---------------------------------------------------------------------------


def _raises(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is what the test reads
        return type(e).__name__ + ": " + str(e)
    return "no error"


def _train_case(plan, mesh, model_name: str, optimizer: str):
    """Two steps of the sharded step and of the 1-rank step from the same
    weights and generator seeds: their losses and final parameters."""
    from ldpc_tpu_torch.models import create_message_gnn_decoder, make_tied_decoder
    from ldpc_tpu_torch.parallel import make_sharded_train_step

    out = {}
    for tag, m in (("sharded", mesh), ("single", None)):
        torch.manual_seed(0)
        model = (make_tied_decoder(plan, 5, 2) if model_name == "tied" else
                 create_message_gnn_decoder(plan, num_iterations=2, hidden_dim=8))
        opt = (torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
               if optimizer == "sgd" else torch.optim.Adam(model.parameters(), lr=1e-3))
        step = make_sharded_train_step(model, plan, opt, m, batch_size=32)
        losses = [step(torch.Generator().manual_seed(5 + k), 2.0).item() for k in range(2)]
        out[tag] = {"losses": losses, "params": {k: v.clone() for k, v in
                                                 model.state_dict().items()}}
    return out


def _rank_main(rank: int, store: str, out_dir: Path) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from ldpc_tpu_torch import cli
    from ldpc_tpu_torch.codes import encoder_from_H, expand_base_matrix, get_base_graph, qc_layout
    from ldpc_tpu_torch.models.classical import decode_min_sum
    from ldpc_tpu_torch.ops import qc_msg
    from ldpc_tpu_torch.ops.fused_minsum import LAUNCHES, make_fused_minsum
    from ldpc_tpu_torch.parallel import (distributed_init, make_mesh, mc_sweep, shard_decode,
                                         trial_generator)
    from ldpc_tpu_torch.training import ComparativeEvaluator
    from ldpc_tpu_torch.utils import bpsk_awgn_llr

    distributed_init(f"file://{store}", WORLD, rank, backend="gloo", timeout=120)
    world = dist.group.WORLD
    distributed_init(f"file://{store}.unused", WORLD, rank, backend="gloo", timeout=1)
    res = {"idempotent": dist.group.WORLD is world and dist.get_world_size() == WORLD}
    mesh = make_mesh()
    res["mesh_shape"] = tuple(mesh.shape)
    res["mesh_3x1"] = _raises(lambda: make_mesh(data=3))
    res["mesh_1x2"] = _raises(lambda: make_mesh(data=1, model=2))

    qc = qc_layout(get_base_graph("toy_4x8"), 4)
    plan = qc_msg.make_plan(qc, device="cpu")
    n = qc.num_vars
    enc = encoder_from_H(expand_base_matrix(get_base_graph("toy_4x8"), 4))

    # the sweep, BPSK all-zero and QPSK random codewords
    decode = lambda llr: decode_min_sum(llr, plan, 10, 0.75).bits  # noqa: E731
    for tag, kw in (("zero", dict(modulation="bpsk")), ("codewords", dict(encoder=enc))):
        kw = dict(snr_range=[1.0, 3.0], batch_size=64, num_trials=3, seed=7, device="cpu", **kw)
        res[f"sweep_{tag}"] = {"sharded": mc_sweep(decode, plan, mesh=mesh, **kw),
                               "single": mc_sweep(decode, plan, mesh=None, **kw)}
    res["sweep_odd_batch"] = _raises(lambda: mc_sweep(decode, plan, [1.0], 63, 1, mesh=mesh,
                                                      device="cpu"))

    # shard_decode over the plain fused_retire
    fused = make_fused_minsum(qc, 5, device="cpu")
    llr = bpsk_awgn_llr(trial_generator(0, 0, 0, "cpu"), torch.zeros((64, n)), 2.0)
    res["decode_single"] = fused(llr)
    res["decode_sharded"] = shard_decode(fused, mesh)(llr)
    res["decode_odd_batch"] = _raises(lambda: shard_decode(fused, mesh)(llr[:63]))
    res["fused_launches"] = dict(LAUNCHES)  # the plain version on the CPU: no launch

    # the data-parallel train step
    for model_name in TRAIN_MODELS:
        for optimizer in ("sgd", "adam"):
            res[f"train_{model_name}_{optimizer}"] = _train_case(plan, mesh, model_name,
                                                                 optimizer)

    # the evaluator, avg_iterations included
    evs = {}
    for tag, m in (("sharded", mesh), ("single", None)):
        ev = ComparativeEvaluator(plan, snr_range=[1.0, 3.0], batch_size=64, num_trials=2,
                                  mesh=m, seed=3, device="cpu")
        ev.add_min_sum(10)
        ev.add_belief_propagation(10)
        ev.add_min_sum(5, qc=qc, fused=True, name="fused min-sum")
        evs[tag] = ev.evaluate_all(log=None)
    res["evaluator"] = evs

    # the CLI's compare under the mesh, then unsharded (rank 0)
    args = ["compare", "--device", "cpu", "--base-graph", "toy_4x8", "--lifting-factor", "4",
            "--snr-min", "1", "--snr-max", "2", "--batch-size", "16", "--num-trials", "2",
            "--bp-max-iterations", "10", "--model-type", "tied",
            "--model-path", str(out_dir / "no_such_model.pt")]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        cli.main(args + ["--mesh-data", "2", "--results-dir", str(out_dir / "cli_mesh")])
    res["cli_printed"] = printed.getvalue()
    if rank == 0:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(args + ["--results-dir", str(out_dir / "cli_single")])
    dist.barrier()
    torch.save(res, out_dir / f"rank{rank}.pt")
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results, from one spawn of two processes."""
    out = tmp_path_factory.mktemp("ranks")
    env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(out / "store"), str(out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return out, [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.mark.parametrize("tag", ["zero", "codewords"])
def test_sharded_sweep_equals_one_rank(ranks, tag):
    for res in ranks[1]:
        sweep = res[f"sweep_{tag}"]
        assert sweep["sharded"] == sweep["single"]
        assert 0.0 < sweep["single"]["ber"][0]


def test_shard_decode_fused_equals_unsharded(ranks):
    for res in ranks[1]:
        (bits1, conv1), (bits2, conv2) = res["decode_single"], res["decode_sharded"]
        assert bits2.shape == bits1.shape and torch.equal(bits2, bits1)
        assert torch.equal(conv2, conv1) and conv1.dtype == torch.int32
        assert bits1.sum() > 0 and (conv1 < 5).any()  # errors and early convergence both seen
        assert res["fused_launches"]["fused_retire"] == 0


@pytest.mark.parametrize("model_name", TRAIN_MODELS)
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_data_parallel_step_equals_one_rank(ranks, model_name, optimizer):
    results = [res[f"train_{model_name}_{optimizer}"] for res in ranks[1]]
    for case in results:
        torch.testing.assert_close(case["sharded"]["losses"], case["single"]["losses"],
                                   rtol=RTOL, atol=0)
        assert case["single"]["losses"][1] != case["single"]["losses"][0]
        if model_name == "tied":
            for name, want in case["single"]["params"].items():
                torch.testing.assert_close(case["sharded"]["params"][name], want, rtol=RTOL,
                                           atol=0)
    # every rank holds the same parameters after the step
    for name, p in results[0]["sharded"]["params"].items():
        assert torch.equal(p, results[1]["sharded"]["params"][name])


def test_evaluator_under_mesh_equals_one_rank(ranks):
    for res in ranks[1]:
        evs = res["evaluator"]
        assert evs["sharded"] == evs["single"]
        entry = evs["single"]["decoders"]["Belief Propagation"]
        assert all(1.0 <= x <= 10.0 for x in entry["avg_iterations"])


def test_cli_compare_mesh_data(ranks):
    out, (r0, r1) = ranks
    mesh_json = json.loads((out / "cli_mesh" / "comparison_results.json").read_text())
    single = json.loads((out / "cli_single" / "comparison_results.json").read_text())
    assert mesh_json == single and len(mesh_json["decoders"]) == 3
    assert "saved" in r0["cli_printed"] and r1["cli_printed"] == ""


def test_mesh_and_batch_errors(ranks):
    for res in ranks[1]:
        assert res["idempotent"] and res["mesh_shape"] == (2, 1)
        assert res["mesh_3x1"].startswith("ValueError: mesh 3x1 != 2 ranks")
        assert res["mesh_1x2"].startswith("NotImplementedError") and "§A6b" in res["mesh_1x2"]
        for key in ("sweep_odd_batch", "decode_odd_batch"):
            assert res[key].startswith("ValueError: batch 63 does not divide")


def test_distributed_init_fails_loudly(tmp_path):
    """A world that never forms raises within the timeout and leaves no group."""
    import torch.distributed as dist

    from ldpc_tpu_torch.parallel import distributed_init

    t0 = time.time()
    with pytest.raises(RuntimeError):
        distributed_init(f"file://{tmp_path / 'store'}", world_size=2, rank=0, backend="gloo",
                         timeout=2)
    assert time.time() - t0 < 60
    assert not dist.is_initialized()


def test_make_mesh_needs_a_process_group():
    from ldpc_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="distributed_init"):
        make_mesh()


def test_placements_are_the_jax_shardings():
    """``P("data")`` is the batch split over the data axis, ``P()`` the
    whole tensor on every rank."""
    from torch.distributed.tensor import Replicate, Shard

    from ldpc_tpu_torch.parallel import batch_sharding, replicated

    assert batch_sharding(None) == (Shard(0), Replicate())
    assert replicated(None) == (Replicate(), Replicate())


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], Path(sys.argv[3]))
