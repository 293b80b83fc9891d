"""``ComparativeEvaluator`` and the one-device Monte-Carlo sweep of the port.

* The results JSON has the JAX evaluator's schema (the same keys, each list
  one entry an SNR), and the port loads ``results/nr_2_0_4_comparison.json``
  (written by the JAX package's ``tools/make_curves.py``) and prints its
  summary.
* The registered plain min-sum and BP decoders give the bits of the JAX
  package's ``decode_min_sum`` / ``decode_bp`` on identical LLRs.
* ``mc_sweep`` is a pure function of its seed; ``avg_iterations`` sees the
  sweep's own LLRs; ``mesh=`` raises and names ROADMAP §A6.
* ``fused=True`` runs the kernels' plain versions on a CPU device, with the
  counts of the tensor-op path, and raises where no kernel takes the code:
  never a fallback.
"""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gnn_parity import both_plans
from test_torch_parity import bpsk_llrs

from ldpc_tpu.models.classical import decode_bp as jax_decode_bp
from ldpc_tpu.models.classical import decode_min_sum as jax_decode_min_sum
from ldpc_tpu.training.evaluator import ComparativeEvaluator as JaxEvaluator
from ldpc_tpu_torch.codes import get_base_graph, qc_layout
from ldpc_tpu_torch.models import make_gnn_decoder
from ldpc_tpu_torch.parallel import mc_sweep, trial_data, trial_generator
from ldpc_tpu_torch.training import ComparativeEvaluator
from ldpc_tpu_torch.utils.metrics import MetricsRegistry

RESULTS = Path(__file__).resolve().parent.parent / "results"


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def schema(results: dict):
    """The shape of a results JSON: its keys, and each list's length."""
    return {"snr_range": len(results["snr_range"]),
            "decoders": {name: {k: len(v) if isinstance(v, list) else type(v).__name__
                                for k, v in entry.items()}
                         for name, entry in results["decoders"].items()}}


def test_results_json_has_the_jax_schema(one_thread, tmp_path):
    qj, pj, qt, pt = both_plans("toy_4x8", 4)
    kw = dict(snr_range=[1.0, 3.0], batch_size=8, num_trials=1)
    jax_ev = JaxEvaluator(pj, **kw)
    jax_ev.add_min_sum(5)
    jax_ev.add_decoder("bits", lambda llr: (llr < 0).astype(jnp.float32), param_count=3)
    jax_ev.evaluate_all(log=None)
    ev = ComparativeEvaluator(pt, device="cpu", **kw)
    ev.add_min_sum(5)
    ev.add_decoder("bits", lambda llr: (llr < 0).to(torch.float32), param_count=3)
    metrics = MetricsRegistry()
    ev.evaluate_all(log=None, metrics=metrics)
    assert schema(ev.results) == schema(jax_ev.results)
    assert metrics.gauges["eval_bits_bits_per_s"] > 0 and "eval_Min-Sum Scaled_s" in metrics.series
    ev.save_results(tmp_path / "r.json")
    jax_ev.save_results(tmp_path / "j.json")
    assert schema(json.loads((tmp_path / "r.json").read_text())) == \
        schema(json.loads((tmp_path / "j.json").read_text()))


def test_loads_and_prints_the_committed_comparison(one_thread):
    pt = both_plans("nr_2_0_4", 4)[3]
    ev = ComparativeEvaluator(pt, device="cpu")
    res = ev.load_results(RESULTS / "nr_2_0_4_comparison.json")
    lines = []
    ev.print_summary(log=lines.append)
    assert len(lines) == 1 + len(res["snr_range"]) + sum(
        bool(e.get("param_count")) for e in res["decoders"].values())
    assert lines[0].startswith("SNR (dB) |") and "Belief Propagation" in lines[0]
    jax_ev = JaxEvaluator(both_plans("nr_2_0_4", 4)[1])
    jax_ev.load_results(RESULTS / "nr_2_0_4_comparison.json")
    jax_lines = []
    jax_ev.print_summary(log=jax_lines.append)
    assert lines == jax_lines
    empty = []
    ComparativeEvaluator(pt, device="cpu").print_summary(log=empty.append)
    assert empty == ["no results — run evaluate_all() first"]


@pytest.mark.parametrize("code,Z", [("toy_4x8", 4), ("nr_2_0_4", 4)])
def test_plain_decoders_match_jax(one_thread, code, Z):
    _, pj, qt, pt = both_plans(code, Z)
    ev = ComparativeEvaluator(pt, device="cpu")
    ev.add_min_sum(8, scaling_factor=0.75)
    ev.add_belief_propagation(10)
    llr = bpsk_llrs(qt.num_vars, 12, 1.5, seed=3)
    for name, jax_fn in (("Min-Sum Scaled", lambda x: jax_decode_min_sum(x, pj, 8, 0.75,
                                                                         early_exit=True)),
                         ("Belief Propagation", lambda x: jax_decode_bp(x, pj, 10,
                                                                       early_exit=True))):
        want = jax_fn(jnp.asarray(llr))
        spec = ev._decoders[name]
        got = spec["decode"](torch.from_numpy(llr))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want.bits), err_msg=name)
        np.testing.assert_array_equal(spec["iters"](torch.from_numpy(llr)).numpy(),
                                      np.asarray(want.conv_iter), err_msg=name)


def test_sweep_is_a_function_of_its_seed(one_thread):
    _, _, qt, pt = both_plans("toy_4x8", 4)

    def decode(llr):
        return (llr < 0).to(torch.float32)

    a = mc_sweep(decode, pt, [0.0, 2.0], 16, 3, seed=7, device="cpu")
    b = mc_sweep(decode, pt, [0.0, 2.0], 16, 3, seed=7, device="cpu")
    c = mc_sweep(decode, pt, [0.0, 2.0], 16, 3, seed=8, device="cpu")
    assert a == b and a["ber"] != c["ber"] and a["snr"] == [0.0, 2.0]
    assert a["ber"][0] > a["ber"][1] > 0.0
    # each trial's generator depends on (seed, SNR index, trial) alone
    x = trial_data(trial_generator(7, 1, 2, "cpu"), qt.num_vars, 4, 2.0)[1]
    assert torch.equal(x, trial_data(trial_generator(7, 1, 2, "cpu"), qt.num_vars, 4, 2.0)[1])
    assert not torch.equal(x, trial_data(trial_generator(7, 2, 1, "cpu"), qt.num_vars, 4, 2.0)[1])
    with pytest.raises(NotImplementedError, match="§A6"):
        mc_sweep(decode, pt, [0.0], 4, 1, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="§A6"):
        ComparativeEvaluator(pt, mesh=object(), device="cpu")


def test_avg_iterations_sees_the_sweeps_llrs(one_thread):
    _, _, qt, pt = both_plans("toy_4x8", 4)
    seen = {"decode": [], "iters": []}

    def record(kind):
        def fn(llr):
            seen[kind].append(llr.clone())
            return (llr < 0).to(torch.float32) if kind == "decode" else \
                torch.ones(llr.shape[0], dtype=torch.int32)
        return fn

    ev = ComparativeEvaluator(pt, snr_range=[0.0, 1.0], batch_size=4, num_trials=2,
                              device="cpu", modulation="bpsk")
    ev.add_decoder("rec", record("decode"), record("iters"))
    res = ev.evaluate_all(log=None)
    assert res["decoders"]["rec"]["avg_iterations"] == [1.0, 1.0]
    assert len(seen["decode"]) == len(seen["iters"]) == 4
    assert all(torch.equal(a, b) for a, b in zip(seen["decode"], seen["iters"]))


def test_fused_runs_the_plain_kernels_on_the_cpu_and_never_falls_back(one_thread):
    qt = qc_layout(get_base_graph("nr_2_0_4"), 4)
    pt = both_plans("nr_2_0_4", 4)[3]
    ev = ComparativeEvaluator(pt, snr_range=[1.0, 2.0], batch_size=8, num_trials=2, device="cpu")
    ev.add_min_sum(10, name="ms fused", qc=qt, fused=True)
    ev.add_min_sum(10, name="ms plain")
    ev.add_belief_propagation(10, name="bp fused", qc=qt, fused=True)
    ev.add_belief_propagation(10, name="bp plain")
    res = ev.evaluate_all(log=None)["decoders"]
    assert res["ms fused"] == res["ms plain"]
    assert res["bp fused"]["fer"] == res["bp plain"]["fer"]
    with pytest.raises(ValueError, match="qc="):
        ev.add_min_sum(10, fused=True)
    big = qc_layout(get_base_graph("nr_2_0_4"), 212)  # too big a frame, Z % 8 != 0
    with pytest.raises(ValueError, match="no fused kernel takes this code"):
        ev.add_min_sum(10, name="none", qc=big, fused=True)
    with pytest.raises(ValueError, match="no fused kernel takes this code"):
        ev.add_belief_propagation(10, name="none", qc=big, fused=True)
    assert "none" not in ev._decoders


def test_add_model_counts_parameters_and_needs_no_grad(one_thread):
    _, _, _, pt = both_plans("toy_4x8", 4)
    model = make_gnn_decoder(pt, 2, 2)
    ev = ComparativeEvaluator(pt, snr_range=[2.0], batch_size=4, num_trials=1, device="cpu")
    ev.add_model("gnn", model)
    entry = ev.evaluate_all(log=None)["decoders"]["gnn"]
    assert entry["param_count"] == sum(p.numel() for p in model.parameters())
    assert "avg_iterations" not in entry
    bits = ev._decoders["gnn"]["decode"](torch.zeros((2, pt.C * pt.Z)))
    assert not bits.requires_grad
