"""B10, the aggregation probe (replaces tools/probe_agg_mxu.py:48
``_kernel``): the port's plain PyTorch version identical to the JAX probe's
kernels in interpret mode (``vpu``, and ``mxu``, whose 0/1 products are exact
there) and within the JAX tool's 2e-2 * scale of its ``reference()``; the
layout conversion; the tool's entry point on the CPU."""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu.codes as jcodes
import ldpc_tpu_torch.codes as tcodes
from ldpc_tpu_torch.tools import probe_agg_mxu as tp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import probe_agg_mxu as jp  # noqa: E402  (the JAX tool, tools/probe_agg_mxu.py)


def _case(name: str, Z: int, h: int, ntiles: int, seed: int = 0):
    qj = jcodes.qc_layout(jcodes.get_base_graph(name), Z)
    qt = tcodes.qc_layout(tcodes.get_base_graph(name), Z)
    x = np.random.default_rng(seed).standard_normal((qt.num_base_edges * h, ntiles * 128))
    xb = jnp.asarray(x, jnp.bfloat16)
    feats = torch.from_numpy(tp.from_tpu_layout(
        np.asarray(xb.astype(jnp.float32)), qt.num_base_edges, h, Z)).to(torch.bfloat16)
    return qj, qt, xb, feats


@pytest.mark.parametrize("variant", list(tp.VARIANTS))
def test_plain_matches_jax_probe(variant):
    """toy_4x8 Z=4 h=16 L=3, one tile (32 frames), in Pallas interpret mode."""
    qj, qt, xb, feats = _case("toy_4x8", 4, 16, 1)
    want = np.asarray(jp.make_probe(qj, 16, 3, 1, variant, interpret=True)(xb)
                      .astype(jnp.float32))
    probe = tp.make_probe(qt, 16, 3, variant, device="cpu")
    launches = dict(tp.LAUNCHES)
    got = probe(feats)
    assert tp.LAUNCHES == launches  # a CPU tensor never reaches a kernel
    assert got.shape == feats.shape and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(tp.to_tpu_layout(got.to(torch.float32).numpy()), want)


def test_plain_within_jax_reference():
    """Against the JAX tool's plain-XLA reference (it divides by the degree
    where the kernels multiply by its inverse), at its own bar."""
    qj, qt, xb, feats = _case("nr_2_0_4", 4, 16, 1, seed=1)
    ref = np.asarray(jp.reference(xb, qj, 16, 2, 1).astype(jnp.float32))
    got = tp.to_tpu_layout(tp.reference(feats, qt, 2).to(torch.float32).numpy())
    assert np.abs(got - ref).max() <= tp.CHECK_TOL * np.abs(ref).max()


def test_layout_round_trip():
    x = np.arange(5 * 16 * 2 * 128, dtype=np.float32).reshape(5 * 16, 2 * 128)
    port = tp.from_tpu_layout(x, 5, 16, 4)
    assert port.shape == (64, 5, 16, 4)
    # frame tile * Bt + b sits at lane z * Bt + b of its tile (Bt = 32)
    assert port[33, 2, 3, 1] == x[2 * 16 + 3, 128 + 1 * 32 + 1]
    np.testing.assert_array_equal(tp.to_tpu_layout(port), x)
    assert tp.frames_of(32, 32) == 128 and tp.frames_of(3, 384) == 3


def test_main_on_the_cpu():
    """The entry point on the CPU: --check against reference(), then a timed
    run (times of the plain version, named as the CPU's)."""
    small = ["--device", "cpu", "--code", "toy_4x8", "--Z", "4", "--hidden", "16"]
    out = tp.main(small + ["--check"])
    assert out["device"] == "cpu" and out["frames"] == 64
    assert all(r["identical"] for r in out["results"].values())
    out = tp.main(small + ["--ntiles", "1", "--iters", "2", "--reps", "1", "--windows", "1"])
    assert set(out["results"]) == {"vpu", "mxu"} and out["mxu_speedup"] > 0
    assert out["results"]["vpu"]["us_per_frame_iteration"] > 0


def test_bf16_steps_and_raising_paths():
    a = torch.tensor([1.0, -2.0, 0.0], dtype=torch.bfloat16)
    assert tp.bf16_steps(a, a) == 0.0
    b = torch.tensor([1.0078125, -2.0, 0.0], dtype=torch.bfloat16)  # one step above 1
    assert tp.bf16_steps(b, a) == 1.0
    qc = tcodes.qc_layout(tcodes.get_base_graph("toy_4x8"), 4)
    with pytest.raises(ValueError, match="hidden_dim % 16"):
        tp.make_probe(qc, 8, 2, "vpu", device="cpu")
    with pytest.raises(ValueError, match="variant"):
        tp.make_probe(qc, 16, 2, "tpu", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.make_probe(qc, 16, 2, "mxu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.main(["--check"])
    probe = tp.make_probe(qc, 16, 2, "vpu", device="cpu")
    with pytest.raises(ValueError, match="bf16"):
        probe(torch.zeros((2, qc.num_base_edges, 16, 4)))


def test_kernel_plans_and_arguments():
    """What the wrapper hands the kernels: no rotation tensor (mxu builds
    its 0/1 fragments in registers), the shared memory of each path with
    fixed byte counts, and the mxu warps a block within shared memory."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 32)
    probe = tp.make_probe(qc, 64, 10, "mxu", device="cpu")
    assert not hasattr(probe, "rot") and probe.max_deg == 10 and probe.warps == 4
    argtypes, _ = tp._SIGNATURES["ldpc_probe_agg"]
    assert len(argtypes) == 14  # variant, in, out, graph, inv, 8 ints, stream
    assert tp.vpu_in_registers(32) and tp.vpu_in_registers(4) and not tp.vpu_in_registers(64)
    # row_ptr, then each row's edges and shifts in row order
    K, R = qc.num_base_edges, qc.num_base_rows
    graph = probe.graph.numpy()
    edges = graph[R + 1:R + 1 + K]
    np.testing.assert_array_equal(graph[R + 1 + K:], np.asarray(qc.edge_shift)[edges])
    assert sorted(edges.tolist()) == list(range(K)) and graph.size == R + 1 + 2 * K
    assert tp.smem_bytes("vpu", 32, 10) == 0
    assert tp.smem_bytes("vpu", 64, 10) == 22_528 == 4 * 8 * 11 * 64
    assert tp.smem_bytes("mxu", 32, 10) == 56_512 == 4 * (4 * 12 + 2 * 11 * 16 * 40)
    assert tp.smem_bytes("mxu", 4, 5, 1) == 4 * 8 + 2 * 6 * 16 * 40  # Z=4 pads to 32 lanes
    assert tp.mxu_warps(128, 10) == 4 and tp.mxu_warps(384, 10) == 1
    assert tp.smem_bytes("mxu", 384, 10, 2) > tp._SMEM_BUDGET >= tp.smem_bytes("mxu", 384, 10, 1)
    assert tp.mxu_warps(4096, 10) == 0
    wide = np.full((2, 26), -1)
    wide[0] = 0
    wide[1, :2] = 1
    with pytest.raises(ValueError, match="at most 24 members"):
        tp.make_probe(tcodes.qc_layout(tcodes.BaseGraph("wide", wide), 4), 16, 1, "vpu",
                      device="cpu")
    with pytest.raises(ValueError, match="exceeds shared memory"):
        tp.Probe(tcodes.qc_layout(tcodes.get_base_graph("toy_4x8"), 4096), 16, 1, "mxu",
                 torch.device("cpu"))


def _sum_model(feats: torch.Tensor, qc, L: int, reverse: bool) -> torch.Tensor:
    """The aggregation with each row sum taken in float64 and in ``reverse``
    member order, then float32, times float32(1 / degree), to bf16."""
    K, Z = qc.num_base_edges, qc.Z
    cur = feats.to(torch.float64)
    z = torch.arange(Z)
    for _ in range(L):
        new = cur.clone()
        for row in qc.row_edges:
            members = [int(k) for k in row if k != K]
            inv = torch.tensor(1.0 / len(members), dtype=torch.float32)
            acc = torch.zeros_like(cur[:, 0])
            for k in (reversed(members) if reverse else members):
                acc = acc + cur[:, k][..., (z + int(qc.edge_shift[k])) % Z]
            mean = (acc.to(torch.float32) * inv).to(torch.bfloat16).to(torch.float64)
            for k in members:
                new[:, k] = mean[..., (z - int(qc.edge_shift[k])) % Z]
        cur = new
    return cur.to(torch.bfloat16)


def test_exact_features_sum_exactly_in_any_order():
    """exact_features, the card's exact case: integers in [-64, 64] whose
    sums are exact in any order and any precision, so a model that sums in
    float64 in reverse member order equals the plain version bit for bit
    after every iteration count."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_4"), 8)
    feats = tp.exact_features(qc, 16, 6, torch.device("cpu"), seed=3)
    assert feats.dtype == torch.bfloat16 and feats.shape == (6, qc.num_base_edges, 16, 8)
    values = feats.to(torch.float32)
    assert bool((values == values.round()).all()) and values.abs().max().item() == tp.EXACT_MAX
    for L in (1, 2, 4):
        want = tp.reference(feats, qc, L)
        assert torch.equal(_sum_model(feats, qc, L, reverse=True), want)
        assert torch.equal(_sum_model(feats, qc, L, reverse=False), want)
