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
