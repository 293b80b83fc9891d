"""The port's profiling module (counterpart of ldpc_tpu/utils/profiling.py):
the roofline counts equal the JAX package's, the bounds take the H100's
peaks (which chip_smoke.py reads from here), and a trace of the CPU is
written."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ldpc_tpu.codes as jcodes
from ldpc_tpu.utils import profiling as jprof
import ldpc_tpu_torch.codes as tcodes
from ldpc_tpu_torch.utils import profiling as tprof

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name,Z,h,T,inject", [("nr_2_0_4", 4, 64, 5, True),
                                               ("nr_2_0_32", 32, 64, 20, False),
                                               ("toy_4x8", 4, 16, 3, True)])
def test_gnn_roofline_counts_match_jax(name, Z, h, T, inject):
    qj = jcodes.qc_layout(jcodes.get_base_graph(name), Z)
    qt = tcodes.qc_layout(tcodes.get_base_graph(name), Z)
    want = jprof.gnn_roofline(qj, h, T, input_injection=inject)
    got = tprof.gnn_roofline(qt, h, T, input_injection=inject)
    for field in ("mxu_flops_per_frame", "vpu_element_ops_per_frame", "hbm_bytes_per_frame",
                  "matmul_m"):
        assert getattr(got, field) == getattr(want, field), field
    bounds = got.bound_bits_per_s(qt.num_vars)
    assert set(bounds) == set(want.bound_bits_per_s(qj.num_vars))
    np.testing.assert_allclose(bounds["mxu_bound_bits_per_s"],
                               qt.num_vars / (got.mxu_flops_per_frame / 989e12))
    np.testing.assert_allclose(bounds["memory_bound_bits_per_s"],
                               qt.num_vars / (got.hbm_bytes_per_frame / 3.35e12))


@pytest.mark.parametrize("name,Z,T", [("nr_2_0_32", 32, 20), ("nr_2_0_4", 4, 5)])
def test_minsum_roofline_counts_match_jax(name, Z, T):
    qj = jcodes.qc_layout(jcodes.get_base_graph(name), Z)
    qt = tcodes.qc_layout(tcodes.get_base_graph(name), Z)
    want, got = jprof.minsum_roofline(qj, T), tprof.minsum_roofline(qt, T)
    assert got.vpu_element_ops_per_frame == want.vpu_element_ops_per_frame
    assert got.hbm_bytes_per_frame == want.hbm_bytes_per_frame
    np.testing.assert_allclose(got.bound_bits_per_s(qt.num_vars)["compute_bound_bits_per_s"],
                               qt.num_vars / (got.vpu_element_ops_per_frame / (67e12 / 2)))


def test_chip_smoke_reads_the_peaks_from_here():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    for name in ("PEAK_BYTES", "PEAK_F32_OPS", "PEAK_I32_OPS", "PEAK_BF16_TENSOR_OPS"):
        assert getattr(chip_smoke, name) is getattr(tprof, name)


def test_trace_and_annotate_on_the_cpu(tmp_path):
    with tprof.trace(tmp_path / "t") as prof:
        with tprof.annotate("ldpc_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(e.key == "ldpc_region" for e in prof.key_averages())
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "ldpc_region" for e in events)
