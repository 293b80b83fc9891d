"""B1, the ``fused`` kernel (replaces ldpc_tpu/ops/pallas_minsum.py:143
``_kernel``): its plain PyTorch version against ``make_fused_minsum(...,
interpret=True)`` in every mode, schedule and flag, plus the builder's
argument checks.  Sum-product on nr_2_0_4 is in test_torch_minsum_sumproduct.py
(each interpret-mode compile of nr_2_0_4 takes about 12 s on the CPU)."""
import numpy as np
import pytest
import torch

from test_torch_parity import (ALL_FLAGS, EARLY_EXIT, TRACKING, bpsk_llrs,
                          check_kernel_plain_against_jax)

import ldpc_tpu_torch.codes as tcodes
from ldpc_tpu_torch.ops import fused_minsum as fm


@pytest.mark.parametrize("mode,schedule,track,early_exit", ALL_FLAGS)
def test_plain_matches_jax_kernel_toy(mode, schedule, track, early_exit):
    check_kernel_plain_against_jax("fused", "toy_4x8", 4, mode, schedule, track, early_exit)


@pytest.mark.parametrize("schedule,flags", [("flooding", TRACKING), ("layered", EARLY_EXIT)])
def test_plain_matches_jax_kernel_nr_2_0_4_minsum(schedule, flags):
    check_kernel_plain_against_jax("fused", "nr_2_0_4", 4, "minsum", schedule, *flags)


@pytest.mark.parametrize("mode", ["minsum", "sumproduct"])
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_early_exit_equals_fixed_trip(mode, schedule):
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_4"), 8)
    llr = torch.from_numpy(bpsk_llrs(qc.num_vars, 16, 2.0, seed=4))
    fixed = fm.make_fused_minsum(qc, 12, mode=mode, schedule=schedule, device="cpu")(llr)
    early = fm.make_fused_minsum(qc, 12, mode=mode, schedule=schedule, early_exit=True,
                                 device="cpu")(llr)
    for a, b in zip(fixed, early):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_make_fused_bp_is_sumproduct():
    qc = tcodes.qc_layout(tcodes.get_base_graph("toy_4x8"), 4)
    llr = torch.from_numpy(bpsk_llrs(qc.num_vars, 9, 1.0, seed=2))
    a = fm.make_fused_bp(qc, 7, device="cpu")(llr)
    b = fm.make_fused_minsum(qc, 7, alpha=1.0, mode="sumproduct", device="cpu")(llr)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_argument_errors():
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 32)
    with pytest.raises(ValueError, match="early_exit requires track_convergence"):
        fm.make_fused_minsum(qc, early_exit=True, track_convergence=False, device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        fm.make_fused_minsum(qc, mode="bogus", device="cpu")
    with pytest.raises(ValueError, match="shared memory"):
        fm.make_fused_minsum(qc, batch_tile=6, device="cpu")  # 6 frames exceed 227 KB
    dec = fm.make_fused_minsum(qc, 4, device="cpu")
    with pytest.raises(TypeError, match="float32"):
        dec(torch.zeros((2, qc.num_vars), dtype=torch.float64))
    with pytest.raises(ValueError, match=r"\(B, 1664\)"):
        dec(torch.zeros((2, 100)))


def test_large_Z_rejected_with_clear_error():
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 384)
    assert not fm.fused_kernel_fits(qc)
    with pytest.raises(ValueError, match="shared memory"):
        fm.make_fused_minsum(qc, 10, device="cpu")


def test_shared_memory_plan():
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 32)
    K, C, R, Z = qc.num_base_edges, qc.num_base_cols, qc.num_base_rows, 32
    words = -(-(4 * K + R + C + 2) // 4) * 4
    assert fm.fused_smem_bytes(qc, 1) == 4 * (words + K * Z + 2 * C * Z) == 42064
    assert fm.pick_fused_batch_tile(qc) == 1
    assert fm.pick_fused_batch_tile(tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_4"), 4)) == 2
    graph = fm._graph_array(fm._structure(qc))
    assert graph.dtype == np.int32 and graph.shape == (4 * K + R + C + 2,)
    row_ptr = graph[:R + 1]
    assert row_ptr[0] == 0 and row_ptr[-1] == K
    np.testing.assert_array_equal(graph[R + 1:R + 1 + K], np.arange(K))  # row-major edges
