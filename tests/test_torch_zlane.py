"""B2, the ``fused_zlane`` kernel (replaces ldpc_tpu/ops/pallas_minsum.py:399
``_kernel_zlane``): its plain PyTorch version against
``make_fused_minsum_zlane(..., interpret=True)`` in every mode, schedule and
flag, plus the builder's argument checks.  The rest of nr_2_0_4 is in
test_torch_zlane_nr.py (each interpret-mode compile of it takes over 10 s)."""
import pytest

from test_torch_parity import ALL_FLAGS, EARLY_EXIT, check_kernel_plain_against_jax

import ldpc_tpu_torch.codes as tcodes
from ldpc_tpu_torch.ops import fused_minsum as fm


@pytest.mark.parametrize("mode,schedule,track,early_exit", ALL_FLAGS)
def test_plain_matches_jax_kernel_toy(mode, schedule, track, early_exit):
    check_kernel_plain_against_jax("fused_zlane", "toy_4x8", 16, mode, schedule, track,
                                   early_exit)


def test_plain_matches_jax_kernel_nr_2_0_4_minsum_flooding():
    check_kernel_plain_against_jax("fused_zlane", "nr_2_0_4", 24, "minsum", "flooding",
                                   *EARLY_EXIT)


def test_argument_errors():
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_4"), 12)
    with pytest.raises(ValueError, match="Z % 8 == 0"):
        fm.make_fused_minsum_zlane(qc, device="cpu")
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 384)
    with pytest.raises(ValueError, match="early_exit requires track_convergence"):
        fm.make_fused_minsum_zlane(qc, early_exit=True, track_convergence=False, device="cpu")
    with pytest.raises(ValueError, match="batch_tile"):
        fm.make_fused_minsum_zlane(qc, batch_tile=0, device="cpu")


def test_z384_fits_shared_memory():
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 384)
    assert fm.zlane_kernel_fits(qc)
    # structure plus one frame's beliefs: 52 * 384 floats
    assert fm.zlane_smem_bytes(qc) == 4 * (-(-(4 * 197 + 42 + 52 + 2) // 4) * 4 + 52 * 384)
    dec = fm.make_fused_minsum_zlane(qc, 20, device="cpu")
    assert dec.kind == "fused_zlane" and dec.n == 52 * 384
