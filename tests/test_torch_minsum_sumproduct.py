"""B1, the ``fused`` kernel in sum-product mode on nr_2_0_4: its plain
PyTorch version against ``make_fused_minsum(..., interpret=True)`` and
``make_fused_bp``.  Bar: bits agree on >= 99.9%, conv_iter within 1."""
import jax.numpy as jnp
import pytest
import torch

from test_torch_parity import (EARLY_EXIT, THROUGHPUT, assert_decoder_parity, bpsk_llrs,
                          check_kernel_plain_against_jax)

import ldpc_tpu.codes as jcodes
import ldpc_tpu_torch.codes as tcodes
from ldpc_tpu.ops.pallas_minsum import make_fused_bp as jax_make_fused_bp
from ldpc_tpu_torch.ops.fused_minsum import make_fused_bp


@pytest.mark.parametrize("schedule,flags", [("flooding", EARLY_EXIT), ("layered", THROUGHPUT)])
def test_plain_matches_jax_kernel_nr_2_0_4_sumproduct(schedule, flags):
    check_kernel_plain_against_jax("fused", "nr_2_0_4", 4, "sumproduct", schedule, *flags)


def test_make_fused_bp_matches_jax():
    qc_j = jcodes.qc_layout(jcodes.get_base_graph("nr_2_0_4"), 4)
    qc_t = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_4"), 4)
    llr = bpsk_llrs(qc_t.num_vars, 16, 1.0, seed=2)
    bj, cj = jax_make_fused_bp(qc_j, 8, batch_tile=8, interpret=True)(jnp.asarray(llr))
    bt, ct = make_fused_bp(qc_t, 8, device="cpu")(torch.from_numpy(llr))
    assert_decoder_parity("sumproduct", bj, cj, bt, ct)
