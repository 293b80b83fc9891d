"""B4, the ``corrected_v2`` kernel (replaces ldpc_tpu/ops/pallas_gnn.py:1791
``_corrected_kernel_v2``): its plain PyTorch version against
``make_fused_corrected_gnn_decoder_v2(..., interpret=True)`` and against
``model.apply``, within 3e-2 on soft bits; ``_extract_corrected_v2`` against
the JAX function, every array within 1e-6.  Interpret mode runs at toy_4x8
(each compile takes seconds); the NR codes are held against ``model.apply``."""
import numpy as np
import pytest
import torch

from test_torch_gnn_parity import (both_plans, check_corrected_plain_against_jax,
                                   check_zero_init_early_exit, model_pair)
from test_torch_parity import bpsk_llrs

from ldpc_tpu.ops import pallas_gnn as jpg
from ldpc_tpu_torch.ops import fused_gnn as tfg


@pytest.mark.parametrize("Z,inject,share,snr_db", [(4, True, False, 1.0), (4, False, False, 1.0),
                                                   (8, True, True, 3.0)])
def test_plain_matches_jax_kernel_toy(Z, inject, share, snr_db):
    check_corrected_plain_against_jax("corrected_v2", "toy_4x8", Z, inject, share, snr_db=snr_db)


@pytest.mark.parametrize("name,Z,h", [("nr_2_0_4", 4, 16), ("toy_4x8", 32, 64)])
def test_plain_matches_module(name, Z, h):
    """A 5G base graph, and the production Z and hidden size."""
    check_corrected_plain_against_jax("corrected_v2", name, Z, True, False, T=2, h=h,
                                      batch=3, interpret=False)


def test_zero_init_early_exit_is_min_sum():
    check_zero_init_early_exit("corrected_v2")


@pytest.mark.parametrize("inject,share", [(True, False), (False, False), (True, True)])
def test_extract_corrected_v2_matches_jax(inject, share):
    qj, pj, qt, pt = both_plans("nr_2_0_4", 4)
    llr = bpsk_llrs(qt.num_vars, 2, 1.0, seed=0)
    kw = dict(num_iterations=2, hidden_dim=8, input_injection=inject, share_layers=share)
    _, params, mt = model_pair("create_corrected_minsum_gnn_decoder", pj, pt, llr, **kw)
    want = jpg._extract_corrected_v2(params, qj, 2, 8, share, inject)
    got = tfg._extract_corrected_v2(mt, qt, 2, 8, share, inject)
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(value), rtol=0, atol=1e-6,
                                   err_msg=key)
    assert np.abs(got["w2p"]).max() > 0 and got["ebias"].shape == (4, 8, qt.num_base_edges)


def test_early_exit_agrees_with_fixed_trip_at_high_snr():
    """Every frame converges and stays converged: the early-exit decisions are
    the fixed-T decisions."""
    _, pj, qt, pt = both_plans("toy_4x8", 4)
    llr = bpsk_llrs(qt.num_vars, 8, 6.0, seed=12)
    kw = dict(num_iterations=3, hidden_dim=16, input_injection=True)
    _, _, mt = model_pair("create_corrected_minsum_gnn_decoder", pj, pt, llr, seed=13, **kw)
    fixed = tfg.make_fused_corrected_gnn_decoder_v2(qt, mt, device="cpu", **kw)
    early = tfg.make_fused_corrected_gnn_decoder_v2(qt, mt, device="cpu", early_exit=True, **kw)
    x = torch.from_numpy(llr)
    np.testing.assert_array_equal(early(x).numpy() > 0.5, fixed(x).numpy() > 0.5)
    # plain() is the same function as a call on a CPU tensor
    np.testing.assert_array_equal(fixed.plain(x).numpy(), fixed(x).numpy())
