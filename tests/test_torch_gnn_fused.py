"""B5, the ``corrected`` kernel (replaces ldpc_tpu/ops/pallas_gnn.py:1341
``_corrected_kernel``): its plain PyTorch version against
``make_fused_corrected_gnn_decoder(..., interpret=True)`` and ``model.apply``
within 3e-2; ``_extract_corrected`` against the JAX function within 1e-6;
the two kernels' plain versions within 2e-2 of each other; and the builders'
argument checks."""
import numpy as np
import pytest
import torch

from test_torch_gnn_parity import (both_plans, check_corrected_plain_against_jax,
                                   check_zero_init_early_exit, model_pair)
from test_torch_parity import bpsk_llrs

import ldpc_tpu_torch.codes as tcodes
from ldpc_tpu.ops import pallas_gnn as jpg
from ldpc_tpu_torch.ops import fused_gnn as tfg


@pytest.mark.parametrize("Z,inject,share,snr_db", [(4, True, False, 1.0), (4, False, False, 1.0),
                                                   (8, True, True, 3.0)])
def test_plain_matches_jax_kernel_toy(Z, inject, share, snr_db):
    check_corrected_plain_against_jax("corrected", "toy_4x8", Z, inject, share, snr_db=snr_db)


@pytest.mark.parametrize("name,Z,h", [("nr_2_0_4", 4, 16), ("toy_4x8", 32, 16)])
def test_plain_matches_module(name, Z, h):
    check_corrected_plain_against_jax("corrected", name, Z, True, False, T=2, h=h,
                                      batch=3, interpret=False)


def test_zero_init_early_exit_is_min_sum():
    check_zero_init_early_exit("corrected")


@pytest.mark.parametrize("inject,share", [(True, False), (False, False), (True, True)])
def test_extract_corrected_matches_jax(inject, share):
    qj, pj, qt, pt = both_plans("nr_2_0_4", 4)
    llr = bpsk_llrs(qt.num_vars, 2, 1.0, seed=0)
    kw = dict(num_iterations=2, hidden_dim=8, input_injection=inject, share_layers=share)
    _, params, mt = model_pair("create_corrected_minsum_gnn_decoder", pj, pt, llr, **kw)
    want = jpg._extract_corrected(params, qj, 2, 8, share, inject)
    got = tfg._extract_corrected(mt.state_dict(), qt, 2, 8, share, inject)
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(value), rtol=0, atol=1e-6,
                                   err_msg=key)
    assert got["h_in"] == (24 if inject else 16)


def test_two_kernels_agree():
    """Two functions (they round to bf16 at different places), 2e-2 apart at
    most: the bar of tests/test_pallas_gnn.py between the JAX kernels."""
    _, pj, qt, pt = both_plans("toy_4x8", 32)
    llr = bpsk_llrs(qt.num_vars, 4, 1.0, seed=1)
    kw = dict(num_iterations=2, hidden_dim=16, input_injection=True)
    _, _, mt = model_pair("create_corrected_minsum_gnn_decoder", pj, pt, llr, seed=11, **kw)
    x = torch.from_numpy(llr)
    v1 = tfg.make_fused_corrected_gnn_decoder(qt, mt, device="cpu", **kw)(x)
    v2 = tfg.make_fused_corrected_gnn_decoder_v2(qt, mt, device="cpu", **kw)(x)
    np.testing.assert_allclose(v2.numpy(), v1.numpy(), rtol=0, atol=2e-2)
    assert not np.array_equal(v2.numpy(), v1.numpy())


def test_plain_walks_a_large_batch_in_chunks(monkeypatch):
    _, pj, qt, pt = both_plans("toy_4x8", 4)
    llr = bpsk_llrs(qt.num_vars, 7, 1.0, seed=3)
    kw = dict(num_iterations=2, hidden_dim=16, input_injection=True)
    _, _, mt = model_pair("create_corrected_minsum_gnn_decoder", pj, pt, llr, **kw)
    dec = tfg.make_fused_corrected_gnn_decoder_v2(qt, mt, device="cpu", early_exit=True,
                                                  return_iterations=True, **kw)
    x = torch.from_numpy(llr)
    whole = dec(x)
    monkeypatch.setattr(tfg, "_PLAIN_CHUNK_BYTES", 2 * qt.num_edges * 16 * 4)  # 2 frames
    for a, b in zip(dec(x), whole):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    empty_soft, empty_conv = dec(x[:0])
    assert empty_soft.shape == (0, qt.num_vars) and empty_conv.shape == (0,)


def test_argument_errors():
    _, pj, qt, pt = both_plans("toy_4x8", 4)
    llr = bpsk_llrs(qt.num_vars, 2, 1.0, seed=0)
    kw = dict(num_iterations=2, hidden_dim=16, input_injection=True)
    _, _, mt = model_pair("create_corrected_minsum_gnn_decoder", pj, pt, llr, **kw)
    for build in (tfg.make_fused_corrected_gnn_decoder, tfg.make_fused_corrected_gnn_decoder_v2):
        with pytest.raises(ValueError, match="return_iterations requires early_exit"):
            build(qt, mt, return_iterations=True, device="cpu", **kw)
        with pytest.raises(ValueError, match="hidden_dim in"):
            build(qt, mt, 2, 32, device="cpu")
        with pytest.raises(ValueError, match="num_iterations"):
            build(qt, mt, 0, 16, device="cpu")
        # Z=384: one frame's messages alone exceed a block's shared memory
        big = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 384)
        with pytest.raises(ValueError, match="shared memory"):
            build(big, mt, 2, 16, device="cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(qt, mt, **kw)  # the default device is the card
        dec = build(qt, mt, device="cpu", **kw)
        with pytest.raises(TypeError, match="float32"):
            dec(torch.zeros((2, qt.num_vars), dtype=torch.float64))
        with pytest.raises(ValueError, match=rf"\(B, {qt.num_vars}\)"):
            dec(torch.zeros((2, 5)))
    with pytest.raises(TypeError, match="state_dict"):
        tfg.make_fused_corrected_gnn_decoder(qt, [1, 2], device="cpu", **kw)
    # the plan of shared memory: main-path shapes fit one block, as the source says
    qc32 = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 32)
    assert tfg.corrected_smem_bytes("corrected_v2", qc32, 64) == 4 * 44324
    assert tfg.corrected_smem_bytes("corrected", qc32, 64) == 4 * 50404
    assert tfg.corrected_scratch_floats(qc32, 64) == (2 * 52 + 42) * 64 * 32


@pytest.mark.parametrize("build", [tfg.make_fused_corrected_gnn_decoder_v2,
                                   tfg.make_fused_corrected_gnn_decoder])
def test_rounding_noise(build):
    """Why the kernels are held to tolerances and not to equality: a relative
    input change of 1e-6 (the size of a float32 sum taken in another order)
    flips bf16 roundings inside the corrections and moves the soft bits of
    three iterations by far more than 1e-6, yet well inside the 2e-2 bar."""
    _, pj, qt, pt = both_plans("toy_4x8", 4)
    llr = torch.from_numpy(bpsk_llrs(qt.num_vars, 64, 1.0, seed=0))
    kw = dict(num_iterations=3, hidden_dim=16, input_injection=True)
    _, _, mt = model_pair("create_corrected_minsum_gnn_decoder", pj, pt, llr.numpy(), **kw)
    dec = build(qt, mt, device="cpu", **kw)
    moved = (dec(llr) - dec(llr * (1 + 1e-6))).abs().max().item()
    assert 1e-5 < moved < 2e-2
