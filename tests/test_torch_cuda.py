"""The CUDA kernels against their plain PyTorch versions, on the card.

Skipped without a card.  This file imports neither JAX nor ldpc_tpu, so it
also runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest.py configures JAX.)  Bars: min-sum
bits and conv_iter identical; sum-product bits agree on >= 99.9% and
conv_iter within 1 (the kernel's logf/tanhf round differently from torch's).
The corrected-GNN kernels: soft bits within 2e-2 on frames whose conv_iter
agrees, decisions equal on >= 99.9% of bits, conv_iter equal on >= 99% of
frames (the products sum in another order than torch.matmul, which can flip a
bf16 rounding); untrained, they are the fused min-sum kernel exactly.
"""
import pytest
import torch

from test_torch_parity import ALL_FLAGS, assert_decoder_parity, to_numpy

import ldpc_tpu_torch.codes as tcodes
from ldpc_tpu_torch.models import create_corrected_minsum_gnn_decoder
from ldpc_tpu_torch.ops import fused_gnn as fg, fused_minsum as fm, qc_msg
from ldpc_tpu_torch.utils import bpsk_awgn_llr

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs an NVIDIA card"),
]

CASES = [("fused", "toy_4x8", 4, 19), ("fused", "nr_2_0_4", 8, 21),
         ("fused", "nr_2_0_32", 32, 7), ("fused_zlane", "nr_2_0_4", 24, 9)]


def _llr(n, batch, snr_db, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return bpsk_awgn_llr(gen, torch.zeros((batch, n), device="cuda"), snr_db)


@pytest.mark.parametrize("kind,name,Z,batch", CASES)
@pytest.mark.parametrize("mode,schedule,track,early_exit", ALL_FLAGS)
def test_kernel_matches_plain(kind, name, Z, batch, mode, schedule, track, early_exit):
    qc = tcodes.qc_layout(tcodes.get_base_graph(name), Z)
    build = fm.make_fused_minsum if kind == "fused" else fm.make_fused_minsum_zlane
    dec = build(qc, 10, 0.75, mode=mode, track_convergence=track, early_exit=early_exit,
                schedule=schedule)
    llr = _llr(qc.num_vars, batch, 1.0, seed=Z)
    before = fm.LAUNCHES[kind]
    bits_k, conv_k = dec(llr)
    assert fm.LAUNCHES[kind] == before + 1
    bits_p, conv_p = dec.plain(llr)
    torch.cuda.synchronize()
    assert bits_k.is_cuda and conv_k.dtype == torch.int32
    assert_decoder_parity(mode, to_numpy(bits_k), to_numpy(conv_k), to_numpy(bits_p),
                          to_numpy(conv_p))


def test_zlane_frames_per_block_loop():
    """Fewer blocks than frames: each block walks several frames."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 384)
    dec = fm.make_fused_minsum_zlane(qc, 10, batch_tile=3)
    llr = _llr(qc.num_vars, 10, 1.5, seed=1)
    (bk, ck), (bp, cp) = dec(llr), dec.plain(llr)
    assert_decoder_parity("minsum", to_numpy(bk), to_numpy(ck), to_numpy(bp), to_numpy(cp))


def test_launch_errors_raise():
    qc = tcodes.qc_layout(tcodes.get_base_graph("toy_4x8"), 4)
    dec = fm.make_fused_minsum(qc, 5)
    with pytest.raises(ValueError, match="contiguous"):
        dec(torch.zeros((qc.num_vars, 3), device="cuda").t())
    with pytest.raises(ValueError, match="built for cuda"):
        dec(torch.zeros((3, qc.num_vars)))


GNN_BUILDERS = {"corrected_v2": fg.make_fused_corrected_gnn_decoder_v2,
                "corrected": fg.make_fused_corrected_gnn_decoder}


def _corrected_model(plan, T, h, inject, share, perturb):
    """Seeded parameters, moved by normal noise when ``perturb``: 0.05 up to
    h=16, 0.02 above.  The bf16 steps grow with the activations: at h=64 and
    noise 0.05 one flipped rounding of ``corrected``'s second-layer output
    (near 30, step 0.125 to 0.25) moves a message by 1e-2.  The flips cascade
    from one iteration to the next, so the cases run two iterations: at three,
    the plain version on the card and on the CPU (the same function, another
    summation order in the matrix products) already differ by 3e-3."""
    gen = torch.Generator().manual_seed(7)
    model = create_corrected_minsum_gnn_decoder(plan, num_iterations=T, hidden_dim=h,
                                                input_injection=inject, share_layers=share,
                                                generator=gen)
    if perturb:
        with torch.no_grad():
            for param in model.parameters():
                scale = 0.05 if h <= 16 else 0.02
                param.add_((scale * torch.randn(param.shape, generator=gen)).to(param.device))
    return model


@pytest.mark.parametrize("kind", list(GNN_BUILDERS))
@pytest.mark.parametrize("name,Z,h,batch", [("toy_4x8", 4, 16, 19), ("toy_4x8", 8, 16, 5),
                                            ("nr_2_0_4", 4, 64, 11), ("nr_2_0_32", 32, 64, 3)])
@pytest.mark.parametrize("inject,share,early_exit", [(True, False, False), (False, False, True),
                                                     (True, True, True)])
def test_corrected_gnn_kernel_matches_plain(kind, name, Z, h, batch, inject, share, early_exit):
    qc = tcodes.qc_layout(tcodes.get_base_graph(name), Z)
    model = _corrected_model(qc_msg.make_plan(qc), 2, h, inject, share, perturb=True)
    dec = GNN_BUILDERS[kind](qc, model, 2, h, share_layers=share, input_injection=inject,
                             early_exit=early_exit, return_iterations=early_exit)
    llr = _llr(qc.num_vars, batch, 3.0, seed=Z)
    before = fg.LAUNCHES[kind]
    out_k, out_p = dec(llr), dec.plain(llr)
    torch.cuda.synchronize()
    assert fg.LAUNCHES[kind] == before + 1
    if early_exit:
        (soft_k, conv_k), (soft_p, conv_p) = out_k, out_p
        assert conv_k.dtype == torch.float32
        same = conv_k == conv_p
        assert same.float().mean().item() >= 0.99
    else:
        soft_k, soft_p = out_k, out_p
        same = torch.ones(batch, dtype=torch.bool, device=llr.device)
    assert soft_k.is_cuda and soft_k.shape == llr.shape
    assert ((soft_k > 0.5) == (soft_p > 0.5)).float().mean().item() >= 0.999
    assert (soft_k - soft_p)[same].abs().max().item() <= 2e-2


@pytest.mark.parametrize("kind", list(GNN_BUILDERS))
def test_untrained_corrected_gnn_is_fused_minsum(kind):
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_4"), 8)
    model = _corrected_model(qc_msg.make_plan(qc), 8, 16, True, False, perturb=False)
    llr = _llr(qc.num_vars, 64, 2.0, seed=3)
    soft, conv = GNN_BUILDERS[kind](qc, model, 8, 16, early_exit=True,
                                    return_iterations=True)(llr)
    bits, conv_ms = fm.make_fused_minsum(qc, 8, 0.8, early_exit=True)(llr)
    assert torch.equal((soft > 0.5).float(), bits) and torch.equal(conv, conv_ms.float())


def test_corrected_gnn_launch_errors_raise():
    qc = tcodes.qc_layout(tcodes.get_base_graph("toy_4x8"), 4)
    model = _corrected_model(qc_msg.make_plan(qc), 2, 16, True, False, perturb=False)
    dec = fg.make_fused_corrected_gnn_decoder_v2(qc, model, 2, 16)
    with pytest.raises(ValueError, match="contiguous"):
        dec(torch.zeros((qc.num_vars, 3), device="cuda").t())
    with pytest.raises(ValueError, match="built for cuda"):
        dec(torch.zeros((3, qc.num_vars)))
