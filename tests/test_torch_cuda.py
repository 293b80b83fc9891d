"""The CUDA kernels against their plain PyTorch versions, on the card.

Skipped without a card.  This file imports neither JAX nor ldpc_tpu, so it
also runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest.py configures JAX.)  Bars: min-sum
bits and conv_iter identical; sum-product bits agree on >= 99.9% and
conv_iter within 1 (the kernel's logf/tanhf round differently from torch's).
"""
import pytest
import torch

from test_torch_parity import ALL_FLAGS, assert_decoder_parity, to_numpy

import ldpc_tpu_torch.codes as tcodes
from ldpc_tpu_torch.ops import fused_minsum as fm
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
