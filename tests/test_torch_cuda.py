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
bf16 rounding); untrained, they are the fused min-sum kernel exactly.  The
trained min-sum kernel (fused_neural): bits identical.  The fully-neural GNN
kernels (msg_gnn, msg_gnn_v2) at T=2: soft bits within 3e-2, decisions equal
where the plain version is confident.
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


def _add_noise(model, scale, gen):
    """Every parameter moved by scale * normal noise from ``gen``."""
    with torch.no_grad():
        for param in model.parameters():
            param.add_((scale * torch.randn(param.shape, generator=gen)).to(param.device))
    return model


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
        _add_noise(model, 0.05 if h <= 16 else 0.02, gen)
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


def _nms_model(plan, T, L, sharing, learn_a, learn_o, per_it):
    """A NeuralMinSumDecoder with every parameter moved by 0.1 normal noise."""
    from ldpc_tpu_torch.models import NeuralMinSumDecoder

    model = NeuralMinSumDecoder(plan, num_iterations=T, depth_L=L, weight_sharing=sharing,
                                learnable_alpha=learn_a, learnable_offset=learn_o,
                                per_iteration=per_it)
    return _add_noise(model, 0.1, torch.Generator().manual_seed(T + L))


@pytest.mark.parametrize("name,Z,batch", [("toy_4x8", 4, 19), ("nr_2_0_4", 4, 21),
                                          ("nr_2_0_32", 32, 5), ("nr_2_0_32", 128, 3)])
@pytest.mark.parametrize("sharing,L,learn_a,learn_o,per_it", [
    ("scalar", 0, False, False, False), ("cell", 2, True, False, False),
    ("type", 1, True, False, True), ("edge", 2, True, True, True), ("edge", 3, True, True, False)])
def test_fused_neural_kernel_matches_plain(name, Z, batch, sharing, L, learn_a, learn_o, per_it):
    """B3: bits identical to the plain version; Z=128 keeps the state in
    global scratch."""
    from ldpc_tpu_torch.ops import fused_neural as fn

    qc = tcodes.qc_layout(tcodes.get_base_graph(name), Z)
    model = _nms_model(qc_msg.make_plan(qc), 4, L, sharing, learn_a, learn_o, per_it)
    dec = fn.make_fused_neural_minsum(qc, model, 4, L, per_iteration=per_it)
    assert dec.shared == (Z != 128)
    llr = _llr(qc.num_vars, batch, 1.0, seed=Z + L)
    before = fn.LAUNCHES["fused_neural"]
    bits_k, bits_p = dec(llr), dec.plain(llr)
    torch.cuda.synchronize()
    assert fn.LAUNCHES["fused_neural"] == before + 1
    assert bits_k.is_cuda and torch.equal(bits_k, bits_p)


def _msg_model(plan, T, h, inject, share):
    from ldpc_tpu_torch.models import create_message_gnn_decoder

    gen = torch.Generator().manual_seed(7)
    model = create_message_gnn_decoder(plan, num_iterations=T, hidden_dim=h,
                                       input_injection=inject, share_layers=share, generator=gen)
    return _add_noise(model, 0.02, gen)


MSG_BUILDERS = {"msg_gnn": fg.make_fused_gnn_decoder, "msg_gnn_v2": fg.make_fused_gnn_decoder_v2}


@pytest.mark.parametrize("kind", list(MSG_BUILDERS))
@pytest.mark.parametrize("name,Z,h,batch", [("toy_4x8", 4, 16, 19), ("nr_2_0_4", 4, 64, 11),
                                            ("nr_2_0_32", 32, 64, 3)])
@pytest.mark.parametrize("inject,share", [(False, False), (True, False), (True, True)])
def test_msg_gnn_kernel_matches_plain(kind, name, Z, h, batch, inject, share):
    """B6 and B7 at T=2: soft bits within 3e-2 of the plain version,
    decisions identical where the plain version is confident."""
    qc = tcodes.qc_layout(tcodes.get_base_graph(name), Z)
    model = _msg_model(qc_msg.make_plan(qc), 2, h, inject, share)
    dec = MSG_BUILDERS[kind](qc, model, 2, h, share_layers=share, input_injection=inject)
    llr = _llr(qc.num_vars, batch, 2.0, seed=Z + h)
    before = fg.LAUNCHES[kind]
    soft_k, soft_p = dec(llr), dec.plain(llr)
    torch.cuda.synchronize()
    assert fg.LAUNCHES[kind] == before + 1
    assert soft_k.is_cuda and soft_k.shape == llr.shape
    assert (soft_k - soft_p).abs().max().item() <= 3e-2
    confident = (soft_p - 0.5).abs() > 0.05
    assert bool(((soft_k > 0.5) == (soft_p > 0.5))[confident].all())


@pytest.mark.parametrize("kind", ["fused_neural", *MSG_BUILDERS])
def test_resident_blocks_decode_several_frames(kind):
    """A batch of three frames or more per resident block, so that each block
    takes later frames into the scratch slice its earlier frames used: B3
    with its state in global scratch (Z=128) bits identical, B6 and B7 at the
    T=2 bar."""
    from ldpc_tpu_torch.ops import fused_neural as fn

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if kind == "fused_neural":
        qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 128)
        dec = fn.make_fused_neural_minsum(qc, _nms_model(qc_msg.make_plan(qc), 4, 2, "edge", True,
                                                         True, True), 4, 2, per_iteration=True)
        assert not dec.shared
        dims = (qc.Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges, 4, 2)
        resident = fn.kernel_library().ldpc_neural_occupancy(*dims, 1, 0) * sms
    else:
        qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_4"), 4)
        dec = MSG_BUILDERS[kind](qc, _msg_model(qc_msg.make_plan(qc), 2, 64, True, False), 2, 64,
                                 input_injection=True)
        dims = (qc.Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges)
        resident = fg.msg_kernel_library().ldpc_msg_gnn_occupancy(fg.MSG_VARIANT[kind], 64,
                                                                   *dims) * sms
    llr = _llr(qc.num_vars, 3 * resident + 1, 1.0, seed=5)
    out_k, out_p = dec(llr), dec.plain(llr)
    torch.cuda.synchronize()
    if kind == "fused_neural":
        assert torch.equal(out_k, out_p)
    else:
        assert (out_k - out_p).abs().max().item() <= 3e-2
        confident = (out_p - 0.5).abs() > 0.05
        assert bool(((out_k > 0.5) == (out_p > 0.5))[confident].all())


def test_slice3_raising_paths():
    """A width without an instantiation; a CPU tensor or a strided one for a
    card decoder."""
    from ldpc_tpu_torch.ops import fused_neural as fn

    qc = tcodes.qc_layout(tcodes.get_base_graph("toy_4x8"), 4)
    plan = qc_msg.make_plan(qc)
    with pytest.raises(ValueError, match="hidden_dim in"):
        fg.make_fused_gnn_decoder(qc, _msg_model(plan, 2, 32, False, False), 2, 32)
    dec = fn.make_fused_neural_minsum(qc, _nms_model(plan, 3, 2, "edge", True, True, True), 3, 2,
                                      per_iteration=True)
    with pytest.raises(ValueError, match="contiguous"):
        dec(torch.zeros((qc.num_vars, 3), device="cuda").t())
    with pytest.raises(ValueError, match="built for cuda"):
        dec(torch.zeros((3, qc.num_vars)))
    msg = fg.make_fused_gnn_decoder_v2(qc, _msg_model(plan, 2, 16, False, False), 2, 16)
    with pytest.raises(ValueError, match="built for cuda"):
        msg(torch.zeros((3, qc.num_vars)))
