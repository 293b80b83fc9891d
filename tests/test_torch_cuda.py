"""The CUDA kernels against their plain PyTorch versions, on the card.

Skipped without a card.  This file imports neither JAX nor ldpc_tpu, so it
also runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest.py configures JAX.)  Bars: min-sum
bits and conv_iter identical; sum-product bits agree on >= 99.9% and
conv_iter within 1 (the kernel's logf/tanhf round differently from torch's),
and retire_sumproduct identical to the fused kernel it replaced.
The corrected-GNN kernels: soft bits within 2e-2 on frames whose conv_iter
agrees, decisions equal on >= 99.9% of bits, conv_iter equal on >= 99% of
frames (the products sum in another order than torch.matmul, which can flip a
bf16 rounding); untrained, they are the fused min-sum kernel exactly; both
(tensor cores) on the exact inputs of ops/msg_gnn_exact.py: soft bits and
conv_iter identical.  The
trained min-sum kernels (neural_group, fused_neural): bits identical.  The fully-neural GNN
kernels (msg_gnn, msg_gnn_v2, msg_gnn_v3, msg_gnn_v4) at T=2: soft bits within
3e-2, decisions equal where the plain version is confident; all four on the
exact inputs of ops/msg_gnn_exact.py (msg_gnn_v3 and msg_gnn_v4 also with
nonzero type embeddings, msg_gnn_v4 also at T=1): identical; msg_gnn_v2 and
msg_gnn_v4 at h=128 (warpgroup tiles on wgmma, their weights streamed through a
ring of chunks) to the same bars, also over ten layers and several frames a
block, their SASS on wgmma.  The aggregation
probe: vpu identical to its plain version, mxu within one bf16 step (the
tensor cores' float32 sums need not round as IEEE additions do), both
identical on integer-valued features.
"""
import pytest
import torch

from test_torch_parity import (ALL_FLAGS, EARLY_EXIT, THROUGHPUT, TRACKING,
                               assert_decoder_parity, to_numpy)

import ldpc_tpu_torch.codes as tcodes
from ldpc_tpu_torch.models import create_corrected_minsum_gnn_decoder
from ldpc_tpu_torch.ops import fused_gnn as fg, fused_minsum as fm, qc_msg
from ldpc_tpu_torch.ops.msg_gnn_exact import (CORRECTED_EXACT_CASES, EXACT_CASES,
                                              EXACT_TE_CASES, EXACT_TYPE_EMBEDDINGS,
                                              EXACT_WIDE_CASES, exact_corrected_case,
                                              exact_msg_gnn_case)
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
    # every mode and schedule runs on its retiring kernel: min-sum flooding
    # on fused_retire / retire_zlane, layered min-sum on retire_layered /
    # retire_zlane_layered, sum-product flooding on retire_sumproduct /
    # retire_zlane_sumproduct, layered sum-product on
    # retire_layered_sumproduct / retire_zlane_layered_sumproduct
    retiring = {("minsum", "fused", "flooding"): "fused_retire",
                ("minsum", "fused_zlane", "flooding"): "retire_zlane",
                ("minsum", "fused", "layered"): "retire_layered",
                ("minsum", "fused_zlane", "layered"): "retire_zlane_layered",
                ("sumproduct", "fused", "flooding"): "retire_sumproduct",
                ("sumproduct", "fused_zlane", "flooding"): "retire_zlane_sumproduct",
                ("sumproduct", "fused", "layered"): "retire_layered_sumproduct",
                ("sumproduct", "fused_zlane", "layered"): "retire_zlane_layered_sumproduct"}
    assert dec.route == retiring[(mode, kind, schedule)]
    before = fm.LAUNCHES[dec.route]
    bits_k, conv_k = dec(llr)
    assert fm.LAUNCHES[dec.route] == before + 1
    bits_p, conv_p = dec.plain(llr)
    torch.cuda.synchronize()
    assert bits_k.is_cuda and conv_k.dtype == torch.int32
    assert_decoder_parity(mode, to_numpy(bits_k), to_numpy(conv_k), to_numpy(bits_p),
                          to_numpy(conv_p))


# fused_retire at every shape it serves; batches that are not a multiple of
# the frames a block holds (7 at Z=32, 3 at Z=64, 10 to 15 below).
RETIRE_SHAPES = [("toy_4x8", 4, 31), ("nr_2_0_4", 8, 53), ("nr_2_0_32", 24, 45),
                 ("nr_2_0_32", 32, 97), ("nr_2_0_32", 64, 23)]


def _assert_identical(out_k, out_p):
    (bits_k, conv_k), (bits_p, conv_p) = out_k, out_p
    torch.cuda.synchronize()
    assert bits_k.is_cuda and conv_k.dtype == torch.int32
    assert torch.equal(bits_k, bits_p) and torch.equal(conv_k, conv_p)


@pytest.mark.parametrize("snr_db", [-2.0, 1.0, 4.0])
@pytest.mark.parametrize("track,early_exit", [TRACKING, THROUGHPUT, EARLY_EXIT])
@pytest.mark.parametrize("name,Z,batch", RETIRE_SHAPES)
def test_retire_kernel_matches_plain(name, Z, batch, track, early_exit, snr_db):
    """Frames that never converge (-2 dB), that converge early (4 dB) and a
    mix: bits and conv_iter identical to the plain version."""
    qc = tcodes.qc_layout(tcodes.get_base_graph(name), Z)
    dec = fm.make_fused_minsum(qc, 12, 0.75, track_convergence=track, early_exit=early_exit)
    llr = _llr(qc.num_vars, batch, snr_db, seed=Z + int(snr_db))
    before = fm.LAUNCHES["fused_retire"]
    out = dec(llr)
    assert fm.LAUNCHES["fused_retire"] == before + 1
    _assert_identical(out, dec.plain(llr))


@pytest.mark.parametrize("parts", [1, 2, 3, 4])
def test_retire_kernel_ties_and_zeros(parts):
    """Quantised LLRs (tied minimums, m1 == m2) with exact +0.0 and -0.0
    (sign(0) = +1), every split of a frame into parts (warps)."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 32)
    llr = torch.round(_llr(qc.num_vars, 61, 1.0, seed=3) / 2.0) * 2.0
    llr[::3, ::5] = 0.0
    llr[1::3, 2::5] = -0.0
    for track in (True, False):
        dec = fm.make_fused_minsum(qc, 12, 0.75, track_convergence=track)
        _assert_identical(dec._launch_retire(llr, parts=parts), dec.plain(llr))


def test_retire_kernel_groups_take_several_frames():
    """More frames than resident frame groups: each group takes frames from
    the counter until the batch is done."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 32)
    dec = fm.make_fused_minsum(qc, 20, 0.75)
    llr = _llr(qc.num_vars, 4001, 1.5, seed=11)
    parts, frames, per_sm = fm.retire_plan(qc, True)
    assert 4001 > frames * per_sm * torch.cuda.get_device_properties(0).multi_processor_count
    _assert_identical(dec(llr), dec.plain(llr))


@pytest.mark.parametrize("track", [True, False])
def test_wide_rows_run_on_the_fused_kernel(track):
    """A code with a row of 31 members, more than fused_retire's 32-bit
    state word holds signs of: min-sum flooding launches fused_retire_wide
    (the 64-bit word) and not fused; a row of 122 members, more than the
    128-bit word holds, still launches the fused kernel.  Bits and conv_iter
    identical to the plain version."""
    from test_torch_minsum_retire import wide_row_shifts
    from test_torch_retire_wide import row_code

    for qc, route in ((tcodes.qc_layout(tcodes.BaseGraph("wide", wide_row_shifts()), 4),
                       "fused_retire_wide"), (row_code(122, cols=124), "fused")):
        dec = fm.make_fused_minsum(qc, 12, 0.75, track_convergence=track)
        assert dec.route == route
        llr = _llr(qc.num_vars, 37, 4.0, seed=5)
        before = dict(fm.LAUNCHES)
        out = dec(llr)
        assert fm.LAUNCHES[route] == before[route] + 1
        assert sum(fm.LAUNCHES.values()) == sum(before.values()) + 1
        _assert_identical(out, dec.plain(llr))


# The four B1 schedules on the 64-bit state word (fm.WIDE_ROUTES), at rows of
# 31 and 58 members (Z=4, batches that are not a multiple of a block's
# frames) and 32 (IEEE 802.3an's shape, Z=64).
WIDE_SCHEDULES = [("minsum", "flooding"), ("minsum", "layered"), ("sumproduct", "flooding"),
                  ("sumproduct", "layered")]


@pytest.mark.parametrize("mode,schedule", WIDE_SCHEDULES)
@pytest.mark.parametrize("track,early_exit", [TRACKING, THROUGHPUT, EARLY_EXIT])
@pytest.mark.parametrize("name", ["w31", "w58", "ieee"])
def test_wide_rows_match_plain(name, track, early_exit, mode, schedule):
    """Each wide kernel, one launch of its route: min-sum bits and conv_iter
    identical to the plain version, sum-product at its bars and identical to
    the fused kernel (_launch_fused), on frames that never converge, that
    converge early and a mix."""
    from test_torch_retire_wide import WIDE_ROUTE, code

    qc = code(name)
    dec = fm.make_fused_minsum(qc, 12, 0.75 if mode == "minsum" else 1.0, mode=mode,
                               schedule=schedule, track_convergence=track,
                               early_exit=early_exit)
    assert dec.route == WIDE_ROUTE[mode, schedule]
    for snr_db in ((5.0, 6.0, 7.0) if name == "ieee" else (1.0, 4.0, 6.0)):
        llr = _llr(qc.num_vars, 301 if name == "ieee" else 37, snr_db, seed=qc.dr_max)
        before = dict(fm.LAUNCHES)
        out = dec(llr)
        assert fm.LAUNCHES[dec.route] == before[dec.route] + 1
        if mode == "minsum":
            _assert_identical(out, dec.plain(llr))
            _assert_identical(dec._launch_fused(llr), out)
        else:
            _assert_sumproduct(dec, llr, out)


@pytest.mark.parametrize("mode,schedule", WIDE_SCHEDULES)
@pytest.mark.parametrize("track,early_exit", [TRACKING, THROUGHPUT, EARLY_EXIT])
@pytest.mark.parametrize("name", ["w59", "w64", "w121", "array61"])
def test_w128_rows_match_plain(name, track, early_exit, mode, schedule):
    """The four B1 kernels on the 128-bit state word (fm.W128_ROUTES), one
    launch of the route and no other kernel, at rows of 59, 64 and 121
    members (Z=4) and on the array code at p = 61 (Z=61, not a power of
    two): min-sum bits and conv_iter identical to the plain version and to
    fused (_launch_fused), sum-product at its bars and identical to fused,
    on frames that never converge, that converge early and a mix."""
    from test_torch_retire_w128 import W128_ROUTE, code

    qc = code(name)
    dec = fm.make_fused_minsum(qc, 12, 0.75 if mode == "minsum" else 1.0, mode=mode,
                               schedule=schedule, track_convergence=track,
                               early_exit=early_exit)
    assert dec.route == W128_ROUTE[mode, schedule]
    for snr_db in ((6.0, 7.25, 8.5) if name == "array61" else (1.0, 5.0, 7.0)):
        llr = _llr(qc.num_vars, 29 if name == "array61" else 37, snr_db, seed=qc.dr_max)
        before = dict(fm.LAUNCHES)
        out = dec(llr)
        moved = {k: fm.LAUNCHES[k] - before[k] for k in before}
        assert moved == {k: int(k == dec.route) for k in before}
        if mode == "minsum":
            _assert_identical(out, dec.plain(llr))
            _assert_identical(dec._launch_fused(llr), out)
        else:
            _assert_sumproduct(dec, llr, out)


@pytest.mark.parametrize("mode,schedule", WIDE_SCHEDULES)
@pytest.mark.parametrize("track,early_exit", [TRACKING, THROUGHPUT, EARLY_EXIT])
@pytest.mark.parametrize("name", ["w31", "w58", "w64", "w121", "ieee384", "array256"])
def test_zlane_wide_rows_match_plain(name, track, early_exit, mode, schedule):
    """The four large-Z kernels on the 64-bit word (rows of 31 and 58 at
    Z=8, of 32 at Z=384, not a power of two) and on the 128-bit word (rows
    of 64 and 121 at Z=8, of 64 at Z=256, a power of two), one launch of
    the route and no other kernel: min-sum bits and conv_iter identical to
    the plain version, sum-product at its bars, and both identical to
    fused_zlane (_launch_zlane), on frames that never converge, that
    converge early and a mix."""
    from test_torch_zlane_retire_wide import ROUTE, array_256, code, ieee_384

    qc = {"ieee384": ieee_384, "array256": array_256}.get(name, lambda: code(name))()
    suffix = "_wide" if qc.dr_max <= 58 else "_w128"
    dec = fm.make_fused_minsum_zlane(qc, 12, 0.75 if mode == "minsum" else 1.0, mode=mode,
                                     schedule=schedule, track_convergence=track,
                                     early_exit=early_exit)
    assert dec.route == ROUTE[mode, schedule] + suffix
    large = qc.Z > 8
    for snr_db in ((5.5, 7.0, 9.0) if large else (1.0, 6.0, 8.0)):
        llr = _llr(qc.num_vars, 9 if large else 37, snr_db, seed=qc.dr_max + qc.Z)
        before = dict(fm.LAUNCHES)
        out = dec(llr)
        moved = {k: fm.LAUNCHES[k] - before[k] for k in before}
        assert moved == {k: int(k == dec.route) for k in before}
        _assert_zlane_path(dec, llr, out)


@pytest.mark.parametrize("mode,schedule", WIDE_SCHEDULES)
def test_fused_holds_rows_over_121(mode, schedule):
    """A row of 122 members, more than the 128-bit word holds: every
    schedule launches fused, held against the plain version (min-sum
    identical, sum-product at its bars)."""
    from test_torch_retire_w128 import wide_row_code

    qc = wide_row_code(122)
    dec = fm.make_fused_minsum(qc, 12, 0.75 if mode == "minsum" else 1.0, mode=mode,
                               schedule=schedule)
    assert dec.route == "fused" and not dec.retire
    llr = _llr(qc.num_vars, 37, 5.0, seed=122)
    before = dict(fm.LAUNCHES)
    bits_k, conv_k = dec(llr)
    assert fm.LAUNCHES["fused"] == before["fused"] + 1
    bits_p, conv_p = dec.plain(llr)
    torch.cuda.synchronize()
    assert_decoder_parity(mode, to_numpy(bits_k), to_numpy(conv_k), to_numpy(bits_p),
                          to_numpy(conv_p))


# retire_layered at every shape it serves: Z=4 (one warp, 4 lanes), Z=24 (not
# a power of two), Z=32 and Z=64 (two warps span Z); batches that are not a
# multiple of a block's frames.
LAYERED_SHAPES = [("toy_4x8", 4, 67), ("nr_2_0_4", 4, 53), ("nr_2_0_32", 24, 45),
                  ("nr_2_0_32", 32, 97), ("nr_2_0_32", 64, 23)]


@pytest.mark.parametrize("snr_db", [-2.0, 1.0, 4.0])
@pytest.mark.parametrize("track,early_exit", [TRACKING, THROUGHPUT, EARLY_EXIT])
@pytest.mark.parametrize("name,Z,batch", LAYERED_SHAPES)
def test_retire_layered_matches_plain(name, Z, batch, track, early_exit, snr_db):
    """Layered min-sum: frames that never converge (-2 dB), that converge
    early (4 dB) and a mix; bits and conv_iter identical to the plain
    version, one launch of retire_layered."""
    qc = tcodes.qc_layout(tcodes.get_base_graph(name), Z)
    dec = fm.make_fused_minsum(qc, 12, 0.75, track_convergence=track, early_exit=early_exit,
                               schedule="layered")
    llr = _llr(qc.num_vars, batch, snr_db, seed=Z + int(snr_db))
    before = dict(fm.LAUNCHES)
    out = dec(llr)
    moved = {k: fm.LAUNCHES[k] - before[k] for k in before}
    assert moved == {k: int(k == "retire_layered") for k in before}
    _assert_identical(out, dec.plain(llr))


@pytest.mark.parametrize("parts", [1, 2, 3])
def test_retire_layered_ties_and_zeros(parts):
    """Quantised LLRs (tied minimums) with exact +0.0 and -0.0, the rows of
    a row group on 1, 2 or 3 warps of a frame."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 32)
    llr = torch.round(_llr(qc.num_vars, 61, 1.0, seed=3) / 2.0) * 2.0
    llr[::3, ::5] = 0.0
    llr[1::3, 2::5] = -0.0
    for track in (True, False):
        dec = fm.make_fused_minsum(qc, 12, 0.75, track_convergence=track, schedule="layered")
        _assert_identical(dec._launch_retire(llr, parts=parts), dec.plain(llr))


def test_retire_layered_groups_take_several_frames():
    """More frames than resident frame groups, and the replaced fused kernel
    on the same batch: all three identical."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 32)
    dec = fm.make_fused_minsum(qc, 20, 0.75, schedule="layered")
    llr = _llr(qc.num_vars, 4001, 1.5, seed=11)
    parts, frames, per_sm = fm.retire_layered_plan(qc, True)
    assert 4001 > frames * per_sm * torch.cuda.get_device_properties(0).multi_processor_count
    out = dec(llr)
    _assert_identical(out, dec.plain(llr))
    _assert_identical(dec._launch_fused(llr), out)


@pytest.mark.parametrize("track,early_exit", [TRACKING, THROUGHPUT, EARLY_EXIT])
def test_retire_layered_wide_rows(track, early_exit):
    """A row of 20 members, wider than the kernel's unrolled bodies, runs
    its run-time loop: bits and conv_iter identical to the plain version."""
    import numpy as np

    rng = np.random.default_rng(3)
    shifts = np.where(rng.random((4, 32)) < 0.4, rng.integers(0, 4, (4, 32)), -1)
    shifts[0] = np.concatenate([rng.integers(0, 4, 20), np.full(12, -1)])
    shifts[1, 20:] = 1
    qc = tcodes.qc_layout(tcodes.BaseGraph("wide", shifts), 4)
    assert qc.dr_max == 20
    dec = fm.make_fused_minsum(qc, 12, 0.75, track_convergence=track, early_exit=early_exit,
                               schedule="layered")
    assert dec.route == "retire_layered"
    for snr_db in (1.0, 4.0):
        llr = _llr(qc.num_vars, 37, snr_db, seed=6)
        _assert_identical(dec(llr), dec.plain(llr))


def test_retire_layered_refused_plan_raises():
    """A plan the kernel cannot take raises; nothing falls back to fused."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 32)
    dec = fm.make_fused_minsum(qc, 5, schedule="layered")
    before = dict(fm.LAUNCHES)
    with pytest.raises(RuntimeError, match="retire_layered"):
        dec._launch_retire(_llr(qc.num_vars, 3, 1.0, seed=1), parts=4)
    assert fm.LAUNCHES == before


@pytest.mark.skipif("torch.cuda.device_count() < 2", reason="needs two NVIDIA cards")
def test_one_decoder_on_two_cards():
    """One decoder serves LLRs on two cards: each launch reads the structure
    from its own card."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 32)
    for dec in (fm.make_fused_minsum(qc, 12, 0.75), fm.make_fused_bp(qc, 5)):
        for card in (0, 1, 0):
            llr = _llr(qc.num_vars, 29, 1.0, seed=card).to(f"cuda:{card}")
            bits, conv = dec(llr)
            assert bits.device == llr.device
            bits_p, conv_p = dec.plain(llr)
            assert_decoder_parity(dec.mode, to_numpy(bits), to_numpy(conv), to_numpy(bits_p),
                                  to_numpy(conv_p))


def test_minsum_flooding_launches_retire_kernel():
    """Min-sum flooding (builder and serving object) launches fused_retire,
    layered min-sum (builder and serving object) retire_layered; sum-product
    flooding launches retire_sumproduct, layered sum-product
    retire_layered_sumproduct; none launches the fused kernel."""
    from ldpc_tpu_torch.models.classical import MinSumScaledDecoder

    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 32)
    llr = _llr(qc.num_vars, 9, 1.0, seed=2)
    before = dict(fm.LAUNCHES)
    fm.make_fused_minsum(qc, 5)(llr)
    MinSumScaledDecoder(qc, 5, backend="auto").decode(llr)
    fm.make_fused_bp(qc, 5)(llr)
    fm.make_fused_minsum(qc, 5, schedule="layered")(llr)
    MinSumScaledDecoder(qc, 5, backend="auto", schedule="layered").decode(llr)
    fm.make_fused_minsum(qc, 5, mode="sumproduct", schedule="layered")(llr)
    torch.cuda.synchronize()
    moved = {k: fm.LAUNCHES[k] - before[k] for k in before}
    assert moved == {"fused_retire": 2, "fused": 0, "retire_zlane": 0, "fused_zlane": 0,
                     "retire_layered": 2, "retire_sumproduct": 1, "retire_zlane_layered": 0,
                     "retire_zlane_sumproduct": 0, "retire_layered_sumproduct": 1,
                     "retire_zlane_layered_sumproduct": 0,
                     **{r: 0 for r in fm.WIDE_ROUTES + fm.W128_ROUTES},
                     "retire_zlane_wide": 0, "retire_zlane_layered_wide": 0,
                     "retire_zlane_sumproduct_wide": 0, "retire_zlane_layered_sumproduct_wide": 0,
                     "retire_zlane_w128": 0, "retire_zlane_layered_w128": 0,
                     "retire_zlane_sumproduct_w128": 0, "retire_zlane_layered_sumproduct_w128": 0}


def test_zlane_frames_per_block_loop():
    """Fewer blocks than frames: each block walks several frames, on
    retire_zlane (min-sum flooding) and on fused_zlane (its old kernel,
    and sum-product)."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 384)
    dec = fm.make_fused_minsum_zlane(qc, 10, batch_tile=3)
    llr = _llr(qc.num_vars, 10, 1.5, seed=1)
    (bk, ck), (bp, cp) = dec(llr), dec.plain(llr)
    assert_decoder_parity("minsum", to_numpy(bk), to_numpy(ck), to_numpy(bp), to_numpy(cp))
    _assert_identical(dec._launch_zlane(llr), (bp, cp))
    bp_dec = fm.make_fused_minsum_zlane(qc, 10, batch_tile=3, mode="sumproduct")
    (bk, ck), (bp, cp) = bp_dec(llr), bp_dec.plain(llr)
    assert_decoder_parity("sumproduct", to_numpy(bk), to_numpy(ck), to_numpy(bp), to_numpy(cp))


# retire_zlane (min-sum flooding at large Z): Z=256 is a power of two, 288
# and 384 are not.
def _hard_llrs(kind: str, n: int, batch: int, seed: int) -> torch.Tensor:
    """Frames that never converge (noise alone), that converge at iteration
    1 (12 dB), a mix (1 dB), and quantised LLRs with tied minimums and exact
    +0.0 and -0.0 (sign(0) = +1)."""
    if kind == "never_converged":
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return 2.0 * torch.randn((batch, n), generator=gen, device="cuda")
    llr = _llr(n, batch, 12.0 if kind == "converged_at_1" else 1.0, seed)
    if kind == "ties_zeros":
        llr = torch.round(llr / 2.0) * 2.0
        llr[::3, ::5] = 0.0
        llr[1::3, 2::5] = -0.0
    return llr


ZLANE_KINDS = ("never_converged", "converged_at_1", "mixed", "ties_zeros")


@pytest.mark.parametrize("track,early_exit", [TRACKING, THROUGHPUT, EARLY_EXIT])
@pytest.mark.parametrize("Z", [256, 288, 384])
def test_retire_zlane_matches_plain(Z, track, early_exit):
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), Z)
    dec = fm.make_fused_minsum_zlane(qc, 12, 0.75, track_convergence=track,
                                     early_exit=early_exit)
    assert dec.route == "retire_zlane"
    for i, kind in enumerate(ZLANE_KINDS):
        llr = _hard_llrs(kind, qc.num_vars, 37, seed=Z + i)
        before = dict(fm.LAUNCHES)
        out = dec(llr)
        assert fm.LAUNCHES["retire_zlane"] == before["retire_zlane"] + 1
        assert fm.LAUNCHES["fused_zlane"] == before["fused_zlane"]
        _assert_identical(out, dec.plain(llr))
        conv = out[1]
        if track and kind == "converged_at_1":
            assert bool((conv == 1).all())
        if kind == "never_converged" or not track:
            assert bool((conv == 12).all())


@pytest.mark.parametrize("batch", [1, 7, 513])
def test_retire_zlane_batches(batch):
    """One frame, fewer frames than blocks, and more frames than the blocks
    that can be resident: each block takes frames from the counter."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 384)
    dec = fm.make_fused_minsum_zlane(qc, 20, 0.75)
    llr = _llr(qc.num_vars, batch, 1.5, seed=batch)
    _assert_identical(dec(llr), dec.plain(llr))


@pytest.mark.parametrize("parts", [1, 2, 3, 4])
def test_retire_zlane_parts(parts):
    """Every split of a frame into parts at Z=256 (8 warps a part), each
    block serving many frames (batch_tile=3)."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 256)
    llr = _hard_llrs("ties_zeros", qc.num_vars, 29, seed=parts)
    for track in (True, False):
        dec = fm.make_fused_minsum_zlane(qc, 12, 0.75, track_convergence=track, batch_tile=3)
        _assert_identical(dec._launch_retire(llr, parts=parts), dec.plain(llr))


def test_minsum_flooding_at_z384_launches_retire_zlane():
    """Min-sum flooding at Z=384 (builder and serving object) launches
    retire_zlane and no other kernel; sum-product flooding launches
    retire_zlane_sumproduct and the layered schedule retire_zlane_layered."""
    from ldpc_tpu_torch.models.classical import MinSumScaledDecoder

    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 384)
    llr = _llr(qc.num_vars, 9, 1.0, seed=2)
    before = dict(fm.LAUNCHES)
    fm.make_fused_minsum_zlane(qc, 5)(llr)
    MinSumScaledDecoder(qc, 5, backend="auto").decode(llr)
    torch.cuda.synchronize()
    moved = {k: fm.LAUNCHES[k] - before[k] for k in before}
    assert moved == {"fused_retire": 0, "fused": 0, "retire_zlane": 2, "fused_zlane": 0,
                     "retire_layered": 0, "retire_sumproduct": 0, "retire_zlane_layered": 0,
                     "retire_zlane_sumproduct": 0, "retire_layered_sumproduct": 0,
                     "retire_zlane_layered_sumproduct": 0,
                     **{r: 0 for r in fm.WIDE_ROUTES + fm.W128_ROUTES},
                     "retire_zlane_wide": 0, "retire_zlane_layered_wide": 0,
                     "retire_zlane_sumproduct_wide": 0, "retire_zlane_layered_sumproduct_wide": 0,
                     "retire_zlane_w128": 0, "retire_zlane_layered_w128": 0,
                     "retire_zlane_sumproduct_w128": 0, "retire_zlane_layered_sumproduct_w128": 0}
    fm.make_fused_minsum_zlane(qc, 5, mode="sumproduct")(llr)
    fm.make_fused_minsum_zlane(qc, 5, schedule="layered")(llr)
    torch.cuda.synchronize()
    assert fm.LAUNCHES["retire_zlane_sumproduct"] == before["retire_zlane_sumproduct"] + 1
    assert fm.LAUNCHES["retire_zlane_layered"] == before["retire_zlane_layered"] + 1
    assert fm.LAUNCHES["fused_zlane"] == before["fused_zlane"]
    assert fm.LAUNCHES["retire_zlane"] == before["retire_zlane"] + 2


# retire_zlane_layered and retire_zlane_sumproduct (layered min-sum and
# sum-product flooding at large Z): Z=256 is a power of two, 288 and 384 are
# not.
ZLANE_PATHS = {"layered": {"schedule": "layered"}, "sumproduct": {"mode": "sumproduct"},
               "layered_sumproduct": {"mode": "sumproduct", "schedule": "layered"}}


def _zlane_decoder(qc, path: str, T: int = 12, **kw):
    dec = fm.make_fused_minsum_zlane(qc, T, 0.75 if path == "layered" else 1.0,
                                     **ZLANE_PATHS[path], **kw)
    assert dec.route == f"retire_zlane_{path}"
    return dec


def _assert_zlane_path(dec, llr, out):
    """Layered: bits and conv_iter identical to the plain version;
    sum-product: the sum-product bars against the plain version and
    identical to fused_zlane (the same float operations in the same order).
    Both identical to fused_zlane, through the side door."""
    if dec.mode == "minsum":
        _assert_identical(out, dec.plain(llr))
    else:
        bits_p, conv_p = dec.plain(llr)
        assert_decoder_parity("sumproduct", to_numpy(out[0]), to_numpy(out[1]), to_numpy(bits_p),
                              to_numpy(conv_p))
    _assert_identical(dec._launch_zlane(llr), out)


@pytest.mark.parametrize("path", ["layered", "sumproduct", "layered_sumproduct"])
@pytest.mark.parametrize("track,early_exit", [TRACKING, THROUGHPUT, EARLY_EXIT])
@pytest.mark.parametrize("Z", [256, 288, 384])
def test_retire_zlane_paths_match_plain(Z, track, early_exit, path):
    """Frames that never converge, that converge at iteration 1, a mix, and
    quantised LLRs with ties and exact +0.0 and -0.0: one launch of the
    path's kernel, no other."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), Z)
    dec = _zlane_decoder(qc, path, track_convergence=track, early_exit=early_exit)
    for i, kind in enumerate(ZLANE_KINDS):
        llr = _hard_llrs(kind, qc.num_vars, 37, seed=Z + i)
        before = dict(fm.LAUNCHES)
        out = dec(llr)
        moved = {k: fm.LAUNCHES[k] - before[k] for k in before}
        assert moved == {k: int(k == dec.route) for k in before}
        _assert_zlane_path(dec, llr, out)
        conv = out[1]
        if track and kind == "converged_at_1":
            assert bool((conv == 1).all())
        if kind == "never_converged" or not track:
            assert bool((conv == 12).all())


@pytest.mark.parametrize("path", ["layered", "sumproduct", "layered_sumproduct"])
@pytest.mark.parametrize("batch", [1, 7, 513])
def test_retire_zlane_paths_batches(batch, path):
    """One frame, fewer frames than blocks, and more frames than the frame
    groups that can be resident: each takes frames from the counter."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 384)
    dec = _zlane_decoder(qc, path, T=20)
    llr = _llr(qc.num_vars, batch, 1.5, seed=batch)
    _assert_zlane_path(dec, llr, dec(llr))


@pytest.mark.parametrize("parts", [1, 2, 3])
def test_retire_zlane_layered_parts(parts):
    """Every split of a frame's row groups at Z=256 (8 warps a part), ties
    and zeros, each group serving many frames (batch_tile=3); and at Z=384,
    1 and 2 parts."""
    for Z in (256, 384):
        qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), Z)
        if parts not in {p for p, _ in fm.retire_zlane_layered_plans(qc)}:
            continue
        llr = _hard_llrs("ties_zeros", qc.num_vars, 29, seed=parts)
        for track in (True, False):
            dec = _zlane_decoder(qc, "layered", track_convergence=track, batch_tile=3)
            _assert_identical(dec._launch_retire(llr, parts=parts), dec.plain(llr))


@pytest.mark.parametrize("parts", [1, 2, 3, 4])
def test_retire_zlane_sumproduct_parts(parts):
    """Every split of a frame into parts at Z=256 (8 warps a part), ties and
    zeros, each block serving many frames (batch_tile=3): identical to
    fused_zlane."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 256)
    llr = _hard_llrs("ties_zeros", qc.num_vars, 29, seed=parts)
    for track in (True, False):
        dec = _zlane_decoder(qc, "sumproduct", track_convergence=track, batch_tile=3)
        _assert_zlane_path(dec, llr, dec._launch_retire(llr, parts=parts))


@pytest.mark.parametrize("path", ["layered", "sumproduct", "layered_sumproduct"])
def test_retire_zlane_paths_batch_tile(path):
    """batch_tile caps the frames in flight: 1, 2 and 5 frame groups serve
    a batch of 23, outputs identical to the uncapped launch."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 384)
    llr = _llr(qc.num_vars, 23, 1.0, seed=4)
    ref = _zlane_decoder(qc, path)(llr)
    for tile in (1, 2, 5):
        out = _zlane_decoder(qc, path, batch_tile=tile)(llr)
        _assert_identical(out, ref)
    _assert_zlane_path(_zlane_decoder(qc, path), llr, ref)


@pytest.mark.parametrize("path", ["layered", "sumproduct", "layered_sumproduct"])
def test_retire_zlane_paths_refused_plan_raises(path):
    """A plan the kernel cannot take raises; nothing falls back to
    fused_zlane."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 384)
    dec = _zlane_decoder(qc, path, T=5)
    before = dict(fm.LAUNCHES)
    with pytest.raises(RuntimeError, match=dec.route):
        dec._launch_retire(_llr(qc.num_vars, 3, 1.0, seed=1), parts=5)
    assert fm.LAUNCHES == before


@pytest.mark.parametrize("parts", [1, 2, 3])
def test_retire_zlane_layered_sumproduct_parts(parts):
    """Every split of a frame's row groups at Z=256 (8 warps a part) and at
    Z=384 (1 and 2 parts), ties and zeros, each group serving many frames
    (batch_tile=3): identical to fused_zlane."""
    for Z in (256, 384):
        qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), Z)
        if parts not in {p for p, _ in fm.retire_zlane_layered_sumproduct_plans(qc)}:
            continue
        llr = _hard_llrs("ties_zeros", qc.num_vars, 29, seed=parts)
        for track in (True, False):
            dec = _zlane_decoder(qc, "layered_sumproduct", track_convergence=track,
                                 batch_tile=3)
            _assert_zlane_path(dec, llr, dec._launch_retire(llr, parts=parts))


def test_retire_zlane_layered_sumproduct_frames_per_sm():
    """At Z=384 the plan takes two frame groups of one part an SM; one group
    of two parts (parts=2) gives the same outputs."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 384)
    llr = _llr(qc.num_vars, 301, 1.0, seed=5)
    assert fm.retire_zlane_layered_sumproduct_plan(qc, True) == (1, 1, 2)
    assert fm.retire_zlane_layered_sumproduct_plan(qc, True, 2) == (2, 1, 1)
    dec = _zlane_decoder(qc, "layered_sumproduct", T=20)
    _assert_identical(dec(llr), dec._launch_retire(llr, parts=2))


def test_probe_zlane_blocks_runs():
    """The blocks-per-SM probe (tools/probe_zlane_blocks.py) times every
    parts count under the plan's cap and leaves the cap as it found it."""
    from ldpc_tpu_torch.tools import probe_zlane_blocks

    cap = fm._ZLANE_SUMPRODUCT_BLOCKS_PER_SM
    out = probe_zlane_blocks.main(["--z", "384", "--batch", "40", "--rounds", "1",
                                   "--reps", "1"])
    assert fm._ZLANE_SUMPRODUCT_BLOCKS_PER_SM == cap
    case = out["cases"]["Z=384"]
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 384)
    assert {f"parts={p} blocks_per_sm=1" for p in fm.retire_zlane_sumproduct_plans(qc)} <= \
        set(case["median_ms"])
    assert all(ms > 0 for ms in case["median_ms"].values())


# retire_sumproduct (sum-product flooding) at every shape it serves: Z=4 (one
# warp, 4 lanes), Z=24 (not a power of two), Z=32 and Z=64 (two warps span
# Z); batches that are not a multiple of a block's frames.
SUMPRODUCT_SHAPES = [("toy_4x8", 4, 67), ("nr_2_0_4", 4, 53), ("nr_2_0_32", 24, 45),
                     ("nr_2_0_32", 32, 97), ("nr_2_0_32", 64, 23)]


def _assert_sumproduct(dec, llr, out):
    """The sum-product bars against the plain version, and identical to the
    fused kernel it replaced (same float operations in the same order)."""
    bits_k, conv_k = out
    bits_p, conv_p = dec.plain(llr)
    assert_decoder_parity("sumproduct", to_numpy(bits_k), to_numpy(conv_k), to_numpy(bits_p),
                          to_numpy(conv_p))
    _assert_identical(dec._launch_fused(llr), out)


@pytest.mark.parametrize("snr_db", [-2.0, 1.0, 4.0])
@pytest.mark.parametrize("track,early_exit", [TRACKING, THROUGHPUT, EARLY_EXIT])
@pytest.mark.parametrize("name,Z,batch", SUMPRODUCT_SHAPES)
def test_retire_sumproduct_matches_plain_and_fused(name, Z, batch, track, early_exit, snr_db):
    """Sum-product flooding: frames that never converge (-2 dB), that
    converge early (4 dB) and a mix; one launch of retire_sumproduct."""
    qc = tcodes.qc_layout(tcodes.get_base_graph(name), Z)
    dec = fm.make_fused_minsum(qc, 12, 1.0, mode="sumproduct", track_convergence=track,
                               early_exit=early_exit)
    llr = _llr(qc.num_vars, batch, snr_db, seed=Z + int(snr_db))
    before = dict(fm.LAUNCHES)
    out = dec(llr)
    moved = {k: fm.LAUNCHES[k] - before[k] for k in before}
    assert moved == {k: int(k == "retire_sumproduct") for k in before}
    _assert_sumproduct(dec, llr, out)


@pytest.mark.parametrize("parts", [1, 2, 3, 4])
def test_retire_sumproduct_ties_and_zeros(parts):
    """Quantised LLRs (ties) with exact +0.0 and -0.0, every split of a
    frame into parts."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 32)
    llr = torch.round(_llr(qc.num_vars, 61, 1.0, seed=3) / 2.0) * 2.0
    llr[::3, ::5] = 0.0
    llr[1::3, 2::5] = -0.0
    for track in (True, False):
        dec = fm.make_fused_bp(qc, 12) if track else fm.make_fused_minsum(
            qc, 12, 1.0, mode="sumproduct", track_convergence=False)
        _assert_sumproduct(dec, llr, dec._launch_retire(llr, parts=parts))


def test_retire_sumproduct_groups_take_several_frames():
    """More frames than resident frame groups, and a row of 20 members
    (phi parked in the c2v slots): identical to the fused kernel."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 32)
    dec = fm.make_fused_bp(qc, 20)
    llr = _llr(qc.num_vars, 4001, 1.5, seed=11)
    parts, frames, staged, per_sm = fm.retire_sumproduct_plan(qc, True)
    assert 4001 > frames * per_sm * torch.cuda.get_device_properties(0).multi_processor_count
    _assert_sumproduct(dec, llr, dec(llr))
    from test_torch_minsum_sumproduct_retire import wide_row_code

    wide = wide_row_code(20)
    dec = fm.make_fused_bp(wide, 12)
    assert dec.route == "retire_sumproduct"
    for snr_db in (3.0, 5.0, 7.0):
        llr = _llr(wide.num_vars, 37, snr_db, seed=6)
        _assert_sumproduct(dec, llr, dec(llr))


def test_retire_sumproduct_refused_plan_raises():
    """A plan the kernel cannot take raises; nothing falls back to fused."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 32)
    dec = fm.make_fused_bp(qc, 5)
    before = dict(fm.LAUNCHES)
    with pytest.raises(RuntimeError, match="retire_sumproduct"):
        dec._launch_retire(_llr(qc.num_vars, 3, 1.0, seed=1), parts=5)
    assert fm.LAUNCHES == before


# retire_layered_sumproduct (layered sum-product) at the shapes of
# retire_sumproduct.
def _layered_sumproduct(qc, T: int = 12, **flags):
    dec = fm.make_fused_minsum(qc, T, 1.0, mode="sumproduct", schedule="layered", **flags)
    assert dec.route == "retire_layered_sumproduct"
    return dec


@pytest.mark.parametrize("snr_db", [-2.0, 1.0, 4.0])
@pytest.mark.parametrize("track,early_exit", [TRACKING, THROUGHPUT, EARLY_EXIT])
@pytest.mark.parametrize("name,Z,batch", SUMPRODUCT_SHAPES)
def test_retire_layered_sumproduct_matches_plain_and_fused(name, Z, batch, track, early_exit,
                                                           snr_db):
    """Layered sum-product: frames that never converge (-2 dB), that
    converge early (4 dB) and a mix; one launch of retire_layered_sumproduct,
    the sum-product bars against the plain version and identical to the
    fused kernel it replaced."""
    qc = tcodes.qc_layout(tcodes.get_base_graph(name), Z)
    dec = _layered_sumproduct(qc, track_convergence=track, early_exit=early_exit)
    llr = _llr(qc.num_vars, batch, snr_db, seed=Z + int(snr_db))
    before = dict(fm.LAUNCHES)
    out = dec(llr)
    moved = {k: fm.LAUNCHES[k] - before[k] for k in before}
    assert moved == {k: int(k == "retire_layered_sumproduct") for k in before}
    _assert_sumproduct(dec, llr, out)


@pytest.mark.parametrize("parts", [1, 2, 3])
def test_retire_layered_sumproduct_ties_and_zeros(parts):
    """Quantised LLRs (ties) with exact +0.0 and -0.0, the rows of a row
    group on 1, 2 or 3 warps of a frame."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 32)
    llr = torch.round(_llr(qc.num_vars, 61, 1.0, seed=3) / 2.0) * 2.0
    llr[::3, ::5] = 0.0
    llr[1::3, 2::5] = -0.0
    for track in (True, False):
        dec = _layered_sumproduct(qc, track_convergence=track)
        _assert_sumproduct(dec, llr, dec._launch_retire(llr, parts=parts))


def test_retire_layered_sumproduct_groups_take_several_frames():
    """More frames than resident frame groups (each group's c2v, never
    cleared, serves frame after frame), and a row of 20 members (the
    run-time loop): identical to the fused kernel."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 32)
    dec = _layered_sumproduct(qc, 20)
    llr = _llr(qc.num_vars, 4001, 1.5, seed=11)
    parts, frames, per_sm = fm.retire_layered_sumproduct_plan(qc, True)
    assert 4001 > frames * per_sm * torch.cuda.get_device_properties(0).multi_processor_count
    _assert_sumproduct(dec, llr, dec(llr))
    from test_torch_minsum_sumproduct_retire import wide_row_code

    wide = wide_row_code(20)
    dec = _layered_sumproduct(wide)
    for snr_db in (3.0, 5.0, 7.0):
        llr = _llr(wide.num_vars, 37, snr_db, seed=6)
        _assert_sumproduct(dec, llr, dec(llr))


def test_retire_layered_sumproduct_refused_plan_raises():
    """A plan the kernel cannot take raises; nothing falls back to fused."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 32)
    dec = _layered_sumproduct(qc, 5)
    before = dict(fm.LAUNCHES)
    with pytest.raises(RuntimeError, match="retire_layered_sumproduct"):
        dec._launch_retire(_llr(qc.num_vars, 3, 1.0, seed=1), parts=4)
    assert fm.LAUNCHES == before


def test_probe_phi_runs():
    """The phi probe (tools/probe_phi.py): both variants built, counted and
    timed; the accurate phi takes more instructions than the approximate."""
    from ldpc_tpu_torch.tools import probe_phi

    out = probe_phi.main(["--n", "4096", "--reps", "4", "--rounds", "1"])
    sass = out["sass_per_phi"]
    assert sass["accurate"]["instructions"] > sass["mufu"]["instructions"] > 0
    assert sass["mufu"]["mufu_instructions"] >= 2
    assert all(rate > 0 for rate in out["phi_per_s"].values())
    assert out["agreement"]["max_abs_diff"] < 1.0


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


@pytest.mark.parametrize("kind", list(GNN_BUILDERS))
@pytest.mark.parametrize("code,Z,h,batch,inject,share,early_exit", CORRECTED_EXACT_CASES)
def test_corrected_v2_exact_inputs_identical(kind, code, Z, h, batch, inject, share, early_exit):
    """B4 and B5 on inputs whose every reordered sum is exact in any order
    (ops/msg_gnn_exact.py): their tensor-core passes must give the plain
    version's soft bits and conv_iter exactly, so an index, shift or gather
    fault shows."""
    qc = tcodes.qc_layout(tcodes.get_base_graph(code), Z)
    model, llr = exact_corrected_case(qc, h, batch, inject, share)
    dec = GNN_BUILDERS[kind](qc, model, 2, h, share_layers=share, input_injection=inject,
                             early_exit=early_exit, return_iterations=early_exit)
    llr = torch.from_numpy(llr).cuda()
    before = fg.LAUNCHES[kind]
    out_k, out_p = dec(llr), dec.plain(llr)
    torch.cuda.synchronize()
    assert fg.LAUNCHES[kind] == before + 1
    if early_exit:
        assert torch.equal(out_k[0], out_p[0]) and torch.equal(out_k[1], out_p[1])
    else:
        assert torch.equal(out_k, out_p)


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


def _row_code(members: int, Z: int = 4):
    """A base graph at Z whose first row has ``members`` members, (4, 32) up
    to 31 members and (4, members + 2) above (tests/test_torch_neural_group.py's
    row_shifts): 31 and 58 take neural_group's 64-bit state word, 64 and 121
    its 128-bit one, 122 none."""
    import numpy as np

    cols = 32 if members < 32 else members + 2
    rng = np.random.default_rng(members)
    shifts = np.where(rng.random((4, cols)) < 0.3, rng.integers(0, Z, (4, cols)), -1)
    shifts[0] = np.where(np.arange(cols) < members, rng.integers(0, Z, cols), -1)
    shifts[1, members:] = 0
    return tcodes.qc_layout(tcodes.BaseGraph(f"row{members}", shifts), Z)


@pytest.mark.parametrize("name,Z,batch", [("toy_4x8", 4, 19), ("nr_2_0_4", 4, 21),
                                          ("nr_2_0_32", 32, 5), ("nr_2_0_32", 128, 3),
                                          ("row31", 4, 19), ("row122", 4, 19)])
@pytest.mark.parametrize("sharing,L,learn_a,learn_o,per_it", [
    ("scalar", 0, False, False, False), ("cell", 2, True, False, False),
    ("type", 1, True, False, True), ("edge", 2, True, True, True), ("edge", 3, True, True, False)])
def test_fused_neural_kernel_matches_plain(name, Z, batch, sharing, L, learn_a, learn_o, per_it):
    """B3's fused_neural: bits identical to the plain version; Z=128 keeps
    the state in global scratch.  Codes neural_group takes (the row of 31
    members on its 64-bit word) reach it through the side door
    (_launch_minsum); the row of 122 members through its route."""
    from ldpc_tpu_torch.ops import fused_neural as fn

    qc = (_row_code(int(name[3:])) if name.startswith("row")
          else tcodes.qc_layout(tcodes.get_base_graph(name), Z))
    model = _nms_model(qc_msg.make_plan(qc), 4, L, sharing, learn_a, learn_o, per_it)
    dec = fn.make_fused_neural_minsum(qc, model, 4, L, per_iteration=per_it)
    assert dec.shared == (Z != 128)
    assert dec.route == {"row122": "fused_neural", "row31": "neural_group_wide"}.get(
        name, "neural_group")
    llr = _llr(qc.num_vars, batch, 1.0, seed=Z + L)
    before = fn.LAUNCHES["fused_neural"]
    bits_k = dec(llr) if dec.route == "fused_neural" else dec._launch_minsum(llr)
    bits_p = dec.plain(llr)
    torch.cuda.synchronize()
    assert fn.LAUNCHES["fused_neural"] == before + 1
    assert bits_k.is_cuda and torch.equal(bits_k, bits_p)


# nms_compare's cases of chip_smoke.py that neural_group takes:
# (code, Z, batch, sharing, depth, learnable alpha, learnable offset, per iteration)
NEURAL_GROUP_CASES = [("nr_2_0_4", 4, 37, "scalar", 0, False, False, False),
                      ("nr_2_0_4", 4, 37, "cell", 2, True, False, False),
                      ("nr_2_0_4", 4, 37, "type", 1, True, False, True),
                      ("nr_2_0_4", 4, 37, "edge", 2, True, True, True),
                      ("nr_2_0_32", 32, 13, "edge", 2, True, True, True),
                      ("nr_2_0_32", 32, 13, "type", 0, True, True, False),
                      ("nr_2_0_32", 32, 13, "cell", 1, False, True, True),
                      ("nr_2_0_32", 32, 13, "edge", 3, True, True, True),
                      ("nr_2_0_32", 24, 9, "edge", 2, True, True, True),
                      ("nr_2_0_32", 12, 9, "cell", 3, True, True, True),
                      ("nr_2_0_32", 64, 5, "edge", 2, True, True, False)]


def _neural_group_decoder(name, Z, sharing, L, learn_a, learn_o, per_it, T=5):
    from ldpc_tpu_torch.ops import fused_neural as fn

    qc = tcodes.qc_layout(tcodes.get_base_graph(name), Z)
    model = _nms_model(qc_msg.make_plan(qc), T, L, sharing, learn_a, learn_o, per_it)
    dec = fn.make_fused_neural_minsum(qc, model, T, L, per_iteration=per_it)
    assert dec.route == "neural_group"
    return qc, dec


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("name,Z,batch,sharing,L,learn_a,learn_o,per_it", NEURAL_GROUP_CASES)
def test_neural_group_matches_plain(name, Z, batch, sharing, L, learn_a, learn_o, per_it, staged):
    """B3 on neural_group, bits identical to the plain version with a frame
    split into every count of parts its plans allow, weights from L2 and
    staged in shared memory (where they fit); at Z=4 and Z=12 a warp holds 8
    and 2 frames side by side (Z=12: 8 idle lanes), batches not a multiple
    of them."""
    from ldpc_tpu_torch.ops import fused_neural as fn

    qc, dec = _neural_group_decoder(name, Z, sharing, L, learn_a, learn_o, per_it)
    llr = _llr(qc.num_vars, batch, 1.0, seed=Z + L)
    bits_p = dec.plain(llr)
    parts = sorted({p for p, _ in fn.neural_group_plans(qc, L, staged)})
    if staged and not parts:
        pytest.skip("the staged weights do not fit a block beside a frame")
    for p in parts:
        assert torch.equal(dec._launch_group(llr, parts=p, staged=staged), bits_p), p


@pytest.mark.parametrize("kind", ["ties", "zeros"])
@pytest.mark.parametrize("Z", [4, 32])
def test_neural_group_ties_and_zeros(Z, kind):
    """Quantised LLRs (tied magnitudes) and LLRs of +0.0 and -0.0."""
    qc, dec = _neural_group_decoder("nr_2_0_32", Z, "edge", 2, True, True, True)
    llr = _llr(qc.num_vars, 11, 1.0, seed=3)
    if kind == "ties":
        llr = torch.round(llr / 2.0) * 2.0
    else:
        mask = torch.rand(llr.shape, generator=torch.Generator().manual_seed(1)).to(llr.device)
        llr = torch.where(mask < 0.2, 0.0, torch.where(mask > 0.9, -0.0, llr))
    assert torch.equal(dec(llr), dec.plain(llr))


@pytest.mark.parametrize("staged", [False, True])
def test_neural_group_groups_take_several_frames(staged):
    """Three rounds or more for every frame group of the resident grid (8
    frames a group at Z=4), and a last round that leaves some groups, and
    some lanes of a group, without a frame."""
    from ldpc_tpu_torch.ops import fused_neural as fn

    qc, dec = _neural_group_decoder("nr_2_0_4", 4, "edge", 2, True, True, True, T=3)
    p, per_block, per_sm = fn.neural_group_plan(qc, 2, staged)
    groups = per_sm * per_block * torch.cuda.get_device_properties(0).multi_processor_count
    F = fn.frames_per_group(qc)
    llr = _llr(qc.num_vars, 3 * groups * F + per_block * F // 2 + 3, 1.0, seed=4)
    assert torch.equal(dec._launch_group(llr, staged=staged), dec.plain(llr))


@pytest.mark.parametrize("L", [0, 2, 4])
@pytest.mark.parametrize("Z,batch", [(128, 7), (384, 3)])
def test_neural_group_large_z_matches_plain(Z, batch, L):
    """B3 on neural_group at nr_2_0_32 Z=128 and Z=384, where a frame
    exceeds a block (but at Z=128 depth 0): its route, and every slice form
    with a plan (the FIFO in the slices, at Z=128 also with W there; Z=384
    only with both) at every parts count and frame-group count, bits
    identical to the plain version; T=6 so that depth 4's taps all run."""
    from ldpc_tpu_torch.ops import fused_neural as fn

    qc, dec = _neural_group_decoder("nr_2_0_32", Z, "edge", L, True, True, True, T=6)
    assert dec.layout == (2 if Z == 384 else 1 if L else 0)  # Z=128 L=0: 117,760 B a frame
    llr = _llr(qc.num_vars, batch, 1.0, seed=Z + L)
    bits_p = dec.plain(llr)
    assert torch.equal(dec(llr), bits_p)
    for layout in (1, 2):
        for p, f in fn.neural_group_plans(qc, L, slice=layout):
            assert torch.equal(dec._launch_group(llr, parts=p, slice=layout, groups=f),
                               bits_p), (layout, p, f)


@pytest.mark.parametrize("Z,batch", [(32, 9), (4, 37)])
def test_neural_group_depth_4_matches_plain(Z, batch):
    """Depth 4 at nr_2_0_32 Z=32 (one whole frame a block, 130,304 B) and
    Z=4: the route and each layout forced, every parts count of each."""
    from ldpc_tpu_torch.ops import fused_neural as fn

    qc, dec = _neural_group_decoder("nr_2_0_32" if Z == 32 else "nr_2_0_4", Z, "edge", 4, True,
                                    True, True, T=7)
    llr = _llr(qc.num_vars, batch, 1.0, seed=Z)
    bits_p = dec.plain(llr)
    assert torch.equal(dec(llr), bits_p)
    for layout in fn.SLICE_LAYOUTS:
        for p in sorted({p for p, _ in fn.neural_group_plans(qc, 4, slice=layout)}):
            assert torch.equal(dec._launch_group(llr, parts=p, slice=layout, staged=False),
                               bits_p), (layout, p)


@pytest.mark.parametrize("layout", [1, 2])
@pytest.mark.parametrize("name,Z,batch,sharing,L,learn_a,learn_o,per_it", NEURAL_GROUP_CASES)
def test_neural_group_slice_forced_matches_shared(name, Z, batch, sharing, L, learn_a, learn_o,
                                                  per_it, layout):
    """The slice forms forced where a whole frame fits a block (Z=4 to
    64): bits identical to the shared layout's and the plain version's,
    with the plan's parts and with one part."""
    qc, dec = _neural_group_decoder(name, Z, sharing, L, learn_a, learn_o, per_it)
    assert dec.layout == 0
    llr = _llr(qc.num_vars, batch, 1.0, seed=Z + L + layout)
    shared, bits_p = dec._launch_group(llr, slice=0), dec.plain(llr)
    assert torch.equal(shared, bits_p)
    assert torch.equal(dec._launch_group(llr, slice=layout), bits_p)
    assert torch.equal(dec._launch_group(llr, slice=layout, parts=1), bits_p)


@pytest.mark.parametrize("name,Z,batch,sharing,L,learn_a,learn_o,per_it", NEURAL_GROUP_CASES)
def test_neural_group_side_door_is_fused_neural(name, Z, batch, sharing, L, learn_a, learn_o,
                                                per_it):
    """The replaced kernel through the side door gives the same bits, and
    each launch moves its own counter."""
    from ldpc_tpu_torch.ops import fused_neural as fn

    qc, dec = _neural_group_decoder(name, Z, sharing, L, learn_a, learn_o, per_it)
    llr = _llr(qc.num_vars, batch, 2.0, seed=Z)
    before = dict(fn.LAUNCHES)
    new, old = dec(llr), dec._launch_minsum(llr)
    torch.cuda.synchronize()
    assert torch.equal(new, old)
    assert fn.LAUNCHES == {k: v + (k in ("neural_group", "fused_neural"))
                           for k, v in before.items()}


def _wide_decoder(members, L, T, sharing="edge", per_it=True):
    from ldpc_tpu_torch.ops import fused_neural as fn

    qc = _row_code(members)
    model = _nms_model(qc_msg.make_plan(qc), T, L, sharing, True, True, per_it)
    return qc, fn.make_fused_neural_minsum(qc, model, T, L, per_iteration=per_it)


@pytest.mark.parametrize("members,L,sharing,per_it", [
    (28, 2, "edge", True), (31, 0, "scalar", False), (31, 3, "cell", True), (58, 2, "edge", False),
    (59, 1, "type", True), (64, 2, "edge", True), (64, 4, "edge", True), (121, 2, "edge", True),
    (121, 6, "edge", True), (58, 5, "cell", True)])
def test_neural_group_wide_words_match_plain(members, L, sharing, per_it):
    """neural_group_wide (rows of 28-58 members, 64-bit state word) and
    neural_group_w128 (59-121, 128-bit) at Z=4 and depths 0-6: the route,
    then every layout with a plan at every parts count, staged and from L2
    where the staged weights fit, bits identical to the plain version and
    to fused_neural through the side door; each launch moves only its
    route's counter."""
    from ldpc_tpu_torch.ops import fused_neural as fn

    qc, dec = _wide_decoder(members, L, L + 2 if L > 2 else 4, sharing, per_it)
    route = "neural_group_wide" if members <= 58 else "neural_group_w128"
    assert dec.route == route and dec.word_bits == (64 if members <= 58 else 128)
    llr = _llr(qc.num_vars, 37, 1.0, seed=members + L)
    bits_p = dec.plain(llr)
    before = dict(fn.LAUNCHES)
    assert torch.equal(dec(llr), bits_p)
    assert torch.equal(dec._launch_minsum(llr), bits_p)
    torch.cuda.synchronize()
    assert fn.LAUNCHES == {k: v + (k in (route, "fused_neural")) for k, v in before.items()}
    for layout in fn.SLICE_LAYOUTS:
        for staged in ((False, True) if layout == 0 else (False,)):
            for p in sorted({p for p, _ in fn.neural_group_plans(qc, L, staged, layout)}):
                got = dec._launch_group(llr, parts=p, staged=staged, slice=layout)
                assert torch.equal(got, bits_p), (layout, staged, p)


@pytest.mark.parametrize("kind", ["ties", "zeros"])
@pytest.mark.parametrize("members,L", [(31, 2), (121, 6)])
def test_neural_group_wide_words_ties_and_zeros(members, L, kind):
    """Quantised LLRs (tied magnitudes) and LLRs of +0.0 and -0.0 on the
    wider words, bits identical in each slice form too."""
    qc, dec = _wide_decoder(members, L, L + 2)
    llr = _llr(qc.num_vars, 11, 1.0, seed=3)
    if kind == "ties":
        llr = torch.floor(llr / 2.0) * 2.0 + 1.0
    else:
        mask = torch.rand(llr.shape, generator=torch.Generator().manual_seed(1)).to(llr.device)
        llr = torch.where(mask < 0.2, 0.0, torch.where(mask > 0.9, -0.0, llr))
    bits_p = dec.plain(llr)
    assert torch.equal(dec(llr), bits_p)
    for layout in (1, 2):
        assert torch.equal(dec._launch_group(llr, slice=layout), bits_p), layout


@pytest.mark.parametrize("name,Z,batch,L", [("nr_2_0_32", 32, 9, 5), ("nr_2_0_32", 32, 9, 8),
                                            ("nr_2_0_4", 4, 37, 6), ("nr_2_0_32", 128, 5, 8),
                                            ("nr_2_0_32", 12, 9, 7)])
def test_neural_group_run_time_depth_matches_plain(name, Z, batch, L):
    """Depths over 4 on neural_group's run-time-depth form: its route (a
    whole frame a block at Z=32 depth 5, the FIFO in the slices from depth
    8 and at Z=128), then every layout with a plan at every parts count,
    bits identical to the plain version; T = depth + 2, so every tap
    reaches the decisions."""
    from ldpc_tpu_torch.ops import fused_neural as fn

    qc, dec = _neural_group_decoder(name, Z, "edge", L, True, True, True, T=L + 2)
    assert dec.run_time_depth
    llr = _llr(qc.num_vars, batch, 1.0, seed=Z + L)
    bits_p = dec.plain(llr)
    assert torch.equal(dec(llr), bits_p)
    for layout in fn.SLICE_LAYOUTS:
        for p in sorted({p for p, _ in fn.neural_group_plans(qc, L, slice=layout)}):
            assert torch.equal(dec._launch_group(llr, parts=p, slice=layout, staged=False),
                               bits_p), (layout, p)


@pytest.mark.parametrize("members,L", [(20, 2), (31, 2), (58, 6), (64, 2), (121, 5)])
def test_neural_group_bytes_match_the_library(members, L):
    """The library of the code's state word (32 bits at 20 members, 64 at
    31 and 58, 128 at 64 and 121): its shared memory of every plan and its
    slice words equal the wrapper's; another word's library refuses the
    code's queries."""
    from ldpc_tpu_torch.ops import fused_neural as fn

    qc = _row_code(members)
    bits = fn.neural_group_word_bits(qc)
    lib = fn.kernel_library(bits)
    dims = (qc.Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges)
    other = fn.kernel_library(64 if bits != 64 else 32)
    assert other.ldpc_neural_group_smem_bytes(*dims, L, 1, 1, 0, 0, bits) == -1
    for layout in fn.SLICE_LAYOUTS:
        if layout:
            assert 4 * lib.ldpc_neural_group_slice_words(qc.Z, dims[1], dims[3], L, layout,
                                                         bits) == \
                fn.neural_group_scratch_bytes(qc, L, layout)
        for staged in (False, True):
            for p, f in fn.neural_group_plans(qc, L, staged, layout):
                assert lib.ldpc_neural_group_smem_bytes(*dims, L, p, f, int(staged), layout,
                                                        bits) == \
                    fn.neural_group_smem_bytes(qc, L, p, f, staged, layout)


def _msg_model(plan, T, h, inject, share):
    from ldpc_tpu_torch.models import create_message_gnn_decoder

    gen = torch.Generator().manual_seed(7)
    model = create_message_gnn_decoder(plan, num_iterations=T, hidden_dim=h,
                                       input_injection=inject, share_layers=share, generator=gen)
    return _add_noise(model, 0.02, gen)


MSG_BUILDERS = {"msg_gnn": fg.make_fused_gnn_decoder, "msg_gnn_v2": fg.make_fused_gnn_decoder_v2,
                "msg_gnn_v3": fg.make_fused_gnn_decoder_v3,
                "msg_gnn_v4": fg.make_fused_gnn_decoder_v4}


@pytest.mark.parametrize("kind", list(MSG_BUILDERS))
@pytest.mark.parametrize("name,Z,h,batch", [("toy_4x8", 4, 16, 19), ("nr_2_0_4", 4, 64, 11),
                                            ("nr_2_0_32", 32, 64, 3)])
@pytest.mark.parametrize("inject,share", [(False, False), (True, False), (True, True)])
def test_msg_gnn_kernel_matches_plain(kind, name, Z, h, batch, inject, share):
    """B6, B7, B8 and B9 at T=2: soft bits within 3e-2 of the plain
    version, decisions identical where the plain version is confident."""
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


@pytest.mark.parametrize("code,Z,h,batch,inject,share", EXACT_CASES)
def test_msg_gnn_v2_exact_inputs_identical(code, Z, h, batch, inject, share):
    """B7 on inputs whose every sum is exact in any order
    (ops/msg_gnn_exact.py): its tensor-core tiles must give the plain
    version's soft bits exactly, so an index or shift fault shows."""
    qc = tcodes.qc_layout(tcodes.get_base_graph(code), Z)
    model, llr = exact_msg_gnn_case(qc, h, batch, inject, share)
    dec = fg.make_fused_gnn_decoder_v2(qc, model, 2, h, share_layers=share, input_injection=inject)
    llr = torch.from_numpy(llr).cuda()
    before = fg.LAUNCHES["msg_gnn_v2"]
    soft_k, soft_p = dec(llr), dec.plain(llr)
    torch.cuda.synchronize()
    assert fg.LAUNCHES["msg_gnn_v2"] == before + 1
    assert torch.equal(soft_k, soft_p)


@pytest.mark.parametrize("code,Z,h,batch,inject,share,T,te",
                         [(*case, 2, (0.0,)) for case in EXACT_CASES]
                         + [(*case, EXACT_TYPE_EMBEDDINGS) for case in EXACT_TE_CASES])
def test_msg_gnn_v3_exact_inputs_identical(code, Z, h, batch, inject, share, T, te):
    """B8 on inputs whose every reordered sum is exact in any order
    (ops/msg_gnn_exact.py), with and without type embeddings: its check
    tiles must give the plain version's soft bits exactly, so an index,
    shift or delta-table fault shows."""
    qc = tcodes.qc_layout(tcodes.get_base_graph(code), Z)
    model, llr = exact_msg_gnn_case(qc, h, batch, inject, share, num_iterations=T,
                                    type_embeddings=te)
    dec = fg.make_fused_gnn_decoder_v3(qc, model, T, h, share_layers=share,
                                       input_injection=inject)
    llr = torch.from_numpy(llr).cuda()
    before = fg.LAUNCHES["msg_gnn_v3"]
    soft_k, soft_p = dec(llr), dec.plain(llr)
    torch.cuda.synchronize()
    assert fg.LAUNCHES["msg_gnn_v3"] == before + 1
    assert torch.equal(soft_k, soft_p)


@pytest.mark.parametrize("kind,code,Z,h,batch,inject,share,T,te",
                         [("msg_gnn", *case, 2, (0.0,)) for case in EXACT_CASES]
                         + [("msg_gnn_v4", *case, 2, (0.0,)) for case in EXACT_CASES]
                         + [("msg_gnn_v4", *case, EXACT_TYPE_EMBEDDINGS)
                            for case in EXACT_TE_CASES]
                         + [("msg_gnn_v4", *case, 1, (0.0,)) for case in EXACT_CASES])
def test_msg_gnn_v1_v4_exact_inputs_identical(kind, code, Z, h, batch, inject, share, T, te):
    """B6 and B9 on inputs whose every reordered sum is exact in any order
    (ops/msg_gnn_exact.py): their tensor-core tiles must give the plain
    version's soft bits exactly, so an index, shift, second-layer split or
    delta-table fault shows; B9 also with type embeddings and at T=1 (its
    thin last layer alone)."""
    qc = tcodes.qc_layout(tcodes.get_base_graph(code), Z)
    model, llr = exact_msg_gnn_case(qc, h, batch, inject, share, num_iterations=T,
                                    type_embeddings=te)
    dec = MSG_BUILDERS[kind](qc, model, T, h, share_layers=share, input_injection=inject)
    llr = torch.from_numpy(llr).cuda()
    before = fg.LAUNCHES[kind]
    soft_k, soft_p = dec(llr), dec.plain(llr)
    torch.cuda.synchronize()
    assert fg.LAUNCHES[kind] == before + 1
    assert torch.equal(soft_k, soft_p)


@pytest.mark.parametrize("kind", ["fused_neural", "neural_group", *MSG_BUILDERS, *GNN_BUILDERS])
def test_resident_blocks_decode_several_frames(kind):
    """A batch of three frames or more per resident block, so that each block
    takes later frames into the scratch slice or shared state its earlier
    frames used: B3 at Z=128 with its state in global scratch (fused_neural,
    through the side door) and in the slice form (neural_group, three frames
    or more for every resident frame group) bits identical, B6-B9 at the
    T=2 bar, B4 and B5 at the corrected bars."""
    from ldpc_tpu_torch.ops import fused_neural as fn

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if kind in ("fused_neural", "neural_group"):
        qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 128)
        dec = fn.make_fused_neural_minsum(qc, _nms_model(qc_msg.make_plan(qc), 4, 2, "edge", True,
                                                         True, True), 4, 2, per_iteration=True)
        assert not dec.shared and dec.route == "neural_group" and dec.layout
        if kind == "fused_neural":
            dims = (qc.Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges, 4, 2)
            resident = fn.kernel_library().ldpc_neural_occupancy(*dims, 1, 0) * sms
        else:  # frame groups in flight
            _, f, _, _, blocks, _ = dec._plan(torch.device("cuda", 0))
            resident = blocks * f
    elif kind in GNN_BUILDERS:
        qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_4"), 4)
        dec = GNN_BUILDERS[kind](qc, _corrected_model(qc_msg.make_plan(qc), 2, 64, True, False,
                                                      perturb=True), 2, 64,
                                 early_exit=True, return_iterations=True)
        resident = fg.corrected_tc_plan(qc, 64, True, kind)[1] * sms
    else:
        qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_4"), 4)
        dec = MSG_BUILDERS[kind](qc, _msg_model(qc_msg.make_plan(qc), 2, 64, True, False), 2, 64,
                                 input_injection=True)
        resident = fg.msg_gnn_tc_plan(qc, 64, True, kind)[1] * sms
    llr = _llr(qc.num_vars, 3 * resident + 1, 1.0, seed=5)
    out_k = dec._launch_minsum(llr) if kind == "fused_neural" else dec(llr)
    out_p = dec.plain(llr)
    torch.cuda.synchronize()
    if kind in ("fused_neural", "neural_group"):
        assert torch.equal(out_k, out_p)
    elif kind in GNN_BUILDERS:
        (soft_k, conv_k), (soft_p, conv_p) = out_k, out_p
        same = conv_k == conv_p
        assert same.float().mean().item() >= 0.99
        assert ((soft_k > 0.5) == (soft_p > 0.5)).float().mean().item() >= 0.999
        assert (soft_k - soft_p)[same].abs().max().item() <= 2e-2
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


@pytest.mark.parametrize("T", [1, 3])
def test_msg_gnn_v4_peeled_layers(T):
    """B9 at T=1 (its thin last layer alone, no residual) and T=3 (a middle
    layer), at nr_2_0_4 h=64 with injection."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_4"), 4)
    model = _msg_model(qc_msg.make_plan(qc), T, 64, True, False)
    dec = fg.make_fused_gnn_decoder_v4(qc, model, T, 64, input_injection=True)
    llr = _llr(qc.num_vars, 9, 2.0, seed=T)
    soft_k, soft_p = dec(llr), dec.plain(llr)
    torch.cuda.synchronize()
    assert (soft_k - soft_p).abs().max().item() <= 3e-2
    confident = (soft_p - 0.5).abs() > 0.05
    assert bool(((soft_k > 0.5) == (soft_p > 0.5))[confident].all())


WIDE_BUILDERS = {"msg_gnn_v2": fg.make_fused_gnn_decoder_v2,
                 "msg_gnn_v4": fg.make_fused_gnn_decoder_v4}


@pytest.mark.parametrize("kind", list(WIDE_BUILDERS))
@pytest.mark.parametrize("name,Z,batch", [("nr_2_0_4", 4, 11), ("nr_2_0_32", 32, 3)])
@pytest.mark.parametrize("inject,share", [(False, False), (True, False), (True, True)])
def test_msg_gnn_wide_kernel_matches_plain(kind, name, Z, batch, inject, share):
    """B7 and B9 at h=128 (msg_gnn_wide_tc_kernel) at T=2: soft bits within
    3e-2 of the plain version, decisions identical where the plain version
    is confident, one launch; the wrapper's shared memory and scratch are
    the library's."""
    qc = tcodes.qc_layout(tcodes.get_base_graph(name), Z)
    dims = (Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges)
    lib, entry = fg.tc_kernel_library(), fg.TC_ENTRY[kind]
    warps, blocks = fg.msg_gnn_tc_plan(qc, 128, inject, kind)
    assert warps >= 1 and blocks >= 1
    for w in (1, warps):
        assert getattr(lib, f"{entry}_tc_smem_bytes")(128, int(inject), *dims, w) == \
            fg.msg_gnn_smem_bytes(qc, 128, kind, inject, w)
    assert getattr(lib, f"{entry}_tc_scratch_floats")(128, *dims) == \
        fg.msg_gnn_scratch_floats(qc, 128, kind)
    model = _msg_model(qc_msg.make_plan(qc), 2, 128, inject, share)
    dec = WIDE_BUILDERS[kind](qc, model, 2, 128, share_layers=share, input_injection=inject)
    llr = _llr(qc.num_vars, batch, 2.0, seed=Z + 128)
    before = fg.LAUNCHES[kind]
    soft_k, soft_p = dec(llr), dec.plain(llr)
    torch.cuda.synchronize()
    assert fg.LAUNCHES[kind] == before + 1
    assert soft_k.is_cuda and soft_k.shape == llr.shape
    assert (soft_k - soft_p).abs().max().item() <= 3e-2
    confident = (soft_p - 0.5).abs() > 0.05
    assert bool(((soft_k > 0.5) == (soft_p > 0.5))[confident].all())


@pytest.mark.parametrize("kind,code,Z,h,batch,inject,share,T",
                         [(kind, *case, 2) for kind in WIDE_BUILDERS for case in EXACT_WIDE_CASES]
                         + [("msg_gnn_v4", *case, 1) for case in EXACT_WIDE_CASES])
def test_msg_gnn_wide_exact_inputs_identical(kind, code, Z, h, batch, inject, share, T):
    """B7 and B9 at h=128 on inputs whose every reordered sum is exact in any
    order (ops/msg_gnn_exact.py): the streamed chunks must give the plain
    version's soft bits exactly, so a chunk, index or shift fault shows; B9
    also at T=1 (its thin last layer alone)."""
    qc = tcodes.qc_layout(tcodes.get_base_graph(code), Z)
    model, llr = exact_msg_gnn_case(qc, h, batch, inject, share, num_iterations=T)
    dec = WIDE_BUILDERS[kind](qc, model, T, h, share_layers=share, input_injection=inject)
    llr = torch.from_numpy(llr).cuda()
    before = fg.LAUNCHES[kind]
    soft_k, soft_p = dec(llr), dec.plain(llr)
    torch.cuda.synchronize()
    assert fg.LAUNCHES[kind] == before + 1
    assert torch.equal(soft_k, soft_p)


def test_msg_gnn_wide_block_and_wgmma():
    """The h=128 kernels' block is fg.WIDE_WARPS warps (two warpgroups),
    one block an SM, at both shapes the card runs them at; in their SASS the
    products run on wgmma (HGMMA), msg_gnn_v2 with no mma.sync (HMMA),
    msg_gnn_v4's mma.sync its thin last layer's alone."""
    import subprocess
    from pathlib import Path

    from ldpc_tpu_torch.ops import _build

    for name, Z in (("nr_2_0_4", 4), ("nr_2_0_32", 32)):
        qc = tcodes.qc_layout(tcodes.get_base_graph(name), Z)
        for kind in WIDE_BUILDERS:
            for inject in (False, True):
                assert fg.msg_gnn_tc_plan(qc, 128, inject, kind) == (fg.WIDE_WARPS, 1)
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path("fused_msg_gnn_tc"))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    ops, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            ops[name] = {"HMMA": 0, "HGMMA": 0}
        elif name is not None:
            for op in ("HGMMA", "HMMA"):
                if op in line:
                    ops[name][op] += 1
    for inject in (0, 1):
        for V in (7, 9):
            name = f"msg_gnn_wide_tc_kernelILb{inject}ELi{V}E"
            (count,) = [c for k, c in ops.items() if name in k]
            assert count["HGMMA"] > 0 and (count["HMMA"] > 0) == (V == 9)


@pytest.mark.parametrize("kind", list(WIDE_BUILDERS))
def test_msg_gnn_wide_ring_over_ten_layers(kind):
    """T=10 at the ft-floor path's shape (nr_2_0_4 Z=4, injection) on 400
    frames: every block decodes several frames, each layer walks the ring 56
    steps, so a stage's barrier phases run on across layers and frames;
    decisions equal to the plain version's on >= 99.9% of the bits (bf16
    flips cascade over ten layers), one launch."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_4"), 4)
    model = _msg_model(qc_msg.make_plan(qc), 10, 128, True, False)
    dec = WIDE_BUILDERS[kind](qc, model, 10, 128, input_injection=True)
    llr = _llr(qc.num_vars, 400, 1.0, seed=10)
    before = fg.LAUNCHES[kind]
    soft_k, soft_p = dec(llr), dec.plain(llr)
    torch.cuda.synchronize()
    assert fg.LAUNCHES[kind] == before + 1
    assert bool(torch.isfinite(soft_k).all())
    assert ((soft_k > 0.5) == (soft_p > 0.5)).float().mean().item() >= 0.999


@pytest.mark.parametrize("kind", list(WIDE_BUILDERS))
@pytest.mark.parametrize("T", [1, 3])
def test_msg_gnn_wide_several_frames_a_block(kind, T):
    """B7 and B9 at h=128 on three frames or more a resident block (each
    block takes later frames into the scratch slice its earlier frames used)
    at T=1 (B9: the thin last layer alone) and T=3 (a middle layer):
    soft bits within 3e-2, confident decisions identical."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_4"), 4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dec = WIDE_BUILDERS[kind](qc, _msg_model(qc_msg.make_plan(qc), T, 128, True, False), T, 128,
                              input_injection=True)
    resident = fg.msg_gnn_tc_plan(qc, 128, True, kind)[1] * sms
    llr = _llr(qc.num_vars, 3 * resident + 1, 1.0, seed=T)
    soft_k, soft_p = dec(llr), dec.plain(llr)
    torch.cuda.synchronize()
    assert (soft_k - soft_p).abs().max().item() <= 3e-2
    confident = (soft_p - 0.5).abs() > 0.05
    assert bool(((soft_k > 0.5) == (soft_p > 0.5))[confident].all())


@pytest.mark.parametrize("variant", ["vpu", "mxu"])
@pytest.mark.parametrize("name,Z,h,L,frames", [("toy_4x8", 4, 16, 3, 5),
                                               ("nr_2_0_4", 24, 16, 2, 3),
                                               ("nr_2_0_32", 32, 64, 10, 9)])
def test_probe_kernel_matches_plain(variant, name, Z, h, L, frames):
    """B10: vpu identical to the plain version, mxu within one bf16 step; Z=4
    and Z=24 pad the tensor cores' lanes to 16 and 32."""
    from ldpc_tpu_torch.tools import probe_agg_mxu as pm

    qc = tcodes.qc_layout(tcodes.get_base_graph(name), Z)
    feats = pm.random_features(qc, h, frames, torch.device("cuda"), seed=Z)
    probe = pm.make_probe(qc, h, L, variant)
    before = pm.LAUNCHES[variant]
    out_k, out_p = probe(feats), probe.plain(feats)
    torch.cuda.synchronize()
    assert pm.LAUNCHES[variant] == before + 1
    assert out_k.shape == feats.shape and out_k.dtype == torch.bfloat16
    if variant == "vpu":
        assert torch.equal(out_k, out_p)
    else:
        assert pm.bf16_steps(out_k, out_p) <= 1.0


@pytest.mark.parametrize("variant", ["vpu", "mxu"])
@pytest.mark.parametrize("name,Z,h,L,frames", [("toy_4x8", 4, 16, 3, 5), ("nr_2_0_4", 8, 32, 4, 3),
                                               ("nr_2_0_32", 32, 64, 10, 3),
                                               ("nr_2_0_32", 64, 32, 5, 2)])
def test_probe_kernels_exact_features(variant, name, Z, h, L, frames):
    """B10 on each of its paths (vpu's shuffles at Z=4, 8 and 32, its
    shared-memory slices at Z=64; mxu's tensor-core tiles at all four):
    random features at the bars (vpu identical, mxu within one bf16 step),
    and on integer-valued features, whose every sum is exact in any order,
    both identical to the plain version."""
    from ldpc_tpu_torch.tools import probe_agg_mxu as pm

    qc = tcodes.qc_layout(tcodes.get_base_graph(name), Z)
    assert pm.vpu_in_registers(Z) == (Z <= 32)
    probe = pm.make_probe(qc, h, L, variant)
    dev = torch.device("cuda")
    for exact in (False, True):
        make = pm.exact_features if exact else pm.random_features
        feats = make(qc, h, frames, dev, seed=Z + exact)
        before = pm.LAUNCHES[variant]
        out_k, out_p = probe(feats), probe.plain(feats)
        torch.cuda.synchronize()
        assert pm.LAUNCHES[variant] == before + 1
        if exact or variant == "vpu":
            assert torch.equal(out_k, out_p)
        else:
            assert pm.bf16_steps(out_k, out_p) <= 1.0


def test_probe_raising_paths():
    from ldpc_tpu_torch.tools import probe_agg_mxu as pm

    qc = tcodes.qc_layout(tcodes.get_base_graph("toy_4x8"), 4)
    probe = pm.make_probe(qc, 16, 2, "mxu")
    with pytest.raises(ValueError, match="built for cuda"):
        probe(torch.zeros((2, qc.num_base_edges, 16, 4), dtype=torch.bfloat16))
    feats = torch.zeros((2, qc.num_base_edges, 4, 16), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        probe(feats.transpose(-1, -2))


def test_trace_records_the_cards_kernels(tmp_path):
    """utils.profiling.trace on the card: the probe kernel shows up with
    device time in the profiler's sums and in the written trace."""
    from ldpc_tpu_torch.tools import probe_agg_mxu as pm
    from ldpc_tpu_torch.utils import profiling

    qc = tcodes.qc_layout(tcodes.get_base_graph("toy_4x8"), 4)
    probe = pm.make_probe(qc, 16, 2, "vpu")
    feats = pm.random_features(qc, 16, 4, torch.device("cuda"))
    with profiling.trace(tmp_path) as prof:
        with profiling.annotate("probe"):
            probe(feats)
        torch.cuda.synchronize()
    device_us = sum(e.device_time_total for e in prof.key_averages() if "probe_vpu" in e.key)
    assert device_us > 0
    assert "probe_vpu" in (tmp_path / "trace.json").read_text()


# ---------------------------------------------------------------------------
# Training and evaluation on the card
# ---------------------------------------------------------------------------


def _train_nms(device):
    """A float32 neural min-sum (type sharing, per-iteration, learnable alpha
    and offset) at toy_4x8 Z=4 on ``device``, its weights moved by seeded
    noise, and a batch of LLRs and ground truth made on the CPU."""
    from ldpc_tpu_torch.models import NeuralMinSumDecoder

    qc = tcodes.qc_layout(tcodes.get_base_graph("toy_4x8"), 4)
    plan = qc_msg.make_plan(qc, device)
    model = NeuralMinSumDecoder(plan, num_iterations=3, depth_L=2, weight_sharing="type",
                                learnable_alpha=True, learnable_offset=True, per_iteration=True)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in model.parameters():
            p.add_((0.1 * torch.randn(p.shape, generator=gen)).to(device))
    bits = (torch.rand((16, qc.num_vars), generator=gen) < 0.5).to(torch.float32)
    llr = bpsk_awgn_llr(gen, bits, 1.0)
    return model, plan, llr.to(device), bits.to(device)


def test_adam_step_on_the_card_matches_the_cpu():
    """One Adam update (clip acting, weight decay on) through the trainer's
    make_optimizer and train_step, on the card and on the CPU from identical
    parameters and batch: loss within 1e-5 relative, clipped gradients
    within 1e-5 relative to their largest magnitude, parameters within atol
    1e-6 (the update is about lr = 1e-3 an entry)."""
    from ldpc_tpu_torch.training.trainer import make_optimizer, train_step

    out = {}
    for device in ("cpu", "cuda"):
        model, plan, llr, bits = _train_nms(device)
        opt = make_optimizer(model.parameters(), "adam", 1e-3, 1e-2)
        loss = train_step(model, plan, opt, llr, bits, grad_clip=0.05)
        out[device] = (float(loss), {n: (p.detach().cpu(), p.grad.cpu())
                                     for n, p in model.named_parameters()})
    (loss_c, cpu), (loss_g, card) = out["cpu"], out["cuda"]
    assert abs(loss_g / loss_c - 1.0) <= 1e-5
    for name, (p_c, g_c) in cpu.items():
        p_g, g_g = card[name]
        assert (g_g - g_c).abs().max() <= 1e-5 * g_c.abs().max(), name
        torch.testing.assert_close(p_g, p_c, rtol=0, atol=1e-6, msg=name)


def test_remat_transparent_on_the_card():
    """remat on the card, float32 compute: forward identical, gradients
    within rtol 1e-5, atol 1e-6 (the backward's index sums accumulate in
    another order from run to run)."""
    from ldpc_tpu_torch.models import create_corrected_minsum_gnn_decoder

    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_4"), 4)
    plan = qc_msg.make_plan(qc)
    kw = dict(num_iterations=3, hidden_dim=16, input_injection=True, multiloss=True,
              compute_dtype=torch.float32)
    base = create_corrected_minsum_gnn_decoder(plan, generator=torch.Generator().manual_seed(1),
                                               **kw)
    with torch.no_grad():
        for p in base.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel()))
                   .cuda())
    rmt = create_corrected_minsum_gnn_decoder(plan, remat=True, **kw)
    rmt.load_state_dict(base.state_dict())
    llr = _llr(qc.num_vars, 32, 1.0, seed=4)
    truth = torch.zeros_like(llr)
    outs, grads = [], []
    for model in (base, rmt):
        soft, loss = model(llr, plan, truth)
        loss.mean().backward()
        outs.append((soft.detach(), loss.detach()))
        grads.append({n: p.grad for n, p in model.named_parameters()})
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=1e-5, atol=1e-6, msg=name)


def test_fine_tuned_corrected_through_b4():
    """The committed nr_2_0_4 corrected GNN (T=5, h=64) fine-tuned three
    Adam updates on the card by train_steps (remat, random codewords), then
    served through corrected_v2: >= 99.9% of the module's confident
    decisions (|p - 0.5| > 0.05) equal, and the kernel launched."""
    from pathlib import Path

    from ldpc_tpu_torch.training import LDPCDecoderTrainer

    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_4"), 4)
    plan = qc_msg.make_plan(qc)
    model = create_corrected_minsum_gnn_decoder(plan, num_iterations=5, hidden_dim=64,
                                                input_injection=True, remat=True)
    enc = tcodes.encoder_from_H(tcodes.expand_base_matrix(tcodes.get_base_graph("nr_2_0_4"), 4))
    trainer = LDPCDecoderTrainer(model, plan, seed=0, encoder=enc)
    trainer.load_model(Path(__file__).resolve().parent.parent / "results"
                       / "corrected_gnn_nr_2_0_4.msgpack")
    trainer.train_steps(3, batch_size=32, learning_rate=3e-4, snr_range=[-1.0, 2.0],
                        grad_clip=1.0, warmup_steps=1)
    dec = fg.make_fused_corrected_gnn_decoder_v2(qc, model, 5, 64, input_injection=True)
    llr = _llr(qc.num_vars, 512, 1.0, seed=5)
    before = fg.LAUNCHES["corrected_v2"]
    soft_k = dec(llr)
    with torch.no_grad():
        soft_m, _ = model(llr, plan)
    torch.cuda.synchronize()
    assert fg.LAUNCHES["corrected_v2"] == before + 1
    confident = (soft_m - 0.5).abs() > 0.05
    agreement = ((soft_k > 0.5) == (soft_m > 0.5))[confident].double().mean().item()
    assert agreement >= 0.999


def test_evaluator_fused_counts_equal_plain():
    """ComparativeEvaluator's fused min-sum (fused_retire) on the card gives
    the plain tensor-op path's BER, FER and mean iterations, and launches
    the kernel twice a trial (counts, then iterations)."""
    from ldpc_tpu_torch.training import ComparativeEvaluator

    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_4"), 4)
    plan = qc_msg.make_plan(qc)
    kw = dict(snr_range=[0.0, 1.0, 2.0], batch_size=512, num_trials=2)
    fused, plain = ComparativeEvaluator(plan, **kw), ComparativeEvaluator(plan, **kw)
    fused.add_min_sum(20, 0.75, qc=qc, fused=True)
    plain.add_min_sum(20, 0.75)
    before = fm.LAUNCHES["fused_retire"]
    got = fused.evaluate_all(log=None)
    assert fm.LAUNCHES["fused_retire"] == before + 12
    assert got == plain.evaluate_all(log=None)


def test_cli_compare_on_the_card(tmp_path):
    """``python -m ldpc_tpu_torch.cli compare`` on the card at nr_2_0_4 Z=4:
    BP, min-sum and a fresh tied model, the JAX CLI's results schema."""
    import json

    from ldpc_tpu_torch import cli

    cli.main(["compare", "--base-graph", "nr_2_0_4", "--lifting-factor", "4",
              "--model-type", "tied", "--snr-min", "0", "--snr-max", "2", "--batch-size", "256",
              "--num-trials", "2", "--model-path", str(tmp_path / "none.pt"),
              "--results-dir", str(tmp_path)])
    res = json.loads((tmp_path / "comparison_results.json").read_text())
    assert res["snr_range"] == [0.0, 1.0, 2.0]
    assert list(res["decoders"]) == ["Belief Propagation", "Min-Sum Scaled", "Neural (tied)"]
    for entry in res["decoders"].values():
        assert all(0.0 <= x <= 1.0 for k in ("ber", "fer") for x in entry[k])
        assert entry["ber"][0] > entry["ber"][2]
    assert res["decoders"]["Neural (tied)"]["param_count"] > 0


def test_shard_decode_fused_retire_world_of_one(tmp_path):
    """shard_decode over fused_retire in an NCCL world of 1: one launch, the
    unsharded call's bits and conv_iter."""
    import torch.distributed as dist

    from ldpc_tpu_torch.parallel import distributed_init, make_mesh, mc_sweep, shard_decode

    distributed_init(f"file://{tmp_path / 'store'}", world_size=1, rank=0, backend="nccl",
                     timeout=60)
    try:
        qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 32)
        mesh = make_mesh()
        dec = fm.make_fused_minsum(qc, 20, 0.75)
        llr = _llr(qc.num_vars, 4096, 2.0, seed=26)
        bits1, conv1 = dec(llr)
        before = fm.LAUNCHES["fused_retire"]
        bits_n, conv_n = shard_decode(dec, mesh)(llr)
        torch.cuda.synchronize()
        assert fm.LAUNCHES["fused_retire"] == before + 1
        assert torch.equal(bits_n, bits1) and torch.equal(conv_n, conv1)
        plan = qc_msg.make_plan(qc)
        kw = dict(snr_range=[1.0], batch_size=4096, num_trials=2, modulation="bpsk")
        decode = lambda x: dec(x)[0]  # noqa: E731
        assert mc_sweep(decode, plan, mesh=mesh, **kw) == mc_sweep(decode, plan, **kw)
    finally:
        dist.destroy_process_group()


def test_waterfall_tool_on_the_card(tmp_path):
    """The waterfall tool at a small --bits-per-point: one fused_retire
    launch a point, the JAX tool's keys, the card's name beside the time."""
    from ldpc_tpu_torch.tools import high_precision_curve

    before = fm.LAUNCHES["fused_retire"]
    res = high_precision_curve.main(["--bits-per-point", "1e7", "--batch", "4096",
                                     "--out", str(tmp_path / "curve.json")])
    assert fm.LAUNCHES["fused_retire"] == before + 7
    assert res["trials_per_point"] == 1 and res["bits_per_point"] == 4096 * 1664
    for key in ("snr", "ber", "fer", "bits_per_point", "iterations", "batch", "code",
                "wall_seconds", "decoded_bits_per_s"):
        assert key in res
    assert res["nvidia_smi"] and res["device"].startswith("cuda")
    assert res["fer"][0] > 0.9 and res["ber"][0] > res["ber"][-1]
