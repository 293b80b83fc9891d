"""B2's min-sum flooding path, the ``retire_zlane`` kernel
(csrc/fused_retire.cu, replaces ldpc_tpu/ops/pallas_minsum.py:399
``_kernel_zlane`` for mode "minsum", schedule "flooding").

It runs ``fused_retire``'s algorithm (compressed check state, syndrome read
off the next check pass, frames that retire the iteration they converge)
for Z where a whole frame exceeds shared memory: one frame a block, the
state words in a global scratch slice.  Held here, on the CPU:

* its shared-memory plan and which codes it takes;
* the dispatch: a ``fused_zlane`` decoder sends min-sum flooding to it and
  keeps sum-product and the layered schedule;
* the numpy model of the kernel's algorithm (``kernel_model``, shared with
  ``fused_retire``'s tests) against the plain version at nr_2_0_32 Z=384
  and Z=256 (the non-power-of-two and power-of-two rolls) on the hard input
  kinds, tracking on and off: bits and conv_iter identical;
* the plain version against the JAX zlane kernel in interpret mode on the
  ties and zeros kinds.
"""
import numpy as np
import pytest
import torch

from test_torch_minsum_retire import BATCH, ITERS, KINDS, _check_kind, hard_llrs, kernel_model
from test_torch_parity import assert_decoder_parity, bpsk_llrs

import ldpc_tpu_torch.codes as tcodes
from ldpc_tpu_torch.models.classical import MinSumScaledDecoder, _resolve_backend
from ldpc_tpu_torch.ops import fused_minsum as fm


@pytest.fixture(autouse=True)
def one_thread():
    """The plain version and the model run many small operations; one torch
    thread each, so several test workers do not fight over the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qc(Z: int, name: str = "nr_2_0_32"):
    return tcodes.qc_layout(tcodes.get_base_graph(name), Z)


def large_z_llrs(kind: str, n: int, seed: int) -> np.ndarray:
    """hard_llrs, except that a batch converged at iteration 1 takes 12 dB:
    at 9 dB some of a frame's 20,000 bits at Z=384 still need a second
    iteration."""
    if kind == "converged_at_1":
        return bpsk_llrs(n, BATCH, 12.0, seed)
    return hard_llrs(kind, n, seed)


@pytest.mark.parametrize("Z", [256, 384])
def test_plan_arithmetic(Z):
    qc = _qc(Z)
    K, R, C = qc.num_base_edges, qc.num_base_rows, qc.num_base_cols
    for parts in fm.retire_zlane_plans(qc):
        structure = 4 * (-(-(6 * K + R + C + 2 + 2 * (parts + 1)) // 4) * 4)
        assert fm.retire_zlane_smem_bytes(qc, parts) == structure + 4 * C * Z + 8 * R * Z
        assert fm.retire_zlane_smem_bytes(qc, parts) <= fm._SMEM_BUDGET
        assert fm.retire_threads(qc, parts, 1) <= 1024
    assert fm.retire_zlane_scratch_bytes(qc) == 4 * R * Z
    # A whole frame (fused_retire's layout) does not fit a block.
    assert fm.retire_smem_bytes(qc, 1, 1) > fm._SMEM_BUDGET


def test_plans_at_z384():
    qc = _qc(384)
    assert fm.retire_zlane_plans(qc) == [1, 2]  # 12 warps a part, 1024 threads at most
    assert fm.retire_zlane_smem_bytes(qc, 2) == 214_032


@pytest.mark.parametrize("Z", [256, 288, 384])
def test_large_z_takes_the_zlane_retiring_kernel(Z):
    qc = _qc(Z)
    assert not fm.retire_kernel_fits(qc) and fm.retire_zlane_fits(qc)


def test_codes_retire_zlane_refuses():
    """Z % 8 != 0, or a row with more members than the 32-bit state word
    holds signs of: no retire_zlane (a row of 31 runs on its 64-bit word,
    retire_zlane_wide); a row of more than the 128-bit word's 121: no
    retiring kernel, fused_zlane."""
    assert not fm.retire_zlane_fits(_qc(12, "nr_2_0_4"))
    from test_torch_minsum_retire import wide_row_shifts
    from test_torch_retire_wide import row_code

    wide = tcodes.qc_layout(tcodes.BaseGraph("wide", wide_row_shifts()), 8)
    assert wide.dr_max == 31 and not fm.retire_zlane_fits(wide)
    assert fm.retire_zlane_fits(wide, word_bits=64)
    assert fm.make_fused_minsum_zlane(wide, ITERS, device="cpu").route == "retire_zlane_wide"
    widest = row_code(122, cols=124, Z=8)
    assert not fm.retire_zlane_fits(widest, word_bits=128)
    dec = fm.make_fused_minsum_zlane(widest, ITERS, device="cpu")
    assert dec.route == "fused_zlane" and not dec.retire


def test_dispatch():
    """Min-sum flooding on a fused_zlane decoder routes to retire_zlane,
    sum-product flooding to retire_zlane_sumproduct, layered min-sum to
    retire_zlane_layered and layered sum-product to
    retire_zlane_layered_sumproduct; auto at Z=384 is still fused_zlane,
    which serves min-sum flooding on retire_zlane."""
    qc = _qc(384)
    dec = fm.make_fused_minsum_zlane(qc, 20, device="cpu")
    assert dec.kind == "fused_zlane" and dec.route == "retire_zlane" and dec.retire
    assert dec.graph is not None  # the CSR structure _launch_zlane needs
    for kw, route in (({"mode": "sumproduct"}, "retire_zlane_sumproduct"),
                      ({"schedule": "layered"}, "retire_zlane_layered")):
        other = fm.make_fused_minsum_zlane(qc, 20, device="cpu", **kw)
        assert other.route == route and other.retire
    other = fm.make_fused_minsum_zlane(qc, 20, device="cpu", mode="sumproduct",
                                       schedule="layered")
    assert other.route == "retire_zlane_layered_sumproduct" and other.retire
    assert _resolve_backend("auto", qc) == "fused_zlane"
    server = MinSumScaledDecoder(qc, 20, 0.75, early_stopping=False, device="cpu")
    assert server._fused.route == "retire_zlane"
    # The route names a launch counter; a CPU tensor moves none of them.
    assert set(fm.LAUNCHES) == {"fused_retire", "fused", "retire_zlane", "fused_zlane",
                                "retire_layered", "retire_sumproduct",
                                "retire_zlane_layered", "retire_zlane_sumproduct",
                                "retire_layered_sumproduct", "retire_zlane_layered_sumproduct",
                                "fused_retire_wide", "retire_layered_wide",
                                "retire_sumproduct_wide", "retire_layered_sumproduct_wide",
                                "fused_retire_w128", "retire_layered_w128",
                                "retire_sumproduct_w128", "retire_layered_sumproduct_w128",
                                "retire_zlane_wide", "retire_zlane_layered_wide",
                                "retire_zlane_sumproduct_wide",
                                "retire_zlane_layered_sumproduct_wide",
                                "retire_zlane_w128", "retire_zlane_layered_w128",
                                "retire_zlane_sumproduct_w128",
                                "retire_zlane_layered_sumproduct_w128"}
    launches = dict(fm.LAUNCHES)
    small = _qc(24, "nr_2_0_4")
    llr = torch.zeros((2, small.num_vars))
    fm.make_fused_minsum_zlane(small, 3, device="cpu")(llr)
    assert fm.LAUNCHES == launches
    with pytest.raises(ValueError, match="no zlane launch"):
        fm.make_fused_minsum(small, 3, device="cpu")._launch_zlane(llr)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("Z", [384, 256])
def test_kernel_model_matches_plain(Z, kind):
    qc = _qc(Z)
    llr = large_z_llrs(kind, qc.num_vars, seed=Z)
    if kind == "zeros":
        assert (np.signbit(llr) & (llr == 0)).any() and (~np.signbit(llr) & (llr == 0)).any()
    for track in (True, False):
        bits_m, conv_m = kernel_model(qc, llr, ITERS, 0.75, track)
        dec = fm.make_fused_minsum_zlane(qc, ITERS, 0.75, track_convergence=track, device="cpu")
        assert dec.route == "retire_zlane"
        bits_p, conv_p = dec.plain(torch.from_numpy(llr))
        assert_decoder_parity("minsum", bits_m, conv_m, bits_p, conv_p)
        if track:
            _check_kind(conv_p.numpy(), kind)


def test_plain_matches_jax_zlane_on_ties_and_zeros():
    """The plain version that retire_zlane is held to against the JAX zlane
    kernel in interpret mode: one compile, both input kinds."""
    import jax.numpy as jnp

    import ldpc_tpu.codes as jcodes
    from ldpc_tpu.ops import pallas_minsum as jpm

    qc = _qc(24, "nr_2_0_4")
    jdec = jpm.make_fused_minsum_zlane(jcodes.qc_layout(jcodes.get_base_graph("nr_2_0_4"), 24),
                                       ITERS, 0.75, batch_tile=8, interpret=True)
    dec = fm.make_fused_minsum_zlane(qc, ITERS, 0.75, device="cpu")
    assert dec.route == "retire_zlane"
    for kind in ("ties", "zeros"):
        llr = hard_llrs(kind, qc.num_vars, seed=24 + len(kind))
        bits_j, conv_j = jdec(jnp.asarray(llr))
        bits_t, conv_t = dec(torch.from_numpy(llr))
        assert_decoder_parity("minsum", bits_j, conv_j, bits_t, conv_t)
        _check_kind(conv_t.numpy(), kind)
