"""The slice as a whole: ldpc_tpu_torch's classical decoders against
ldpc_tpu's at the production code, nr_2_0_32 Z=32, batch 8, 20 iterations,
1-3 dB.  Bits identical; conv_iter within 1 on at most 1% of frames (the JAX
package's own kernel-vs-XLA bar, tests/test_pallas_minsum.py), because the
tensor-op path sums column messages with a matmul."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import bpsk_llrs, to_numpy

import ldpc_tpu.codes as jcodes
import ldpc_tpu.models.classical as jc
import ldpc_tpu.ops.qc_msg as jm
import ldpc_tpu_torch.codes as tcodes
import ldpc_tpu_torch.models.classical as tc
import ldpc_tpu_torch.ops.qc_msg as tm
from ldpc_tpu_torch.ops import fused_minsum as fm

ITERS, BATCH = 20, 8
SNRS = [1.0, 2.0, 3.0]


@pytest.fixture(scope="module")
def code():
    qc_j = jcodes.qc_layout(jcodes.get_base_graph("nr_2_0_32"), 32)
    qc_t = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 32)
    return qc_j, qc_t, jm.make_plan(qc_j), tm.make_plan(qc_t, device="cpu")


@pytest.fixture(scope="module")
def jax_layered(code):
    """One jitted JAX layered decoder for the module: it compiles once."""
    return jc.make_layered_minsum(code[0], ITERS, 0.75)


def _llr(snr_db, seed=0):
    return bpsk_llrs(1664, BATCH, snr_db, seed=seed + int(10 * snr_db))


def _assert_slice_parity(bits_j, conv_j, bits_t, conv_t):
    np.testing.assert_array_equal(to_numpy(bits_t), to_numpy(bits_j))
    d = np.abs(to_numpy(conv_t).astype(np.int64) - to_numpy(conv_j))
    assert (d <= 1).all() and (d > 0).mean() <= 0.01


@pytest.mark.parametrize("snr_db", SNRS)
@pytest.mark.parametrize("early_exit", [False, True])
def test_decode_min_sum(code, snr_db, early_exit):
    _, _, pj, pt = code
    llr = _llr(snr_db)
    j = jc.decode_min_sum(jnp.asarray(llr), pj, ITERS, 0.75, early_exit=early_exit)
    t = tc.decode_min_sum(torch.from_numpy(llr), pt, ITERS, 0.75, early_exit=early_exit)
    _assert_slice_parity(j.bits, j.conv_iter, t.bits, t.conv_iter)
    np.testing.assert_array_equal(to_numpy(t.converged), np.asarray(j.converged))
    np.testing.assert_allclose(to_numpy(t.beliefs), np.asarray(j.beliefs), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("snr_db", SNRS)
def test_decode_bp(code, snr_db):
    _, _, pj, pt = code
    llr = _llr(snr_db, seed=1)
    j = jc.decode_bp(jnp.asarray(llr), pj, ITERS)
    t = tc.decode_bp(torch.from_numpy(llr), pt, ITERS)
    _assert_slice_parity(j.bits, j.conv_iter, t.bits, t.conv_iter)
    te = tc.decode_bp(torch.from_numpy(llr), pt, ITERS, early_exit=True)
    torch.testing.assert_close(te.bits, t.bits, rtol=0, atol=0)
    torch.testing.assert_close(te.conv_iter, t.conv_iter, rtol=0, atol=0)


@pytest.mark.parametrize("snr_db", SNRS)
def test_layered_minsum(code, jax_layered, snr_db):
    _, qc_t, _, _ = code
    llr = _llr(snr_db, seed=2)
    j = jax_layered(jnp.asarray(llr))
    t = tc.make_layered_minsum(qc_t, ITERS, 0.75, device="cpu")(torch.from_numpy(llr))
    _assert_slice_parity(j.bits, j.conv_iter, t.bits, t.conv_iter)
    te = tc.make_layered_minsum(qc_t, ITERS, 0.75, early_exit=True,
                                device="cpu")(torch.from_numpy(llr))
    torch.testing.assert_close(te.bits, t.bits, rtol=0, atol=0)
    torch.testing.assert_close(te.conv_iter, t.conv_iter, rtol=0, atol=0)


@pytest.mark.parametrize("snr_db,schedule", [(s, "flooding") for s in SNRS] + [(2.0, "layered")])
def test_min_sum_decoder_object(code, snr_db, schedule):
    """The serving object: the JAX one on the CPU takes its XLA path, the port
    takes the fused kernel's plain version (auto -> fused)."""
    qc_j, qc_t, _, _ = code
    llr = _llr(snr_db, seed=3)
    dj = jc.MinSumScaledDecoder(qc_j, ITERS, 0.75, schedule=schedule)
    dt = tc.MinSumScaledDecoder(qc_t, ITERS, 0.75, schedule=schedule, device="cpu")
    assert dt._fused is not None and dt._fused.kind == "fused"
    bj, ij = dj.decode(jnp.asarray(llr))
    bt, it = dt.decode(torch.from_numpy(llr))
    np.testing.assert_array_equal(to_numpy(bt), np.asarray(bj))
    assert abs(it - ij) <= 1
    fj, ft = dj.decode_full(jnp.asarray(llr)), dt.decode_full(torch.from_numpy(llr))
    _assert_slice_parity(fj.bits, fj.conv_iter, ft.bits, ft.conv_iter)


@pytest.mark.parametrize("snr_db", SNRS)
def test_bp_decoder_object(code, snr_db):
    qc_j, qc_t, _, _ = code
    llr = _llr(snr_db, seed=4)
    bj, ij = jc.BeliefPropagationDecoder(qc_j, ITERS).decode(jnp.asarray(llr))
    bt, it = tc.BeliefPropagationDecoder(qc_t, ITERS, device="cpu").decode(
        torch.from_numpy(llr))
    np.testing.assert_array_equal(to_numpy(bt), np.asarray(bj))
    assert abs(it - ij) <= 1


def test_plain_backend_and_fixed_trip(code):
    _, qc_t, _, _ = code
    llr = torch.from_numpy(_llr(2.0, seed=5))
    auto = tc.MinSumScaledDecoder(qc_t, ITERS, 0.75, early_stopping=False, device="cpu")
    plain = tc.MinSumScaledDecoder(qc_t, ITERS, 0.75, early_stopping=False,
                                   backend="plain", device="cpu")
    assert plain._fused is None
    (ba, ia), (bp, ip) = auto.decode(llr), plain.decode(llr)
    torch.testing.assert_close(ba, bp, rtol=0, atol=0)
    assert ia == ip == ITERS


def test_resolve_backend():
    bg = tcodes.get_base_graph("nr_2_0_32")
    assert tc._resolve_backend("auto", tcodes.qc_layout(bg, 32)) == "fused"
    assert tc._resolve_backend("auto", tcodes.qc_layout(bg, 384)) == "fused_zlane"
    assert tc._resolve_backend("plain", tcodes.qc_layout(bg, 384)) == "plain"
    with pytest.raises(ValueError, match="no fused kernel"):
        tc._resolve_backend("auto", tcodes.qc_layout(bg, 212))  # too big, Z % 8 != 0
    with pytest.raises(ValueError, match="unknown backend"):
        tc._resolve_backend("xla")
    dec = tc.MinSumScaledDecoder(tcodes.qc_layout(bg, 384), 2, device="cpu")
    assert dec._fused.kind == "fused_zlane"


def test_entry_points_raise_without_a_card(code):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    _, qc_t, _, _ = code
    for make in (lambda: tm.make_plan(qc_t),
                 lambda: fm.make_fused_minsum(qc_t),
                 lambda: fm.make_fused_minsum_zlane(tcodes.qc_layout(
                     tcodes.get_base_graph("nr_2_0_32"), 384)),
                 lambda: tc.make_layered_minsum(qc_t),
                 lambda: tc.MinSumScaledDecoder(qc_t),
                 lambda: tc.BeliefPropagationDecoder(qc_t)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    dec = fm.make_fused_minsum(qc_t, device="cpu")
    with pytest.raises(ValueError, match="built for cpu"):
        dec(torch.zeros((1, 1664), device="meta"))
