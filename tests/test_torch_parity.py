"""Shared helpers for holding ldpc_tpu_torch against ldpc_tpu, and tests
of the helpers themselves.

Inputs are made with numpy from a seed and handed to both packages, since
the two frameworks' generators never give the same numbers.  The other
test_torch_*.py files import these helpers; this file imports neither JAX
nor ldpc_tpu at module level, so the card-only tests can use it too.
"""
import numpy as np
import pytest
import torch

# Flag sets of the fused kernels: (track_convergence, early_exit).
TRACKING = (True, False)
THROUGHPUT = (False, False)
EARLY_EXIT = (True, True)
ALL_FLAGS = [
    (mode, schedule, tr, ee)
    for mode in ("minsum", "sumproduct")
    for schedule in ("flooding", "layered")
    for tr, ee in (TRACKING, THROUGHPUT, EARLY_EXIT)
]


def bpsk_llrs(n: int, batch: int, snr_db: float, seed: int) -> np.ndarray:
    """(batch, n) float32 BPSK-AWGN LLRs of the all-zero codeword."""
    rng = np.random.default_rng(seed)
    snr = 10.0 ** (snr_db / 10.0)
    sigma = 1.0 / np.sqrt(snr)
    received = 1.0 + sigma * rng.standard_normal((batch, n))
    return (2.0 * received / sigma**2).astype(np.float32)


def assert_decoder_parity(mode: str, bits_a, conv_a, bits_b, conv_b) -> None:
    """The JAX package's kernel bars: min-sum bits and conv_iter identical;
    sum-product bits agree on >= 99.9% and conv_iter within 1
    (tests/test_pallas_minsum.py), because log/tanh round differently."""
    bits_a, bits_b = np.asarray(bits_a), np.asarray(bits_b)
    conv_a, conv_b = np.asarray(conv_a), np.asarray(conv_b)
    assert bits_a.shape == bits_b.shape
    assert conv_a.shape == conv_b.shape
    if mode == "minsum":
        np.testing.assert_array_equal(bits_a, bits_b)
        np.testing.assert_array_equal(conv_a, conv_b)
    else:
        assert (bits_a == bits_b).mean() >= 0.999
        assert (np.abs(conv_a - conv_b) <= 1).all()


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def check_kernel_plain_against_jax(kind: str, name: str, Z: int, mode: str, schedule: str,
                                   track_convergence: bool, early_exit: bool,
                                   iterations: int = 8, snr_db: float = 1.0,
                                   batch: int = 9, seed: int = 0) -> None:
    """The port's builder (CPU tensors -> the kernel's plain version) against
    the JAX builder in Pallas interpret mode, on the same numpy LLRs.  The
    batch is not a multiple of the JAX batch tile (8), so padding is covered."""
    import jax.numpy as jnp

    import ldpc_tpu.codes as jcodes
    from ldpc_tpu.ops import pallas_minsum as jpm

    import ldpc_tpu_torch.codes as tcodes
    from ldpc_tpu_torch.ops import fused_minsum as tfm

    qc_j = jcodes.qc_layout(jcodes.get_base_graph(name), Z)
    qc_t = tcodes.qc_layout(tcodes.get_base_graph(name), Z)
    llr = bpsk_llrs(qc_t.num_vars, batch, snr_db, seed)
    flags = dict(mode=mode, track_convergence=track_convergence, early_exit=early_exit,
                 schedule=schedule)
    if kind == "fused":
        jdec = jpm.make_fused_minsum(qc_j, iterations, 0.75, batch_tile=8, interpret=True,
                                     **flags)
        tdec = tfm.make_fused_minsum(qc_t, iterations, 0.75, device="cpu", **flags)
    else:
        jdec = jpm.make_fused_minsum_zlane(qc_j, iterations, 0.75, batch_tile=8,
                                           interpret=True, **flags)
        tdec = tfm.make_fused_minsum_zlane(qc_t, iterations, 0.75, device="cpu", **flags)
    bits_j, conv_j = jdec(jnp.asarray(llr))
    launches = dict(tfm.LAUNCHES)
    bits_t, conv_t = tdec(torch.from_numpy(llr))
    assert tfm.LAUNCHES == launches  # a CPU tensor never reaches a kernel
    assert bits_t.shape == (batch, qc_t.num_vars) and bits_t.dtype == torch.float32
    assert conv_t.shape == (batch,) and conv_t.dtype == torch.int32
    assert_decoder_parity(mode, bits_j, conv_j, bits_t, conv_t)
    conv = to_numpy(conv_t)
    if track_convergence:
        assert len(set(conv.tolist())) > 1  # frames converge at different iterations
    else:
        assert (conv == iterations).all()


def test_bpsk_llrs_are_seeded_and_scaled():
    a, b = bpsk_llrs(64, 500, 2.0, seed=3), bpsk_llrs(64, 500, 2.0, seed=3)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.float32 and a.shape == (500, 64)
    snr = 10 ** 0.2
    assert abs(a.mean() / (2 * snr) - 1) < 0.02  # mean 2/sigma^2 with sigma^2 = 1/snr
    assert not np.array_equal(a, bpsk_llrs(64, 500, 2.0, seed=4))


def test_decoder_parity_bars():
    bits = np.zeros((4, 10), np.float32)
    conv = np.array([1, 2, 3, 4], np.int32)
    assert_decoder_parity("minsum", bits, conv, bits.copy(), conv.copy())
    flipped = bits.copy()
    flipped[0, 0] = 1.0
    with pytest.raises(AssertionError):
        assert_decoder_parity("minsum", bits, conv, flipped, conv)
    # sum-product: 1 of 40 bits differs (97.5% < 99.9%) -> rejected
    with pytest.raises(AssertionError):
        assert_decoder_parity("sumproduct", bits, conv, flipped, conv)
    assert_decoder_parity("sumproduct", bits, conv, bits, conv + 1)
    with pytest.raises(AssertionError):
        assert_decoder_parity("sumproduct", bits, conv, bits, conv + 2)
