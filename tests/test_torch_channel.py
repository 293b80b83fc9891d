"""ldpc_tpu_torch.utils.channel held against ldpc_tpu.utils.channel.

The deterministic functions must agree exactly given the same noise; the two
frameworks' generators differ, so the JAX side is handed the port's noise
array in place of ``jax.random.normal``, and generated LLRs are also checked
statistically (BPSK: mean 2/sigma^2, variance 4/sigma^2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu.utils.channel as jch
import ldpc_tpu_torch.utils.channel as tch
from ldpc_tpu_torch.utils.metrics import MetricsRegistry, decode_throughput


def _bits(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 2, shape).astype(np.float32)


def _noise_from(gen_seed, shape):
    """The normal draws the port makes from a CPU generator with this seed."""
    g = torch.Generator(device="cpu").manual_seed(gen_seed)
    return torch.randn(shape, generator=g, dtype=torch.float32).numpy()


@pytest.fixture
def jax_normal_is(monkeypatch):
    """Make ``jax.random.normal`` return a given array (the port's noise)."""
    def install(noise):
        monkeypatch.setattr(jax.random, "normal",
                            lambda key, shape, dtype=jnp.float32: jnp.asarray(noise))
    return install


def test_modulators_exact():
    for n in (10, 11):
        bits = _bits((4, n))
        np.testing.assert_array_equal(tch.bpsk_modulate(torch.from_numpy(bits)).numpy(),
                                      np.asarray(jch.bpsk_modulate(jnp.asarray(bits))))
        t = tch.qpsk_modulate(torch.from_numpy(bits)).numpy()
        j = np.asarray(jch.qpsk_modulate(jnp.asarray(bits)))
        assert t.shape == j.shape == (4, (n + 1) // 2, 2)
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("convention", ["consistent", "reference_package"])
@pytest.mark.parametrize("snr_db", [-2.0, 0.0, 3.5])
def test_qpsk_demodulate_exact(convention, snr_db):
    received = np.random.default_rng(1).normal(0, 1, (3, 7, 2)).astype(np.float32)
    t = tch.qpsk_demodulate(torch.from_numpy(received), snr_db, convention).numpy()
    j = np.asarray(jch.qpsk_demodulate(jnp.asarray(received), snr_db, convention))
    np.testing.assert_array_equal(t, j)
    with pytest.raises(ValueError):
        tch.qpsk_demodulate(torch.from_numpy(received), snr_db, "bogus")


@pytest.mark.parametrize("snr_db", [0.0, 2.0])
def test_bpsk_awgn_llr_exact_given_noise(jax_normal_is, snr_db):
    bits = _bits((6, 40))
    jax_normal_is(_noise_from(5, bits.shape))
    t = tch.bpsk_awgn_llr(torch.Generator().manual_seed(5), torch.from_numpy(bits), snr_db)
    j = jch.bpsk_awgn_llr(jax.random.PRNGKey(0), jnp.asarray(bits), snr_db)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("convention", ["consistent", "reference_package"])
def test_qpsk_awgn_llr_exact_given_noise(jax_normal_is, convention):
    bits = _bits((5, 21))  # odd: padded symbol, truncated LLRs
    jax_normal_is(_noise_from(9, (5, 11, 2)))
    t = tch.qpsk_awgn_llr(torch.Generator().manual_seed(9), torch.from_numpy(bits), 1.5,
                          convention)
    j = jch.qpsk_awgn_llr(jax.random.PRNGKey(0), jnp.asarray(bits), 1.5, convention)
    assert t.shape == (5, 21)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_llr_statistics():
    snr_db = 2.0
    snr = 10 ** (snr_db / 10)
    zeros = torch.zeros((200, 1000))
    llr = tch.bpsk_awgn_llr(torch.Generator().manual_seed(0), zeros, snr_db).double()
    sigma2 = 1.0 / snr
    assert abs(llr.mean().item() / (2 / sigma2) - 1) < 0.01
    assert abs(llr.var().item() / (4 / sigma2) - 1) < 0.02
    # QPSK (consistent): per-component sigma^2 = 1/(2 snr), mean 2 (1/sqrt2) / sigma^2.
    q = tch.qpsk_awgn_llr(torch.Generator().manual_seed(1), zeros, snr_db).double()
    s2 = 1.0 / (2 * snr)
    assert abs(q.mean().item() / (2 / np.sqrt(2) / s2) - 1) < 0.01
    assert abs(q.var().item() / (4 / s2) - 1) < 0.02


def test_error_counts_and_rates_exact():
    tx = _bits((8, 30), seed=2)
    rx = tx.copy()
    rx[1, 3] = 1 - rx[1, 3]
    rx[5, :4] = 1 - rx[5, :4]
    t = [x.item() for x in tch.error_counts(torch.from_numpy(tx), torch.from_numpy(rx))]
    j = [float(x) for x in jch.error_counts(jnp.asarray(tx), jnp.asarray(rx))]
    assert t == j == [5.0, 2.0, 240.0, 8.0]
    tb, tf = tch.compute_ber_fer(torch.from_numpy(tx), torch.from_numpy(rx))
    jb, jf = jch.compute_ber_fer(jnp.asarray(tx), jnp.asarray(rx))
    assert (tb.item(), tf.item()) == (float(jb), float(jf))


def test_scalar_helpers():
    for snr_db in (-3.0, 0.0, 4.0):
        np.testing.assert_allclose(tch.snr_db_to_linear(snr_db).item(),
                                   float(jch.snr_db_to_linear(snr_db)), rtol=1e-6)
        np.testing.assert_allclose(tch.theoretical_qpsk_ber(snr_db).item(),
                                   float(jch.theoretical_qpsk_ber(snr_db)), rtol=1e-6)
        np.testing.assert_allclose(tch.ebn0_to_esn0(snr_db, 0.2).item(),
                                   float(jch.ebn0_to_esn0(snr_db, 0.2)), rtol=1e-6)


def test_metrics_registry():
    reg = MetricsRegistry()
    bps = decode_throughput(100, 1664, 0.5, registry=reg, name="minsum")
    assert bps == 100 * 1664 / 0.5
    assert reg.gauges["minsum_bits_per_s"] == bps
    assert reg.counters["decoded_frames"] == 100
    with reg.timer("step"):
        pass
    snap = reg.snapshot()
    assert len(snap["series"]["step_s"]) == 1
    assert "decoded_bits: 166400" in reg.summary()
