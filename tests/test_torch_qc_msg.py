"""ldpc_tpu_torch.ops.qc_msg held against ldpc_tpu.ops.qc_msg, op by op.

Gathers, min-sum and the syndrome are exact; col_sum is a matmul that sums
in another order than XLA's (atol=1e-5); sum-product goes through log/tanh,
which round differently (rtol=1e-5, plus atol=1e-6 for outputs near 0)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu.codes as jcodes
import ldpc_tpu.ops.qc_msg as jm
import ldpc_tpu_torch.codes as tcodes
import ldpc_tpu_torch.ops.qc_msg as tm

CODES = [("toy_4x8", 4), ("nr_2_0_4", 4), ("nr_2_0_32", 32)]
B = 6


def _plans(name, Z):
    pj = jm.make_plan(jcodes.qc_layout(jcodes.get_base_graph(name), Z))
    pt = tm.make_plan(tcodes.qc_layout(tcodes.get_base_graph(name), Z), device="cpu")
    return pj, pt


def _msgs(plan, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((plan.K, plan.Z, B)) * scale).astype(np.float32)
    x[0, 0, 0] = 0.0  # sign(0) = +1 on both sides
    x[1, :, 1] = x[2, :, 1]  # ties between magnitudes
    return x


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("name,Z", CODES)
def test_plan_fields_match(name, Z):
    pj, pt = _plans(name, Z)
    for f in ("Z", "R", "C", "K", "dr_max", "num_edge_types"):
        assert getattr(pj, f) == getattr(pt, f), f
    for f in ("edge_col", "edge_type", "row_gather_var", "ungroup_to_var", "row_valid",
              "col_incidence", "edge_check_var_aligned", "row_incidence", "edge_row",
              "roll_to_check", "roll_to_var"):
        np.testing.assert_array_equal(np.asarray(getattr(pj, f)), getattr(pt, f).numpy(),
                                      err_msg=f)
    assert pt.to("cpu").col_incidence.device == torch.device("cpu")


@pytest.mark.parametrize("name,Z", CODES)
def test_gathers_and_layout_exact(name, Z):
    pj, pt = _plans(name, Z)
    x = _msgs(pt, 0)
    for pad in (0.0, -7.0):
        np.testing.assert_array_equal(
            tm.group_to_check(_t(x), pt, pad).numpy(),
            np.asarray(jm.group_to_check(jnp.asarray(x), pj, pad)))
    g = np.random.default_rng(1).standard_normal((pt.R, pt.dr_max, Z, B)).astype(np.float32)
    np.testing.assert_array_equal(tm.ungroup_to_var(_t(g), pt).numpy(),
                                  np.asarray(jm.ungroup_to_var(jnp.asarray(g), pj)))
    llr = np.random.default_rng(2).standard_normal((B, pt.C * Z)).astype(np.float32)
    cz = tm.llr_to_cz(_t(llr), pt)
    np.testing.assert_array_equal(cz.numpy(), np.asarray(jm.llr_to_cz(jnp.asarray(llr), pj)))
    np.testing.assert_array_equal(tm.cz_to_llr(cz).numpy(), llr)


@pytest.mark.parametrize("name,Z", CODES)
def test_col_sum_and_var_update(name, Z):
    pj, pt = _plans(name, Z)
    x = _msgs(pt, 3)
    np.testing.assert_allclose(tm.col_sum(_t(x), pt).numpy(),
                               np.asarray(jm.col_sum(jnp.asarray(x), pj)), atol=1e-5, rtol=0)
    llr_cz = np.random.default_rng(4).standard_normal((pt.C, Z, B)).astype(np.float32)
    v2c_t, bel_t = tm.var_update(_t(x), _t(llr_cz), pt)
    v2c_j, bel_j = jm.var_update(jnp.asarray(x), jnp.asarray(llr_cz), pj)
    np.testing.assert_allclose(v2c_t.numpy(), np.asarray(v2c_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(bel_t.numpy(), np.asarray(bel_j), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name,Z", CODES)
@pytest.mark.parametrize("alpha,offset", [(1.0, 0.0), (0.75, 0.0), (0.8, 0.25)])
def test_check_update_minsum_exact(name, Z, alpha, offset):
    pj, pt = _plans(name, Z)
    x = _msgs(pt, 5)
    t = tm.check_update_minsum(_t(x), pt, alpha=alpha, offset=offset).numpy()
    j = np.asarray(jm.check_update_minsum(jnp.asarray(x), pj, alpha=alpha, offset=offset))
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("name,Z", CODES)
def test_check_update_sumproduct(name, Z):
    pj, pt = _plans(name, Z)
    x = _msgs(pt, 6)
    t = tm.check_update_sumproduct(_t(x), pt).numpy()
    j = np.asarray(jm.check_update_sumproduct(jnp.asarray(x), pj))
    # atol: for large leave-one-out sums tanh(x/2) sits within an ulp of 1
    # (6e-8), so phi of it is a few 1e-7 wide whatever the library.
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,Z", CODES)
def test_syndrome_exact(name, Z):
    pj, pt = _plans(name, Z)
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, (pt.C, Z, B)).astype(np.float32)
    bits[..., 0] = 0.0  # the all-zero codeword is valid
    t = tm.syndrome_ok(_t(bits), pt).numpy()
    j = np.asarray(jm.syndrome_ok(jnp.asarray(bits), pj))
    np.testing.assert_array_equal(t, j)
    assert t[0] and not t[1:].all()


def test_plan_from_H():
    H = jcodes.expand_base_matrix(jcodes.get_base_graph("toy_4x8"), 2)
    pj, pt = jm.plan_from_H(H), tm.plan_from_H(H, device="cpu")
    assert (pt.Z, pt.R, pt.C, pt.K) == (pj.Z, pj.R, pj.C, pj.K) == (1, 8, 16, int(H.sum()))
    np.testing.assert_array_equal(pt.row_gather_var.numpy(), np.asarray(pj.row_gather_var))


def test_minsum_check_update_is_differentiable():
    _, pt = _plans("toy_4x8", 4)
    x = _t(_msgs(pt, 8)).requires_grad_(True)
    tm.check_update_minsum(x, pt, alpha=0.75).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
