"""Group means and per-edge plumbing of the port's qc_msg against
``ldpc_tpu.ops.qc_msg`` on the same numpy inputs.  float32 within 1e-6;
bfloat16 within one bf16 ulp of the value (2^-7 relative)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gnn_parity import both_plans

from ldpc_tpu.ops import qc_msg as jqc
from ldpc_tpu_torch.ops import qc_msg as tqc

CODES = [("toy_4x8", 4), ("toy_4x8", 8), ("nr_2_0_4", 4)]


def _feats(plan, B, H, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((plan.K, plan.Z, B, H)).astype(np.float32)


@pytest.mark.parametrize("name,Z", CODES)
@pytest.mark.parametrize("fn", ["var_group_mean", "check_group_mean"])
def test_group_mean_float32(name, Z, fn):
    _, pj, _, pt = both_plans(name, Z)
    x = _feats(pt, 3, 5, seed=Z)
    want = np.asarray(getattr(jqc, fn)(jnp.asarray(x), pj))
    got = getattr(tqc, fn)(torch.from_numpy(x), pt)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,Z", CODES)
@pytest.mark.parametrize("fn", ["var_group_mean", "check_group_mean"])
def test_group_mean_bfloat16(name, Z, fn):
    """Sums accumulate in float32 and the mean is cast back to bf16."""
    _, pj, _, pt = both_plans(name, Z)
    x = _feats(pt, 3, 5, seed=Z + 1)
    want = np.asarray(getattr(jqc, fn)(jnp.asarray(x, jnp.bfloat16), pj).astype(jnp.float32))
    got = getattr(tqc, fn)(torch.from_numpy(x).to(torch.bfloat16), pt)
    assert got.dtype == torch.bfloat16
    got = got.to(torch.float32).numpy()
    assert np.all(np.abs(got - want) <= np.abs(want) * 2.0**-7 + 1e-30)
    assert (got == want).mean() > 0.99


def test_group_means_are_group_means():
    """Against a direct numpy mean over the members of each variable / check."""
    _, _, qt, pt = both_plans("toy_4x8", 4)
    x = _feats(pt, 2, 3, seed=9)
    got_v = tqc.var_group_mean(torch.from_numpy(x), pt).numpy()
    got_c = tqc.check_group_mean(torch.from_numpy(x), pt).numpy()
    Z = qt.Z
    for k in range(pt.K):
        for z in range(Z):
            same_var = [j for j in range(pt.K) if qt.edge_col[j] == qt.edge_col[k]]
            np.testing.assert_allclose(got_v[k, z], x[same_var, z].mean(axis=0), atol=1e-6)
            zc = (z - qt.edge_shift[k]) % Z
            same_chk = [(j, (zc + qt.edge_shift[j]) % Z) for j in range(pt.K)
                        if qt.edge_row[j] == qt.edge_row[k]]
            want = np.mean([x[j, zz] for j, zz in same_chk], axis=0)
            np.testing.assert_allclose(got_c[k, z], want, atol=1e-6)


@pytest.mark.parametrize("name,Z", CODES)
def test_flat_to_qc_var(name, Z):
    qj, _, qt, _ = both_plans(name, Z)
    flat = np.random.default_rng(Z).standard_normal(qt.num_edges).astype(np.float32)
    want = np.asarray(jqc.flat_to_qc_var(jnp.asarray(flat), qj))
    np.testing.assert_array_equal(tqc.flat_to_qc_var(flat, qt), want)
    got = tqc.flat_to_qc_var(torch.from_numpy(flat), qt)
    assert isinstance(got, torch.Tensor) and got.shape == (qt.num_base_edges, Z)
    np.testing.assert_array_equal(got.numpy(), want)
