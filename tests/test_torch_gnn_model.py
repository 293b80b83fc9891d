"""``MessageGNNDecoder`` of the port against ``model.apply`` of the flax
module, every factory, on the same numpy LLRs and carried-over parameters.
``compute_dtype=float32``: soft bits and loss within 1e-4; bfloat16: within
3e-2 (the JAX package's own bar between its bf16 paths)."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from test_torch_gnn_parity import FACTORIES, both_plans, model_pair
from test_torch_parity import bpsk_llrs

import ldpc_tpu.models.message_gnn as jmg
import ldpc_tpu_torch.models.message_gnn as tmg
from ldpc_tpu_torch import convert
from ldpc_tpu_torch.models.classical import decode_min_sum

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
OPTIONS = [
    {},
    {"input_injection": True, "multiloss": True},
    {"share_layers": True, "input_injection": True},
]
RESULTS = Path(__file__).resolve().parent.parent / "results"


def _apply_both(mj, params, mt, pj, pt, llr, truth=None):
    args = () if truth is None else (jnp.asarray(truth),)
    soft_j, loss_j = mj.apply(params, jnp.asarray(llr), pj, *args)
    with torch.no_grad():
        targs = () if truth is None else (torch.from_numpy(truth),)
        soft_t, loss_t = mt(torch.from_numpy(llr), pt, *targs)
    return np.asarray(soft_j), loss_j, soft_t.numpy(), loss_t


@pytest.mark.parametrize("options", OPTIONS, ids=["plain", "inject_multiloss", "shared"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factory", FACTORIES)
def test_forward_matches_flax(factory, dtype, options):
    _, pj, qt, pt = both_plans("toy_4x8", 4)
    llr = bpsk_llrs(qt.num_vars, 5, 1.0, seed=0)
    truth = (np.random.default_rng(1).random(llr.shape) < 0.1).astype(np.float32)
    mj, params, mt = model_pair(factory, pj, pt, llr, num_iterations=3, hidden_dim=16,
                                compute_dtype=dtype, **options)
    soft_j, loss_j, soft_t, loss_t = _apply_both(mj, params, mt, pj, pt, llr, truth)
    assert soft_t.shape == llr.shape and loss_t.shape == (5,)
    np.testing.assert_allclose(soft_t, soft_j, rtol=0, atol=TOL[dtype])
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=0, atol=TOL[dtype])
    # without ground truth there is no loss, and decode() thresholds the soft bits
    soft_only, none = mt(torch.from_numpy(llr), pt)
    assert none is None
    np.testing.assert_array_equal(mt.decode(torch.from_numpy(llr), pt).numpy(),
                                  (soft_only.detach().numpy() > 0.5).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nr_code_matches_flax(dtype):
    """A 5G base graph (42 x 52, rows and columns of uneven degree)."""
    _, pj, qt, pt = both_plans("nr_2_0_4", 4)
    llr = bpsk_llrs(qt.num_vars, 3, 2.0, seed=2)
    mj, params, mt = model_pair("create_corrected_minsum_gnn_decoder", pj, pt, llr,
                                num_iterations=2, hidden_dim=16, compute_dtype=dtype,
                                input_injection=True)
    soft_j, _, soft_t, _ = _apply_both(mj, params, mt, pj, pt, llr)
    np.testing.assert_allclose(soft_t, soft_j, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trained_checkpoint_matches_flax(dtype):
    """results/corrected_gnn_nr_2_0_4.msgpack (T=5, h=64), read by the port's
    own reader on one side and by flax on the other."""
    _, pj, qt, pt = both_plans("nr_2_0_4", 4)
    llr = bpsk_llrs(qt.num_vars, 6, 1.0, seed=5)
    dt_j, dt_t = {"float32": (jnp.float32, torch.float32),
                  "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    kw = dict(num_iterations=5, hidden_dim=64, input_injection=True)
    mj = jmg.create_corrected_minsum_gnn_decoder(pj, compute_dtype=dt_j, **kw)
    path = RESULTS / "corrected_gnn_nr_2_0_4.msgpack"
    params = serialization.msgpack_restore(path.read_bytes())["params"]
    mt = tmg.create_corrected_minsum_gnn_decoder(pt, compute_dtype=dt_t, **kw)
    convert.load_message_gnn(path, mt)
    truth = np.zeros_like(llr)
    soft_j, loss_j, soft_t, loss_t = _apply_both(mj, params, mt, pj, pt, llr, truth)
    np.testing.assert_allclose(soft_t, soft_j, rtol=0, atol=TOL[dtype])
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=0, atol=TOL[dtype])
    assert 0.0 < float(np.abs(soft_t - 0.5).min())  # a trained model is not stuck at 0.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_untrained_corrected_is_scaled_min_sum(dtype):
    """Zero projections: soft bits of scaled min-sum (alpha 0.8, same T) within
    1e-5, and the decisions of the port's decode_min_sum."""
    _, _, qt, pt = both_plans("nr_2_0_4", 4)
    T = 4
    llr = torch.from_numpy(bpsk_llrs(qt.num_vars, 8, 2.0, seed=7))
    model = tmg.create_corrected_minsum_gnn_decoder(
        pt, num_iterations=T, hidden_dim=16, input_injection=True, compute_dtype=dtype,
        generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        soft, _ = model(llr, pt)
    from ldpc_tpu_torch.ops import qc_msg as tqc
    llr_cz = tqc.llr_to_cz(llr, pt)
    v2c = edge = llr_cz[pt.edge_col]
    for _ in range(T):
        c2v = tqc.check_update_minsum(v2c, pt, alpha=0.8)
        v2c = tqc.col_sum(c2v, pt)[pt.edge_col] - c2v + edge
    expect = torch.sigmoid(-tqc.cz_to_llr(llr_cz + tqc.col_sum(c2v, pt)))
    np.testing.assert_allclose(soft.numpy(), expect.numpy(), rtol=0, atol=1e-5)
    # decode_min_sum freezes a frame's first valid decisions; the module never
    # freezes, so the two are held on frames that are still valid after T.
    ref = decode_min_sum(llr, pt, T, 0.8)
    hard = model.decode(llr, pt)
    still_valid = tqc.syndrome_ok(tqc.llr_to_cz(hard, pt), pt)
    assert int(still_valid.sum()) >= 4
    np.testing.assert_array_equal(hard[still_valid].numpy(), ref.bits[still_valid].numpy())


def test_untrained_neural_is_channel_passthrough():
    """Zero output projection: sigmoid(-llr) within 1e-6."""
    _, _, qt, pt = both_plans("toy_4x8", 4)
    llr = torch.from_numpy(bpsk_llrs(qt.num_vars, 3, 3.0, seed=5))
    model = tmg.create_message_gnn_decoder(pt, num_iterations=2, hidden_dim=8,
                                           generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        soft, _ = model(llr, pt)
    np.testing.assert_allclose(soft.numpy(), torch.sigmoid(-llr).numpy(), rtol=0, atol=1e-6)


def test_initialisation_is_seeded_and_keeps_the_identities():
    _, _, _, pt = both_plans("toy_4x8", 4)
    make = lambda seed: tmg.create_corrected_minsum_gnn_decoder(  # noqa: E731
        pt, num_iterations=2, hidden_dim=8, generator=torch.Generator().manual_seed(seed))
    a, b, c = make(1).state_dict(), make(1).state_dict(), make(2).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["check_0_gnn.message_type_embeddings"],
                           c["check_0_gnn.message_type_embeddings"])
    assert float(a["alpha"]) == pytest.approx(0.8) and float(a["w_ch"]) == 1.0
    assert not a["check_0_proj.weight"].any() and not a["var_1_proj.bias"].any()
    assert 0.05 < float(a["check_0_gnn.message_type_embeddings"].std()) < 0.2
    with pytest.raises(ValueError, match="modes must be among"):
        tmg.MessageGNNDecoder(var_mode="bogus")
    with pytest.raises(ValueError, match="compute_dtype"):
        tmg.MessageGNNDecoder(compute_dtype=torch.float16)
