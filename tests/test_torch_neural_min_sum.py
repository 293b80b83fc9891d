"""The port's NeuralMinSumDecoder against ldpc_tpu's flax module on the same
numpy LLRs and parameters: soft bits within 1e-5, hard bits identical, for
the flag cases of tests/test_pallas_neural.py plus ``mean_edges`` and both
loss modes; unit weights equal to the port's ``decode_min_sum`` at alpha 1;
the four committed neural min-sum checkpoints read by ``load_neural_min_sum``
and decoded against the flax module."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu.codes as jcodes
from ldpc_tpu.models.neural_min_sum import NeuralMinSumDecoder as JNMS
from ldpc_tpu.ops import qc_msg as jqc

import ldpc_tpu_torch.codes as tcodes
from ldpc_tpu_torch import convert
from ldpc_tpu_torch.models import (NeuralMinSumDecoder, decode_min_sum, make_standard_decoder,
                                   make_tied_decoder)
from ldpc_tpu_torch.ops import qc_msg as tqc
from test_torch_gnn_parity import perturbed
from test_torch_parity import bpsk_llrs

RESULTS = Path(__file__).resolve().parent.parent / "results"
SOFT_ATOL = 1e-5

# (weight_sharing, depth_L, learnable_alpha, learnable_offset, per_iteration):
# the cases of tests/test_pallas_neural.py
FLAG_CASES = [("scalar", 0, False, False, False), ("cell", 2, True, False, False),
              ("edge", 2, True, True, False), ("type", 1, True, False, True)]


def plans(name: str, Z: int):
    qj = jcodes.qc_layout(jcodes.get_base_graph(name), Z)
    qt = tcodes.qc_layout(tcodes.get_base_graph(name), Z)
    return qj, jqc.make_plan(qj), qt, tqc.make_plan(qt, "cpu")


def nms_pair(pj, pt, llr: np.ndarray, seed: int = 1, scale: float = 0.1, **kw):
    """(flax module, its params moved by seeded noise, the port's module
    with the same parameters)."""
    mj = JNMS(**kw)
    params = mj.init(jax.random.PRNGKey(seed), jnp.asarray(llr[:2]), pj)
    if scale:
        params = perturbed(params, seed, scale)
    mt = NeuralMinSumDecoder(pt, **kw)
    mt.load_state_dict(convert.neural_min_sum_state_dict_from_numpy(params), strict=True)
    return mj, params, mt


def assert_module_parity(mj, params, mt, pj, pt, llr: np.ndarray, gt=None) -> None:
    soft_j, loss_j = mj.apply(params, jnp.asarray(llr), pj,
                              None if gt is None else jnp.asarray(gt))
    with torch.no_grad():
        soft_t, loss_t = mt(torch.from_numpy(llr), pt,
                            None if gt is None else torch.from_numpy(gt))
    np.testing.assert_allclose(soft_t.numpy(), np.asarray(soft_j), rtol=0, atol=SOFT_ATOL)
    np.testing.assert_array_equal(mt.decode(torch.from_numpy(llr), pt).numpy(),
                                  np.asarray(mj.decode(params, jnp.asarray(llr), pj)))
    if gt is not None:
        np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sharing,depth,learn_a,learn_o,per_it", FLAG_CASES)
def test_module_matches_flax(sharing, depth, learn_a, learn_o, per_it):
    _, pj, qt, pt = plans("toy_4x8", 4)
    llr = bpsk_llrs(qt.num_vars, 8, 2.0, seed=0)
    kw = dict(num_iterations=3, depth_L=depth, weight_sharing=sharing,
              learnable_alpha=learn_a, learnable_offset=learn_o, per_iteration=per_it)
    mj, params, mt = nms_pair(pj, pt, llr, **kw)
    assert_module_parity(mj, params, mt, pj, pt, llr)


@pytest.mark.parametrize("output_mode,loss_mode", [("mean_edges", "max"),
                                                   ("sum_plus_input", "mean"),
                                                   ("sum_plus_input", "max")])
def test_output_and_loss_modes_match_flax(output_mode, loss_mode):
    _, pj, qt, pt = plans("nr_2_0_4", 4)
    llr = bpsk_llrs(qt.num_vars, 6, 1.0, seed=2)
    gt = (np.random.default_rng(3).random(llr.shape) < 0.5).astype(np.float32)
    kw = dict(num_iterations=4, depth_L=2, weight_sharing="edge", learnable_alpha=True,
              learnable_offset=True, per_iteration=True, output_mode=output_mode,
              loss_mode=loss_mode)
    mj, params, mt = nms_pair(pj, pt, llr, seed=4, **kw)
    assert_module_parity(mj, params, mt, pj, pt, llr, gt)


def test_unit_init_is_min_sum():
    """w_ch = 1, no residual taps, alpha 1: the decoder is plain min-sum, so
    its soft bits are sigmoid(-beliefs) of decode_min_sum at alpha 1."""
    _, _, qt, pt = plans("toy_4x8", 4)
    llr = (np.random.default_rng(0).normal(size=(6, qt.num_vars)) * 2).astype(np.float32)
    model = NeuralMinSumDecoder(pt, num_iterations=4, depth_L=0, weight_sharing="scalar")
    x = torch.from_numpy(llr)
    with torch.no_grad():
        soft, loss = model(x, pt)
    assert loss is None
    classical = decode_min_sum(x, pt, 4, 1.0)
    np.testing.assert_allclose(soft.numpy(), torch.sigmoid(-classical.beliefs).numpy(),
                               rtol=1e-5, atol=1e-6)
    llr = bpsk_llrs(qt.num_vars, 16, 4.0, seed=1)
    model = NeuralMinSumDecoder(pt, num_iterations=8, depth_L=0, weight_sharing="scalar")
    np.testing.assert_array_equal(model.decode(torch.from_numpy(llr), pt).numpy(),
                                  decode_min_sum(torch.from_numpy(llr), pt, 8, 1.0).bits.numpy())


def test_parameter_shapes_and_factories():
    _, _, qt, pt = plans("toy_4x8", 4)
    K, Z, ty = pt.K, pt.Z, pt.num_edge_types
    for sharing, shape in (("edge", (K, Z)), ("cell", (K,)), ("type", (ty,)), ("scalar", ())):
        m = NeuralMinSumDecoder(pt, weight_sharing=sharing, depth_L=2)
        assert tuple(m.w_ch.shape) == shape and tuple(m.w_res.shape) == (2,)
        assert float(m.w_ch.detach().min()) == 1.0 and float(m.w_res.detach().abs().max()) == 0.0
    m = NeuralMinSumDecoder(pt, num_iterations=4, weight_sharing="cell", per_iteration=True,
                            learnable_alpha=True, learnable_offset=True)
    assert m.w_ch.shape == (4, K) and m.w_res.shape == (4, 2)
    assert m.alpha.shape == (4,) and float(m.alpha.detach()[0]) == pytest.approx(0.8)
    assert m.offset.shape == (4,)
    assert make_standard_decoder(pt, 3).weight_sharing == "edge"
    assert make_tied_decoder(pt, 3, sharing="type").w_ch.shape == (ty,)
    with pytest.raises(ValueError, match="weight_sharing"):
        NeuralMinSumDecoder(pt, weight_sharing="row")


# (checkpoint, code, Z, flax hyperparameters)
CHECKPOINTS = [
    ("standard_nr_2_0_4", "nr_2_0_4", 4, dict(num_iterations=5, weight_sharing="edge",
                                              learnable_alpha=True)),
    ("tied_nr_2_0_4", "nr_2_0_4", 4, dict(num_iterations=5, weight_sharing="cell",
                                          learnable_alpha=True)),
    ("oms_per_iter_nr_2_0_4", "nr_2_0_4", 4, dict(num_iterations=5, weight_sharing="cell",
                                                  learnable_alpha=True, learnable_offset=True,
                                                  per_iteration=True)),
    ("oms10_per_iter_nr_2_0_32", "nr_2_0_32", 32, dict(num_iterations=10,
                                                       weight_sharing="edge",
                                                       learnable_alpha=True,
                                                       learnable_offset=True,
                                                       per_iteration=True)),
]


@pytest.mark.parametrize("ckpt,code,Z,kw", CHECKPOINTS, ids=[c[0] for c in CHECKPOINTS])
def test_checkpoint_matches_flax(ckpt, code, Z, kw):
    """The committed checkpoints, read by the port's own reader, decode 4
    frames as the flax module does with the flax reader's parameters."""
    from flax import serialization

    _, pj, qt, pt = plans(code, Z)
    kw = dict(depth_L=2, loss_mode="mean", **kw)
    model = NeuralMinSumDecoder(pt, **kw)
    convert.load_neural_min_sum(RESULTS / f"{ckpt}.msgpack", model)
    mj = JNMS(**kw)
    llr = bpsk_llrs(qt.num_vars, 4, -1.0 if Z == 32 else 1.0, seed=5)
    template = mj.init(jax.random.PRNGKey(0), jnp.asarray(llr[:2]), pj)
    payload = serialization.msgpack_restore((RESULTS / f"{ckpt}.msgpack").read_bytes())
    params = serialization.from_state_dict(template, payload["params"])
    assert_module_parity(mj, params, model, pj, pt, llr)


def test_loader_refuses_unknown_entries():
    with pytest.raises(KeyError, match="unexpected"):
        convert.neural_min_sum_state_dict_from_numpy({"params": {"w_ch": np.ones(3),
                                                                 "bias": np.ones(3)}})
