"""B8 and B9, the fully-neural kernels with the type embeddings in the
features (replace ldpc_tpu/ops/pallas_gnn.py:644 ``_kernel_v3`` and :952
``_kernel_v4``): ``_extract_v3`` within 1e-6 of the JAX function; the delta
table and v4's last-layer folds against the same tables built here from
``pallas_gnn._extract_v3`` by the lines of pallas_gnn.py:845-856 and
:1171-1196; each kernel's plain PyTorch version within 1e-5 of the JAX
kernel in interpret mode at toy_4x8 (v4 also at T = 1 and 2, its peeled
paths), and within 3e-2 of ``model.apply`` with confident decisions equal,
at nr_2_0_4 Z=4 and on the committed ``message_gnn_nr_2_0_4`` checkpoint."""
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu.models.message_gnn as jmg
from ldpc_tpu.ops import pallas_gnn as jpg
from ldpc_tpu_torch import convert
from ldpc_tpu_torch.models import create_message_gnn_decoder
from ldpc_tpu_torch.ops import fused_gnn as tfg
from test_torch_gnn_parity import both_plans, model_pair
from test_torch_msg_gnn_fused import assert_close_and_confident
from test_torch_parity import bpsk_llrs

RESULTS = Path(__file__).resolve().parent.parent / "results"
BUILDERS = {"msg_gnn_v3": (jpg.make_fused_gnn_decoder_v3, tfg.make_fused_gnn_decoder_v3),
            "msg_gnn_v4": (jpg.make_fused_gnn_decoder_v4, tfg.make_fused_gnn_decoder_v4)}


def _params(T: int, inject: bool, share: bool, h: int = 8):
    """(JAX layout, flax params, port layout, port module) at nr_2_0_4 Z=4."""
    qj, pj, qt, pt = both_plans("nr_2_0_4", 4)
    llr = bpsk_llrs(qt.num_vars, 2, 1.0, seed=0)
    _, params, mt = model_pair("create_message_gnn_decoder", pj, pt, llr, num_iterations=T,
                               hidden_dim=h, input_injection=inject, share_layers=share)
    return qj, params, qt, mt


@pytest.mark.parametrize("inject,share", [(True, False), (False, True)])
def test_extract_v3_matches_jax(inject, share):
    qj, params, qt, mt = _params(2, inject, share)
    want = jpg._extract_v3(params, qj, 2, 8, share, inject)
    got = tfg._extract_v3(mt, qt, 2, 8, share, inject)
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(value), rtol=0, atol=1e-6,
                                   err_msg=key)
    assert got["te"].shape == (2, qt.num_base_edges, 8)


@pytest.mark.parametrize("T", [1, 3])
def test_delta_table_and_last_layer_folds_match_jax(T):
    """dte, w2last, proj8 and dsc as the JAX builders pack them, from the
    JAX package's own _extract_v3."""
    qj, params, qt, mt = _params(T, True, False)
    h, K = 8, qt.num_base_edges
    w = jpg._extract_v3(params, qj, T, h, False, True)
    te = w["te"]
    dte = np.zeros(((T + 1) * h, K), np.float32)  # pallas_gnn.py:845-851
    dte[0:h, :K] = te[0].T
    for t in range(1, T + 1):
        nxt = te[t] if t < T else np.zeros_like(te[0])
        prev = np.zeros_like(te[0]) if t == 1 else te[t - 1]
        dte[t * h:(t + 1) * h, :K] = (nxt - prev).T
    pw = w["proj_w"]  # pallas_gnn.py:1170-1196
    w2last = np.zeros((2 * h,), np.float32)
    w2last[0:h] = pw @ w["W2v"][T - 1]
    w2last[h:2 * h] = pw @ w["W2c"][T - 1]
    w2last = np.asarray(jnp.asarray(w2last, jnp.bfloat16).astype(jnp.float32))
    proj8 = np.asarray(jnp.asarray(pw, jnp.bfloat16).astype(jnp.float32))
    dsc = np.zeros((K,), np.float32)
    dsc[:K] = w["proj_b"] + pw @ w["b2"][T - 1] - (te[T - 1] @ pw if T > 1 else 0.0)

    x = tfg._extract_v3(mt, qt, T, h, False, True)
    got_dte = tfg._te_deltas(x["te"])
    np.testing.assert_allclose(got_dte.transpose(0, 2, 1).reshape((T + 1) * h, K), dte,
                               rtol=0, atol=1e-6)
    got_w2last, got_proj8, got_dsc = tfg._last_layer_folds(x)
    np.testing.assert_array_equal(got_proj8, proj8)
    np.testing.assert_allclose(got_w2last, w2last, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_dsc, dsc, rtol=0, atol=1e-6)
    tables = tfg._MsgTables("msg_gnn_v4", qt, mt, T, h, False, True, torch.device("cpu"))
    np.testing.assert_array_equal(tables.extra.numpy(), np.concatenate([got_w2last, got_dsc]))
    np.testing.assert_array_equal(tables.emb[2 * h:3 * h].numpy(), got_proj8)


@functools.lru_cache(maxsize=None)
def _toy_case(T: int):
    """(JAX plan, params, port module, llr, module soft bits) at toy_4x8 Z=4,
    h=16, T iterations, input injection."""
    qj, pj, qt, pt = both_plans("toy_4x8", 4)
    llr = bpsk_llrs(qt.num_vars, 5, 2.0, seed=1)
    kw = dict(num_iterations=T, hidden_dim=16, input_injection=True)
    mj, params, mt = model_pair("create_message_gnn_decoder", pj, pt, llr, **kw)
    soft_module = np.asarray(mj.apply(params, jnp.asarray(llr), pj)[0])
    return qj, params, qt, mt, llr, soft_module


@pytest.mark.parametrize("kind,T", [("msg_gnn_v3", 3), ("msg_gnn_v4", 3), ("msg_gnn_v4", 1),
                                    ("msg_gnn_v4", 2)])
def test_plain_matches_jax_kernel(kind, T):
    """toy_4x8 Z=4 h=16 with input injection, in Pallas interpret mode; v4
    at T = 1 (no residual in its thin last layer) and T = 2 (no middle
    layer) too."""
    qj, params, qt, mt, llr, soft_module = _toy_case(T)
    kw = dict(num_iterations=T, hidden_dim=16, input_injection=True)
    jbuild, tbuild = BUILDERS[kind]
    want = np.asarray(jbuild(qj, params, interpret=True, **kw)(jnp.asarray(llr)))
    launches = dict(tfg.LAUNCHES)
    got = tbuild(qt, mt, device="cpu", **kw)(torch.from_numpy(llr))
    assert tfg.LAUNCHES == launches  # a CPU tensor never reaches a kernel
    assert got.shape == llr.shape and got.dtype == torch.float32
    # The same function up to the summation order inside the products.
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert_close_and_confident(got.numpy(), soft_module)


@functools.lru_cache(maxsize=None)
def _module_case(code: str, Z: int, inject: bool, share: bool):
    _, pj, qt, pt = both_plans(code, Z)
    llr = bpsk_llrs(qt.num_vars, 4, 2.0, seed=2)
    kw = dict(num_iterations=3, hidden_dim=16, input_injection=inject, share_layers=share)
    mj, params, mt = model_pair("create_message_gnn_decoder", pj, pt, llr, seed=4, **kw)
    return qt, mt, llr, np.asarray(mj.apply(params, jnp.asarray(llr), pj)[0]), kw


@pytest.mark.parametrize("kind", list(BUILDERS))
@pytest.mark.parametrize("code,Z,inject,share", [("nr_2_0_4", 4, True, False),
                                                 ("nr_2_0_4", 4, False, False),
                                                 ("toy_4x8", 8, True, True)])
def test_plain_matches_module(kind, code, Z, inject, share):
    """Against ``model.apply`` at the JAX package's configurations for this
    bar (h=16, T=3, shared layers at toy_4x8 Z=8: tests/test_pallas_gnn.py;
    at nr_2_0_4 with shared layers the JAX kernels themselves miss it, see
    ROADMAP.md C); a state_dict builds the same decoder as the module;
    mm_group changes no number."""
    qt, mt, llr, soft_module, kw = _module_case(code, Z, inject, share)
    build = BUILDERS[kind][1]
    got = build(qt, mt, device="cpu", **kw)(torch.from_numpy(llr)).numpy()
    assert_close_and_confident(got, soft_module)
    other = dict(mm_group=3) if kind == "msg_gnn_v4" else {}
    sd = build(qt, mt.state_dict(), device="cpu", **other, **kw)
    np.testing.assert_array_equal(sd(torch.from_numpy(llr)).numpy(), got)


@functools.lru_cache(maxsize=None)
def _checkpoint_case():
    from flax import serialization

    _, pj, qt, pt = both_plans("nr_2_0_4", 4)
    llr = bpsk_llrs(qt.num_vars, 4, 1.0, seed=5)
    kw = dict(num_iterations=5, hidden_dim=64, input_injection=True)
    mj = jmg.create_message_gnn_decoder(pj, **kw)
    template = mj.init(jax.random.PRNGKey(0), jnp.asarray(llr[:2]), pj)
    payload = serialization.msgpack_restore(
        (RESULTS / "message_gnn_nr_2_0_4.msgpack").read_bytes())
    params = serialization.from_state_dict(template, payload["params"])
    soft_module = np.asarray(mj.apply(params, jnp.asarray(llr), pj)[0])
    mt = create_message_gnn_decoder(pt, **kw)
    convert.load_message_gnn(RESULTS / "message_gnn_nr_2_0_4.msgpack", mt)
    return qt, mt, llr, soft_module, kw


# On the checkpoint's inputs below the JAX package's own v3 kernel (interpret
# mode) lies beyond the 3e-2 bar from the module as well (bf16 flips at
# h=64; its compile there takes about a minute, so it is not run here): v3
# is held within 3.8e-2, v4 to the bar.
CHECKPOINT_ATOL = {"msg_gnn_v3": 3.8e-2, "msg_gnn_v4": 3e-2}


@pytest.mark.parametrize("kind", list(BUILDERS))
def test_trained_checkpoint_matches_jax(kind):
    """results/message_gnn_nr_2_0_4.msgpack (h=64, T=5, input injection),
    read by the port's reader, through the plain version against the flax
    module with the flax reader's parameters: soft bits within
    CHECKPOINT_ATOL, decisions equal where the module is confident."""
    qt, mt, llr, soft_module, kw = _checkpoint_case()
    got = BUILDERS[kind][1](qt, mt, device="cpu", **kw)(torch.from_numpy(llr)).numpy()
    assert_close_and_confident(got, soft_module, atol=CHECKPOINT_ATOL[kind])


def test_v3_v4_match_v1():
    """B8 and B9 move bf16 roundings of B6: within 2e-2 of it."""
    _, pj, qt, pt = both_plans("nr_2_0_4", 4)
    llr = torch.from_numpy(bpsk_llrs(qt.num_vars, 4, 1.0, seed=3))
    kw = dict(num_iterations=3, hidden_dim=16, input_injection=True)
    _, _, mt = model_pair("create_message_gnn_decoder", pj, pt, llr.numpy(), seed=6, **kw)
    v1 = tfg.make_fused_gnn_decoder(qt, mt, device="cpu", **kw)(llr)
    for build in (tfg.make_fused_gnn_decoder_v3, tfg.make_fused_gnn_decoder_v4):
        diff = (v1 - build(qt, mt, device="cpu", **kw)(llr)).abs().max().item()
        assert 0 < diff <= 2e-2


def test_plans_and_raising_paths():
    """Shared memory and scratch follow the kernels' layout; a width without
    a kernel instantiation raises, and so does the card without a card."""
    _, _, qt, pt = both_plans("nr_2_0_32", 32)
    K, C, R, Z = qt.num_base_edges, qt.num_base_cols, qt.num_base_rows, qt.Z
    # graph, inverse degrees, LLRs, embedding and projection, the layer's
    # biases b1v, b1c, b2 (3h), all 4-byte words
    base = 4 * ((6 * K + R + C + 2 + 3) // 4 * 4 + (C + R + 3) // 4 * 4 + C * Z + 196 + 3 * 64)
    # both on the tensor cores (csrc/fused_msg_gnn_tc.cu make_layout), one
    # warp.  v3: packed bf16 weights W1v, W1c, W1ca, W2 with injection, the
    # staged deltas and two stage buffers (f and vmean rows); v4: B7's packed
    # W1v, W1c, W2 and two tile buffers (f, vmean and rmean rows)
    assert tfg.msg_gnn_smem_bytes(qt, 64, "msg_gnn_v3", True) == 117_776
    assert tfg.msg_gnn_smem_bytes(qt, 64, "msg_gnn_v4") == base + 2 * 64 * 3 * 136 \
        + 2 * 2 * 3 * 16 * 72
    assert tfg.msg_gnn_smem_bytes(qt, 64, "msg_gnn_v4") == 79_760
    feats = K * Z * 32
    # v3: the features and the variable means, bf16
    assert tfg.msg_gnn_scratch_floats(qt, 64, "msg_gnn_v3") == C * Z * 32 + feats
    # v4: the features, vmean and rmean, bf16, then a float32 output scalar
    # a message
    assert tfg.msg_gnn_scratch_floats(qt, 64, "msg_gnn_v4") == (C + R) * Z * 32 + feats \
        + K * Z
    model = create_message_gnn_decoder(pt, num_iterations=2, hidden_dim=32)
    for build in (tfg.make_fused_gnn_decoder_v3, tfg.make_fused_gnn_decoder_v4):
        with pytest.raises(ValueError, match="hidden_dim in"):
            build(qt, model, 2, 32, device="cpu")
    model = create_message_gnn_decoder(pt, num_iterations=2, hidden_dim=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfg.make_fused_gnn_decoder_v4(qt, model, 2, 16)
    with pytest.raises(ValueError, match="num_iterations"):
        tfg.make_fused_gnn_decoder_v3(qt, model, 0, 16, device="cpu")
