"""Shared helpers for holding the port's message GNN against the JAX
package, and tests of the helpers themselves.

Both sides get the same numpy LLRs (``test_torch_parity.bpsk_llrs``) and the
same parameters: the flax module is initialised, every leaf is moved by
seeded numpy noise (zero-init projections would hide aggregation bugs, as in
tests/test_pallas_gnn.py), and ``ldpc_tpu_torch.convert`` carries the tree
into the port's module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu.codes as jcodes
import ldpc_tpu.models.message_gnn as jmg
from ldpc_tpu.ops import qc_msg as jqc

import ldpc_tpu_torch.codes as tcodes
import ldpc_tpu_torch.models.message_gnn as tmg
from ldpc_tpu_torch.convert import message_gnn_state_dict_from_numpy
from ldpc_tpu_torch.ops import qc_msg as tqc

FACTORIES = [
    "create_message_gnn_decoder",
    "create_custom_variable_message_gnn_decoder",
    "create_custom_check_message_gnn_decoder",
    "create_corrected_minsum_gnn_decoder",
    "create_custom_minsum_message_gnn_decoder",
]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def both_plans(name: str, Z: int):
    """(JAX layout, JAX plan, port layout, port plan on the CPU)."""
    qj = jcodes.qc_layout(jcodes.get_base_graph(name), Z)
    qt = tcodes.qc_layout(tcodes.get_base_graph(name), Z)
    return qj, jqc.make_plan(qj), qt, tqc.make_plan(qt, "cpu")


def perturbed(params, seed: int, scale: float = 0.05):
    """Every leaf of a flax tree plus seeded normal noise, as numpy."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    moved = [np.asarray(leaf) + scale * rng.standard_normal(leaf.shape).astype(np.float32)
             for leaf in leaves]
    return jax.tree_util.tree_unflatten(tree, moved)


def model_pair(factory: str, plan_j, plan_t, llr: np.ndarray, seed: int = 3, perturb=True, **kw):
    """(flax module, its params, port module with the same parameters).
    ``compute_dtype`` in ``kw`` is a key of ``DTYPES``."""
    dt_j, dt_t = DTYPES[kw.pop("compute_dtype", "bfloat16")]
    mj = getattr(jmg, factory)(plan_j, compute_dtype=dt_j, **kw)
    params = mj.init(jax.random.PRNGKey(seed), jnp.asarray(llr[:2]), plan_j)
    if perturb:
        params = perturbed(params, seed + 1)
    mt = getattr(tmg, factory)(plan_t, compute_dtype=dt_t, **kw)
    mt.load_state_dict(message_gnn_state_dict_from_numpy(params), strict=True)
    return mj, params, mt


def test_perturbed_is_seeded_and_moves_every_leaf():
    tree = {"a": np.zeros((3, 2), np.float32), "b": {"c": np.zeros((), np.float32)}}
    x, y = perturbed(tree, 5), perturbed(tree, 5)
    np.testing.assert_array_equal(x["a"], y["a"])
    assert np.all(x["a"] != 0) and float(x["b"]["c"]) != 0.0
    assert not np.array_equal(x["a"], perturbed(tree, 6)["a"])


@pytest.mark.parametrize("factory", FACTORIES)
def test_state_dict_names_cover_the_module(factory):
    """Strict loading: the converted flax tree names every parameter of the
    port's module and nothing else, with nn.Linear's (out, in) layout."""
    _, pj, _, pt = both_plans("toy_4x8", 4)
    llr = np.zeros((2, pt.C * pt.Z), np.float32)
    _, params, mt = model_pair(factory, pj, pt, llr, num_iterations=2, hidden_dim=8,
                               input_injection=True)
    sd = message_gnn_state_dict_from_numpy(params)
    assert set(sd) == set(mt.state_dict())
    assert sd["input_embedding.weight"].shape == (8, 1)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.testing.assert_array_equal(sd["input_embedding.weight"].numpy()[:, 0],
                                  flat["params/input_embedding/kernel"][0])


# ---------------------------------------------------------------------------
# The corrected-GNN serving kernels: plain version against the JAX builders
# ---------------------------------------------------------------------------

KERNEL_ATOL = 3e-2  # the JAX package's bar between its kernels and model.apply


def corrected_builders(kind: str):
    """(JAX builder, port builder) of one kernel: ``corrected_v2`` is B4
    (pallas_gnn._corrected_kernel_v2), ``corrected`` is B5 (_corrected_kernel)."""
    from ldpc_tpu.ops import pallas_gnn as jpg
    from ldpc_tpu_torch.ops import fused_gnn as tfg

    if kind == "corrected_v2":
        return jpg.make_fused_corrected_gnn_decoder_v2, tfg.make_fused_corrected_gnn_decoder_v2
    return jpg.make_fused_corrected_gnn_decoder, tfg.make_fused_corrected_gnn_decoder


def check_corrected_plain_against_jax(kind: str, name: str, Z: int, inject: bool, share: bool,
                                      T: int = 3, h: int = 16, batch: int = 5,
                                      snr_db: float = 1.0, interpret: bool = True) -> None:
    """The port's builder on CPU tensors (its kernel's plain version) against
    ``model.apply`` and, with ``interpret``, against the JAX builder of the
    same name in Pallas interpret mode, fixed T and early exit with
    ``return_iterations``.  Soft bits within KERNEL_ATOL; decisions equal
    wherever the module is confident; conv_iter equal."""
    from test_torch_parity import bpsk_llrs
    from ldpc_tpu_torch.ops import fused_gnn as tfg

    qj, pj, qt, pt = both_plans(name, Z)
    llr = bpsk_llrs(qt.num_vars, batch, snr_db, seed=1)
    kw = dict(num_iterations=T, hidden_dim=h, input_injection=inject, share_layers=share)
    mj, params, mt = model_pair("create_corrected_minsum_gnn_decoder", pj, pt, llr, seed=9, **kw)
    soft_module = np.asarray(mj.apply(params, jnp.asarray(llr), pj)[0])
    jbuild, tbuild = corrected_builders(kind)

    launches = dict(tfg.LAUNCHES)
    soft_t = tbuild(qt, mt, device="cpu", **kw)(torch.from_numpy(llr))
    assert soft_t.shape == llr.shape and soft_t.dtype == torch.float32
    soft_t = soft_t.numpy()
    np.testing.assert_allclose(soft_t, soft_module, rtol=0, atol=KERNEL_ATOL)
    confident = np.abs(soft_module - 0.5) > 0.05
    assert confident.mean() > 0.5  # the check below must actually bite
    assert ((soft_t > 0.5) == (soft_module > 0.5))[confident].all()
    # state_dict instead of the module: the same decoder
    soft_sd = tbuild(qt, mt.state_dict(), device="cpu", **kw)(torch.from_numpy(llr))
    np.testing.assert_array_equal(soft_sd.numpy(), soft_t)

    soft_e, conv_e = tbuild(qt, mt, device="cpu", early_exit=True, return_iterations=True,
                            **kw)(torch.from_numpy(llr))
    assert conv_e.shape == (batch,) and conv_e.dtype == torch.float32
    assert tfg.LAUNCHES == launches  # a CPU tensor never reaches a kernel
    if not interpret:
        return
    soft_j = np.asarray(jbuild(qj, params, interpret=True, **kw)(jnp.asarray(llr)))
    np.testing.assert_allclose(soft_t, soft_j, rtol=0, atol=KERNEL_ATOL)
    soft_je, conv_je = jbuild(qj, params, interpret=True, early_exit=True,
                              return_iterations=True, **kw)(jnp.asarray(llr))
    np.testing.assert_array_equal(conv_e.numpy(), np.asarray(conv_je))
    np.testing.assert_allclose(soft_e.numpy(), np.asarray(soft_je), rtol=0, atol=KERNEL_ATOL)
    assert len(set(conv_e.numpy().tolist())) > 1  # frames stop at different iterations


def check_zero_init_early_exit(kind: str, name: str = "toy_4x8", Z: int = 4, T: int = 8) -> None:
    """Untrained parameters with early exit: the plain version gives the JAX
    kernel's decisions and conv_iter, and those of the port's fused min-sum
    decoder (alpha 0.8), exactly."""
    from test_torch_parity import bpsk_llrs
    from ldpc_tpu_torch.ops import fused_minsum as tfm

    qj, pj, qt, pt = both_plans(name, Z)
    llr = bpsk_llrs(qt.num_vars, 8, 2.0, seed=7)
    kw = dict(num_iterations=T, hidden_dim=16, input_injection=True)
    _, params, mt = model_pair("create_corrected_minsum_gnn_decoder", pj, pt, llr, seed=8,
                               perturb=False, **kw)
    jbuild, tbuild = corrected_builders(kind)
    soft_t, conv_t = tbuild(qt, mt, device="cpu", early_exit=True, return_iterations=True,
                            **kw)(torch.from_numpy(llr))
    soft_j, conv_j = jbuild(qj, params, interpret=True, early_exit=True, return_iterations=True,
                            **kw)(jnp.asarray(llr))
    np.testing.assert_array_equal(soft_t.numpy() > 0.5, np.asarray(soft_j) > 0.5)
    np.testing.assert_array_equal(conv_t.numpy(), np.asarray(conv_j))
    bits_ms, conv_ms = tfm.make_fused_minsum(qt, T, 0.8, early_exit=True, device="cpu")(
        torch.from_numpy(llr))
    np.testing.assert_array_equal(soft_t.numpy() > 0.5, bits_ms.numpy() > 0.5)
    np.testing.assert_array_equal(conv_t.numpy(), conv_ms.numpy().astype(np.float32))
    assert len(set(conv_t.numpy().tolist())) > 1
