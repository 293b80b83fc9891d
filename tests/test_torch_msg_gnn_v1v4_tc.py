"""B6 and B9 on the tensor cores (csrc/fused_msg_gnn_tc.cu ``msg_gnn_tc_kernel``
and ``msg_gnn_v4_tc_kernel``, replacing ldpc_tpu/ops/pallas_gnn.py:137
``_kernel`` and :952 ``_kernel_v4``) on the CPU: the torch model of B7's
message-major tiles (``tile_model`` of tests/test_torch_msg_gnn_tc.py,
which takes the variant from the decoder) against the plain versions, the
packed weights and the plans.

What the tile model takes from the kernel for these two: B6 runs its second
layer in two halves through one accumulator, bf16(W2v h1v + b2v) first, then
bf16(W2c h1c + b2c), added in bf16; B9 adds the delta of the type embeddings
before the residual, bf16(bf16(out + d) + f), and its last layer is one thin
accumulation w2last . h1 (+ proj8 . f after layer 0), summed per variable
with dsc in member order.  On the exact inputs of ``ops/msg_gnn_exact.py``
(``EXACT_CASES``; for B9 also ``EXACT_TE_CASES``, nonzero type embeddings,
and T = 1, the last layer alone) the soft bits must equal the plain
version's (``torch.equal``): every sum the kernel reorders is checked exact
in any order, value by value, so only an index, shift, delta or
rounding-point fault can make them differ.  ``_MsgPlain`` and
``_FoldPlain`` are held against the JAX kernels in
tests/test_torch_msg_gnn_fused.py and tests/test_torch_msg_gnn_v34.py.
"""
import numpy as np
import pytest
import torch

from test_torch_msg_gnn_tc import TILE, _r, tile_model, unpack_tc_weights

from ldpc_tpu_torch.codes import get_base_graph, qc_layout
from ldpc_tpu_torch.ops import fused_gnn as fg
from ldpc_tpu_torch.ops.msg_gnn_exact import (EXACT_CASES, EXACT_TE_CASES,
                                              EXACT_TYPE_EMBEDDINGS, exact_msg_gnn_case)

BUILD = {"msg_gnn": fg.make_fused_gnn_decoder, "msg_gnn_v4": fg.make_fused_gnn_decoder_v4}

CASES = ([("msg_gnn", *case, 2, (0.0,)) for case in EXACT_CASES]
         + [("msg_gnn_v4", *case, 2, (0.0,)) for case in EXACT_CASES]
         + [("msg_gnn_v4", *case, EXACT_TYPE_EMBEDDINGS) for case in EXACT_TE_CASES]
         + [("msg_gnn_v4", *case, 1, (0.0,)) for case in EXACT_CASES if case[1] == 4])


@pytest.mark.parametrize("kind,code,Z,h,batch,inject,share,T,te", CASES)
def test_tile_model_equals_plain_on_exact_inputs(kind, code, Z, h, batch, inject, share, T, te):
    """B6's split second layer and B9's deltas and thin last layer, on the
    flat-index tiles with the packed weights, give the plain version's soft
    bits exactly; the decode is not trivial (both decisions present, soft
    bits not all saturated), and with nonzero type embeddings the deltas
    move the result."""
    torch.set_num_threads(1)
    qc = qc_layout(get_base_graph(code), Z)
    model, llr = exact_msg_gnn_case(qc, h, batch, inject, share, num_iterations=T,
                                    type_embeddings=te)
    dec = BUILD[kind](qc, model, T, h, share_layers=share, input_injection=inject, device="cpu")
    x = torch.from_numpy(llr)
    plain = dec(x)
    assert torch.equal(tile_model(dec, x), plain)
    decided = plain > 0.5
    assert decided.any() and (~decided).any()
    assert ((plain - 0.5).abs() < 0.45).float().mean() > 0.05
    if te != (0.0,):
        assert dec.tables.tab.abs().amax(dim=(1, 2)).min() > 0
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("message_type_embeddings"):
                    p.zero_()
        flat = BUILD[kind](qc, model, T, h, share_layers=share, input_injection=inject,
                           device="cpu")
        assert not torch.equal(flat(x), plain)


@pytest.mark.parametrize("kind", ["msg_gnn", "msg_gnn_v4"])
@pytest.mark.parametrize("h,inject", [(16, False), (16, True), (64, False), (64, True)])
def test_pack_weights_round_trip(kind, h, inject):
    """B6 and B9 stage B7's layout: [W1vf W1va (W1vl)], [W1cf W1ca (W1cl)]
    and [W2v W2c] of each layer, zero-padded rows of 2h (3h) + 8 and 2h + 8."""
    T = 3
    w = _r(torch.from_numpy(np.random.default_rng(h).standard_normal((T, 8, h, h), np.float32)))
    packed = fg.pack_tc_weights(w, inject, kind)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert torch.equal(packed, fg.pack_tc_weights(w, inject, "msg_gnn_v2"))
    w1v, w1c, w2 = unpack_tc_weights(packed, h, inject)
    # _MsgTables order: va, ca, vl, cl, vf, cf, W2v, W2c
    assert torch.equal(w1v, torch.cat([w[:, 4], w[:, 0]] + ([w[:, 2]] if inject else []), dim=2))
    assert torch.equal(w1c, torch.cat([w[:, 5], w[:, 1]] + ([w[:, 3]] if inject else []), dim=2))
    assert torch.equal(w2, torch.cat([w[:, 6], w[:, 7]], dim=2))


# Dynamic shared memory of one block of one warp, bytes, by (h, injection),
# from make_layout in csrc/fused_msg_gnn_tc.cu: structure, inverse degrees,
# LLRs, embedding, the staged biases (B6 b2v, b2c: 2h floats; B9 b1v, b1c,
# b2: 3h), one layer's packed weights and one warp's two tile buffers.
SMEM_ONE_WARP = {
    "msg_gnn": {
        "toy_4x8": {(16, False): 9_472, (16, True): 10_496, (64, False): 68_032,
                    (64, True): 84_416},
        "nr_2_0_4": {(16, False): 15_120, (16, True): 16_144, (64, False): 73_680,
                     (64, True): 90_064},
        "nr_2_0_32": {(16, False): 20_944, (16, True): 21_968, (64, False): 79_504,
                      (64, True): 95_888},
    },
    "msg_gnn_v4": {
        "toy_4x8": {(16, False): 9_536, (16, True): 10_560, (64, False): 68_288,
                    (64, True): 84_672},
        "nr_2_0_4": {(16, False): 15_184, (16, True): 16_208, (64, False): 73_936,
                     (64, True): 90_320},
        "nr_2_0_32": {(16, False): 21_008, (16, True): 22_032, (64, False): 79_760,
                      (64, True): 96_144},
    },
}


@pytest.mark.parametrize("kind", ["msg_gnn", "msg_gnn_v4"])
@pytest.mark.parametrize("code,Z", [("toy_4x8", 4), ("nr_2_0_4", 4), ("nr_2_0_32", 32)])
def test_plans(kind, code, Z):
    """Shared memory and scratch of B6 and B9 follow make_layout and
    scratch_elems in csrc/fused_msg_gnn_tc.cu."""
    qc = qc_layout(get_base_graph(code), Z)
    K, C, R = qc.num_base_edges, qc.num_base_cols, qc.num_base_rows
    for h in (16, 64):
        for inject in (False, True):
            one = SMEM_ONE_WARP[kind][code][(h, inject)]
            assert fg.msg_gnn_smem_bytes(qc, h, kind, inject, 1) == one
            # B7's block plus the further biases: B6 b2c (h floats), B9 b1v, b1c (2h)
            assert one - fg.msg_gnn_smem_bytes(qc, h, "msg_gnn_v2", inject, 1) == \
                4 * h * (1 if kind == "msg_gnn" else 2)
            # each further warp: two buffers of 16 f, vmean and rmean rows
            assert fg.msg_gnn_smem_bytes(qc, h, kind, inject, 12) == \
                one + 11 * 2 * 3 * TILE * (h + 8) * 2
        # features, vmean, rmean: one bf16 h-row each; B9 then a float32
        # output scalar a message, rounded up to 16 bytes
        extra = (K * Z + 3) // 4 * 4 if kind == "msg_gnn_v4" else 0
        assert fg.msg_gnn_scratch_floats(qc, h, kind) == (K + C + R) * Z * h // 2 + extra
    if code == "nr_2_0_32":
        # the main path: twelve warps fit a block's 232,448 B without injection
        # (B7 231,312 B); 1,191,936 B (B9 1,217,152 B) of scratch a block
        assert fg.msg_gnn_smem_bytes(qc, 64, kind, False, 12) == \
            {"msg_gnn": 231_568, "msg_gnn_v4": 231_824}[kind]
        assert fg.msg_gnn_scratch_floats(qc, 64, kind) * 4 == \
            {"msg_gnn": 1_191_936, "msg_gnn_v4": 1_217_152}[kind]
    if code == "nr_2_0_4" and kind == "msg_gnn":
        # the serving path (injection): eleven warps fit, twelve do not
        assert fg.msg_gnn_smem_bytes(qc, 64, kind, True, 11) == 228_304
        assert fg.msg_gnn_smem_bytes(qc, 64, kind, True, 12) > 232_448
