"""B8's tensor-core kernel (csrc/fused_msg_gnn_tc.cu ``msg_gnn_v3_tc_kernel``,
replaces ldpc_tpu/ops/pallas_gnn.py:644 ``_kernel_v3``) on the CPU: a torch
model of its check-major tiles against the plain version, its packed
weights and its plans.

The tile model repeats what the kernel computes from what the wrapper hands
it: the packed bf16 weights unpacked, the graph tensor decoded, the seed
with block 0 of the delta table, the variable means summed in member order,
then per 16-check tile of the flat check index: pre_row as the sum of every
member slot's W1ca product in one accumulator (times 1/degree, plus b1c),
and per member slot pv over [f | vmean | lf], pc as (W1cf f + pre_row) +
W1cl lf, the second layer over [h1v | h1c] plus b2, and the writeback with the
residual and the next block of the delta table; a slot past a row's degree
is a zero row and writes nothing.  On the exact inputs of
``ops/msg_gnn_exact.py`` (``EXACT_CASES``, and ``EXACT_TE_CASES`` with
nonzero type embeddings) it must give the plain version's soft bits
exactly (``torch.equal``): every sum the kernel reorders is checked exact
in any order, value by value (``_exact_acc``: all of a sum's products and
its starting value together), so only an index, shift, gather or
rounding-point fault can make the two differ.  ``_FoldPlain`` is held
against the JAX kernel in tests/test_torch_msg_gnn_v34.py.
"""
import numpy as np
import pytest
import torch

from test_torch_msg_gnn_tc import (_assert_exact, _exact_acc, _exact_sum, _graph, _member_sums,
                                 _r, _span)

from ldpc_tpu_torch.codes import get_base_graph, qc_layout
from ldpc_tpu_torch.ops import fused_gnn as fg
from ldpc_tpu_torch.ops.msg_gnn_exact import (EXACT_CASES, EXACT_TE_CASES,
                                              EXACT_TYPE_EMBEDDINGS, exact_msg_gnn_case)

TILE = 16


def unpack_v3_weights(packed: torch.Tensor, h: int, inject: bool):
    """The packed (T, LW) bf16 weights -> W1v (T, h, 2h or 3h), W1c (T, h, h
    or 2h), W1ca (T, h, h), W2 (T, h, 2h) float32; the row padding must be
    zero."""
    T = packed.shape[0]
    p = packed.to(torch.float32)
    out, o = [], 0
    for width in ((3 if inject else 2) * h, (2 if inject else 1) * h, h, 2 * h):
        m = p[:, o:o + h * (width + 8)].reshape(T, h, width + 8)
        assert not m[:, :, width:].any()
        out.append(m[:, :, :width])
        o += h * (width + 8)
    assert o == p.shape[1]
    return out


def tile_model(dec, llr: torch.Tensor) -> torch.Tensor:
    """The msg_gnn_v3 kernel's arithmetic, check tile by check tile, on the CPU."""
    qc, h, T, inject = dec.qc, dec.hidden_dim, dec.num_iterations, dec.input_injection
    tb = dec.tables
    Z, K, C, R = qc.Z, qc.num_base_edges, qc.num_base_cols, qc.num_base_rows
    E, n, M = K * Z, C * Z, R * Z
    row_ptr, row_edge, col_ptr, col_edge, shift, col, _ = _graph(dec)
    W1v, W1c, W1ca, W2 = unpack_v3_weights(tb.w_bf16, h, inject)
    emb_w, emb_b, proj_w, proj_b = tb.emb[:h], tb.emb[h:2 * h], tb.emb[2 * h:3 * h], tb.emb[3 * h]
    inv_dc, inv_dr = tb.inv[:C], tb.inv[C:]
    dte = tb.tab  # (T + 1, K, h)
    B = llr.shape[0]

    i = torch.arange(E)
    k_of = i // Z
    vrow = col[k_of] * Z + (i - k_of * Z)  # each message's variable
    f = _r((llr[:, vrow, None] * emb_w + emb_b) + dte[0][k_of])  # (B, E, h)
    lf = _r(llr[..., None] * emb_w + emb_b)  # (B, n, h), by variable

    # The check tiles: row i of tile `tile` is flat check tile*16 + i.
    ntiles = -(-M // TILE)
    rows = torch.arange(ntiles * TILE)
    valid = rows < M
    r_of = torch.where(valid, rows // Z, 0)
    zc = rows - r_of * Z
    deg = torch.where(valid, row_ptr[r_of + 1] - row_ptr[r_of], 0)
    dmax = deg.reshape(ntiles, TILE).amax(dim=1)  # a tile's stages: 2 * dmax

    def slot(s):
        """Member slot s of every tile row: (ok, base edge, message, variable)."""
        ok = deg > s
        k = row_edge[(row_ptr[r_of] + s).clamp(max=K - 1)]
        v = (zc + shift[k]) % Z
        return ok, k, k * Z + v, col[k] * Z + v

    for t in range(T):
        vsum = _member_sums(f, col_ptr, lambda j, zs: col_edge[j] * Z + zs, Z)
        vmean = _r(vsum * inv_dc.repeat_interleave(Z)[:, None])  # (B, n, h)
        b1v, b1c, b2 = tb.small[t, :h], tb.small[t, h:2 * h], tb.small[t, 2 * h:]

        # W1ca stages: one accumulator over every member slot of a tile (a
        # slot past a row's degree is a zero row there: it adds nothing).
        slots = [slot(s) for s in range(int(dmax.max()))]
        pre = torch.zeros((B, ntiles * TILE, h))
        bound = torch.zeros((B, ntiles * TILE, h), dtype=torch.float64)
        lq = torch.full((B, ntiles * TILE, h), torch.inf)
        for s, (ok, _, e, _) in enumerate(slots):
            assert bool((~ok | (s < dmax.repeat_interleave(TILE))).all())
            fs = f[:, e[ok]]
            b, q = _span(fs, W1ca[t])
            bound[:, ok] += b.reshape(B, -1, h)
            lq[:, ok] = torch.minimum(lq[:, ok], q.reshape(B, -1, h))
            pre[:, ok] += fs @ W1ca[t].t()
        _assert_exact(bound, lq)
        pre = pre * inv_dr[r_of][None, :, None] + b1c  # (B, tiles * 16, h)

        # Update stages, member slot by member slot, written back in place
        # (a zero row writes nothing).
        new = f.clone()
        for ok, k, e, var in slots:
            fs, vm, ls = f[:, e[ok]], vmean[:, var[ok]], lf[:, var[ok]]
            pv_in = [fs, vm] + ([ls] if inject else [])
            # the plain version adds b1v and b2 inside these sums, the kernel after them
            pv = _exact_acc([(torch.cat(pv_in, dim=-1), W1v[t])], init=b1v)
            # pre_row is no multiple of the products' quanta: the plain version's order
            pc = _exact_acc([(fs, W1c[t][:, :h])]) + pre[:, ok]
            if inject:
                pc = pc + _exact_acc([(ls, W1c[t][:, h:])])
            h1 = torch.cat([_r(torch.relu(pv)), _r(torch.relu(pc))], dim=-1)
            out = _r(_exact_acc([(h1, W2[t])], init=b2))
            d = _r(dte[t + 1][k[ok]])[None]
            new[:, e[ok]] = _r(out + d) if t == 0 else _r(_r(out + fs) + d)
        f = new

    contrib = _exact_acc([(f, proj_w[None])])[..., 0]  # (B, E)
    acc = torch.zeros((B, n))
    for c in range(C):
        for j in range(int(col_ptr[c]), int(col_ptr[c + 1])):
            msgs = col_edge[j] * Z + torch.arange(Z)
            sl = slice(c * Z, (c + 1) * Z)
            _exact_sum(acc[:, sl], contrib[:, msgs], proj_b)
            acc[:, sl] = (acc[:, sl] + contrib[:, msgs]) + proj_b
    _exact_sum(llr, acc)
    return 1.0 / (1.0 + torch.exp(llr + acc))


CASES = ([(*case, 2, (0.0,)) for case in EXACT_CASES]
         + [(*case, EXACT_TYPE_EMBEDDINGS) for case in EXACT_TE_CASES])


@pytest.mark.parametrize("code,Z,h,batch,inject,share,T,te", CASES)
def test_tile_model_equals_plain_on_exact_inputs(code, Z, h, batch, inject, share, T, te):
    """The check-major tiles with pre_row in one accumulator, the packed
    weights and the delta table give the plain version's soft bits
    exactly; the decode is not trivial (both decisions present, soft bits
    not all saturated), and with nonzero type embeddings the deltas move
    the result."""
    torch.set_num_threads(1)
    qc = qc_layout(get_base_graph(code), Z)
    model, llr = exact_msg_gnn_case(qc, h, batch, inject, share, num_iterations=T,
                                    type_embeddings=te)
    dec = fg.make_fused_gnn_decoder_v3(qc, model, T, h, share_layers=share,
                                       input_injection=inject, device="cpu")
    x = torch.from_numpy(llr)
    plain = dec(x)
    assert torch.equal(tile_model(dec, x), plain)
    decided = plain > 0.5
    assert decided.any() and (~decided).any()
    assert ((plain - 0.5).abs() < 0.45).float().mean() > 0.05
    if te != (0.0,):
        # the case exercises the delta table: nonzero blocks, and a decode
        # that differs from the same model without them
        assert dec.tables.tab.abs().amax(dim=(1, 2)).min() > 0
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("message_type_embeddings"):
                    p.zero_()
        flat = fg.make_fused_gnn_decoder_v3(qc, model, T, h, share_layers=share,
                                            input_injection=inject, device="cpu")
        assert not torch.equal(flat(x), plain)


def test_tiles_span_rows_of_different_degree():
    """At Z < 16 a check tile holds rows of several base rows, so member
    slots past a row's degree are zero rows (nr_2_0_4 Z=4); at nr_2_0_32
    Z=32 every tile is two halves of one base row."""
    for code, Z, mixed in (("nr_2_0_4", 4, True), ("nr_2_0_32", 32, False)):
        qc = qc_layout(get_base_graph(code), Z)
        deg = np.asarray([(qc.row_edges[r] != qc.num_base_edges).sum()
                          for r in range(qc.num_base_rows)]).repeat(Z)
        deg = np.pad(deg, (0, -len(deg) % TILE)).reshape(-1, TILE)
        assert bool((deg.min(axis=1) != deg.max(axis=1)).any()) == mixed


@pytest.mark.parametrize("h,inject", [(16, False), (16, True), (64, False), (64, True)])
def test_pack_v3_weights_round_trip(h, inject):
    """The packed layout holds [W1vf W1va (W1vl)], [W1cf (W1cl)], W1ca and
    [W2v W2c] of each layer, rows padded by 8 zeros."""
    T = 3
    w = _r(torch.from_numpy(np.random.default_rng(h).standard_normal((T, 8, h, h), np.float32)))
    packed = fg.pack_tc_weights(w, inject, "msg_gnn_v3")
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    w1v, w1c, w1ca, w2 = unpack_v3_weights(packed, h, inject)
    # _MsgTables order: va, ca, vl, cl, vf, cf, W2v, W2c
    assert torch.equal(w1v, torch.cat([w[:, 4], w[:, 0]] + ([w[:, 2]] if inject else []), dim=2))
    assert torch.equal(w1c, torch.cat([w[:, 5]] + ([w[:, 3]] if inject else []), dim=2))
    assert torch.equal(w1ca, w[:, 1])
    assert torch.equal(w2, torch.cat([w[:, 6], w[:, 7]], dim=2))


# Dynamic shared memory of one msg_gnn_v3 block of one warp, bytes, by
# (h, injection), from make_layout in csrc/fused_msg_gnn_tc.cu: structure,
# inverse degrees, LLRs, embedding, b1v/b1c/b2, one layer's packed weights,
# the staged deltas (K h bf16) and one warp's two stage buffers.
V3_SMEM_ONE_WARP = {
    "toy_4x8": {(16, False): 8_864, (16, True): 9_888, (64, False): 67_136, (64, True): 83_520},
    "nr_2_0_4": {(16, False): 20_208, (16, True): 21_232, (64, False): 95_568,
                 (64, True): 111_952},
    "nr_2_0_32": {(16, False): 26_032, (16, True): 27_056, (64, False): 101_392,
                  (64, True): 117_776},
}


@pytest.mark.parametrize("code,Z", [("toy_4x8", 4), ("nr_2_0_4", 4), ("nr_2_0_32", 32)])
def test_v3_plans(code, Z):
    """Shared memory, packed weights and scratch of msg_gnn_v3 follow
    make_layout and scratch_elems_v3 in csrc/fused_msg_gnn_tc.cu."""
    qc = qc_layout(get_base_graph(code), Z)
    K, C = qc.num_base_edges, qc.num_base_cols
    for h in (16, 64):
        for inject in (False, True):
            one = V3_SMEM_ONE_WARP[code][(h, inject)]
            assert fg.msg_gnn_smem_bytes(qc, h, "msg_gnn_v3", inject, 1) == one
            # each further warp: two buffers of 16 f rows and 16 vmean rows
            assert fg.msg_gnn_smem_bytes(qc, h, "msg_gnn_v3", inject, 12) == \
                one + 11 * 2 * 2 * TILE * (h + 8) * 2
            # features and variable means, one bf16 h-row each
            assert fg.msg_gnn_scratch_floats(qc, h, "msg_gnn_v3") == (K + C) * Z * h // 2
            w = torch.zeros((2, 8, h, h))
            blocks = fg.tc_weight_blocks(h, inject, "msg_gnn_v3")
            assert fg.pack_tc_weights(w, inject, "msg_gnn_v3").shape == \
                (2, h * sum(width for _, width in blocks))
    if code == "nr_2_0_32":
        # the main path: 53,248 B of weights a layer (69,632 B with injection),
        # 9,216 B of stage buffers a warp; twelve warps fit a block's
        # 232,448 B; 1,019,904 B of scratch a block
        assert 2 * fg.pack_tc_weights(torch.zeros((1, 8, 64, 64)), False, "msg_gnn_v3").numel() \
            == 53_248
        assert 2 * fg.pack_tc_weights(torch.zeros((1, 8, 64, 64)), True, "msg_gnn_v3").numel() \
            == 69_632
        assert fg.msg_gnn_smem_bytes(qc, 64, "msg_gnn_v3", False, 2) - \
            fg.msg_gnn_smem_bytes(qc, 64, "msg_gnn_v3", False, 1) == 9_216
        assert fg.msg_gnn_smem_bytes(qc, 64, "msg_gnn_v3", True, 12) <= 232_448
        assert fg.msg_gnn_scratch_floats(qc, 64, "msg_gnn_v3") * 4 == 1_019_904
