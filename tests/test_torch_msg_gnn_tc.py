"""B7's tensor-core kernel (csrc/fused_msg_gnn_tc.cu, replaces
ldpc_tpu/ops/pallas_gnn.py:295 ``_kernel_v2``) on the CPU: a torch model of
its tiles against the plain version, its packed weights and its plans.

The tile model repeats what the kernel computes from what the wrapper hands
it: the packed bf16 weights unpacked, the graph tensor decoded, the means
summed in member order, the first layer folded into one product over [f |
mean | lf] per 16-message tile of the flat message index, with each row's
(col, z) and (row, (z - shift) mod Z) gathers, and the second layer over
[h1v | h1c].  On the exact inputs of ``msg_gnn_exact`` it must give soft
bits identical to the plain version (``torch.equal``): there the order of a
sum cannot matter, so an index, shift or rounding-point fault shows, which
the card's 3e-2 bar could let through.

Why the inputs are exact.  bf16 x bf16 products are exact in float32.  A sum
of float32 terms that are all multiples of one power of two Q, whose
magnitudes add up to less than 2**24 Q, is exact in any order and through
any alignment that keeps 24 bits below its largest term (every partial sum
is then a multiple of Q below 2**24 Q, which float32 holds).  ``_exact_sum``
checks that condition on every sum the model takes, value by value, with Q
the least power of two that divides the terms' nonzero values and the
bound the largest sum of magnitudes; the plain version's sums are these
sums, split or reordered.  The rest of the decode is the same elementwise
operations on the same values in both.
"""
import numpy as np
import pytest
import torch

from ldpc_tpu_torch.codes import get_base_graph, qc_layout
from ldpc_tpu_torch.models import create_message_gnn_decoder
from ldpc_tpu_torch.ops import fused_gnn as fg, qc_msg
from ldpc_tpu_torch.ops.msg_gnn_exact import EXACT_CASES, exact_msg_gnn_case

TILE = 16


def _quanta(x: torch.Tensor) -> torch.Tensor:
    """Per value of x (float32), the largest power of two dividing it; inf
    for zeros."""
    v = x.detach().double().abs()
    mant, exp = torch.frexp(v)
    ints = (mant * 2.0 ** 24).to(torch.int64)  # exact: float32 values have 24 bits
    q = (ints & -ints).double() * torch.pow(2.0, exp.double() - 24)  # lowest set bit
    return torch.where(v > 0, q, torch.inf)


def _exact_sum(*terms: torch.Tensor) -> None:
    """Raises unless the elementwise sum of these term tensors (broadcast
    together) is exact in float32 in any order: per value, the magnitudes
    add up to less than 2**24 times the least quantum of its terms."""
    terms = torch.broadcast_tensors(*terms)
    q = torch.stack([_quanta(t) for t in terms]).amin(dim=0)
    bound = sum(t.double().abs() for t in terms)
    assert bool((bound < 2.0 ** 24 * q).all()), "a sum is not exact"


def _exact_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (..., in) @ w (out, in)^T after checking that every output's sum of
    products is exact in any order: per output, the products' magnitudes
    add up to less than 2**24 times the least quantum of its nonzero
    products (an a-quantum times a w-quantum)."""
    # log2 of the quanta: exact integers (inf for zeros), summed per product
    la = torch.log2(_quanta(a).reshape(-1, a.shape[-1])).float()
    lw = torch.log2(_quanta(w)).float()
    bound = (a.double().abs() @ w.double().abs().t()).reshape(-1, w.shape[0])
    rows = max(1, 2 ** 22 // lw.numel())
    for i in range(0, la.shape[0], rows):
        # least quantum of each output's products; inf where a row meets no nonzero weight
        q = torch.pow(2.0, (la[i:i + rows, None, :] + lw[None]).amin(dim=2).double())
        assert bool((bound[i:i + rows] < 2.0 ** 24 * q).all()), "a product is not exact"
    return a @ w.t()


def _span(a: torch.Tensor, w: torch.Tensor):
    """Per output of a (..., in) @ w (out, in)^T: the sum of the products'
    magnitudes and log2 of their least quantum (inf where every product is
    0), each (rows, out)."""
    la = torch.log2(_quanta(a).reshape(-1, a.shape[-1])).float()
    lw = torch.log2(_quanta(w)).float()
    bound = a.double().abs().reshape(-1, a.shape[-1]) @ w.double().abs().t()
    rows = max(1, 2 ** 22 // lw.numel())
    lq = torch.cat([(la[i:i + rows, None, :] + lw[None]).amin(dim=2)
                    for i in range(0, la.shape[0], rows)])
    return bound, lq


def _assert_exact(bound: torch.Tensor, lq: torch.Tensor) -> None:
    """Raises unless every sum whose terms' magnitudes add up to ``bound``
    is below 2**24 times its least quantum 2**lq: then it is exact in any
    order."""
    assert bool((bound < 2.0 ** 24 * torch.pow(2.0, lq.double())).all()), "a sum is not exact"


def _exact_acc(pairs, init: torch.Tensor | None = None) -> torch.Tensor:
    """init + the sum of a @ w^T over (a, w) in ``pairs``, one float32
    accumulation, after checking that it is exact in any order: per output,
    the magnitudes of every product and of init add up to less than 2**24
    times the least quantum among them."""
    shape = pairs[0][0].shape[:-1] + (pairs[0][1].shape[0],)
    bound, lq = 0.0, torch.full((1,), torch.inf)
    for a, w in pairs:
        b, q = _span(a, w)
        bound, lq = bound + b, torch.minimum(lq, q)
    acc = sum(a @ w.t() for a, w in pairs)
    if init is not None:
        init = init.expand(shape)
        bound = bound + init.double().abs().reshape(bound.shape)
        lq = torch.minimum(lq, torch.log2(_quanta(init)).reshape(bound.shape).float())
        acc = init + acc
    _assert_exact(bound, lq)
    return acc


def _r(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def unpack_tc_weights(packed: torch.Tensor, h: int, inject: bool):
    """The packed (T, h * (2 ws1 + ws2)) bf16 weights -> W1v, W1c (T, h,
    2h or 3h) and W2 (T, h, 2h) float32; the row padding must be zero."""
    ws1, ws2 = fg.tc_row_widths(h, inject)
    kin = ws1 - 8
    T = packed.shape[0]
    p = packed.to(torch.float32)
    w1v = p[:, : h * ws1].reshape(T, h, ws1)
    w1c = p[:, h * ws1: 2 * h * ws1].reshape(T, h, ws1)
    w2 = p[:, 2 * h * ws1:].reshape(T, h, ws2)
    for m, width in ((w1v, kin), (w1c, kin), (w2, 2 * h)):
        assert not m[:, :, width:].any()
    return w1v[:, :, :kin], w1c[:, :, :kin], w2[:, :, : 2 * h]


def _graph(dec):
    """The kernel's view of ``tables.graph``: row_ptr, row_edge, col_ptr,
    col_edge, shift, col, row."""
    qc = dec.qc
    R, C, K = qc.num_base_rows, qc.num_base_cols, qc.num_base_edges
    g = dec.tables.graph.to(torch.int64)
    sizes = (R + 1, K, C + 1, K, K, K, K)
    return torch.split(g[: sum(sizes)], sizes)


def _member_sums(f: torch.Tensor, ptr: torch.Tensor, members, Z: int) -> torch.Tensor:
    """Per group (variable or check) and z, the sum over its members in
    member order of f at members(j, z) -> row of f; (B, groups*Z, h)."""
    out = []
    for grp in range(ptr.numel() - 1):
        zs = torch.arange(Z)
        acc = torch.zeros_like(f[:, :Z])
        terms = [f[:, members(j, zs)] for j in range(int(ptr[grp]), int(ptr[grp + 1]))]
        if terms:
            _exact_sum(*terms)
        for term in terms:
            acc = acc + term
        out.append(acc)
    return torch.cat(out, dim=1)


def tile_model(dec, llr: torch.Tensor) -> torch.Tensor:
    """A message-major kernel's arithmetic (``dec.kind``: msg_gnn_v2,
    msg_gnn or msg_gnn_v4), tile by tile, on the CPU.  Each first-layer
    output is one accumulation over [f | mean | lf] plus b1 (per edge; v4's
    per layer).  The second layer: v2 one accumulation over [h1v | h1c]
    plus b2; msg_gnn its halves apart, bf16(W2v h1v + b2v) and then bf16(W2c
    h1c + b2c), added in bf16; v4 as v2, then the delta before the residual,
    bf16(bf16(out + d) + f).  v4's features carry the type embeddings (the
    delta table), and its last layer is the thin product w2last . h1 (+
    proj8 . f after layer 0), one accumulation, summed per variable with
    dsc."""
    qc, h, T, inject = dec.qc, dec.hidden_dim, dec.num_iterations, dec.input_injection
    tb, kind = dec.tables, dec.kind
    v4 = kind == "msg_gnn_v4"
    Z, K, C = qc.Z, qc.num_base_edges, qc.num_base_cols
    E, n = K * Z, C * Z
    row_ptr, row_edge, col_ptr, col_edge, shift, col, row = _graph(dec)
    W1v, W1c, W2 = unpack_tc_weights(tb.w_bf16, h, inject)
    emb_w, emb_b, proj_w, proj_b = tb.emb[:h], tb.emb[h:2 * h], tb.emb[2 * h:3 * h], tb.emb[3 * h]
    inv_dc, inv_dr = tb.inv[:C], tb.inv[C:]
    B = llr.shape[0]

    i = torch.arange(E)
    k = i // Z
    z = i - k * Z
    vrow = col[k] * Z + z  # the message's variable: its vmean row and its LLR
    crow = row[k] * Z + (z - shift[k]) % Z  # its check: the rmean row
    lf = _r(llr[:, vrow, None] * emb_w + emb_b)  # (B, E, h)
    f = _r((llr[:, vrow, None] * emb_w + emb_b) + tb.tab[0][k]) if v4 else lf
    ntiles = -(-E // TILE)
    pad = ntiles * TILE - E

    def tiles(x):  # (B, E, w) -> (B, tiles, 16, w), rows past E zero
        return torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(B, ntiles, TILE, -1)

    def untile(x):  # (B, tiles, 16, w) -> (B, E, w)
        return x.reshape(B, ntiles * TILE, -1)[:, :E]

    for t in range(T):
        vsum = _member_sums(f, col_ptr, lambda j, zs: col_edge[j] * Z + zs, Z)
        rsum = _member_sums(f, row_ptr, lambda j, zs: row_edge[j] * Z + (zs + shift[row_edge[j]])
                            % Z, Z)
        vmean = _r(vsum * inv_dc.repeat_interleave(Z)[:, None])
        rmean = _r(rsum * inv_dr.repeat_interleave(Z)[:, None])
        parts_v, parts_c = [f, vmean[:, vrow]], [f, rmean[:, crow]]
        if inject:
            parts_v.append(lf)
            parts_c.append(lf)
        if v4:  # per layer
            b1v, b1c = tb.small[t, :h], tb.small[t, h:2 * h]
        else:  # (2, K, h), per edge
            b1v, b1c = (tiles(tb.tab[t][side][k].expand(B, E, h)) for side in (0, 1))
        pv = _exact_acc([(tiles(torch.cat(parts_v, dim=-1)), W1v[t])], init=b1v)
        pc = _exact_acc([(tiles(torch.cat(parts_c, dim=-1)), W1c[t])], init=b1c)
        h1v, h1c = _r(torch.relu(pv)), _r(torch.relu(pc))
        h1 = torch.cat([h1v, h1c], dim=-1)
        if v4 and t == T - 1:  # the thin last layer: one output scalar a message
            pairs = [(h1, tb.extra[None, :2 * h])]
            if t >= 1:
                pairs.append((tiles(f), proj_w[None]))
            break
        if kind == "msg_gnn":  # the halves rounded apart, out_v first
            outs = [(_exact_product(x, W2[t][:, s * h:(s + 1) * h]), tb.small[t, s * h:(s + 1) * h])
                    for s, x in enumerate((h1v, h1c))]
            for out, b2 in outs:
                _exact_sum(out, b2)
            new = untile(_r(_r(outs[0][0] + outs[0][1]) + _r(outs[1][0] + outs[1][1])))
        else:
            out, b2 = _exact_product(h1, W2[t]), tb.small[t, 2 * h:3 * h] if v4 else tb.small[t, :h]
            _exact_sum(out, b2)
            new = untile(_r(out + b2))
        if v4:
            d = _r(tb.tab[t + 1][k])
            new = _r(new + d) if t == 0 else _r(_r(new + d) + f)
        elif t >= 1:
            _exact_sum(new, f)
            new = _r(new + f)
        f = new

    # The per-variable sums, in member order as the kernel adds them: v4's
    # per message s plus its edge's float32 dsc (not dyadic: the order is
    # the plain version's, not checked exact); the others' projection of
    # the features plus proj_b.
    if v4:
        terms, adds = untile(_exact_acc(pairs))[..., 0], tb.extra[2 * h:]
    else:
        terms, adds = _exact_product(f, proj_w[None])[..., 0], proj_b.expand(K)
    acc = torch.zeros((B, n))
    for c in range(C):
        for j in range(int(col_ptr[c]), int(col_ptr[c + 1])):
            rows = col_edge[j] * Z + torch.arange(Z)
            sl = slice(c * Z, (c + 1) * Z)
            if not v4:
                _exact_sum(acc[:, sl], terms[:, rows], adds[col_edge[j]])
            acc[:, sl] = (acc[:, sl] + terms[:, rows]) + adds[col_edge[j]]
    if not v4:
        _exact_sum(llr, acc)
    return 1.0 / (1.0 + torch.exp(llr + acc))


@pytest.mark.parametrize("code,Z,h,batch,inject,share", EXACT_CASES)
def test_tile_model_equals_plain_on_exact_inputs(code, Z, h, batch, inject, share):
    """The fold, the flat-index tiles with their gathers and the packed
    weights give the plain version's soft bits exactly; the decode is not
    trivial (both decisions present, soft bits not all saturated)."""
    torch.set_num_threads(1)
    qc = qc_layout(get_base_graph(code), Z)
    model, llr = exact_msg_gnn_case(qc, h, batch, inject, share)
    dec = fg.make_fused_gnn_decoder_v2(qc, model, 2, h, share_layers=share,
                                       input_injection=inject, device="cpu")
    x = torch.from_numpy(llr)
    plain = dec(x)
    got = tile_model(dec, x)
    assert torch.equal(got, plain)
    decided = plain > 0.5
    assert decided.any() and (~decided).any()
    assert ((plain - 0.5).abs() < 0.45).float().mean() > 0.05


@pytest.mark.parametrize("h,inject", [(16, False), (16, True), (64, False), (64, True)])
def test_pack_tc_weights_round_trip(h, inject):
    """The packed layout holds [W1vf W1va (W1vl)], [W1cf W1ca (W1cl)] and
    [W2v W2c] of each layer, zero-padded rows of 2h (3h) + 8 and 2h + 8."""
    T = 3
    w = torch.from_numpy(np.random.default_rng(h).standard_normal((T, 8, h, h), np.float32))
    w = _r(w)
    packed = fg.pack_tc_weights(w, inject)
    ws1, ws2 = fg.tc_row_widths(h, inject)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.shape == (T, h * (2 * ws1 + ws2))
    w1v, w1c, w2 = unpack_tc_weights(packed, h, inject)
    # _MsgTables order: va, ca, vl, cl, vf, cf, W2v, W2c
    want_v = [w[:, 4], w[:, 0]] + ([w[:, 2]] if inject else [])
    want_c = [w[:, 5], w[:, 1]] + ([w[:, 3]] if inject else [])
    assert torch.equal(w1v, torch.cat(want_v, dim=2))
    assert torch.equal(w1c, torch.cat(want_c, dim=2))
    assert torch.equal(w2, torch.cat([w[:, 6], w[:, 7]], dim=2))


def test_tc_plans():
    """Shared memory and scratch of msg_gnn_v2 follow make_layout and
    scratch_elems in csrc/fused_msg_gnn_tc.cu."""
    qc = qc_layout(get_base_graph("nr_2_0_32"), 32)
    K, C, R, Z = qc.num_base_edges, qc.num_base_cols, qc.num_base_rows, qc.Z
    fixed = 4 * (((6 * K + R + C + 2) + 3) // 4 * 4 + (C + R + 3) // 4 * 4 + C * Z + 196 + 64)
    # weights: W1v, W1c rows of 2h + 8 (3h + 8), W2 rows of 2h + 8, bf16
    assert fg.msg_gnn_smem_bytes(qc, 64, "msg_gnn_v2", False, 1) == \
        fixed + 2 * 64 * (2 * 136 + 136) + 2 * 2 * 3 * 16 * 72
    assert fg.msg_gnn_smem_bytes(qc, 64, "msg_gnn_v2", True, 11) == \
        fixed + 2 * 64 * (2 * 200 + 136) + 11 * 2 * 2 * 3 * 16 * 72
    assert fg.msg_gnn_smem_bytes(qc, 64, "msg_gnn_v2", False, 11) <= 232_448
    # features, vmean, rmean: one bf16 h-row each, no float32 terms
    assert fg.msg_gnn_scratch_floats(qc, 64, "msg_gnn_v2") == (K + C + R) * Z * 32
    assert fg.msg_gnn_scratch_floats(qc, 64, "msg_gnn_v2") * 4 == 1_191_936


def test_tc_raising_paths():
    """A width without an instantiation, the card without a card, and an
    input on another device than the decoder's, of another dtype or shape."""
    qc = qc_layout(get_base_graph("toy_4x8"), 4)
    plan = qc_msg.make_plan(qc, device="cpu")
    model = create_message_gnn_decoder(plan, num_iterations=2, hidden_dim=32)
    with pytest.raises(ValueError, match="hidden_dim in"):
        fg.make_fused_gnn_decoder_v2(qc, model, 2, 32, device="cpu")
    model = create_message_gnn_decoder(plan, num_iterations=2, hidden_dim=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fg.make_fused_gnn_decoder_v2(qc, model, 2, 16)
    dec = fg.FusedMessageGNNDecoder("msg_gnn_v2", qc, model, 2, 16, False, False,
                                    torch.device("meta"))
    with pytest.raises(ValueError, match="built for meta"):
        dec(torch.zeros((3, qc.num_vars)))
    cpu = fg.make_fused_gnn_decoder_v2(qc, model, 2, 16, device="cpu")
    with pytest.raises(TypeError, match="float32"):
        cpu(torch.zeros((3, qc.num_vars), dtype=torch.float64))
    with pytest.raises(ValueError, match="must be"):
        cpu(torch.zeros((3, qc.num_vars + 1)))
