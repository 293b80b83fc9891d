"""B5's tensor-core kernel (csrc/fused_gnn_tc.cu ``corrected_tc_kernel``,
replaces ldpc_tpu/ops/pallas_gnn.py:1341 ``_corrected_kernel``) on the CPU:
a torch model of its variable-major tiles against the plain version, its
packed weights, its shared-memory plan and its raising paths.

The tile model repeats what the kernel computes from what the wrapper hands
it: the packed bf16 weights unpacked (the first layer's six matrices, then
W2v and W2c), the graph tensor decoded, the per-edge first-layer biases, the
min-sum skeleton of ``test_torch_corrected_tc.TileModel``, and each
correction as the kernel's one pass over 16-row tiles of flat variables:
the member sums for the variable mean, pre_col = (W1va vmean) + W1vl lf and
pre_llr = W1cl lf per variable, then per member slot the message's
out_v = bf16(W2v bf16(relu((W1vf f + pre_col) + bias1v)) + b2v), its check's
mean rebuilt from the check's messages in row order, out_c =
bf16(W2c bf16(relu(((W1cf f + W1ca rmean) + bias1c) + pre_llr)) + b2c), lo =
bf16(out_v + out_c) and the projection sum_j lo_j pw_j + pb into the output
in place.  Rows are independent in a tile, so each product is taken in one
call over every (variable, member slot) row.

On the exact inputs of ``ops/msg_gnn_exact.py`` it must give the plain
version's soft bits and conv_iter exactly (``torch.equal``): every sum the
kernel takes in another order than the plain version is a product, the sum
of W1cf f and W1ca rmean (one accumulator in the kernel), W2 h1 + b2, or the
projection, each checked exact in any order value by value here
(``_exact_product``, ``_exact_acc``), and every other operation runs in the
plain version's order.  The means are sums of float32 features in member
order, so their order must be the plain version's: the graph tensor's
member lists are held to the plain version's gathers separately.
"""
import numpy as np
import pytest
import torch

from test_torch_corrected_tc import TileModel, _graph, unpack_corrected_tc_weights
from test_torch_msg_gnn_tc import _exact_acc, _exact_product, _exact_sum, _r

from ldpc_tpu_torch.codes import get_base_graph, qc_layout
from ldpc_tpu_torch.models import create_corrected_minsum_gnn_decoder
from ldpc_tpu_torch.ops import fused_gnn as fg, qc_msg
from ldpc_tpu_torch.ops.msg_gnn_exact import CORRECTED_EXACT_CASES, exact_corrected_case
from ldpc_tpu_torch.utils import bpsk_awgn_llr

BLOCK_BYTES = 232_448  # the shared memory one block can use on the H100


class UnfoldedTileModel(TileModel):
    """corrected_tc_kernel's arithmetic on the CPU, for one decoder."""

    def _mean_features(self, msgs: torch.Tensor, slots) -> torch.Tensor:
        """Sum of the bf16 features of the messages ``slots`` yields, in its
        order: (valid rows, flat message index of each row) per slot."""
        x = None
        for ok, e in slots:
            f = self._features(msgs[:, e], self.emb_b)
            x = torch.zeros_like(f) if x is None else x
            x = torch.where(ok[None, :, None], x + f, x)
        return x

    def correction(self, idx: int, msgs: torch.Tensor, out: torch.Tensor, llr: torch.Tensor):
        """out (B, E) += correction of layer idx computed from msgs (B, E)."""
        Z, h, tb = self.Z, self.h, self.tb
        W = self.W[idx]
        Wvf, Wcf, Wca, Wva, W2v, W2c = W[0], W[1], W[2], W[3], W[-2], W[-1]
        small = tb.small[idx]
        b2v, b2c, pw, pb = small[:h], small[h:2 * h], small[2 * h:3 * h], small[3 * h]
        bias1v, bias1c = tb.tab[idx][0], tb.tab[idx][1]  # (K, h) each

        # Per flat variable v = c*Z + z: vmean, pre_col, pre_llr.
        n = self.C * Z
        vc, vz = torch.arange(n) // Z, torch.arange(n) % Z
        vmean = _r(self._mean_features(
            msgs, ((ok, k * Z + vz) for ok, k in self._slots(self.col_ptr, self.col_edge, vc)))
            * self.inv_dc[vc][:, None])
        pre_col = _exact_product(vmean, Wva)
        if self.inject:
            lf = self._features(llr, self.emb_b)
            pre_col = pre_col + _exact_product(lf, W[4])
            pre_llr = _exact_product(lf, W[5])

        # Per (variable, member slot) row: the message's base edge and lane.
        rows, ks = [], []
        for ok, k in self._slots(self.col_ptr, self.col_edge, vc):
            rows.append(torch.arange(n)[ok])
            ks.append(k[ok])
        rows, ks = torch.cat(rows), torch.cat(ks)
        z = vz[rows]
        edges = ks * Z + z
        f = self._features(msgs[:, edges], self.emb_b)

        pv = (_exact_product(f, Wvf) + pre_col[:, rows]) + bias1v[ks]
        ov = _r(_exact_acc([(_r(torch.relu(pv)), W2v)], init=b2v))

        # The message's check (row[k], (z - shift[k]) mod Z): its mean from its
        # members' messages, in row order.
        r, zc = self.row[ks], (z - self.shift[ks]) % Z
        deg = (self.row_ptr[1:] - self.row_ptr[:-1])[r]

        def members():
            for j in range(int(deg.max())):
                kk = self.row_edge[(self.row_ptr[r] + j).clamp(max=self.K - 1)]
                yield deg > j, kk * Z + (zc + self.shift[kk]) % Z

        rmean = _r(self._mean_features(msgs, members()) * self.inv_dr[r][:, None])
        pc = _exact_acc([(f, Wcf), (rmean, Wca)]) + bias1c[ks]  # one accumulator
        if self.inject:
            pc = pc + pre_llr[:, rows]
        oc = _r(_exact_acc([(_r(torch.relu(pc)), W2c)], init=b2c))
        _exact_sum(ov, oc)
        lo = _r(ov + oc)
        corr = _exact_acc([(lo, pw[None])], init=pb.reshape(1))[..., 0]
        out[:, edges] = out[:, edges] + corr


def _decoder(qc, model, h, inject, share, early_exit):
    return fg.make_fused_corrected_gnn_decoder(qc, model, 2, h, share_layers=share,
                                               input_injection=inject, early_exit=early_exit,
                                               return_iterations=early_exit, device="cpu")


@pytest.mark.parametrize("code,Z,h,batch,inject,share,early_exit", CORRECTED_EXACT_CASES)
def test_tile_model_equals_plain_on_exact_inputs(code, Z, h, batch, inject, share, early_exit):
    """The variable tiles, the rebuilt check means, both second-layer halves,
    the projection and the packed weights give the plain version's soft bits
    and conv_iter exactly; the decode is not trivial (both decisions present,
    soft bits not all saturated, early exit stopping some frames and not
    others)."""
    torch.set_num_threads(1)
    qc = qc_layout(get_base_graph(code), Z)
    model, llr = exact_corrected_case(qc, h, batch, inject, share)
    dec = _decoder(qc, model, h, inject, share, early_exit)
    x = torch.from_numpy(llr)
    plain = dec(x)
    soft_p, conv_p = plain if early_exit else (plain, None)
    soft_m, conv_m = UnfoldedTileModel(dec).decode(x)
    assert torch.equal(soft_m, soft_p)
    decided = soft_p > 0.5
    assert decided.any() and (~decided).any()
    assert ((soft_p - 0.5).abs() < 0.45).float().mean() > 0.05
    if early_exit:
        assert torch.equal(conv_m, conv_p)
        assert (conv_p == 1).any() and (conv_p == 2).any()


@pytest.mark.parametrize("code,Z", [("toy_4x8", 4), ("nr_2_0_4", 4), ("nr_2_0_32", 32)])
def test_member_lists_are_the_plain_gathers(code, Z):
    """The means sum float32 features in member order, which the exact
    inputs cannot show: the kernel's member lists (the graph tensor) must be
    the plain version's gathers, row_edges and col_edges without their pads,
    and its shifts and rows the layout's."""
    torch.set_num_threads(1)
    qc = qc_layout(get_base_graph(code), Z)
    model = create_corrected_minsum_gnn_decoder(qc_msg.make_plan(qc, device="cpu"),
                                                num_iterations=2, hidden_dim=16)
    dec = fg.make_fused_corrected_gnn_decoder(qc, model, 2, 16, input_injection=False,
                                              device="cpu")
    row_ptr, row_edge, col_ptr, col_edge, shift, col, row, _ = _graph(dec)
    K = qc.num_base_edges
    for ptr, members, table in ((row_ptr, row_edge, qc.row_edges),
                                (col_ptr, col_edge, qc.col_edges)):
        for i, slots in enumerate(table):
            assert members[int(ptr[i]):int(ptr[i + 1])].tolist() == [k for k in slots if k != K]
    assert torch.equal(shift, torch.from_numpy(qc.edge_shift.astype(np.int64)))
    assert torch.equal(col, torch.from_numpy(qc.edge_col.astype(np.int64)))
    assert torch.equal(row, torch.from_numpy(qc.edge_row.astype(np.int64)))


@pytest.mark.parametrize("h,inject", [(16, False), (16, True), (64, False), (64, True)])
def test_pack_corrected_weights_round_trip(h, inject):
    """The packed layout holds vf, cf, ca, va (vl, cl), W2v, W2c of each
    layer, each h rows of h inputs then 8 zeros, and the wrapper packs its
    tables so."""
    T2 = 4
    w = _r(torch.from_numpy(np.random.default_rng(h).standard_normal((T2, 8, h, h), np.float32)))
    packed = fg.pack_corrected_tc_weights(w, inject, "corrected")
    nm = 8 if inject else 6
    assert fg.corrected_tc_matrices(inject, "corrected") == nm
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.shape == (T2, nm * h * (h + 8))
    order = list(range(nm - 2)) + [6, 7]
    assert torch.equal(unpack_corrected_tc_weights(packed, h, inject, "corrected"), w[:, order])
    qc = qc_layout(get_base_graph("toy_4x8"), 4)
    model = create_corrected_minsum_gnn_decoder(qc_msg.make_plan(qc, device="cpu"),
                                                num_iterations=2, hidden_dim=h,
                                                input_injection=inject,
                                                generator=torch.Generator().manual_seed(h))
    tb = fg.make_fused_corrected_gnn_decoder(qc, model, 2, h, input_injection=inject,
                                             device="cpu").tables
    assert torch.equal(tb.w_bf16, fg.pack_corrected_tc_weights(tb.w, inject, "corrected"))
    assert torch.equal(unpack_corrected_tc_weights(tb.w_bf16, h, inject, "corrected"),
                       tb.w[:, order])


def test_corrected_plans():
    """Shared memory of corrected follows make_layout in csrc/fused_gnn_tc.cu:
    graph, inverse degrees, v2c, c2v, LLRs, colsum, embedding, the layer's
    b2v, b2c, pw, pb, its eight (six) padded bf16 matrices and, with
    injection, 16 rows of h floats of pre_llr a warp; no partial, no ebias
    table, no global scratch."""
    qc = qc_layout(get_base_graph("nr_2_0_32"), 32)
    K, C, R, Z = qc.num_base_edges, qc.num_base_cols, qc.num_base_rows, qc.Z
    assert (K, C, R) == (197, 52, 42)
    state = 4 * (1280 + 96 + 2 * K * Z + 2 * C * Z + 128 + 196)
    assert state == 70_544
    weights = 8 * 64 * 72 * 2
    assert weights == 73_728
    assert fg.corrected_smem_bytes("corrected", qc, 64, True) == state + weights + 4096
    assert fg.corrected_smem_bytes("corrected", qc, 64, True, warps=12) == 193_424
    assert fg.corrected_smem_bytes("corrected", qc, 64, False, warps=12) \
        == state + 6 * 64 * 72 * 2
    # nr_2_0_4 Z=4: two blocks of six warps fit an SM's 228 KB (1 KB each reserved)
    qc4 = qc_layout(get_base_graph("nr_2_0_4"), 4)
    assert fg.corrected_smem_bytes("corrected", qc4, 64, True, warps=6) == 113_072
    assert 2 * (113_072 + 1024) <= 228 * 1024
    # h=128 does not fit a block (ROADMAP, hidden widths): the weights alone
    assert fg.corrected_smem_bytes("corrected", qc4, 128, True) > BLOCK_BYTES
    assert 8 * 128 * 136 * 2 > BLOCK_BYTES


def test_corrected_raising_paths():
    """A width without an instantiation (h=128 among them), a code whose
    state does not fit, the card without a card, and an input on another
    device than the decoder's, of another dtype or shape."""
    qc = qc_layout(get_base_graph("toy_4x8"), 4)
    plan = qc_msg.make_plan(qc, device="cpu")
    for h in (32, 128):
        model = create_corrected_minsum_gnn_decoder(plan, num_iterations=2, hidden_dim=h)
        with pytest.raises(ValueError, match="hidden_dim in"):
            fg.make_fused_corrected_gnn_decoder(qc, model, 2, h, device="cpu")
    model = create_corrected_minsum_gnn_decoder(plan, num_iterations=2, hidden_dim=64,
                                                input_injection=True)
    # nr_2_0_32 at Z=96: v2c, c2v, LLRs and colsum are 191,232 B, the weights 73,728 B
    big = qc_layout(get_base_graph("nr_2_0_32"), 96)
    assert fg.corrected_smem_bytes("corrected", big, 64, True) > BLOCK_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        fg.make_fused_corrected_gnn_decoder(big, model, 2, 64, device="cpu")
    model = create_corrected_minsum_gnn_decoder(plan, num_iterations=2, hidden_dim=16,
                                                input_injection=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fg.make_fused_corrected_gnn_decoder(qc, model, 2, 16)
    dec = fg.FusedCorrectedDecoder("corrected", qc, model, 2, 16, False, True, False, False,
                                   torch.device("meta"))
    with pytest.raises(ValueError, match="built for meta"):
        dec(torch.zeros((3, qc.num_vars)))
    cpu = fg.make_fused_corrected_gnn_decoder(qc, model, 2, 16, device="cpu")
    with pytest.raises(TypeError, match="float32"):
        cpu(torch.zeros((3, qc.num_vars), dtype=torch.float64))
    with pytest.raises(ValueError, match="must be"):
        cpu(torch.zeros((3, qc.num_vars + 1)))


# chip_smoke.py's GNN_DEPTH1_ATOL["corrected"]: the kernel against the plain
# version after one iteration at nr_2_0_32 Z=32 h=64, where no flipped
# rounding can cascade.
DEPTH1_ATOL = 1e-4


class _DroppedRounding(fg._Plain):
    """B5's plain version with one bf16 rounding point left out (``dropped``:
    "rmean", "out_v", "out_c" or "lo"): what a kernel with that fault
    computes, in the plain version's order."""

    def __init__(self, dropped: str, dec):
        super().__init__("corrected", dec.qc, dec.tables, dec.num_iterations, dec.hidden_dim,
                         dec.input_injection, dec.early_exit)
        self.dropped = dropped

    def _round(self, point: str, x: torch.Tensor) -> torch.Tensor:
        return x if point == self.dropped else fg._r(x)

    def correction(self, idx, msgs, llr_cz):
        tb, ix, h, Z, B, K = self.tb, self.ix, self.h, self.Z, msgs.shape[0], self.K
        W, small, bias1 = tb.w[idx], tb.small[idx], tb.tab[idx]
        emb_b = tb.emb[h:]
        f = self._features(msgs, emb_b)
        vmean = fg._r(fg._member_sum(f, ix.col_edges, ix.col_valid)
                      * tb.inv[: self.C][None, :, None, None])
        rmean = self._round("rmean", fg._row_sum(f, ix, self.R)
                            * tb.inv[self.C:][None, :, None, None])
        lf = self._features(llr_cz, emb_b)
        pre_col = vmean @ W[3].t() + lf @ W[4].t()
        pre_row = (rmean @ W[2].t()).reshape(B, self.R * Z, h)[:, ix.edge_check]
        pv = (f @ W[0].t() + pre_col[:, ix.cols]) + bias1[0][None, :, None, :]
        pc = (f @ W[1].t() + pre_row.reshape(B, K, Z, h)) + bias1[1][None, :, None, :]
        pc = pc + (lf @ W[5].t())[:, ix.cols]
        ov = self._round("out_v", fg._r(torch.relu(pv)) @ W[6].t() + small[:h])
        oc = self._round("out_c", fg._r(torch.relu(pc)) @ W[7].t() + small[h:2 * h])
        lo = self._round("lo", ov + oc)
        return (lo * small[2 * h:3 * h]).sum(dim=-1) + small[3 * h]


@pytest.mark.parametrize("variant", ["reordered", "rmean", "out_v", "out_c", "lo"])
def test_depth1_bar_separates_order_from_rounding(variant):
    """The one-iteration bar tells a kernel that sums in another order from
    one that drops a bf16 rounding.  On chip_smoke.py's noise-floor shape
    (nr_2_0_32 Z=32 h=64 with injection, a noise-0.02 model, three frames at
    3 dB): the plain version with its hidden units permuted (every product
    and the projection summed in another float32 order; three permutations)
    stays within DEPTH1_ATOL of the plain version, and the plain version with
    any one of B5's roundings after a reordered sum left out leaves it by
    more than twice the bar.  The same `_DroppedRounding` with nothing dropped
    is the plain version exactly."""
    torch.set_num_threads(1)
    qc = qc_layout(get_base_graph("nr_2_0_32"), 32)
    gen = torch.Generator().manual_seed(7)
    model = create_corrected_minsum_gnn_decoder(qc_msg.make_plan(qc, device="cpu"),
                                                num_iterations=1, hidden_dim=64,
                                                input_injection=True, generator=gen)
    with torch.no_grad():
        for param in model.parameters():
            param.add_(0.02 * torch.randn(param.shape, generator=gen))
    llr = bpsk_awgn_llr(torch.Generator().manual_seed(32), torch.zeros((3, qc.num_vars)), 3.0)
    dec = fg.make_fused_corrected_gnn_decoder(qc, model, 1, 64, input_injection=True,
                                              device="cpu")
    soft = dec.plain(llr)
    if variant == "reordered":
        assert torch.equal(_DroppedRounding("", dec).decode(llr)[0], soft)
        errs = [(dec.plain_reordered(llr, torch.randperm(64, generator=torch.Generator()
                                                         .manual_seed(seed))) - soft)
                .abs().max().item() for seed in (1, 2, 3)]
        print(f"depth 1, {variant}: {errs}")  # the readings, with pytest -s
        assert 0.0 < max(errs) <= DEPTH1_ATOL, errs
    else:
        err = (_DroppedRounding(variant, dec).decode(llr)[0] - soft).abs().max().item()
        print(f"depth 1, {variant} not rounded: {err}")
        assert err > 2 * DEPTH1_ATOL, err
