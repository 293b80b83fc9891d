"""B4's tensor-core kernel (csrc/fused_gnn_tc.cu, replaces
ldpc_tpu/ops/pallas_gnn.py:1791 ``_corrected_kernel_v2``) on the CPU: a torch
model of its passes and tiles against the plain version, its packed weights,
its shared-memory plan and its raising paths.

The tile model repeats what the kernel computes from what the wrapper hands
it: the packed bf16 weights unpacked, the graph tensor decoded, the min-sum
skeleton with its running minima, and each correction as the kernel's two
passes over 16-row tiles of flat variables (pass A: the member sums for the
variable mean, pre_col, then per member slot W1vf f + pre_col and the thin
w2pv product into the partial) and of flat checks (pass B: pre_row as the sum
of every member's W1ca product, then per member slot (W1cf f + pre_row) +
W1cl lf and the thin w2pc product, plus the partial and cconst).  On the
exact inputs of ``ops/msg_gnn_exact.py`` it must give the plain version's
soft bits and conv_iter exactly (``torch.equal``): every sum the kernel
reorders is a product, checked exact in any order value by value here
(``_exact_product``, as for B7), and every other operation runs in the plain
version's order, so only an index, shift, gather or rounding-point fault can
make the two differ.
"""
import numpy as np
import pytest
import torch

from test_torch_msg_gnn_tc import _exact_product, _r

from ldpc_tpu_torch.codes import get_base_graph, qc_layout
from ldpc_tpu_torch.models import create_corrected_minsum_gnn_decoder
from ldpc_tpu_torch.ops import fused_gnn as fg, qc_msg
from ldpc_tpu_torch.ops.msg_gnn_exact import CORRECTED_EXACT_CASES, exact_corrected_case

BIG = 1e9


def unpack_corrected_tc_weights(packed: torch.Tensor, h: int, inject: bool,
                                kind: str = "corrected_v2") -> torch.Tensor:
    """The packed (2T, NM * h * (h + 8)) bf16 weights -> (2T, NM, h, h)
    float32 in the order vf, cf, ca, va (vl, cl) (``corrected``: then W2v,
    W2c); the row padding must be zero."""
    nm = fg.corrected_tc_matrices(inject, kind)
    w = packed.to(torch.float32).reshape(packed.shape[0], nm, h, h + 8)
    assert not w[..., h:].any()
    return w[..., :h]


def _graph(dec):
    """The kernel's view of ``tables.graph``: row_ptr, row_edge, col_ptr,
    col_edge, shift, col, row, type."""
    qc = dec.qc
    R, C, K = qc.num_base_rows, qc.num_base_cols, qc.num_base_edges
    g = dec.tables.graph.to(torch.int64)
    sizes = (R + 1, K, C + 1, K, K, K, K, K)
    return torch.split(g[: sum(sizes)], sizes)


class TileModel:
    """corrected_v2_tc_kernel's arithmetic on the CPU, for one decoder."""

    def __init__(self, dec):
        qc, tb = dec.qc, dec.tables
        self.dec, self.h, self.T = dec, dec.hidden_dim, dec.num_iterations
        self.inject, self.early_exit = dec.input_injection, dec.early_exit
        self.Z, self.K, self.C, self.R = qc.Z, qc.num_base_edges, qc.num_base_cols, qc.num_base_rows
        (self.row_ptr, self.row_edge, self.col_ptr, self.col_edge, self.shift, self.col, self.row,
         self.type) = _graph(dec)
        self.W = unpack_corrected_tc_weights(tb.w_bf16, self.h, self.inject, dec.kind)
        self.emb_w, self.emb_b = tb.emb[: self.h], tb.emb[self.h:]
        self.inv_dc, self.inv_dr = tb.inv[: self.C], tb.inv[self.C:]
        self.tb = tb

    def _features(self, m: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """bf16(m * emb_w + bias): m (B, N), bias (N, h) or (h,)."""
        return _r(m[..., None] * self.emb_w + bias)

    def _slots(self, ptr, members, groups: torch.Tensor):
        """Per member slot s of tile rows in ``groups`` (base column or row of
        each row): (valid rows, base edge of each row's member s)."""
        deg = (ptr[1:] - ptr[:-1])[groups]
        for s in range(int(deg.max())):
            ok = deg > s
            yield ok, members[(ptr[groups] + s).clamp(max=self.K - 1)]

    def correction(self, idx: int, msgs: torch.Tensor, out: torch.Tensor, llr: torch.Tensor):
        """out (B, E) += correction of layer idx computed from msgs (B, E).
        The member slots' products are taken in one call per product (rows
        are independent in a tile; the slots only decide which message a row
        reads)."""
        Z, h, tb = self.Z, self.h, self.tb
        Wvf, Wcf, Wca, Wva = self.W[idx, :4]
        small, ebias = tb.small[idx], tb.tab[idx]
        b1v, b1c, w2pv, w2pc, cconst = (small[:h], small[h:2 * h], small[2 * h:3 * h],
                                        small[3 * h:4 * h], small[4 * h])
        B = msgs.shape[0]

        # Pass A, tiles of flat variables v = c*Z + z.
        n = self.C * Z
        vc, vz = torch.arange(n) // Z, torch.arange(n) % Z
        x = torch.zeros((B, n, h))
        rows, edges, types = [], [], []
        for ok, k in self._slots(self.col_ptr, self.col_edge, vc):
            f = self._features(msgs[:, k * Z + vz], ebias[self.type[k]])
            x = torch.where(ok[None, :, None], x + f, x)  # member order
            rows.append(torch.arange(n)[ok])
            edges.append((k * Z + vz)[ok])
            types.append(self.type[k][ok])
        vmean = _r(x * self.inv_dc[vc][:, None])
        pre_col = _exact_product(vmean, Wva) + b1v
        if self.inject:
            pre_col = pre_col + _exact_product(self._features(llr, self.emb_b), self.W[idx, 4])
        rows, edges, types = torch.cat(rows), torch.cat(edges), torch.cat(types)
        f = self._features(msgs[:, edges], ebias[types])
        h1 = _r(torch.relu(_exact_product(f, Wvf) + pre_col[:, rows]))
        part = torch.zeros_like(msgs)
        part[:, edges] = _exact_product(h1, w2pv[None])[..., 0]

        # Pass B, tiles of flat checks r*Z + zc.
        M = self.R * Z
        rr, rz = torch.arange(M) // Z, torch.arange(M) % Z
        feats, rows, edges, variables, types = [], [], [], [], []
        for ok, k in self._slots(self.row_ptr, self.row_edge, rr):
            v = (rz + self.shift[k]) % Z
            f = self._features(msgs[:, k * Z + v], ebias[self.type[k]])
            feats.append(torch.where(ok[None, :, None], f, 0.0))
            rows.append(torch.arange(M)[ok])
            edges.append((k * Z + v)[ok])
            variables.append((self.col[k] * Z + v)[ok])
            types.append(self.type[k][ok])
        # Every member's W1ca product in one sum: one exactness check over all.
        pre_row = _exact_product(torch.cat(feats, dim=-1), Wca.repeat(1, len(feats)))
        pre_row = pre_row * self.inv_dr[rr][:, None] + b1c
        rows, edges, variables = torch.cat(rows), torch.cat(edges), torch.cat(variables)
        f = self._features(msgs[:, edges], ebias[torch.cat(types)])
        pc = _exact_product(f, Wcf) + pre_row[:, rows]
        if self.inject:
            pc = pc + _exact_product(self._features(llr[:, variables], self.emb_b), self.W[idx, 5])
        th = _exact_product(_r(torch.relu(pc)), w2pc[None])[..., 0]
        out[:, edges] = out[:, edges] + ((part[:, edges] + th) + cconst)

    def decode(self, llr: torch.Tensor):
        """(B, n) -> (soft, conv_iter), frames stopping alone as in the kernel."""
        Z, K, C, T = self.Z, self.K, self.C, self.T
        alpha, w_ch = self.tb.alpha, self.tb.w_ch
        B, n = llr.shape
        E = K * Z
        ek, ez = torch.arange(E) // Z, torch.arange(E) % Z
        var = self.col[ek] * Z + ez  # each message's variable
        v2c = llr[:, var].clone()
        c2v = torch.zeros_like(v2c)
        conv = torch.zeros(B)
        soft = torch.zeros_like(llr)
        colsum = torch.zeros_like(llr)
        live = torch.ones(B, dtype=torch.bool)
        zs = torch.arange(Z)
        for t in range(T):
            for r in range(self.R):  # check half: running m1/m2 in member order
                ks = self.row_edge[int(self.row_ptr[r]): int(self.row_ptr[r + 1])]
                idx = [int(k) * Z + (zs + self.shift[k]) % Z for k in ks]
                m1 = torch.full((B, Z), BIG)
                m2 = torch.full((B, Z), BIG)
                sp = torch.ones((B, Z))
                for i in idx:
                    x = v2c[:, i]
                    mag = x.abs()
                    sp = sp * torch.where(x < 0, -1.0, 1.0)
                    m2 = torch.minimum(torch.maximum(mag, m1), m2)
                    m1 = torch.minimum(mag, m1)
                for i in idx:
                    x = v2c[:, i]
                    loo = torch.where(x.abs() > m1, m1, m2)
                    loo = torch.where(loo < BIG, loo, 0.0)
                    c2v[:, i] = alpha * sp * torch.where(x < 0, -1.0, 1.0) * loo
            self.correction(2 * t, v2c, c2v, llr)
            colsum = torch.zeros_like(llr)
            for c in range(C):
                for j in range(int(self.col_ptr[c]), int(self.col_ptr[c + 1])):
                    colsum[:, c * Z: (c + 1) * Z] += c2v[:, int(self.col_edge[j]) * Z + zs]
            if self.early_exit:
                hard = (llr + colsum) < 0
                odd = torch.zeros((B, self.R * Z), dtype=torch.bool)
                for r in range(self.R):
                    for j in range(int(self.row_ptr[r]), int(self.row_ptr[r + 1])):
                        k = int(self.row_edge[j])
                        odd[:, r * Z + zs] ^= hard[:, int(self.col[k]) * Z + (zs + self.shift[k]) % Z]
                stop = live & ~odd.any(dim=1)
                soft[stop] = hard[stop].float()
                conv[stop] = t + 1
                live &= ~stop
            if t + 1 == T:
                break
            v2c = (colsum[:, var] - c2v) + w_ch * llr[:, var]
            self.correction(2 * t + 1, c2v, v2c, llr)
        soft[live] = (1.0 / (1.0 + torch.exp(llr + colsum)))[live]
        conv[live] = float(T)
        return soft, conv


@pytest.mark.parametrize("code,Z,h,batch,inject,share,early_exit", CORRECTED_EXACT_CASES)
def test_tile_model_equals_plain_on_exact_inputs(code, Z, h, batch, inject, share, early_exit):
    """The two passes, their tiles and gathers, the check's sum of products
    and the packed weights give the plain version's soft bits and conv_iter
    exactly; the decode is not trivial (both decisions present, soft bits
    not all saturated, early exit stopping some frames and not others)."""
    torch.set_num_threads(1)
    qc = qc_layout(get_base_graph(code), Z)
    model, llr = exact_corrected_case(qc, h, batch, inject, share)
    dec = fg.make_fused_corrected_gnn_decoder_v2(qc, model, 2, h, share_layers=share,
                                                 input_injection=inject, early_exit=early_exit,
                                                 return_iterations=early_exit, device="cpu")
    x = torch.from_numpy(llr)
    plain = dec(x)
    soft_p, conv_p = plain if early_exit else (plain, None)
    soft_m, conv_m = TileModel(dec).decode(x)
    assert torch.equal(soft_m, soft_p)
    decided = soft_p > 0.5
    assert decided.any() and (~decided).any()
    assert ((soft_p - 0.5).abs() < 0.45).float().mean() > 0.05
    if early_exit:
        assert torch.equal(conv_m, conv_p)
        assert (conv_p == 1).any() and (conv_p == 2).any()


@pytest.mark.parametrize("h,inject", [(16, False), (16, True), (64, False), (64, True)])
def test_pack_corrected_tc_weights_round_trip(h, inject):
    """The packed layout holds vf, cf, ca, va (vl, cl) of each layer, each h
    rows of h inputs then 8 zeros."""
    T2 = 4
    w = _r(torch.from_numpy(np.random.default_rng(h).standard_normal((T2, 6, h, h), np.float32)))
    packed = fg.pack_corrected_tc_weights(w, inject)
    nm = 6 if inject else 4
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.shape == (T2, nm * h * (h + 8))
    assert torch.equal(unpack_corrected_tc_weights(packed, h, inject), w[:, :nm])


def test_corrected_tc_plans():
    """Shared memory of corrected_v2 follows make_layout in
    csrc/fused_gnn_tc.cu; it takes no global scratch."""
    qc = qc_layout(get_base_graph("nr_2_0_32"), 32)
    K, C, R, Z = qc.num_base_edges, qc.num_base_cols, qc.num_base_rows, qc.Z
    assert (K, C, R, qc.num_edge_types) == (197, 52, 42, 32)
    # graph, inverse degrees, v2c, c2v, partial, LLRs, colsum, emb, small, ebias
    state = 4 * (1280 + 96 + 3 * K * Z + 2 * C * Z + 128 + 260 + 32 * 64)
    assert state == 104_208
    assert fg.corrected_smem_bytes("corrected_v2", qc, 64, True) == state + 6 * 64 * 72 * 2
    assert fg.corrected_smem_bytes("corrected_v2", qc, 64, False) == state + 4 * 64 * 72 * 2
    assert fg.corrected_smem_bytes("corrected_v2", qc, 64, True) == 159_504
    # nr_2_0_4 Z=4: three blocks of an SM's 228 KB
    qc4 = qc_layout(get_base_graph("nr_2_0_4"), 4)
    assert 3 * fg.corrected_smem_bytes("corrected_v2", qc4, 64, True) < 228 * 1024 - 3 * 1024
    # h=128 does not fit a block (ROADMAP, hidden widths)
    assert fg.corrected_smem_bytes("corrected_v2", qc, 128, True) > 232_448


def test_corrected_tc_raising_paths():
    """A width without an instantiation, a code whose state does not fit, the
    card without a card, and an input on another device than the decoder's,
    of another dtype or shape."""
    qc = qc_layout(get_base_graph("toy_4x8"), 4)
    plan = qc_msg.make_plan(qc, device="cpu")
    model = create_corrected_minsum_gnn_decoder(plan, num_iterations=2, hidden_dim=32)
    with pytest.raises(ValueError, match="hidden_dim in"):
        fg.make_fused_corrected_gnn_decoder_v2(qc, model, 2, 32, device="cpu")
    model = create_corrected_minsum_gnn_decoder(plan, num_iterations=2, hidden_dim=16,
                                                input_injection=True)
    big = qc_layout(get_base_graph("nr_2_0_32"), 96)
    with pytest.raises(ValueError, match="shared memory"):
        fg.make_fused_corrected_gnn_decoder_v2(big, model, 2, 16, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fg.make_fused_corrected_gnn_decoder_v2(qc, model, 2, 16)
    dec = fg.FusedCorrectedDecoder("corrected_v2", qc, model, 2, 16, False, True, False, False,
                                   torch.device("meta"))
    with pytest.raises(ValueError, match="built for meta"):
        dec(torch.zeros((3, qc.num_vars)))
    cpu = fg.make_fused_corrected_gnn_decoder_v2(qc, model, 2, 16, device="cpu")
    with pytest.raises(TypeError, match="float32"):
        cpu(torch.zeros((3, qc.num_vars), dtype=torch.float64))
    with pytest.raises(ValueError, match="must be"):
        cpu(torch.zeros((3, qc.num_vars + 1)))
