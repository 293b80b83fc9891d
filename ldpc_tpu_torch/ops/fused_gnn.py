"""Fused corrected min-sum GNN decoders: the whole decode of the flagship
model in one CUDA kernel (counterpart of the corrected half of
``ldpc_tpu.ops.pallas_gnn``).

Two hand-written kernels live in ``csrc/fused_gnn.cu``:

* ``corrected_v2`` (replaces ``pallas_gnn._corrected_kernel_v2``): min-sum
  half-updates in exact float32 plus a GNN correction per half-update, the
  second MLP layer and the projection folded into one thin product.
* ``corrected`` (replaces ``pallas_gnn._corrected_kernel``): the same
  decoder with the second layer not folded: full (h, h) products, bf16 layer
  outputs, float32 projection.

Both serve a trained :class:`ldpc_tpu_torch.models.message_gnn.MessageGNNDecoder`
with ``var_mode = check_mode = "corrected"``, ``depth_L = 0``, ``damping = 1``
(``create_corrected_minsum_gnn_decoder``).  ``params`` is that module or its
``state_dict``.  Input (B, n) float32 LLRs; output (B, n) float32 soft bits
(probabilities of bit 1) and, with ``return_iterations``, (B,) float32
``conv_iter``.

Each builder returns a :class:`FusedCorrectedDecoder`.  Called on a CUDA
tensor it launches its kernel (and raises if the launch fails); called on a
CPU tensor it runs the kernel's plain PyTorch version, which repeats the
kernel's arithmetic with the same bf16 rounding points in the same order.
``plain(llr)`` runs the plain version on any device, for comparisons; it
walks a large batch in chunks.  ``LAUNCHES`` counts kernel launches per
kernel name.

bf16 rounding points of both versions, in order: the embedded features of a
message, the per-variable mean, the LLR features, ``corrected``'s per-check
mean, the ReLU outputs, ``corrected``'s two second-layer outputs and their
sum.  The first- and second-layer weights, and ``corrected_v2``'s folded
``w2p`` and ``cconst``, are rounded to bf16 when the decoder is built.
Products accumulate in float32.
"""
from __future__ import annotations

import ctypes
from collections.abc import Mapping

import numpy as np
import torch

from ldpc_tpu_torch._device import resolve_device
from ldpc_tpu_torch.codes.edge_layout import QCLayout
from ldpc_tpu_torch.ops.fused_minsum import _SMEM_BUDGET, _structure
from ldpc_tpu_torch.ops.qc_msg import _BIG

LAUNCHES: dict[str, int] = {"corrected_v2": 0, "corrected": 0}

KERNEL_HIDDEN_DIMS = (16, 64)  # instantiations in csrc/fused_gnn.cu
VARIANT = {"corrected_v2": 2, "corrected": 1}
_ENTRY = {"corrected_v2": "ldpc_corrected_gnn_v2", "corrected": "ldpc_corrected_gnn"}
_PLAIN_CHUNK_BYTES = 64 * 2**20  # one (frames, K, Z, h) float32 tensor of the plain version


# ---------------------------------------------------------------------------
# Parameters -> packed numpy tables (the JAX package's _extract_* functions)
# ---------------------------------------------------------------------------


def _np_params(params) -> dict[str, np.ndarray]:
    """Module or state_dict -> float32 numpy arrays by state_dict name."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    if not isinstance(params, Mapping):
        raise TypeError("params must be a MessageGNNDecoder or its state_dict")
    return {k: np.asarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v,
                          dtype=np.float32) for k, v in params.items()}


def _layer_names(num_iterations: int, share_layers: bool):
    """(packed index, state_dict prefix) of the 2T half-update layers:
    index 2t is iteration t's check half, 2t + 1 its var half."""
    for t in range(num_iterations):
        for half, prefix in ((0, "check"), (1, "var")):
            yield 2 * t + half, prefix if share_layers else f"{prefix}_{t}"


def _common(p: dict, h: int) -> dict:
    return dict(
        emb_w=p["input_embedding.weight"].reshape(h),
        emb_b=p["input_embedding.bias"].reshape(h),
        w_ch=float(p["w_ch"].reshape(())),
        alpha=float(p["alpha"].reshape(())),
    )


def _extract_corrected(params, qc: QCLayout, num_iterations: int, hidden_dim: int,
                       share_layers: bool, input_injection: bool) -> dict:
    """Parameters of a corrected MessageGNNDecoder -> the ``corrected``
    kernel's tables (float32, unrounded).  Type embeddings are folded into
    per-edge first-layer biases ``bias1v`` / ``bias1c`` (2T, h, K)."""
    p = _np_params(params)
    h, T, K = hidden_dim, num_iterations, qc.num_base_edges
    h_in = 3 * h if input_injection else 2 * h
    col_members = [[] for _ in range(qc.num_base_cols)]
    row_members = [[] for _ in range(qc.num_base_rows)]
    for k in range(K):
        col_members[qc.edge_col[k]].append(k)
        row_members[qc.edge_row[k]].append(k)

    T2 = 2 * T
    out = dict(
        W1v=np.zeros((T2, h, h_in), np.float32), W2v=np.zeros((T2, h, h), np.float32),
        W1c=np.zeros((T2, h, h_in), np.float32), W2c=np.zeros((T2, h, h), np.float32),
        b2v=np.zeros((T2, h), np.float32), b2c=np.zeros((T2, h), np.float32),
        bias1v=np.zeros((T2, h, K), np.float32), bias1c=np.zeros((T2, h, K), np.float32),
        proj_w=np.zeros((T2, h), np.float32), proj_b=np.zeros((T2,), np.float32),
    )
    for idx, name in _layer_names(T, share_layers):
        out["proj_w"][idx] = p[f"{name}_proj.weight"].reshape(h)
        out["proj_b"][idx] = float(p[f"{name}_proj.bias"].reshape(()))
        te_edge = p[f"{name}_gnn.message_type_embeddings"][np.asarray(qc.edge_type)]
        te_var = np.stack([te_edge[col_members[qc.edge_col[k]]].mean(axis=0) for k in range(K)])
        te_chk = np.stack([te_edge[row_members[qc.edge_row[k]]].mean(axis=0) for k in range(K)])
        for rel, s, te_agg in (("var_to_check_update", "v", te_var),
                               ("check_to_var_update", "c", te_chk)):
            w1 = p[f"{name}_gnn.{rel}.Dense_0.weight"]  # (h, h_in)
            out[f"W1{s}"][idx] = w1
            out[f"W2{s}"][idx] = p[f"{name}_gnn.{rel}.Dense_1.weight"]
            out[f"b2{s}"][idx] = p[f"{name}_gnn.{rel}.Dense_1.bias"]
            te_cat = np.zeros((K, h_in), np.float32)
            te_cat[:, :h] = te_edge
            te_cat[:, h:2 * h] = te_agg
            out[f"bias1{s}"][idx] = (te_cat @ w1.T + p[f"{name}_gnn.{rel}.Dense_0.bias"]).T
    return dict(_common(p, h), h_in=h_in, **out)


def _extract_corrected_v2(params, qc: QCLayout, num_iterations: int, hidden_dim: int,
                          share_layers: bool, input_injection: bool) -> dict:
    """Parameters -> the ``corrected_v2`` kernel's tables (float32,
    unrounded): raw first-layer blocks, per-edge embedding bias ``ebias``
    (emb_b + type embedding), the folded thin second layer ``w2p`` =
    pw^T [W2v W2c] and its constant ``cconst`` = pw . (b2v + b2c) + pb."""
    p = _np_params(params)
    h, T, K = hidden_dim, num_iterations, qc.num_base_edges
    T2 = 2 * T
    out = {name: np.zeros((T2, h, h), np.float32)
           for name in ("W1vf", "W1cf", "W1va", "W1ca", "W1vl", "W1cl")}
    out.update(b1v=np.zeros((T2, h), np.float32), b1c=np.zeros((T2, h), np.float32),
               w2p=np.zeros((T2, 2 * h), np.float32), cconst=np.zeros((T2,), np.float32),
               ebias=np.zeros((T2, h, K), np.float32))
    com = _common(p, h)
    for idx, name in _layer_names(T, share_layers):
        pw = p[f"{name}_proj.weight"].reshape(h)
        pb = float(p[f"{name}_proj.bias"].reshape(()))
        te = p[f"{name}_gnn.message_type_embeddings"]
        out["ebias"][idx] = com["emb_b"][:, None] + te[np.asarray(qc.edge_type)].T
        b2sum = np.zeros(h, np.float32)
        for rel, s, half in (("var_to_check_update", "v", slice(0, h)),
                             ("check_to_var_update", "c", slice(h, 2 * h))):
            w1 = p[f"{name}_gnn.{rel}.Dense_0.weight"]  # (h, 2h or 3h)
            out[f"W1{s}f"][idx] = w1[:, 0:h]
            out[f"W1{s}a"][idx] = w1[:, h:2 * h]
            if input_injection:
                out[f"W1{s}l"][idx] = w1[:, 2 * h:3 * h]
            out[f"b1{s}"][idx] = p[f"{name}_gnn.{rel}.Dense_0.bias"]
            out["w2p"][idx, half] = pw @ p[f"{name}_gnn.{rel}.Dense_1.weight"]
            b2sum += p[f"{name}_gnn.{rel}.Dense_1.bias"]
        out["cconst"][idx] = float(pw @ b2sum) + pb
    return dict(com, **out)


# ---------------------------------------------------------------------------
# Packed device tables shared by a kernel and its plain version
# ---------------------------------------------------------------------------


def _bf16_round(x: np.ndarray) -> torch.Tensor:
    """float32 numpy -> float32 tensor holding the bf16-rounded values."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).to(
        torch.float32)


class _Tables:
    """What a launch and the plain version read, on one device.

    ``w`` (2T, NW, h, h): the layer's weight matrices, values already rounded
    to bf16, kept as float32 for the plain version and as bf16 (``w_bf16``)
    for the kernel; order vf, cf, ca, va, vl, cl[, W2v, W2c].
    ``small`` (2T, 4h + 4) for corrected_v2: b1v, b1c, w2p (v, c), cconst;
    (2T, 3h + 4) for corrected: b2v, b2c, pw, pb.
    ``tab``: corrected_v2's ebias per message type (2T, types, h);
    corrected's per-edge first-layer biases (2T, 2, K, h).
    """

    def __init__(self, kind: str, qc: QCLayout, params, T: int, h: int, share_layers: bool,
                 input_injection: bool, device: torch.device):
        K = qc.num_base_edges
        T2 = 2 * T
        pad = np.zeros((T2, 3), np.float32)
        if kind == "corrected_v2":
            x = _extract_corrected_v2(params, qc, T, h, share_layers, input_injection)
            w = np.stack([x[name] for name in ("W1vf", "W1cf", "W1ca", "W1va", "W1vl", "W1cl")],
                         axis=1)
            folded = _bf16_round(np.concatenate([x["w2p"], x["cconst"][:, None]], axis=1)).numpy()
            small = np.concatenate([x["b1v"], x["b1c"], folded, pad], axis=1)
            # ebias is per edge in the JAX tables; edges of one type share it.
            first_of_type = np.array([int(np.nonzero(qc.edge_type == ty)[0][0])
                                      for ty in range(qc.num_edge_types)])
            tab = np.ascontiguousarray(x["ebias"][:, :, first_of_type].transpose(0, 2, 1))
        else:
            x = _extract_corrected(params, qc, T, h, share_layers, input_injection)
            w1v, w1c = x["W1v"], x["W1c"]
            zero = np.zeros((T2, h, h), np.float32)
            w = np.stack([w1v[:, :, 0:h], w1c[:, :, 0:h], w1c[:, :, h:2 * h], w1v[:, :, h:2 * h],
                          w1v[:, :, 2 * h:3 * h] if input_injection else zero,
                          w1c[:, :, 2 * h:3 * h] if input_injection else zero,
                          x["W2v"], x["W2c"]], axis=1)
            small = np.concatenate([x["b2v"], x["b2c"], x["proj_w"], x["proj_b"][:, None], pad],
                                   axis=1)
            tab = np.ascontiguousarray(
                np.stack([x["bias1v"], x["bias1c"]], axis=1).transpose(0, 1, 3, 2))
        self.w_ch, self.alpha = x["w_ch"], x["alpha"]
        self.w = _bf16_round(w).to(device)
        self.w_bf16 = self.w.to(torch.bfloat16).contiguous()
        self.small = torch.from_numpy(np.ascontiguousarray(small, np.float32)).to(device)
        self.tab = torch.from_numpy(np.ascontiguousarray(tab, np.float32)).to(device)
        self.emb = torch.from_numpy(np.concatenate([x["emb_w"], x["emb_b"]])).to(device)
        # Inverse degrees as the kernels multiply by them: float32(1 / d).
        deg_c = np.maximum((qc.col_edges != K).sum(axis=1), 1)
        deg_r = np.maximum((qc.row_edges != K).sum(axis=1), 1)
        self.inv = torch.from_numpy(
            np.concatenate([1.0 / deg_c, 1.0 / deg_r]).astype(np.float32)).to(device)
        st = _structure(qc)
        row_ptr = np.cumsum([0] + [len(m) for m in st.row_members])
        col_ptr = np.cumsum([0] + [len(m) for m in st.col_members])
        parts = [row_ptr, [k for m in st.row_members for k in m],
                 col_ptr, [k for m in st.col_members for k in m],
                 st.shifts, st.cols, qc.edge_row, qc.edge_type]
        self.graph = torch.from_numpy(
            np.concatenate([np.asarray(x_, dtype=np.int32) for x_ in parts])).to(device)


def corrected_smem_bytes(kind: str, qc: QCLayout, hidden_dim: int) -> int:
    """Dynamic shared memory of one block (mirrors make_layout in
    csrc/fused_gnn.cu): graph, inverse degrees, v2c, c2v, LLRs, column sums,
    embedding, the layer's small vectors, corrected_v2's ebias table and the
    layer's 6 or 8 (h, h) weight matrices, all 4-byte words."""
    def r4(x):
        return -(-x // 4) * 4

    K, Z, C, R, h = qc.num_base_edges, qc.Z, qc.num_base_cols, qc.num_base_rows, hidden_dim
    v2 = kind == "corrected_v2"
    words = (r4(6 * K + R + C + 2) + r4(C + R) + 2 * r4(K * Z) + 2 * r4(C * Z) + 2 * h
             + (4 * h + 4 if v2 else 3 * h + 4) + (r4(qc.num_edge_types * h) if v2 else 0)
             + (6 if v2 else 8) * h * h)
    return 4 * words


def corrected_scratch_floats(qc: QCLayout, hidden_dim: int) -> int:
    """Global scratch of one resident block: the per-variable and per-check
    first-layer terms of one frame."""
    return (2 * qc.num_base_cols + qc.num_base_rows) * hidden_dim * qc.Z


# ---------------------------------------------------------------------------
# Plain PyTorch version of the kernels
# ---------------------------------------------------------------------------


class _PlainIndex:
    """Index tensors of the padded member tables, on one device."""

    def __init__(self, qc: QCLayout, device: torch.device):
        K, Z = qc.num_base_edges, qc.Z

        def t(a, dtype=np.int64):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype), device=device)

        self.cols = t(qc.edge_col)
        self.types = t(qc.edge_type)
        self.rows = t(qc.edge_row)
        self.col_edges = t(qc.col_edges)  # (C, dv) pad = K
        self.col_valid = t(qc.col_edges != K, bool)
        self.row_gather = t(qc.row_gather_var)  # (R, dr, Z) into K*Z (+1 pad slot)
        self.row_valid = t(qc.row_edges != K, bool)  # (R, dr)
        self.ungroup = t(qc.ungroup_to_var.reshape(-1))  # (K*Z,) into R*dr*Z
        z = np.arange(Z)[None, :]
        # check lane of message (k, z): (z - shift) mod Z, flat into (R*Z)
        self.edge_check = t((qc.edge_row[:, None] * Z
                             + (z - qc.edge_shift[:, None]) % Z).reshape(-1))


def _r(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16, keep float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _check_half(v2c: torch.Tensor, ix: _PlainIndex, alpha: float) -> torch.Tensor:
    """Scaled min-sum check update, (B, K, Z) -> (B, K, Z).  m1 and m2 are
    the two smallest magnitudes of a check, whatever the order they are
    found in, so this equals the kernel's running update bit for bit."""
    B, K, Z = v2c.shape
    R, D, _ = ix.row_gather.shape
    padded = torch.cat([v2c.reshape(B, K * Z), v2c.new_zeros((B, 1))], dim=1)
    x = padded[:, ix.row_gather.reshape(-1)].reshape(B, R, D, Z)
    valid = ix.row_valid[None, :, :, None]
    mag = torch.where(valid, x.abs(), _BIG)
    sgn = torch.where((x < 0) & valid, -1.0, 1.0)
    sp = torch.prod(sgn, dim=2, keepdim=True)
    if D > 1:
        low = torch.topk(mag, 2, dim=2, largest=False).values
        m1, m2 = low[:, :, 0:1], low[:, :, 1:2]
    else:
        m1, m2 = mag, torch.full_like(mag, _BIG)
    loo = torch.where(mag > m1, m1, m2)
    loo = torch.where(loo < _BIG, loo, 0.0)
    out = alpha * sp * sgn * loo
    return out.reshape(B, R * D * Z)[:, ix.ungroup].reshape(B, K, Z)


def _member_sum(x: torch.Tensor, members: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Sequential float32 sum over padded member slots: x (B, K, ...) ->
    (B, G, ...), members (G, d) with pads masked by ``valid``."""
    acc = None
    for j in range(members.shape[1]):
        v = valid[:, j].reshape((1, -1) + (1,) * (x.dim() - 2))
        term = torch.where(v, x[:, members[:, j].clamp(max=x.shape[1] - 1)], 0.0)
        acc = term if acc is None else acc + term
    return acc


class _Plain:
    """The plain version of one kernel for one decoder."""

    def __init__(self, kind: str, qc: QCLayout, tables: _Tables, T: int, h: int, inject: bool,
                 early_exit: bool):
        self.kind, self.T, self.h, self.inject, self.early_exit = kind, T, h, inject, early_exit
        self.tb = tables
        self.ix = _PlainIndex(qc, tables.w.device)
        self.Z, self.C, self.R, self.K = qc.Z, qc.num_base_cols, qc.num_base_rows, qc.num_base_edges

    def _features(self, msgs: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        emb_w = self.tb.emb[: self.h]
        return _r(msgs[..., None] * emb_w + bias)

    def correction(self, idx: int, msgs: torch.Tensor, llr_cz: torch.Tensor) -> torch.Tensor:
        """(B, K, Z) messages -> (B, K, Z) additive corrections of layer idx."""
        tb, ix, h, Z = self.tb, self.ix, self.h, self.Z
        B, K = msgs.shape[0], self.K
        v2 = self.kind == "corrected_v2"
        W = tb.w[idx]
        Wvf, Wcf, Wca, Wva, Wvl, Wcl = (W[i].t() for i in range(6))
        emb_b = tb.emb[h:]
        inv_dc = tb.inv[: self.C][None, :, None, None]
        inv_dr = tb.inv[self.C:][None, :, None, None]
        small = tb.small[idx]
        bias = tb.tab[idx][ix.types][None, :, None, :] if v2 else emb_b
        f = self._features(msgs, bias)  # (B, K, Z, h)

        vmean = _r(_member_sum(f, ix.col_edges, ix.col_valid) * inv_dc)  # (B, C, Z, h)
        f_pad = torch.cat([f.reshape(B, K * Z, h), f.new_zeros((B, 1, h))], dim=1)
        rsum = None
        for j in range(ix.row_gather.shape[1]):  # row order; the pad slot adds 0
            term = f_pad[:, ix.row_gather[:, j].reshape(-1)].reshape(B, self.R, Z, h)
            rsum = term if rsum is None else rsum + term

        pre_col = vmean @ Wva
        if v2:
            pre_col = pre_col + small[:h]
            pre_row = (rsum @ Wca) * inv_dr + small[h:2 * h]
        else:
            pre_row = _r(rsum * inv_dr) @ Wca
        pre_llr = None
        if self.inject:
            lf = self._features(llr_cz, emb_b)  # (B, C, Z, h)
            pre_col = pre_col + lf @ Wvl
            pre_llr = (lf @ Wcl)[:, ix.cols]
        pre_row_e = pre_row.reshape(B, self.R * Z, h)[:, ix.edge_check].reshape(B, K, Z, h)

        pv = f @ Wvf + pre_col[:, ix.cols]
        pc = f @ Wcf + pre_row_e
        if v2:
            if pre_llr is not None:
                pc = pc + pre_llr
            h1v, h1c = _r(torch.relu(pv)), _r(torch.relu(pc))
            return (h1v @ small[2 * h:3 * h] + h1c @ small[3 * h:4 * h]) + small[4 * h]
        bias1 = tb.tab[idx]  # (2, K, h)
        pv = pv + bias1[0][None, :, None, :]
        pc = pc + bias1[1][None, :, None, :]
        if pre_llr is not None:
            pc = pc + pre_llr
        ov = _r(_r(torch.relu(pv)) @ W[6].t() + small[:h])
        oc = _r(_r(torch.relu(pc)) @ W[7].t() + small[h:2 * h])
        lo = _r(ov + oc)
        return (lo * small[2 * h:3 * h]).sum(dim=-1) + small[3 * h]

    def decode(self, llr: torch.Tensor):
        """(B, n) -> (soft (B, n), conv_iter (B,) float32)."""
        tb, ix, T = self.tb, self.ix, self.T
        B, n = llr.shape
        llr_cz = llr.reshape(B, self.C, self.Z)
        edge_llr = llr_cz[:, ix.cols]
        v2c = edge_llr.clone()
        conv = torch.zeros((B,), dtype=torch.float32, device=llr.device)
        frozen = torch.zeros_like(llr)
        colsum = torch.zeros_like(llr_cz)
        for t in range(T):
            c2v = _check_half(v2c, ix, tb.alpha)
            c2v = c2v + self.correction(2 * t, v2c, llr_cz)
            colsum = _member_sum(c2v, ix.col_edges, ix.col_valid)
            if self.early_exit:
                hard = (llr_cz + colsum) < 0
                padded = torch.cat([hard[:, ix.cols].reshape(B, -1),
                                    hard.new_zeros((B, 1))], dim=1)
                member_bits = padded[:, ix.row_gather.reshape(-1)].reshape(
                    (B,) + tuple(ix.row_gather.shape))
                odd = member_bits.sum(dim=2) % 2 == 1
                newly = ~odd.reshape(B, -1).any(dim=1) & (conv == 0)
                frozen = torch.where(newly[:, None], hard.reshape(B, n).to(torch.float32), frozen)
                conv = torch.where(newly, float(t + 1), conv)
                if bool((conv > 0).all()):
                    break
            if t + 1 == T:
                break  # the last var half feeds nothing
            v2c = (colsum[:, ix.cols] - c2v) + tb.w_ch * edge_llr
            v2c = v2c + self.correction(2 * t + 1, c2v, llr_cz)
        soft = 1.0 / (1.0 + torch.exp(llr + colsum.reshape(B, n)))
        converged = conv > 0
        soft = torch.where(converged[:, None], frozen, soft)
        return soft, torch.where(converged, conv, float(T))


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# H, llr, soft, conv, counter, scratch, graph, inv, w, tab, small, emb,
# B, Z, R, C, K, ntypes, T, inject, early_exit, w_ch, alpha, grid, stream
_LAUNCH = ([_I] + [_P] * 11 + [_I] * 9 + [_F, _F, _I, _P], _I)
_SIGNATURES = {
    "ldpc_corrected_gnn_v2": _LAUNCH,
    "ldpc_corrected_gnn": _LAUNCH,
    # variant, H, Z, R, C, K, ntypes
    "ldpc_corrected_gnn_smem_bytes": ([_I] * 7, ctypes.c_longlong),
    "ldpc_corrected_gnn_scratch_floats": ([_I] * 4, ctypes.c_longlong),
    "ldpc_corrected_gnn_occupancy": ([_I] * 7, _I),
    "ldpc_gnn_cuda_error_string": ([_I], ctypes.c_char_p),
}


def kernel_library():
    """The compiled ``csrc/fused_gnn.cu``, built on first use."""
    from ldpc_tpu_torch.ops import _build

    return _build.load("fused_gnn", _SIGNATURES)


class FusedCorrectedDecoder:
    """``decode(llr) -> soft`` or, with ``return_iterations``, ``(soft,
    conv_iter)``: soft bits (B, n) float32, ``conv_iter`` (B,) float32 as the
    JAX builders return it (1-based first iteration with a valid syndrome;
    ``num_iterations`` for frames that never converged).

    Launches the ``kind`` kernel for CUDA tensors and runs the plain version
    for CPU tensors; ``plain(llr)`` runs the plain version on any device.
    """

    def __init__(self, kind: str, qc: QCLayout, params, num_iterations: int, hidden_dim: int,
                 share_layers: bool, input_injection: bool, early_exit: bool,
                 return_iterations: bool, device: torch.device):
        self.kind = kind
        self.qc = qc
        self.n = qc.num_vars
        self.num_iterations = int(num_iterations)
        self.hidden_dim = int(hidden_dim)
        self.input_injection = bool(input_injection)
        self.early_exit = bool(early_exit)
        self.return_iterations = bool(return_iterations)
        self.tables = _Tables(kind, qc, params, self.num_iterations, self.hidden_dim,
                              share_layers, self.input_injection, device)
        self._plain: _Plain | None = None
        self._grid: int | None = None

    def _check_llr(self, llr: torch.Tensor) -> None:
        if llr.device != self.tables.w.device:
            raise ValueError(f"decoder was built for {self.tables.w.device}, "
                             f"llr is on {llr.device}")
        if llr.dtype != torch.float32:
            raise TypeError(f"llr must be float32, got {llr.dtype}")
        if llr.ndim != 2 or llr.shape[1] != self.n:
            raise ValueError(f"llr must be (B, {self.n}), got {tuple(llr.shape)}")

    def _result(self, soft, conv):
        return (soft, conv) if self.return_iterations else soft

    def __call__(self, llr: torch.Tensor):
        self._check_llr(llr)
        if llr.device.type == "cuda":
            return self._result(*self._launch(llr))
        return self._result(*self._run_plain(llr))

    def plain(self, llr: torch.Tensor):
        self._check_llr(llr)
        return self._result(*self._run_plain(llr))

    def _run_plain(self, llr: torch.Tensor):
        if self._plain is None:
            self._plain = _Plain(self.kind, self.qc, self.tables, self.num_iterations,
                                 self.hidden_dim, self.input_injection, self.early_exit)
        plain = self._plain
        per_frame = self.qc.num_edges * self.hidden_dim * 4
        chunk = max(1, _PLAIN_CHUNK_BYTES // per_frame)
        with torch.no_grad():
            outs = [plain.decode(llr[i:i + chunk]) for i in range(0, llr.shape[0], chunk)]
        if not outs:
            return torch.empty_like(llr), llr.new_empty((0,))
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    def _launch(self, llr: torch.Tensor):
        if not llr.is_contiguous():
            raise ValueError("llr must be contiguous")
        qc, h = self.qc, self.hidden_dim
        B = llr.shape[0]
        soft = torch.empty_like(llr)
        conv = torch.empty((B,), dtype=torch.float32, device=llr.device)
        if B == 0:
            return soft, conv
        tb = self.tables
        lib = kernel_library()
        variant = VARIANT[self.kind]
        dims = (qc.Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges, qc.num_edge_types)
        with torch.cuda.device(llr.device):
            if self._grid is None:
                per_sm = lib.ldpc_corrected_gnn_occupancy(variant, h, *dims)
                if per_sm < 1:
                    raise RuntimeError(
                        f"{self.kind} kernel cannot be resident (occupancy query gave {per_sm})")
                sms = torch.cuda.get_device_properties(llr.device).multi_processor_count
                self._grid = per_sm * sms
            grid = min(B, self._grid)
            counter = torch.zeros((1,), dtype=torch.int32, device=llr.device)
            scratch = torch.empty((grid * corrected_scratch_floats(qc, h),),
                                  dtype=torch.float32, device=llr.device)
            stream = torch.cuda.current_stream(llr.device).cuda_stream
            rc = getattr(lib, _ENTRY[self.kind])(
                h, llr.data_ptr(), soft.data_ptr(),
                conv.data_ptr() if self.return_iterations else None, counter.data_ptr(),
                scratch.data_ptr(), tb.graph.data_ptr(), tb.inv.data_ptr(),
                tb.w_bf16.data_ptr(), tb.tab.data_ptr(), tb.small.data_ptr(), tb.emb.data_ptr(),
                B, *dims, self.num_iterations, int(self.input_injection), int(self.early_exit),
                tb.w_ch, tb.alpha, grid, stream)
        if rc != 0:
            msg = lib.ldpc_gnn_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.kind} kernel launch failed: CUDA error {rc} ({msg})")
        LAUNCHES[self.kind] += 1
        return soft, conv


def _make(kind: str, qc: QCLayout, params, num_iterations: int, hidden_dim: int,
          share_layers: bool, input_injection: bool, early_exit: bool, return_iterations: bool,
          device) -> FusedCorrectedDecoder:
    if return_iterations and not early_exit:
        raise ValueError("return_iterations requires early_exit=True")
    if num_iterations < 1:
        raise ValueError(f"num_iterations must be >= 1, got {num_iterations}")
    if hidden_dim not in KERNEL_HIDDEN_DIMS:
        raise ValueError(f"the {kind} kernel is built for hidden_dim in {KERNEL_HIDDEN_DIMS}, "
                         f"got {hidden_dim}")
    need = corrected_smem_bytes(kind, qc, hidden_dim)
    if need > _SMEM_BUDGET:
        raise ValueError(
            f"{kind} kernel state ({need / 1024:.1f} KiB: messages, LLRs and one layer's "
            f"weights) exceeds the {_SMEM_BUDGET / 1024:.0f} KiB of shared memory one block "
            f"can use (Z={qc.Z}, h={hidden_dim})")
    return FusedCorrectedDecoder(kind, qc, params, num_iterations, hidden_dim, share_layers,
                                 input_injection, early_exit, return_iterations,
                                 resolve_device(device))


def make_fused_corrected_gnn_decoder(
    qc: QCLayout,
    params,
    num_iterations: int = 5,
    hidden_dim: int = 64,
    share_layers: bool = False,
    input_injection: bool = True,
    early_exit: bool = False,
    return_iterations: bool = False,
    device="cuda",
) -> FusedCorrectedDecoder:
    """Serving kernel for the flagship corrected decoder: min-sum
    half-updates plus trained GNN corrections, one launch per batch.

    ``params``: a ``MessageGNNDecoder(var_mode=check_mode="corrected",
    depth_L=0, damping=1.0)`` (see ``create_corrected_minsum_gnn_decoder``) or
    its ``state_dict``.  Returns ``decode(llr) -> soft bits`` matching the
    module's forward.

    ``early_exit=True``: per-iteration syndrome tracking with first-valid
    freezing (the fused min-sum kernel's rule): a frame stops the iteration
    its syndrome is valid and emits its decisions as 0/1 probabilities.  This
    is a documented deviation from the fixed-``T`` module, which never
    freezes.  ``return_iterations=True`` (requires ``early_exit``): returns
    ``(soft, conv_iter)`` with ``conv_iter`` (B,) float32.

    The kernel needs ``hidden_dim`` in ``KERNEL_HIDDEN_DIMS`` and one frame's
    messages plus one layer's weights in a block's shared memory; a code that
    does not fit raises.  The JAX builder's ``interpret`` flag has no
    counterpart: a CPU tensor runs the plain version.
    """
    return _make("corrected", qc, params, num_iterations, hidden_dim, share_layers,
                 input_injection, early_exit, return_iterations, device)


def make_fused_corrected_gnn_decoder_v2(
    qc: QCLayout,
    params,
    num_iterations: int = 5,
    hidden_dim: int = 64,
    share_layers: bool = False,
    input_injection: bool = True,
    early_exit: bool = False,
    return_iterations: bool = False,
    device="cuda",
) -> FusedCorrectedDecoder:
    """The corrected decoder with the second MLP layer and the projection
    folded into one thin bf16 product (same flags and outputs as
    :func:`make_fused_corrected_gnn_decoder`; the two differ in where they
    round to bf16)."""
    return _make("corrected_v2", qc, params, num_iterations, hidden_dim, share_layers,
                 input_injection, early_exit, return_iterations, device)
