"""Fused message-GNN decoders: the whole decode of a message-centered GNN in
one CUDA kernel (counterpart of ``ldpc_tpu.ops.pallas_gnn``).

Four hand-written kernels, in two sources:

``csrc/fused_gnn.cu``, the corrected min-sum GNN (the flagship), served for a
:class:`ldpc_tpu_torch.models.message_gnn.MessageGNNDecoder` with
``var_mode = check_mode = "corrected"``, ``depth_L = 0``, ``damping = 1``
(``create_corrected_minsum_gnn_decoder``):

* ``corrected_v2`` (replaces ``pallas_gnn._corrected_kernel_v2``): min-sum
  half-updates in exact float32 plus a GNN correction per half-update, the
  second MLP layer and the projection folded into one thin product.
* ``corrected`` (replaces ``pallas_gnn._corrected_kernel``): the same
  decoder with the second layer not folded: full (h, h) products, bf16 layer
  outputs, float32 projection.

``csrc/fused_msg_gnn.cu``, the fully-neural message GNN
(``create_message_gnn_decoder``):

* ``msg_gnn`` (replaces ``pallas_gnn._kernel``): T GNN layers, the two
  halves of each MLP's second layer rounded to bf16 apart and added in bf16.
* ``msg_gnn_v2`` (replaces ``pallas_gnn._kernel_v2``): the same function
  with the second layer's two halves summed in float32 and rounded once.

``params`` is the module or its ``state_dict``.  Input (B, n) float32 LLRs;
output (B, n) float32 soft bits (probabilities of bit 1) and, for the
corrected decoders with ``return_iterations``, (B,) float32 ``conv_iter``.

Each builder returns a decoder object.  Called on a CUDA tensor it launches
its kernel (and raises if the launch fails); called on a CPU tensor it runs
the kernel's plain PyTorch version, which repeats the kernel's arithmetic
with the same bf16 rounding points in the same order.  ``plain(llr)`` runs
the plain version on any device, for comparisons; it walks a large batch in
chunks.  ``LAUNCHES`` counts kernel launches per kernel name.

bf16 rounding points of the corrected decoders, in order: the embedded
features of a message, the per-variable mean, the LLR features,
``corrected``'s per-check mean, the ReLU outputs, ``corrected``'s two
second-layer outputs and their sum.  The first- and second-layer weights,
and ``corrected_v2``'s folded ``w2p`` and ``cconst``, are rounded to bf16
when the decoder is built.  Those of the fully-neural decoders are listed in
the header of ``csrc/fused_msg_gnn.cu``.  Products accumulate in float32.
"""
from __future__ import annotations

import ctypes
from collections.abc import Mapping

import numpy as np
import torch

from ldpc_tpu_torch._device import resolve_device
from ldpc_tpu_torch.codes.edge_layout import QCLayout
from ldpc_tpu_torch.ops.fused_minsum import (_SMEM_BUDGET, _check_llr, _resident_grid,
                                             _structure)
from ldpc_tpu_torch.ops.qc_msg import _BIG

LAUNCHES: dict[str, int] = {"corrected_v2": 0, "corrected": 0, "msg_gnn": 0, "msg_gnn_v2": 0}

KERNEL_HIDDEN_DIMS = (16, 64)  # instantiations in csrc/fused_gnn.cu and csrc/fused_msg_gnn.cu
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


def _fold_type_embeddings(p: dict, layers, qc: QCLayout, h: int, h_in: int) -> dict:
    """The two MLPs of each GNN layer ``(index, state_dict prefix)`` in
    ``layers``, with the type embeddings folded into per-edge first-layer
    biases: W1v, W1c (N, h, h_in), W2v, W2c (N, h, h), b2v, b2c (N, h),
    bias1v, bias1c (N, h, K), float32.  The embeddings enter the MLPs only
    through the first Dense layer (directly and through the relation means,
    which are linear); the check-relation mean of the type embeddings is the
    mean over the check's members (it does not depend on the roll)."""
    K = qc.num_base_edges
    col_members = [[] for _ in range(qc.num_base_cols)]
    row_members = [[] for _ in range(qc.num_base_rows)]
    for k in range(K):
        col_members[qc.edge_col[k]].append(k)
        row_members[qc.edge_row[k]].append(k)
    N = len(layers)
    out = dict(
        W1v=np.zeros((N, h, h_in), np.float32), W2v=np.zeros((N, h, h), np.float32),
        W1c=np.zeros((N, h, h_in), np.float32), W2c=np.zeros((N, h, h), np.float32),
        b2v=np.zeros((N, h), np.float32), b2c=np.zeros((N, h), np.float32),
        bias1v=np.zeros((N, h, K), np.float32), bias1c=np.zeros((N, h, K), np.float32),
    )
    for idx, name in layers:
        te_edge = p[f"{name}.message_type_embeddings"][np.asarray(qc.edge_type)]  # (K, h)
        te_var = np.stack([te_edge[col_members[qc.edge_col[k]]].mean(axis=0) for k in range(K)])
        te_chk = np.stack([te_edge[row_members[qc.edge_row[k]]].mean(axis=0) for k in range(K)])
        for rel, s, te_agg in (("var_to_check_update", "v", te_var),
                               ("check_to_var_update", "c", te_chk)):
            w1 = p[f"{name}.{rel}.Dense_0.weight"]  # (h, h_in)
            out[f"W1{s}"][idx] = w1
            out[f"W2{s}"][idx] = p[f"{name}.{rel}.Dense_1.weight"]
            out[f"b2{s}"][idx] = p[f"{name}.{rel}.Dense_1.bias"]
            te_cat = np.zeros((K, h_in), np.float32)
            te_cat[:, :h] = te_edge
            te_cat[:, h:2 * h] = te_agg  # the LLR block carries no type embedding
            out[f"bias1{s}"][idx] = (te_cat @ w1.T + p[f"{name}.{rel}.Dense_0.bias"]).T
    return out


def _extract_corrected(params, qc: QCLayout, num_iterations: int, hidden_dim: int,
                       share_layers: bool, input_injection: bool) -> dict:
    """Parameters of a corrected MessageGNNDecoder -> the ``corrected``
    kernel's tables (float32, unrounded).  Type embeddings are folded into
    per-edge first-layer biases ``bias1v`` / ``bias1c`` (2T, h, K)."""
    p = _np_params(params)
    h = hidden_dim
    h_in = 3 * h if input_injection else 2 * h
    names = list(_layer_names(num_iterations, share_layers))
    out = _fold_type_embeddings(p, [(idx, f"{name}_gnn") for idx, name in names], qc, h, h_in)
    out["proj_w"] = np.stack([p[f"{name}_proj.weight"].reshape(h) for _, name in names])
    out["proj_b"] = np.array([float(p[f"{name}_proj.bias"].reshape(())) for _, name in names],
                             np.float32)
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


def _extract(params, qc: QCLayout, num_iterations: int, hidden_dim: int, share_layers: bool,
             input_injection: bool) -> dict:
    """Parameters of a fully-neural MessageGNNDecoder -> the ``msg_gnn``
    kernels' tables (float32, unrounded), as the JAX package's ``_extract``
    packs them, type embeddings folded into ``bias1v`` / ``bias1c`` (T, h, K)."""
    p = _np_params(params)
    h = hidden_dim
    h_in = 3 * h if input_injection else 2 * h
    layers = [(t, "gnn_layer" if share_layers else f"gnn_layer_{t}")
              for t in range(num_iterations)]
    return dict(
        emb_w=p["input_embedding.weight"].reshape(h), emb_b=p["input_embedding.bias"].reshape(h),
        proj_w=p["output_projection.weight"].reshape(h),
        proj_b=float(p["output_projection.bias"].reshape(())), h_in=h_in,
        **_fold_type_embeddings(p, layers, qc, h, h_in))


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
        self.inv, self.graph = _structure_tensors(qc, device)


def _structure_tensors(qc: QCLayout, device: torch.device):
    """(inverse degrees, graph) as the GNN kernels read them: float32(1 / d)
    per column then per row, as they multiply by it; and int32 row_ptr,
    row_edge, col_ptr, col_edge, shift, col, row, type."""
    K = qc.num_base_edges
    deg_c = np.maximum((qc.col_edges != K).sum(axis=1), 1)
    deg_r = np.maximum((qc.row_edges != K).sum(axis=1), 1)
    inv = torch.from_numpy(np.concatenate([1.0 / deg_c, 1.0 / deg_r]).astype(np.float32))
    st = _structure(qc)
    row_ptr = np.cumsum([0] + [len(m) for m in st.row_members])
    col_ptr = np.cumsum([0] + [len(m) for m in st.col_members])
    parts = [row_ptr, [k for m in st.row_members for k in m],
             col_ptr, [k for m in st.col_members for k in m],
             st.shifts, st.cols, qc.edge_row, qc.edge_type]
    graph = torch.from_numpy(np.concatenate([np.asarray(x_, dtype=np.int32) for x_ in parts]))
    return inv.to(device), graph.to(device)


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


def _row_sum(f: torch.Tensor, ix: _PlainIndex, R: int) -> torch.Tensor:
    """Sequential float32 sum of the features of each check's members, in
    row order, check-aligned: (B, K, Z, h) -> (B, R, Z, h); pads add 0."""
    B, K, Z, h = f.shape
    f_pad = torch.cat([f.reshape(B, K * Z, h), f.new_zeros((B, 1, h))], dim=1)
    rsum = None
    for j in range(ix.row_gather.shape[1]):
        term = f_pad[:, ix.row_gather[:, j].reshape(-1)].reshape(B, R, Z, h)
        rsum = term if rsum is None else rsum + term
    return rsum


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
        rsum = _row_sum(f, ix, self.R)

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


class _ResidentGridDecoder:
    """What both GNN decoder families share: the input checks, the plain
    version walked in chunks, and a launch of one block per resident slot
    with a zeroed frame counter and a global scratch slice per block.

    A subclass sets ``tables`` (with ``w`` on the decoder's device) and
    implements ``_new_plain()``, ``_run_plain(llr)`` and ``_launch(llr)``."""

    def __init__(self, kind: str, qc: QCLayout, num_iterations: int, hidden_dim: int,
                 input_injection: bool):
        self.kind = kind
        self.qc = qc
        self.n = qc.num_vars
        self.num_iterations = int(num_iterations)
        self.hidden_dim = int(hidden_dim)
        self.input_injection = bool(input_injection)
        self._plain = None
        self._grid: int | None = None

    def __call__(self, llr: torch.Tensor):
        _check_llr(llr, self.tables.w.device, self.n)
        if llr.device.type == "cuda":
            return self._launch(llr)
        return self._run_plain(llr)

    def plain(self, llr: torch.Tensor):
        _check_llr(llr, self.tables.w.device, self.n)
        return self._run_plain(llr)

    def _plain_chunks(self, llr: torch.Tensor) -> list:
        """The plain version's outputs on successive chunks of the batch."""
        if self._plain is None:
            self._plain = self._new_plain()
        chunk = max(1, _PLAIN_CHUNK_BYTES // (self.qc.num_edges * self.hidden_dim * 4))
        with torch.no_grad():
            return [self._plain.decode(llr[i:i + chunk]) for i in range(0, llr.shape[0], chunk)]

    def _launch_grid(self, llr: torch.Tensor, occupancy, scratch_floats: int, launch,
                     error_string) -> None:
        """``launch(counter, scratch, grid, stream) -> cudaError_t`` over
        min(B, resident blocks) blocks; ``occupancy()`` gives the blocks per
        SM (queried once).  Raises on a failed launch; counts a good one."""
        B = llr.shape[0]
        with torch.cuda.device(llr.device):
            if self._grid is None:
                self._grid = _resident_grid(occupancy(), self.kind, llr.device)
            grid = min(B, self._grid)
            counter = torch.zeros((1,), dtype=torch.int32, device=llr.device)
            scratch = torch.empty((grid * scratch_floats,), dtype=torch.float32,
                                  device=llr.device)
            stream = torch.cuda.current_stream(llr.device).cuda_stream
            rc = launch(counter.data_ptr(), scratch.data_ptr(), grid, stream)
        if rc != 0:
            msg = error_string(rc).decode()
            raise RuntimeError(f"{self.kind} kernel launch failed: CUDA error {rc} ({msg})")
        LAUNCHES[self.kind] += 1


def _check_build(kind: str, num_iterations: int, hidden_dim: int, smem_bytes: int,
                 state: str, qc: QCLayout) -> None:
    """Raises unless the kernel is built for ``hidden_dim`` and one block's
    ``state`` fits the shared memory of a block."""
    if num_iterations < 1:
        raise ValueError(f"num_iterations must be >= 1, got {num_iterations}")
    if hidden_dim not in KERNEL_HIDDEN_DIMS:
        raise ValueError(f"the {kind} kernel is built for hidden_dim in {KERNEL_HIDDEN_DIMS}, "
                         f"got {hidden_dim}")
    if smem_bytes > _SMEM_BUDGET:
        raise ValueError(
            f"{kind} kernel state ({smem_bytes / 1024:.1f} KiB: {state}) exceeds the "
            f"{_SMEM_BUDGET / 1024:.0f} KiB of shared memory one block can use "
            f"(Z={qc.Z}, h={hidden_dim})")


class FusedCorrectedDecoder(_ResidentGridDecoder):
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
        super().__init__(kind, qc, num_iterations, hidden_dim, input_injection)
        self.early_exit = bool(early_exit)
        self.return_iterations = bool(return_iterations)
        self.tables = _Tables(kind, qc, params, self.num_iterations, self.hidden_dim,
                              share_layers, self.input_injection, device)

    def _result(self, soft, conv):
        return (soft, conv) if self.return_iterations else soft

    def _new_plain(self):
        return _Plain(self.kind, self.qc, self.tables, self.num_iterations, self.hidden_dim,
                      self.input_injection, self.early_exit)

    def _run_plain(self, llr: torch.Tensor):
        outs = self._plain_chunks(llr)
        if not outs:
            return self._result(torch.empty_like(llr), llr.new_empty((0,)))
        return self._result(torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))

    def _launch(self, llr: torch.Tensor):
        if not llr.is_contiguous():
            raise ValueError("llr must be contiguous")
        qc, h, tb = self.qc, self.hidden_dim, self.tables
        B = llr.shape[0]
        soft = torch.empty_like(llr)
        conv = torch.empty((B,), dtype=torch.float32, device=llr.device)
        if B == 0:
            return self._result(soft, conv)
        lib = kernel_library()
        dims = (qc.Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges, qc.num_edge_types)
        self._launch_grid(
            llr, lambda: lib.ldpc_corrected_gnn_occupancy(VARIANT[self.kind], h, *dims),
            corrected_scratch_floats(qc, h),
            lambda counter, scratch, grid, stream: getattr(lib, _ENTRY[self.kind])(
                h, llr.data_ptr(), soft.data_ptr(),
                conv.data_ptr() if self.return_iterations else None, counter, scratch,
                tb.graph.data_ptr(), tb.inv.data_ptr(), tb.w_bf16.data_ptr(), tb.tab.data_ptr(),
                tb.small.data_ptr(), tb.emb.data_ptr(), B, *dims, self.num_iterations,
                int(self.input_injection), int(self.early_exit), tb.w_ch, tb.alpha, grid,
                stream),
            lib.ldpc_gnn_cuda_error_string)
        return self._result(soft, conv)


def _make(kind: str, qc: QCLayout, params, num_iterations: int, hidden_dim: int,
          share_layers: bool, input_injection: bool, early_exit: bool, return_iterations: bool,
          device) -> FusedCorrectedDecoder:
    if return_iterations and not early_exit:
        raise ValueError("return_iterations requires early_exit=True")
    _check_build(kind, num_iterations, hidden_dim, corrected_smem_bytes(kind, qc, hidden_dim),
                 "messages, LLRs and one layer's weights", qc)
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


# ---------------------------------------------------------------------------
# The fully-neural message GNN: tables, plain version, launch
# ---------------------------------------------------------------------------

MSG_VARIANT = {"msg_gnn": 6, "msg_gnn_v2": 7}
_MSG_ENTRY = {"msg_gnn": "ldpc_msg_gnn", "msg_gnn_v2": "ldpc_msg_gnn_v2"}
_MSG_THREADS = 256  # kThreads in csrc/fused_msg_gnn.cu


class _MsgTables:
    """What a ``msg_gnn`` launch and its plain version read, on one device.

    ``w`` (T, 8, h, h): layer t's weight matrices, values rounded to bf16,
    kept as float32 (``w_bf16`` for the kernel), order va, ca, vl, cl, vf,
    cf, W2v, W2c (the LLR blocks vl, cl are zero without injection).
    ``tab`` (T, 2, K, h): first-layer biases per edge, b1v then b1c.
    ``small`` (T, 2h): ``msg_gnn`` b2v, b2c; ``msg_gnn_v2`` b2v + b2c, 0.
    ``emb`` (3h + 1): emb_w, emb_b, proj_w, proj_b.
    """

    def __init__(self, kind: str, qc: QCLayout, params, T: int, h: int, share_layers: bool,
                 input_injection: bool, device: torch.device):
        x = _extract(params, qc, T, h, share_layers, input_injection)
        W1v, W1c = x["W1v"], x["W1c"]
        zero = np.zeros((T, h, h), np.float32)
        w = np.stack([W1v[:, :, h:2 * h], W1c[:, :, h:2 * h],
                      W1v[:, :, 2 * h:3 * h] if input_injection else zero,
                      W1c[:, :, 2 * h:3 * h] if input_injection else zero,
                      W1v[:, :, 0:h], W1c[:, :, 0:h], x["W2v"], x["W2c"]], axis=1)
        if kind == "msg_gnn":
            small = np.concatenate([x["b2v"], x["b2c"]], axis=1)
        else:
            small = np.concatenate([x["b2v"] + x["b2c"], np.zeros_like(x["b2c"])], axis=1)
        tab = np.stack([x["bias1v"], x["bias1c"]], axis=1).transpose(0, 1, 3, 2)
        self.w = _bf16_round(w).to(device)
        self.w_bf16 = self.w.to(torch.bfloat16).contiguous()
        self.tab = torch.from_numpy(np.ascontiguousarray(tab, np.float32)).to(device)
        self.small = torch.from_numpy(np.ascontiguousarray(small, np.float32)).to(device)
        self.emb = torch.from_numpy(np.concatenate(
            [x["emb_w"], x["emb_b"], x["proj_w"], [x["proj_b"]]]).astype(np.float32)).to(device)
        self.inv, self.graph = _structure_tensors(qc, device)


def msg_gnn_smem_bytes(qc: QCLayout, hidden_dim: int) -> int:
    """Dynamic shared memory of one ``msg_gnn`` block (mirrors make_layout in
    csrc/fused_msg_gnn.cu): graph, inverse degrees, the frame's LLRs,
    embedding and projection, second-layer biases, four (h, h) float32
    weight matrices and 2h bf16 of staging per thread, in 4-byte words."""
    def r4(x):
        return -(-x // 4) * 4

    K, Z, C, R, h = qc.num_base_edges, qc.Z, qc.num_base_cols, qc.num_base_rows, hidden_dim
    words = (r4(6 * K + R + C + 2) + r4(C + R) + r4(C * Z) + r4(3 * h + 1) + 2 * h
             + 4 * h * h + h * _MSG_THREADS)
    return 4 * words


def msg_gnn_scratch_floats(qc: QCLayout, hidden_dim: int, input_injection: bool) -> int:
    """Global scratch of one resident block: a frame's features (bf16) and
    its per-variable and per-check first-layer terms (float32)."""
    K, Z, C, R, h = qc.num_base_edges, qc.Z, qc.num_base_cols, qc.num_base_rows, hidden_dim
    return (C + R + (2 * C if input_injection else 0)) * Z * h + K * Z * h // 2


class _MsgPlain:
    """The plain version of one ``msg_gnn`` kernel for one decoder."""

    def __init__(self, kind: str, qc: QCLayout, tables: _MsgTables, T: int, h: int,
                 inject: bool):
        self.kind, self.T, self.h, self.inject = kind, T, h, inject
        self.tb = tables
        self.ix = _PlainIndex(qc, tables.w.device)
        self.Z, self.C, self.R, self.K = qc.Z, qc.num_base_cols, qc.num_base_rows, qc.num_base_edges

    def decode(self, llr: torch.Tensor) -> torch.Tensor:
        """(B, n) -> soft bits (B, n)."""
        tb, ix, h, Z, K = self.tb, self.ix, self.h, self.Z, self.K
        B = llr.shape[0]
        emb_w, emb_b, proj_w = tb.emb[:h], tb.emb[h:2 * h], tb.emb[2 * h:3 * h]
        proj_b = tb.emb[3 * h]
        inv_dc = tb.inv[: self.C][None, :, None, None]
        inv_dr = tb.inv[self.C:][None, :, None, None]
        llr_cz = llr.reshape(B, self.C, Z)
        f = _r(llr_cz[:, ix.cols][..., None] * emb_w + emb_b)  # (B, K, Z, h)
        lf = _r(llr_cz[..., None] * emb_w + emb_b) if self.inject else None  # (B, C, Z, h)
        for t in range(self.T):
            Wva, Wca, Wvl, Wcl, Wvf, Wcf, W2v, W2c = (tb.w[t, i].t() for i in range(8))
            b1v = tb.tab[t, 0][None, :, None, :]
            b1c = tb.tab[t, 1][None, :, None, :]
            b2 = tb.small[t]
            vmean = _r(_member_sum(f, ix.col_edges, ix.col_valid) * inv_dc)  # (B, C, Z, h)
            pre_col = vmean @ Wva
            pre_row = _r(_row_sum(f, ix, self.R) * inv_dr) @ Wca
            pre_row_e = pre_row.reshape(B, self.R * Z, h)[:, ix.edge_check].reshape(B, K, Z, h)
            pv = f @ Wvf
            pc = (f @ Wcf + pre_row_e) + b1c
            if self.kind == "msg_gnn":
                if self.inject:
                    pre_col = pre_col + lf @ Wvl
                pv = (pv + pre_col[:, ix.cols]) + b1v
            else:
                pv = (pv + pre_col[:, ix.cols]) + b1v
                if self.inject:
                    pv = pv + (lf @ Wvl)[:, ix.cols]
            if self.inject:
                pc = pc + (lf @ Wcl)[:, ix.cols]
            h1v, h1c = _r(torch.relu(pv)), _r(torch.relu(pc))
            if self.kind == "msg_gnn":
                new = _r(_r(h1v @ W2v + b2[:h]) + _r(h1c @ W2c + b2[h:]))
            else:
                new = _r(torch.cat([h1v, h1c], dim=-1) @ torch.cat([W2v, W2c], dim=0) + b2[:h])
            f = _r(new + f) if t >= 1 else new  # residual from layer 2 on
        contrib = (f * proj_w).sum(dim=-1)  # (B, K, Z)
        acc = torch.zeros_like(llr_cz)
        for j in range(ix.col_edges.shape[1]):  # col_members order; pads add nothing
            v = ix.col_valid[:, j][None, :, None]
            term = contrib[:, ix.col_edges[:, j].clamp(max=K - 1)]
            acc = torch.where(v, (acc + term) + proj_b, acc)
        return 1.0 / (1.0 + torch.exp(llr + acc.reshape(B, -1)))


_MSG_LAUNCH = ([_I] + [_P] * 10 + [_I] * 8 + [_P], _I)
_MSG_SIGNATURES = {
    # H, llr, soft, counter, scratch, graph, inv, w, tab, small, emb,
    # B, Z, R, C, K, T, inject, grid, stream
    "ldpc_msg_gnn": _MSG_LAUNCH,
    "ldpc_msg_gnn_v2": _MSG_LAUNCH,
    "ldpc_msg_gnn_smem_bytes": ([_I] * 5, ctypes.c_longlong),  # H, Z, R, C, K
    "ldpc_msg_gnn_scratch_floats": ([_I] * 6, ctypes.c_longlong),  # ..., inject
    "ldpc_msg_gnn_occupancy": ([_I] * 6, _I),  # variant, H, Z, R, C, K
    "ldpc_msg_gnn_cuda_error_string": ([_I], ctypes.c_char_p),
}


def msg_kernel_library():
    """The compiled ``csrc/fused_msg_gnn.cu``, built on first use."""
    from ldpc_tpu_torch.ops import _build

    return _build.load("fused_msg_gnn", _MSG_SIGNATURES)


class FusedMessageGNNDecoder(_ResidentGridDecoder):
    """``decode(llr) -> soft``: (B, n) float32 LLRs to (B, n) float32 soft
    bits of a fully-neural message GNN.

    Launches the ``kind`` kernel for CUDA tensors and runs the plain version
    for CPU tensors; ``plain(llr)`` runs the plain version on any device.
    """

    def __init__(self, kind: str, qc: QCLayout, params, num_iterations: int, hidden_dim: int,
                 share_layers: bool, input_injection: bool, device: torch.device):
        super().__init__(kind, qc, num_iterations, hidden_dim, input_injection)
        self.tables = _MsgTables(kind, qc, params, self.num_iterations, self.hidden_dim,
                                 share_layers, self.input_injection, device)

    def _new_plain(self):
        return _MsgPlain(self.kind, self.qc, self.tables, self.num_iterations, self.hidden_dim,
                         self.input_injection)

    def _run_plain(self, llr: torch.Tensor) -> torch.Tensor:
        outs = self._plain_chunks(llr)
        return torch.cat(outs) if outs else torch.empty_like(llr)

    def _launch(self, llr: torch.Tensor) -> torch.Tensor:
        if not llr.is_contiguous():
            raise ValueError("llr must be contiguous")
        qc, h, tb = self.qc, self.hidden_dim, self.tables
        B = llr.shape[0]
        soft = torch.empty_like(llr)
        if B == 0:
            return soft
        lib = msg_kernel_library()
        dims = (qc.Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges)
        self._launch_grid(
            llr, lambda: lib.ldpc_msg_gnn_occupancy(MSG_VARIANT[self.kind], h, *dims),
            msg_gnn_scratch_floats(qc, h, self.input_injection),
            lambda counter, scratch, grid, stream: getattr(lib, _MSG_ENTRY[self.kind])(
                h, llr.data_ptr(), soft.data_ptr(), counter, scratch, tb.graph.data_ptr(),
                tb.inv.data_ptr(), tb.w_bf16.data_ptr(), tb.tab.data_ptr(), tb.small.data_ptr(),
                tb.emb.data_ptr(), B, *dims, self.num_iterations, int(self.input_injection),
                grid, stream),
            lib.ldpc_msg_gnn_cuda_error_string)
        return soft


def _make_msg(kind: str, qc: QCLayout, params, num_iterations: int, hidden_dim: int,
              share_layers: bool, input_injection: bool, device) -> FusedMessageGNNDecoder:
    _check_build(kind, num_iterations, hidden_dim, msg_gnn_smem_bytes(qc, hidden_dim),
                 "LLRs, one phase's weights and the first-layer staging", qc)
    return FusedMessageGNNDecoder(kind, qc, params, num_iterations, hidden_dim, share_layers,
                                  input_injection, resolve_device(device))


def make_fused_gnn_decoder(
    qc: QCLayout,
    params,
    num_iterations: int = 5,
    hidden_dim: int = 64,
    share_layers: bool = False,
    input_injection: bool = False,
    interpret: bool = False,
    device="cuda",
) -> FusedMessageGNNDecoder:
    """Serving kernel of the fully-neural message GNN: (B, n) LLRs -> (B, n)
    soft bits, one launch per batch.

    ``params``: a ``MessageGNNDecoder`` built by ``create_message_gnn_decoder``
    with matching hyperparameters, or its ``state_dict``.  The kernel needs
    ``hidden_dim`` in ``KERNEL_HIDDEN_DIMS``; another width raises.  The JAX
    builder's ``interpret`` flag has no counterpart and changes nothing: a
    CPU tensor runs the plain version.
    """
    del interpret
    return _make_msg("msg_gnn", qc, params, num_iterations, hidden_dim, share_layers,
                     input_injection, device)


def make_fused_gnn_decoder_v2(
    qc: QCLayout,
    params,
    num_iterations: int = 5,
    hidden_dim: int = 64,
    share_layers: bool = False,
    input_injection: bool = False,
    mm_group: int = 16,
    interpret: bool = False,
    device="cuda",
) -> FusedMessageGNNDecoder:
    """The fully-neural decoder with each MLP's second layer summed over both
    halves in float32 and rounded to bf16 once (same flags and outputs as
    :func:`make_fused_gnn_decoder`; the two differ in that rounding).
    ``mm_group`` (the TPU kernel's edge-group size) and ``interpret`` are the
    JAX builder's and change nothing here."""
    del mm_group, interpret
    return _make_msg("msg_gnn_v2", qc, params, num_iterations, hidden_dim, share_layers,
                     input_injection, device)
