"""Fused message-GNN decoders: the whole decode of a message-centered GNN in
one CUDA kernel (counterpart of ``ldpc_tpu.ops.pallas_gnn``).

Six hand-written kernels, in two sources:

``csrc/fused_gnn_tc.cu``, the corrected min-sum GNN (the flagship), served
for a :class:`ldpc_tpu_torch.models.message_gnn.MessageGNNDecoder` with
``var_mode = check_mode = "corrected"``, ``depth_L = 0``, ``damping = 1``
(``create_corrected_minsum_gnn_decoder``), two kernels on one tensor-core
skeleton (the min-sum half-updates in exact float32, a frame's whole state
in shared memory, the correction's products as bf16 tiles):

* ``corrected_v2`` (replaces ``pallas_gnn._corrected_kernel_v2``): a GNN
  correction per half-update, the second MLP layer and the projection folded
  into one thin product; two passes, variable-major then check-major.
* ``corrected`` (replaces ``pallas_gnn._corrected_kernel``): the same
  decoder with the second layer not folded: full (h, h) products, bf16
  layer outputs, float32 projection; one variable-major pass.

``csrc/fused_msg_gnn_tc.cu``, the fully-neural message GNN
(``create_message_gnn_decoder``), four variants of one tensor-core skeleton:

* ``msg_gnn`` (replaces ``pallas_gnn._kernel``; message-major tiles): T GNN
  layers, the two halves of each MLP's second layer rounded to bf16 apart
  and added in bf16.
* ``msg_gnn_v2`` (replaces ``pallas_gnn._kernel_v2``; message-major tiles):
  the same function with the second layer's two halves summed in float32
  and rounded once.
* ``msg_gnn_v3`` (replaces ``pallas_gnn._kernel_v3``; check-major tiles that
  keep the check side's sum in registers): the type embeddings ride in the
  features (``_extract_v3``, the delta table ``dte``), the check side
  projects each message and averages in float32, b2 is bf16.
* ``msg_gnn_v4`` (replaces ``pallas_gnn._kernel_v4``; message-major tiles):
  v3's folds on ``msg_gnn_v2``'s layer, the last layer folded into thin
  rows through the output projection (``w2last``, ``proj8``, ``dsc``).

Each kernel is built for the hidden widths in ``KERNEL_HIDDEN_DIMS``:
``msg_gnn_v2`` and ``msg_gnn_v4`` also at ``WIDE_HIDDEN`` = 128
(``msg_gnn_wide_tc_kernel``, on ``wgmma``), where a layer's weights exceed a
block's shared memory and stream through a ring of ``WIDE_STAGES`` buffers
in chunks of ``WIDE_CHUNK`` hidden units (:func:`pack_tc_weights`), read by
``WIDE_GROUPS`` warpgroups, each on a tile of ``WIDE_ROWS`` messages.

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
the header of ``csrc/fused_msg_gnn_tc.cu``.  Every kernel sums each product,
and ``corrected`` its projection, in another float32 order than the plain
version; nothing else differs.  Products accumulate in float32.
"""
from __future__ import annotations

import copy
import ctypes
from collections.abc import Mapping

import numpy as np
import torch

from ldpc_tpu_torch._device import resolve_device
from ldpc_tpu_torch.codes.edge_layout import QCLayout
from ldpc_tpu_torch.ops.fused_minsum import (_SMEM_BUDGET, _check_llr, _resident_grid,
                                             _structure)
from ldpc_tpu_torch.ops.qc_msg import _BIG

LAUNCHES: dict[str, int] = {"corrected_v2": 0, "corrected": 0, "msg_gnn": 0, "msg_gnn_v2": 0,
                            "msg_gnn_v3": 0, "msg_gnn_v4": 0}

# The hidden widths each kernel is built for (csrc/fused_gnn_tc.cu,
# fused_msg_gnn_tc.cu): msg_gnn_v2 and msg_gnn_v4 also at WIDE_HIDDEN, their
# weights streamed through a ring of shared memory in chunks of WIDE_CHUNK units.
KERNEL_HIDDEN_DIMS = {"corrected_v2": (16, 64), "corrected": (16, 64), "msg_gnn": (16, 64),
                      "msg_gnn_v2": (16, 64, 128), "msg_gnn_v3": (16, 64),
                      "msg_gnn_v4": (16, 64, 128)}
WIDE_HIDDEN = 128  # kWideH in csrc/fused_msg_gnn_tc.cu
WIDE_CHUNK = 16  # kWideChunk: hidden units a streamed weight chunk
WIDE_ROWS = 64  # kWideRows: messages a warpgroup tile (wgmma's M)
WIDE_GROUPS = 2  # kWideGroups: warpgroups a block
WIDE_STAGES = 2  # kWideStages: chunk buffers in the ring
WIDE_WARPS = 4 * WIDE_GROUPS  # kWideWarps: the block
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


def _extract_v3(params, qc: QCLayout, num_iterations: int, hidden_dim: int, share_layers: bool,
                input_injection: bool) -> dict:
    """Parameters of a fully-neural MessageGNNDecoder -> the ``msg_gnn_v3``
    and ``msg_gnn_v4`` tables, as the JAX package's ``_extract_v3`` packs
    them (float32, unrounded): the first-layer blocks W1vf, W1cf, W1va, W1ca,
    W1vl, W1cl and W2v, W2c (T, h, h) as (out, in); b1v, b1c and b2 = b2v +
    b2c (T, h); the type embedding of each edge ``te`` (T, K, h), kept raw."""
    p = _np_params(params)
    h, T, K = hidden_dim, num_iterations, qc.num_base_edges
    out = {name: np.zeros((T, h, h), np.float32)
           for name in ("W1vf", "W1cf", "W1va", "W1ca", "W1vl", "W1cl", "W2v", "W2c")}
    out.update(b1v=np.zeros((T, h), np.float32), b1c=np.zeros((T, h), np.float32),
               b2=np.zeros((T, h), np.float32), te=np.zeros((T, K, h), np.float32))
    for t in range(T):
        name = "gnn_layer" if share_layers else f"gnn_layer_{t}"
        out["te"][t] = p[f"{name}.message_type_embeddings"][np.asarray(qc.edge_type)]
        for rel, s in (("var_to_check_update", "v"), ("check_to_var_update", "c")):
            w1 = p[f"{name}.{rel}.Dense_0.weight"]  # (h, 2h or 3h)
            out[f"W1{s}f"][t] = w1[:, 0:h]
            out[f"W1{s}a"][t] = w1[:, h:2 * h]
            if input_injection:
                out[f"W1{s}l"][t] = w1[:, 2 * h:3 * h]
            out[f"b1{s}"][t] = p[f"{name}.{rel}.Dense_0.bias"]
            out[f"W2{s}"][t] = p[f"{name}.{rel}.Dense_1.weight"]
            out["b2"][t] += p[f"{name}.{rel}.Dense_1.bias"]
    return dict(emb_w=p["input_embedding.weight"].reshape(h),
                emb_b=p["input_embedding.bias"].reshape(h),
                proj_w=p["output_projection.weight"].reshape(h),
                proj_b=float(p["output_projection.bias"].reshape(())), **out)


def _te_deltas(te: np.ndarray) -> np.ndarray:
    """The delta table ``dte`` (T + 1, K, h) of the JAX builders: block 0 is
    te_0 (the seed), block 1 te_1 in full (layer 0 has no residual, so its
    output carries no te_0 to cancel), block t >= 2 te_t - te_{t-1}, with
    te_T = 0.  Block t + 1 is added at the end of layer t."""
    zero = np.zeros_like(te[:1])
    return np.concatenate([te[:1], np.concatenate([te[1:], zero])
                           - np.concatenate([zero, te[1:]])]).astype(np.float32)


def _last_layer_folds(x: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``msg_gnn_v4``'s folded last layer (pallas_gnn.py:1171-1196): the last
    features are only read through the output projection, which is linear,
    so proj . feats_T = (proj [W2v W2c]) . h1 + proj . feats_{T-1} + dsc.
    Returns w2last (2h,) and proj8 (h,), rounded to bf16 as the kernels read
    them, and the float32 per-edge scalars dsc (K,) = proj_b + proj . b2_{T-1}
    - proj . te_{T-1} (the residual stream carries te_{T-1} only for T > 1)."""
    pw, te = x["proj_w"], x["te"]
    T = te.shape[0]
    w2last = _bf16_round(np.concatenate([pw @ x["W2v"][T - 1], pw @ x["W2c"][T - 1]])).numpy()
    proj8 = _bf16_round(pw).numpy()
    dsc = np.zeros(te.shape[1], np.float32)
    dsc[:] = x["proj_b"] + pw @ x["b2"][T - 1] - (te[T - 1] @ pw if T > 1 else 0.0)
    return w2last, proj8, dsc


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
    to bf16, kept as float32 for the plain version; order vf, cf, ca, va, vl,
    cl[, W2v, W2c].  ``w_bf16``: the kernel's copy, packed by
    :func:`pack_corrected_tc_weights`.
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
        self.w_bf16 = pack_corrected_tc_weights(self.w, input_injection, kind)
        self.small = torch.from_numpy(np.ascontiguousarray(small, np.float32)).to(device)
        self.tab = torch.from_numpy(np.ascontiguousarray(tab, np.float32)).to(device)
        self.emb = torch.from_numpy(np.concatenate([x["emb_w"], x["emb_b"]])).to(device)
        self.inv, self.graph = _structure_tensors(qc, device)

    def hidden_permuted(self, kind: str, perm: torch.Tensor) -> "_Tables":
        """A copy for the plain version with the hidden units in the order
        ``perm``: the same function, each product and the projection summed
        in another float32 order.  The kernel's packed weights are shared,
        not permuted."""
        t = copy.copy(self)
        h = perm.numel()
        perm = perm.to(self.w.device)
        t.w = self.w[:, :, perm][:, :, :, perm]
        t.small = self.small.clone()
        for i in range(4 if kind == "corrected_v2" else 3):  # the h-vectors first
            t.small[:, i * h:(i + 1) * h] = self.small[:, i * h:(i + 1) * h][:, perm]
        t.tab = self.tab[..., perm]
        t.emb = torch.cat([self.emb[:h][perm], self.emb[h:][perm]])
        return t


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


def _r4(x: int) -> int:
    """x rounded up to a multiple of 4 (shared-memory words, 16-byte aligned)."""
    return -(-x // 4) * 4


def corrected_tc_matrices(input_injection: bool, kind: str = "corrected_v2") -> int:
    """(h, h) matrices a corrected kernel stages a layer: the first layer's
    vf, cf, ca, va, then vl, cl with injection; ``corrected`` then W2v,
    W2c."""
    return (6 if input_injection else 4) + (2 if kind == "corrected" else 0)


def pack_corrected_tc_weights(w: torch.Tensor, inject: bool,
                              kind: str = "corrected_v2") -> torch.Tensor:
    """``_Tables.w`` (2T, 6 or 8, h, h), bf16 values as float32 -> the
    tensor-core kernel's packed bf16 layout (2T, NM * h * (h + 8)), as it
    stages it in shared memory: the matrices of
    :func:`corrected_tc_matrices` in order, each h rows (out) of its h
    inputs then 8 zeros."""
    idx = list(range(corrected_tc_matrices(inject))) + ([6, 7] if kind == "corrected" else [])
    padded = torch.nn.functional.pad(w[:, idx], (0, 8))
    return padded.reshape(w.shape[0], -1).to(torch.bfloat16).contiguous()


def corrected_smem_bytes(kind: str, qc: QCLayout, hidden_dim: int,
                         input_injection: bool = True, warps: int = 1) -> int:
    """Dynamic shared memory of one block of ``warps`` warps (make_layout in
    csrc/fused_gnn_tc.cu): graph, inverse degrees, v2c, c2v, LLRs, column
    sums, embedding and the layer's small vectors, 4-byte words, and its
    padded bf16 matrices (:func:`corrected_tc_matrices`).  ``corrected_v2``
    adds the variable-side partial of each message and the layer's ebias
    table; ``corrected`` with injection adds each warp's tile of pre_llr
    (16 rows of h floats)."""
    K, Z, C, R, h = qc.num_base_edges, qc.Z, qc.num_base_cols, qc.num_base_rows, hidden_dim
    state = _r4(6 * K + R + C + 2) + _r4(C + R) + 2 * _r4(K * Z) + 2 * _r4(C * Z) + 2 * h
    if kind == "corrected_v2":
        words = state + _r4(K * Z) + 4 * h + 4 + qc.num_edge_types * h
    else:
        words = state + 3 * h + 4 + (warps * _TILE * h if input_injection else 0)
    return 4 * words + 2 * corrected_tc_matrices(input_injection, kind) * h * (h + 8)


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
_CORRECTED_TC_SIGNATURES = {
    # v1 (0: corrected_v2, 1: corrected), H, llr, soft, conv, counter, graph, inv, w, tab,
    # small, emb, B, Z, R, C, K, ntypes, T, inject, early_exit, w_ch, alpha, grid, warps, stream
    "ldpc_corrected_gnn": ([_I, _I] + [_P] * 10 + [_I] * 9 + [_F, _F, _I, _I, _P], _I),
    # v1, H, inject, Z, R, C, K, ntypes, warps
    "ldpc_corrected_tc_smem_bytes": ([_I] * 9, ctypes.c_longlong),
    "ldpc_corrected_tc_plan": ([_I] * 8 + [_P, _P], _I),  # v1, H, ..., ntypes, *warps, *blocks
    "ldpc_corrected_tc_cuda_error_string": ([_I], ctypes.c_char_p),
}


def corrected_tc_library():
    """The compiled ``csrc/fused_gnn_tc.cu`` (``corrected_v2`` and
    ``corrected``), built on first use."""
    from ldpc_tpu_torch.ops import _build

    return _build.load("fused_gnn_tc", _CORRECTED_TC_SIGNATURES)


def _dims(qc: QCLayout) -> tuple[int, int, int, int]:
    return qc.Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges


def corrected_tc_plan(qc: QCLayout, hidden_dim: int, input_injection: bool,
                      kind: str = "corrected_v2") -> tuple[int, int]:
    """(warps a block, blocks an SM) of a corrected kernel on the current
    card: the runtime's occupancy query over every block size, the most
    resident warps per SM (csrc/fused_gnn_tc.cu)."""
    lib = corrected_tc_library()
    warps, blocks = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.ldpc_corrected_tc_plan(int(kind == "corrected"), hidden_dim, int(input_injection),
                                    *_dims(qc), qc.num_edge_types, ctypes.addressof(warps),
                                    ctypes.addressof(blocks))
    if rc != 0:
        msg = lib.ldpc_corrected_tc_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kind} occupancy query failed: CUDA error {rc} ({msg})")
    return warps.value, blocks.value


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
    if hidden_dim not in KERNEL_HIDDEN_DIMS[kind]:
        raise ValueError(f"the {kind} kernel is built for hidden_dim in "
                         f"{KERNEL_HIDDEN_DIMS[kind]}, got {hidden_dim}")
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
        self._warps = 0  # the block size, from the kernel's plan at the first launch
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

    def plain_reordered(self, llr: torch.Tensor, perm: torch.Tensor):
        """The plain version with the hidden units in the order ``perm``
        (:meth:`_Tables.hidden_permuted`), in one chunk: what another
        summation order alone moves, beside which a kernel's difference from
        :meth:`plain` is read (chip_smoke.py's noise floor)."""
        _check_llr(llr, self.tables.w.device, self.n)
        plain = _Plain(self.kind, self.qc, self.tables.hidden_permuted(self.kind, perm),
                       self.num_iterations, self.hidden_dim, self.input_injection,
                       self.early_exit)
        with torch.no_grad():
            return self._result(*plain.decode(llr))

    def _launch(self, llr: torch.Tensor):
        if not llr.is_contiguous():
            raise ValueError("llr must be contiguous")
        qc, h, tb = self.qc, self.hidden_dim, self.tables
        B = llr.shape[0]
        soft = torch.empty_like(llr)
        conv = torch.empty((B,), dtype=torch.float32, device=llr.device)
        if B == 0:
            return self._result(soft, conv)
        conv_ptr = conv.data_ptr() if self.return_iterations else None
        flags = (self.num_iterations, int(self.input_injection), int(self.early_exit), tb.w_ch,
                 tb.alpha)
        tables = (tb.graph.data_ptr(), tb.inv.data_ptr(), tb.w_bf16.data_ptr(),
                  tb.tab.data_ptr(), tb.small.data_ptr(), tb.emb.data_ptr())
        lib = corrected_tc_library()

        def blocks_per_sm() -> int:
            self._warps, blocks = corrected_tc_plan(qc, h, self.input_injection, self.kind)
            return blocks

        self._launch_grid(
            llr, blocks_per_sm, 0,
            lambda counter, scratch, grid, stream: lib.ldpc_corrected_gnn(
                int(self.kind == "corrected"), h, llr.data_ptr(), soft.data_ptr(), conv_ptr,
                counter, *tables, B, *_dims(qc), qc.num_edge_types, *flags, grid, self._warps,
                stream),
            lib.ldpc_corrected_tc_cuda_error_string)
        return self._result(soft, conv)


def _make(kind: str, qc: QCLayout, params, num_iterations: int, hidden_dim: int,
          share_layers: bool, input_injection: bool, early_exit: bool, return_iterations: bool,
          device) -> FusedCorrectedDecoder:
    if return_iterations and not early_exit:
        raise ValueError("return_iterations requires early_exit=True")
    _check_build(kind, num_iterations, hidden_dim,
                 corrected_smem_bytes(kind, qc, hidden_dim, input_injection),
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

    The kernel needs ``hidden_dim`` in ``KERNEL_HIDDEN_DIMS[kind]`` and one frame's
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

# The kernels of csrc/fused_msg_gnn_tc.cu by kind: each one's launch entry,
# whose name also prefixes its size and plan entries.
TC_ENTRY = {"msg_gnn": "ldpc_msg_gnn", "msg_gnn_v2": "ldpc_msg_gnn_v2",
             "msg_gnn_v3": "ldpc_msg_gnn_v3", "msg_gnn_v4": "ldpc_msg_gnn_v4"}
_FOLDED = ("msg_gnn_v3", "msg_gnn_v4")  # the type embeddings ride in the features
_CHECK_MAJOR = "msg_gnn_v3"  # the check-major kernel; the others are message-major
_TILE = 16  # kTile in csrc/fused_msg_gnn_tc.cu: messages (v3: checks) a tile


def tc_row_widths(h: int, inject: bool) -> tuple[int, int]:
    """Padded row lengths (bf16) of the packed message-major weights: W1v
    and W1c (2h or 3h inputs, plus 8), W2 (2h inputs, plus 8)."""
    return (3 if inject else 2) * h + 8, 2 * h + 8


def tc_weight_blocks(h: int, inject: bool, kind: str = "msg_gnn_v2") -> tuple:
    """The packed matrices of one layer of a tensor-core kernel, in order:
    ((indices into ``_MsgTables.w``, whose inputs a row concatenates),
    padded row length in bf16).  Message-major (``msg_gnn``, ``msg_gnn_v2``,
    ``msg_gnn_v4``): W1v = [W1vf W1va (W1vl)], W1c = [W1cf W1ca (W1cl)], W2
    = [W2v W2c].  ``msg_gnn_v3``: W1v = [W1vf W1va (W1vl)], W1c = [W1cf
    (W1cl)], W1ca, W2 = [W2v W2c].  At h = ``WIDE_HIDDEN`` the message-major
    kernels stream the same weights cut into chunks of hidden units
    (:func:`tc_chunk_matrices`)."""
    ws1, ws2 = tc_row_widths(h, inject)
    w2 = ((6, 7), ws2)
    if kind != _CHECK_MAJOR:  # _MsgTables.w order: va, ca, vl, cl, vf, cf, W2v, W2c
        return (((4, 0, 2) if inject else (4, 0), ws1),
                ((5, 1, 3) if inject else (5, 1), ws1), w2)
    return (((4, 0, 2) if inject else (4, 0), ws1),
            ((5, 3) if inject else (5,), (2 if inject else 1) * h + 8), ((1,), h + 8), w2)


def tc_chunk_matrices(h: int, inject: bool) -> tuple:
    """The matrices of one streamed weight chunk at h = ``WIDE_HIDDEN``, in
    order, as (name, rows, columns), for the ``WIDE_CHUNK`` hidden units u of
    the chunk: [W1vf; W1cf] (their first-layer rows' f columns, W1v's units
    then W1c's), W1va, W1ca, with injection [W1vl; W1cl], then [W2v W2c]
    cut to the units' columns (h rows: W2v[:, u] then W2c[:, u])."""
    ch = WIDE_CHUNK
    lf = (("W1l", 2 * ch, h),) if inject else ()
    return (("W1f", 2 * ch, h), ("W1va", ch, h), ("W1ca", ch, h)) + lf + (("W2", h, 2 * ch),)


def tc_chunk_elems(h: int, inject: bool) -> int:
    """bf16 elements of one streamed weight chunk (chunk_weights in
    csrc/fused_msg_gnn_tc.cu): its matrices, unpadded."""
    return sum(rows * cols for _, rows, cols in tc_chunk_matrices(h, inject))


def core_matrix_order(m: torch.Tensor) -> torch.Tensor:
    """(..., n, K) -> (..., n K): the rows in 8 x 8 blocks of 128 contiguous
    bytes, the blocks of an 8-row group along K, then the next group (cm in
    csrc/fused_msg_gnn_tc.cu, the layout ``wgmma`` reads with no swizzle)."""
    *lead, n, k = m.shape
    blocks = m.reshape(*lead, n // 8, 8, k // 8, 8).transpose(-3, -2)
    return blocks.reshape(*lead, n * k)


def pack_tc_weights(w: torch.Tensor, inject: bool, kind: str = "msg_gnn_v2") -> torch.Tensor:
    """``_MsgTables.w`` (T, 8, h, h), bf16 values as float32 -> the ``kind``
    tensor-core kernel's packed bf16 layout (T, layer elements), in the order
    it stages it in shared memory: the matrices of :func:`tc_weight_blocks`,
    each h rows (out) of its inputs then zeros.  At h = ``WIDE_HIDDEN`` (a
    message-major kernel) the layer is h / ``WIDE_CHUNK`` chunks of
    :func:`tc_chunk_elems`, each its matrices (:func:`tc_chunk_matrices`)
    one after another, each in :func:`core_matrix_order`."""
    T, _, h, _ = w.shape
    blocks = tc_weight_blocks(h, inject, kind)
    mats = [torch.cat([w[:, i] for i in idx], dim=2) for idx, _ in blocks]  # (T, h, inputs)
    pad = torch.nn.functional.pad
    if h != WIDE_HIDDEN:
        parts = [pad(m, (0, width - m.shape[2])) for m, (_, width) in zip(mats, blocks)]
    else:
        if kind == _CHECK_MAJOR:
            raise ValueError(f"{kind} has no streamed layout at h={h}")
        w1v, w1c, w2 = mats  # [f | mean | lf] columns; W2 [W2v W2c]
        parts = []
        for u in range(0, h, WIDE_CHUNK):
            v, c = w1v[:, u:u + WIDE_CHUNK], w1c[:, u:u + WIDE_CHUNK]
            chunk = {"W1f": torch.cat([v[..., :h], c[..., :h]], dim=1),
                     "W1va": v[..., h:2 * h], "W1ca": c[..., h:2 * h],
                     "W1l": torch.cat([v[..., 2 * h:], c[..., 2 * h:]], dim=1),
                     "W2": torch.cat([w2[..., u:u + WIDE_CHUNK],
                                      w2[..., h + u:h + u + WIDE_CHUNK]], dim=2)}
            parts += [core_matrix_order(chunk[name])
                      for name, _, _ in tc_chunk_matrices(h, inject)]
    return torch.cat([x.reshape(T, -1) for x in parts], dim=1).to(torch.bfloat16).contiguous()


class _MsgTables:
    """What a ``msg_gnn`` launch and its plain version read, on one device.

    ``w`` (T, 8, h, h): layer t's weight matrices, values rounded to bf16,
    kept as float32, order va, ca, vl, cl, vf, cf, W2v, W2c (the LLR blocks
    vl, cl are zero without injection); ``w_bf16`` the kernel's copy, packed
    by :func:`pack_tc_weights`.
    ``tab``: ``msg_gnn[_v2]`` (T, 2, K, h), the first-layer biases per edge,
    b1v then b1c; ``msg_gnn_v3/_v4`` (T + 1, K, h), the delta table ``dte``.
    ``small``: ``msg_gnn`` (T, 2h) b2v, b2c; ``msg_gnn_v2`` (T, h) b2v +
    b2c; ``msg_gnn_v3/_v4`` (T, 3h) b1v, b1c, b2 (v3's b2 rounded to bf16:
    it enters the product through a ones-row).
    ``emb`` (3h + 1): emb_w, emb_b, proj_w, proj_b; ``msg_gnn_v4`` holds
    bf16(proj_w) and 0 (its proj_b rides in ``dsc``).
    ``extra``: ``msg_gnn_v4`` (2h + K) w2last, dsc; else one zero.
    """

    def __init__(self, kind: str, qc: QCLayout, params, T: int, h: int, share_layers: bool,
                 input_injection: bool, device: torch.device):
        extra = np.zeros(1, np.float32)
        if kind in _FOLDED:
            x = _extract_v3(params, qc, T, h, share_layers, input_injection)
            w = np.stack([x[name] for name in ("W1va", "W1ca", "W1vl", "W1cl", "W1vf", "W1cf",
                                               "W2v", "W2c")], axis=1)
            b2 = _bf16_round(x["b2"]).numpy() if kind == "msg_gnn_v3" else x["b2"]
            small = np.concatenate([x["b1v"], x["b1c"], b2], axis=1)
            tab = _te_deltas(x["te"])
            proj_w, proj_b = x["proj_w"], x["proj_b"]
            if kind == "msg_gnn_v4":
                w2last, proj_w, dsc = _last_layer_folds(x)
                proj_b = 0.0
                extra = np.concatenate([w2last, dsc])
        else:
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
                small = x["b2v"] + x["b2c"]
            tab = np.stack([x["bias1v"], x["bias1c"]], axis=1).transpose(0, 1, 3, 2)
            proj_w, proj_b = x["proj_w"], x["proj_b"]
        self.w = _bf16_round(w).to(device)
        self.w_bf16 = pack_tc_weights(self.w, input_injection, kind)
        self.tab = torch.from_numpy(np.ascontiguousarray(tab, np.float32)).to(device)
        self.small = torch.from_numpy(np.ascontiguousarray(small, np.float32)).to(device)
        self.emb = torch.from_numpy(np.concatenate(
            [x["emb_w"], x["emb_b"], proj_w, [proj_b]]).astype(np.float32)).to(device)
        self.extra = torch.from_numpy(np.ascontiguousarray(extra, np.float32)).to(device)
        self.inv, self.graph = _structure_tensors(qc, device)


def msg_gnn_smem_bytes(qc: QCLayout, hidden_dim: int, kind: str = "msg_gnn",
                       input_injection: bool = False, warps: int = 1) -> int:
    """Dynamic shared memory of one ``kind`` block of ``warps`` warps (mirrors
    make_layout in csrc/fused_msg_gnn_tc.cu): graph, inverse degrees, the
    frame's LLRs, embedding and projection, the layer's biases (one row of
    ``_MsgTables.small``), its packed bf16 weights (:func:`tc_weight_blocks`),
    v3's staged deltas (K h bf16) and the two stage buffers of a warp, 16 rows
    of h + 8 bf16 each of the message-major kernels' features, vmean and
    rmean; of v3's features and vmean.  At h = ``WIDE_HIDDEN`` the weights
    are the ring, ``WIDE_STAGES`` chunks of :func:`tc_chunk_elems`, then each
    whole warpgroup of the block has one tile buffer (features, vmean, rmean
    and with injection lf of ``WIDE_ROWS`` messages, h bf16 each), then the
    ring's full barrier and release count (8 bytes each a stage)."""
    K, Z, C, R, h = qc.num_base_edges, qc.Z, qc.num_base_cols, qc.num_base_rows, hidden_dim
    v3 = kind == _CHECK_MAJOR
    small = h if kind == "msg_gnn_v2" else (2 if kind == "msg_gnn" else 3) * h
    state = 4 * (_r4(6 * K + R + C + 2) + _r4(C + R) + _r4(C * Z) + _r4(3 * h + 1) + small)
    if h == WIDE_HIDDEN:
        mats = 4 if input_injection else 3
        return (state + 2 * WIDE_STAGES * tc_chunk_elems(h, input_injection)
                + warps // 4 * mats * 2 * WIDE_ROWS * h + 2 * 8 * WIDE_STAGES)
    weights = h * sum(width for _, width in tc_weight_blocks(h, input_injection, kind))
    return (state + 2 * weights + (2 * K * h if v3 else 0)
            + warps * 2 * 2 * (2 if v3 else 3) * _TILE * (h + 8))


def msg_gnn_scratch_floats(qc: QCLayout, hidden_dim: int, kind: str = "msg_gnn") -> int:
    """Global scratch of one resident block (scratch_elems in
    csrc/fused_msg_gnn_tc.cu), in floats: a frame's features and variable
    means, one bf16 h-row each; the message-major kernels then the check
    means; ``msg_gnn_v4`` then one float32 output scalar per message (K Z,
    rounded up to 16 bytes).  Injection adds nothing."""
    K, Z, C, R, h = qc.num_base_edges, qc.Z, qc.num_base_cols, qc.num_base_rows, hidden_dim
    if kind == _CHECK_MAJOR:
        return (K + C) * Z * h // 2
    return (K + C + R) * Z * h // 2 + (_r4(K * Z) if kind == "msg_gnn_v4" else 0)


def _variable_sums(terms: torch.Tensor, adds: torch.Tensor, ix: _PlainIndex) -> torch.Tensor:
    """The output stage's per-variable sum, (B, K, Z) -> (B, C, Z): over a
    column's messages in col_members order, acc = (acc + terms[k]) + adds[k]
    (``adds`` (K,) or a scalar); pads add nothing."""
    K = terms.shape[1]
    adds = adds.expand(K)
    acc = terms.new_zeros((terms.shape[0], ix.col_edges.shape[0], terms.shape[2]))
    for j in range(ix.col_edges.shape[1]):
        v = ix.col_valid[:, j][None, :, None]
        k = ix.col_edges[:, j].clamp(max=K - 1)
        acc = torch.where(v, (acc + terms[:, k]) + adds[k][None, :, None], acc)
    return acc


class _MsgPlain:
    """The plain version of one ``msg_gnn`` kernel for one decoder."""

    def __init__(self, kind: str, qc: QCLayout, tables: _MsgTables, T: int, h: int,
                 inject: bool):
        self.kind, self.T, self.h, self.inject = kind, T, h, inject
        self.tb = tables
        self.ix = _PlainIndex(qc, tables.w.device)
        self.Z, self.C, self.R, self.K = qc.Z, qc.num_base_cols, qc.num_base_rows, qc.num_base_edges

    def _to_edges(self, pre_row: torch.Tensor) -> torch.Tensor:
        """Check-aligned (B, R, Z, h) -> the value each message reads (B, K, Z, h)."""
        B, h = pre_row.shape[0], pre_row.shape[-1]
        return pre_row.reshape(B, self.R * self.Z, h)[:, self.ix.edge_check].reshape(
            B, self.K, self.Z, h)

    def _soft(self, llr: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        """Output stage: projection, per-variable sum, sigmoid of the bit-1 logit."""
        h = self.h
        contrib = (f * self.tb.emb[2 * h:3 * h]).sum(dim=-1)  # (B, K, Z)
        acc = _variable_sums(contrib, self.tb.emb[3 * h], self.ix)
        return 1.0 / (1.0 + torch.exp(llr + acc.reshape(llr.shape[0], -1)))

    def decode(self, llr: torch.Tensor) -> torch.Tensor:
        """(B, n) -> soft bits (B, n)."""
        tb, ix, h, Z = self.tb, self.ix, self.h, self.Z
        B = llr.shape[0]
        emb_w, emb_b = tb.emb[:h], tb.emb[h:2 * h]
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
            pv = f @ Wvf
            pc = (f @ Wcf + self._to_edges(pre_row)) + b1c
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
        return self._soft(llr, f)


class _FoldPlain(_MsgPlain):
    """The plain version of ``msg_gnn_v3`` or ``msg_gnn_v4``: the type
    embeddings ride in the features (seeded with te_0, moved on by the delta
    table at each writeback), the first-layer biases fold into the
    per-variable and per-check terms, and the v-side LLR term into the
    per-variable one.  v3 projects each message by W1ca and averages the
    products over the check in float32; v4 averages the features, rounds the
    mean to bf16 and projects it, and folds its last layer into thin rows."""

    def decode(self, llr: torch.Tensor) -> torch.Tensor:
        tb, ix, h, Z, T = self.tb, self.ix, self.h, self.Z, self.T
        v4 = self.kind == "msg_gnn_v4"
        B = llr.shape[0]
        inv_dc = tb.inv[: self.C][None, :, None, None]
        inv_dr = tb.inv[self.C:][None, :, None, None]
        llr_cz = llr.reshape(B, self.C, Z)
        f0 = llr_cz[..., None] * tb.emb[:h] + tb.emb[h:2 * h]  # (B, C, Z, h) float32
        lf = _r(f0) if self.inject else None
        f = _r(f0[:, ix.cols] + tb.tab[0][None, :, None, :])  # (B, K, Z, h)
        ones = f.new_ones(f.shape[:-1] + (1,))
        for t in range(T):
            Wva, Wca, Wvl, Wcl, Wvf, Wcf, W2v, W2c = (tb.w[t, i].t() for i in range(8))
            b1v, b1c, b2 = tb.small[t, :h], tb.small[t, h:2 * h], tb.small[t, 2 * h:]
            vmean = _r(_member_sum(f, ix.col_edges, ix.col_valid) * inv_dc)  # (B, C, Z, h)
            pre_col = vmean @ Wva + b1v
            if self.inject:
                pre_col = pre_col + lf @ Wvl
            if v4:
                pre_row = _r(_row_sum(f, ix, self.R) * inv_dr) @ Wca + b1c
            else:
                pre_row = _row_sum(f @ Wca, ix, self.R) * inv_dr + b1c
            pv = f @ Wvf + pre_col[:, ix.cols]
            pc = f @ Wcf + self._to_edges(pre_row)
            if self.inject:
                pc = pc + (lf @ Wcl)[:, ix.cols]
            h1 = torch.cat([_r(torch.relu(pv)), _r(torch.relu(pc))], dim=-1)  # (B, K, Z, 2h)
            if v4 and t == T - 1:  # thin last layer: per-message output scalars
                w2last, dsc = tb.extra[:2 * h], tb.extra[2 * h:]
                s = h1 @ w2last
                if t > 0:
                    s = s + f @ tb.emb[2 * h:3 * h]
                acc = _variable_sums(s, dsc, ix)
                return 1.0 / (1.0 + torch.exp(llr + acc.reshape(B, -1)))
            W2 = torch.cat([W2v, W2c], dim=0)  # (2h, h)
            if v4:
                out = _r(h1 @ W2 + b2)
            else:  # b2 through the ones-row of the product
                out = _r(torch.cat([h1, ones], dim=-1) @ torch.cat([W2, b2[None]], dim=0))
            d = _r(tb.tab[t + 1])[None, :, None, :]
            if t == 0:
                f = _r(out + d)
            elif v4:
                f = _r(_r(out + d) + f)
            else:
                f = _r(_r(out + f) + d)
        return self._soft(llr, f)


_TC_SIGNATURES = {"ldpc_msg_gnn_tc_cuda_error_string": ([_I], ctypes.c_char_p)}
for _entry in TC_ENTRY.values():
    _TC_SIGNATURES.update({
        # H, llr, soft, counter, scratch, graph, inv, w, tab, small, emb, extra,
        # B, Z, R, C, K, T, inject, grid, warps, stream
        _entry: ([_I] + [_P] * 11 + [_I] * 9 + [_P], _I),
        # H, inject, Z, R, C, K, warps
        f"{_entry}_tc_smem_bytes": ([_I] * 7, ctypes.c_longlong),
        f"{_entry}_tc_scratch_floats": ([_I] * 5, ctypes.c_longlong),  # H, Z, R, C, K
        f"{_entry}_tc_plan": ([_I] * 6 + [_P, _P], _I),  # H, inject, Z, R, C, K, *warps, *blocks
    })


def tc_kernel_library():
    """The compiled ``csrc/fused_msg_gnn_tc.cu``, built on first use."""
    from ldpc_tpu_torch.ops import _build

    return _build.load("fused_msg_gnn_tc", _TC_SIGNATURES)


def msg_gnn_tc_plan(qc: QCLayout, hidden_dim: int, input_injection: bool,
                    kind: str = "msg_gnn_v2") -> tuple[int, int]:
    """(warps a block, blocks an SM) of the ``kind`` kernel on the current
    card: the runtime's occupancy query over every block size, the most
    resident warps per SM (csrc/fused_msg_gnn_tc.cu)."""
    lib = tc_kernel_library()
    warps, blocks = ctypes.c_int(0), ctypes.c_int(0)
    dims = (hidden_dim, int(input_injection), qc.Z, qc.num_base_rows, qc.num_base_cols,
            qc.num_base_edges)
    rc = getattr(lib, f"{TC_ENTRY[kind]}_tc_plan")(*dims, ctypes.addressof(warps),
                                                    ctypes.addressof(blocks))
    if rc != 0:
        msg = lib.ldpc_msg_gnn_tc_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kind} occupancy query failed: CUDA error {rc} ({msg})")
    return warps.value, blocks.value


class FusedMessageGNNDecoder(_ResidentGridDecoder):
    """``decode(llr) -> soft``: (B, n) float32 LLRs to (B, n) float32 soft
    bits of a fully-neural message GNN.

    Launches the ``kind`` kernel for CUDA tensors and runs the plain version
    for CPU tensors; ``plain(llr)`` runs the plain version on any device.
    """

    def __init__(self, kind: str, qc: QCLayout, params, num_iterations: int, hidden_dim: int,
                 share_layers: bool, input_injection: bool, device: torch.device):
        super().__init__(kind, qc, num_iterations, hidden_dim, input_injection)
        self._warps = 0  # the block size, from the kernel's plan at the first launch
        self.tables = _MsgTables(kind, qc, params, self.num_iterations, self.hidden_dim,
                                 share_layers, self.input_injection, device)

    def _new_plain(self):
        plain = _FoldPlain if self.kind in _FOLDED else _MsgPlain
        return plain(self.kind, self.qc, self.tables, self.num_iterations, self.hidden_dim,
                     self.input_injection)

    def _run_plain(self, llr: torch.Tensor) -> torch.Tensor:
        outs = self._plain_chunks(llr)
        return torch.cat(outs) if outs else torch.empty_like(llr)

    def _launch(self, llr: torch.Tensor) -> torch.Tensor:
        if not llr.is_contiguous():
            raise ValueError("llr must be contiguous")
        qc, h, tb, inject = self.qc, self.hidden_dim, self.tables, self.input_injection
        soft = torch.empty_like(llr)
        if llr.shape[0] == 0:
            return soft
        lib = tc_kernel_library()
        entry = getattr(lib, TC_ENTRY[self.kind])

        def blocks_per_sm() -> int:
            self._warps, blocks = msg_gnn_tc_plan(qc, h, inject, self.kind)
            return blocks

        def launch(counter, scratch, grid, stream):
            return entry(h, llr.data_ptr(), soft.data_ptr(), counter, scratch,
                         tb.graph.data_ptr(), tb.inv.data_ptr(), tb.w_bf16.data_ptr(),
                         tb.tab.data_ptr(), tb.small.data_ptr(), tb.emb.data_ptr(),
                         tb.extra.data_ptr(), llr.shape[0], *_dims(qc), self.num_iterations,
                         int(inject), grid, self._warps, stream)

        self._launch_grid(llr, blocks_per_sm, msg_gnn_scratch_floats(qc, h, self.kind),
                          launch, lib.ldpc_msg_gnn_tc_cuda_error_string)
        return soft


def _make_msg(kind: str, qc: QCLayout, params, num_iterations: int, hidden_dim: int,
              share_layers: bool, input_injection: bool, device) -> FusedMessageGNNDecoder:
    wide = hidden_dim == WIDE_HIDDEN
    _check_build(kind, num_iterations, hidden_dim,
                 msg_gnn_smem_bytes(qc, hidden_dim, kind, input_injection,
                                    WIDE_WARPS if wide else 1),
                 "LLRs, the weight chunk ring and the warpgroups' tile buffers" if wide
                 else "LLRs, one layer's weights and one warp's tile buffers", qc)
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
    ``hidden_dim`` in ``KERNEL_HIDDEN_DIMS["msg_gnn"]``; another width raises
    (the v2 and v4 kernels also take 128).  The JAX
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
    :func:`make_fused_gnn_decoder`; the two differ in that rounding), also
    at ``hidden_dim`` 128 (``msg_gnn_wide_tc_kernel``).  ``mm_group`` (the
    TPU kernel's edge-group size) and ``interpret`` are the JAX builder's and
    change nothing here."""
    del mm_group, interpret
    return _make_msg("msg_gnn_v2", qc, params, num_iterations, hidden_dim, share_layers,
                     input_injection, device)


def make_fused_gnn_decoder_v3(
    qc: QCLayout,
    params,
    num_iterations: int = 5,
    hidden_dim: int = 64,
    share_layers: bool = False,
    input_injection: bool = False,
    interpret: bool = False,
    device="cuda",
) -> FusedMessageGNNDecoder:
    """The fully-neural decoder as ``pallas_gnn._kernel_v3`` computes it:
    the type embeddings ride in the bf16 features, the first-layer biases
    and the v-side LLR term fold into the per-variable and per-check terms,
    the check side projects each message by W1ca and averages the products
    in float32, and b2 enters the second product through a bf16 ones-row.
    Same flags and outputs as :func:`make_fused_gnn_decoder`; ``interpret``
    changes nothing here."""
    del interpret
    return _make_msg("msg_gnn_v3", qc, params, num_iterations, hidden_dim, share_layers,
                     input_injection, device)


def make_fused_gnn_decoder_v4(
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
    """The fully-neural decoder as ``pallas_gnn._kernel_v4`` computes it:
    v3's folds on :func:`make_fused_gnn_decoder_v2`'s layer (the check mean
    rounded to bf16 and projected, b2 added in float32), with the last
    layer's second product and writeback folded into thin rows through the
    output projection; also at ``hidden_dim`` 128
    (``msg_gnn_wide_tc_kernel``).  ``mm_group`` (the TPU kernel's edge-group
    size) changes no number: each message's column of the product is
    independent; it and ``interpret`` change nothing here."""
    del mm_group, interpret
    return _make_msg("msg_gnn_v4", qc, params, num_iterations, hidden_dim, share_layers,
                     input_injection, device)
