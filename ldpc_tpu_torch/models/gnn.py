"""Node-centered GNN LDPC decoder on the Tanner graph (counterpart of
``ldpc_tpu.models.gnn``).

Belief-propagation iterations whose trainable degrees of freedom are indexed
by **edge type** and shared across all edges of that type:

* ``w_ch[type]``  — channel-LLR weights (init 1)
* ``w_c2v[type]`` — check-message scaling (init 1)
* ``w_res[L]``    — residual taps on a FIFO of past variable messages (init 0)

``type_source`` selects the sharing: "shift" shares by circulant shift value
(``num_edge_types`` classes), "cell" by base-graph cell, so every Z-lifted
copy of a base edge shares its weights.  With its initial weights the
decoder is min-sum at alpha = 1 without freezing.  The decoder has no kernel
of its own; its weights carry across from flax through
:func:`ldpc_tpu_torch.convert.load_gnn`.
"""
from __future__ import annotations

import torch
from torch import nn

from ldpc_tpu_torch.ops import qc_msg
from ldpc_tpu_torch.ops.qc_msg import QCPlan

TYPE_SOURCES = ("shift", "cell")


class GNNLDPCDecoder(nn.Module):
    """Tanner-graph GNN decoder with typed weight sharing:
    ``forward(llr, plan, ground_truth=None) -> (soft_bits (B, n), per-frame
    loss (B,) or None)``.  ``loss_mode``: per-frame "max" or "mean" of the
    bit-wise BCE."""

    def __init__(self, plan: QCPlan, num_iterations: int = 5, depth_L: int = 2,
                 type_source: str = "shift", loss_mode: str = "max"):
        super().__init__()
        if type_source not in TYPE_SOURCES:
            raise ValueError(f"unknown type_source {type_source!r}")
        if loss_mode not in ("max", "mean"):
            raise ValueError(f"unknown loss_mode {loss_mode!r}")
        self.num_iterations = int(num_iterations)
        self.depth_L = int(depth_L)
        self.type_source = type_source
        self.loss_mode = loss_mode
        num_types = plan.num_edge_types if type_source == "shift" else plan.K
        dev = plan.edge_col.device
        self.w_ch = nn.Parameter(torch.ones((num_types,), device=dev))
        self.w_c2v = nn.Parameter(torch.ones((num_types,), device=dev))
        # Residual taps start at 0: the untrained decoder is min-sum.
        self.w_res = nn.Parameter(torch.zeros((self.depth_L,), device=dev))

    def _types(self, plan: QCPlan) -> torch.Tensor:
        if self.type_source == "shift":
            return plan.edge_type
        return torch.arange(plan.K, device=plan.edge_col.device)

    def forward(self, llr: torch.Tensor, plan: QCPlan, ground_truth: torch.Tensor | None = None):
        B = llr.shape[0]
        llr_cz = qc_msg.llr_to_cz(llr, plan)  # (C, Z, B)
        edge_llr = llr_cz[plan.edge_col]  # (K, Z, B)
        types = self._types(plan)
        w_ch = self.w_ch[types][:, None, None]
        w_c2v = self.w_c2v[types][:, None, None]
        q = edge_llr
        fifo = llr.new_zeros((self.depth_L, plan.K, plan.Z, B))  # newest first
        c2v = None
        for t in range(self.num_iterations):
            c2v = w_c2v * qc_msg.check_update_minsum(q, plan, alpha=1.0)
            if t + 1 == self.num_iterations:
                break  # the last variable update feeds nothing
            colsum = qc_msg.col_sum(c2v, plan)
            q = colsum[plan.edge_col] - c2v + w_ch * edge_llr
            if self.depth_L:
                q = q + torch.tensordot(self.w_res, fifo, dims=1)
                fifo = torch.cat([q[None], fifo[:-1]], dim=0)

        logits = -qc_msg.cz_to_llr(llr_cz + qc_msg.col_sum(c2v, plan))  # bit-1 logits
        soft_bits = torch.sigmoid(logits)
        loss = None
        if ground_truth is not None:
            x = (1.0 - 2.0 * ground_truth) * logits
            bce = torch.logaddexp(x, torch.zeros_like(x))  # softplus
            loss = bce.amax(dim=-1) if self.loss_mode == "max" else bce.mean(dim=-1)
        return soft_bits, loss

    @torch.no_grad()
    def decode(self, llr: torch.Tensor, plan: QCPlan) -> torch.Tensor:
        """Hard-decision decode: (B, n) LLRs -> (B, n) float32 bits."""
        soft, _ = self(llr, plan)
        return (soft > 0.5).to(torch.float32)


def make_gnn_decoder(plan: QCPlan, num_iterations: int = 5, depth_L: int = 2,
                     **kw) -> GNNLDPCDecoder:
    """``GNNLDPCDecoder`` with shift-type sharing."""
    return GNNLDPCDecoder(plan, num_iterations=num_iterations, depth_L=depth_L,
                          type_source="shift", **kw)


def make_base_graph_gnn_decoder(plan: QCPlan, num_iterations: int = 5, depth_L: int = 2,
                                **kw) -> GNNLDPCDecoder:
    """``GNNLDPCDecoder`` with per-base-cell sharing (``BaseGraphGNNDecoder``)."""
    return GNNLDPCDecoder(plan, num_iterations=num_iterations, depth_L=depth_L,
                          type_source="cell", **kw)
