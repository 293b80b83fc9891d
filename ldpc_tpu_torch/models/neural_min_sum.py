"""Neural min-sum LDPC decoders with learnable weights (counterpart of
``ldpc_tpu.models.neural_min_sum``).

One module, :class:`NeuralMinSumDecoder`: min-sum message passing over the QC
edge layout with trained channel weights ``w_ch``, residual taps ``w_res`` on
a FIFO of past variable-to-check messages, and an optional learnable scaling
``alpha`` and offset (offset min-sum).  The ``weight_sharing`` axis selects
the standard decoder (one weight per lifted edge) or the tied ones (per
base-graph cell, per shift type, one scalar).

Parameter names and shapes follow the flax module (``w_ch``, ``w_res``,
``alpha``, ``offset``), so :func:`ldpc_tpu_torch.convert.load_neural_min_sum`
carries checkpoints across as they are stored.  A trained decoder is served
on the card by the kernel of :mod:`ldpc_tpu_torch.ops.fused_neural`; this
module is the reference forward (and, in a later slice, what training
differentiates).
"""
from __future__ import annotations

import torch
from torch import nn

from ldpc_tpu_torch.ops import qc_msg
from ldpc_tpu_torch.ops.qc_msg import QCPlan

WEIGHT_SHARINGS = ("edge", "cell", "type", "scalar")


class NeuralMinSumDecoder(nn.Module):
    """Learnable min-sum decoder: ``forward(llr, plan, ground_truth=None) ->
    (soft_bits (B, n), per-frame loss (B,) or None)``.

    ``plan`` at construction sizes the channel weights: ``weight_sharing``
    "edge" (K, Z), "cell" (K,), "type" (num_edge_types,) or "scalar" ();
    ``per_iteration`` puts a leading (T,) on every parameter.  ``w_ch``
    starts at one and ``w_res`` at zero, so the untrained decoder is plain
    min-sum; ``learnable_alpha`` adds ``alpha`` (init 0.8), ``learnable_offset``
    adds ``offset`` (init 0).  ``output_mode``: "sum_plus_input" (channel LLR
    plus the final check messages per variable) or "mean_edges" (their mean).
    ``loss_mode``: per-frame "max" or "mean" of the bit-wise BCE.
    """

    def __init__(self, plan: QCPlan, num_iterations: int = 5, depth_L: int = 2,
                 weight_sharing: str = "edge", learnable_alpha: bool = False,
                 learnable_offset: bool = False, per_iteration: bool = False,
                 output_mode: str = "sum_plus_input", loss_mode: str = "max"):
        super().__init__()
        if weight_sharing not in WEIGHT_SHARINGS:
            raise ValueError(f"unknown weight_sharing {weight_sharing!r}")
        if output_mode not in ("sum_plus_input", "mean_edges"):
            raise ValueError(f"unknown output_mode {output_mode!r}")
        if loss_mode not in ("max", "mean"):
            raise ValueError(f"unknown loss_mode {loss_mode!r}")
        self.num_iterations = int(num_iterations)
        self.depth_L = int(depth_L)
        self.weight_sharing = weight_sharing
        self.learnable_alpha = bool(learnable_alpha)
        self.learnable_offset = bool(learnable_offset)
        self.per_iteration = bool(per_iteration)
        self.output_mode = output_mode
        self.loss_mode = loss_mode
        lead = (self.num_iterations,) if self.per_iteration else ()
        shape = {"edge": (plan.K, plan.Z), "cell": (plan.K,),
                 "type": (plan.num_edge_types,), "scalar": ()}[weight_sharing]
        dev = plan.edge_col.device
        self.w_ch = nn.Parameter(torch.ones(lead + shape, device=dev))
        # Residual taps start at 0: the untrained decoder is classical min-sum.
        self.w_res = nn.Parameter(torch.zeros(lead + (self.depth_L,), device=dev))
        if self.learnable_alpha:
            self.alpha = nn.Parameter(torch.full(lead, 0.8, device=dev))
        if self.learnable_offset:
            self.offset = nn.Parameter(torch.zeros(lead, device=dev))

    def _w_ch(self, plan: QCPlan) -> torch.Tensor:
        """Channel weights broadcast to ([T,] K, Z)."""
        w = self.w_ch
        lead = w.shape[:1] if self.per_iteration else ()
        if self.weight_sharing == "cell":
            w = w[..., None]
        elif self.weight_sharing == "type":
            w = w[..., plan.edge_type][..., None]
        elif self.weight_sharing == "scalar":
            w = w[..., None, None]
        return w.expand(lead + (plan.K, plan.Z))

    def _per_step(self, x: torch.Tensor | float) -> list:
        """A parameter's value at each iteration (shared ones repeat)."""
        T = self.num_iterations
        if isinstance(x, torch.Tensor) and self.per_iteration:
            return [x[t] for t in range(T)]
        return [x] * T

    def forward(self, llr: torch.Tensor, plan: QCPlan, ground_truth: torch.Tensor | None = None):
        B = llr.shape[0]
        llr_cz = qc_msg.llr_to_cz(llr, plan)  # (C, Z, B)
        edge_llr = llr_cz[plan.edge_col]  # (K, Z, B) per-edge channel copies
        T = self.num_iterations
        steps = zip(self._per_step(self._w_ch(plan)), self._per_step(self.w_res),
                    self._per_step(self.alpha if self.learnable_alpha else 1.0),
                    self._per_step(self.offset if self.learnable_offset else 0.0))
        q = edge_llr
        fifo = llr.new_zeros((self.depth_L, plan.K, plan.Z, B))  # newest first
        c2v = None
        for t, (w_ch_t, w_res_t, alpha_t, offset_t) in enumerate(steps):
            c2v = qc_msg.check_update_minsum(q, plan, alpha=alpha_t, offset=offset_t)
            if t + 1 == T:
                break  # the last variable update feeds nothing
            # Leave-one-out sum of check messages + weighted channel LLR +
            # residual taps on the FIFO.
            colsum = qc_msg.col_sum(c2v, plan)
            q = colsum[plan.edge_col] - c2v + w_ch_t[..., None] * edge_llr
            if self.depth_L:
                q = q + torch.tensordot(w_res_t, fifo, dims=1)
                fifo = torch.cat([q[None], fifo[:-1]], dim=0)

        if self.output_mode == "sum_plus_input":
            combined = llr_cz + qc_msg.col_sum(c2v, plan)
        else:  # mean_edges
            counts = plan.col_incidence.sum(dim=1)[:, None, None]
            combined = qc_msg.col_sum(c2v, plan) / torch.clamp(counts, min=1.0)
        # LLR > 0 -> bit 0, so the bit-1 logit is -LLR.
        logits = -qc_msg.cz_to_llr(combined)
        soft_bits = torch.sigmoid(logits)

        loss = None
        if ground_truth is not None:
            # Stable BCE straight from the logits: softplus((1 - 2b) * logit).
            x = (1.0 - 2.0 * ground_truth) * logits
            bce = torch.logaddexp(x, torch.zeros_like(x))
            loss = bce.amax(dim=-1) if self.loss_mode == "max" else bce.mean(dim=-1)
        return soft_bits, loss

    @torch.no_grad()
    def decode(self, llr: torch.Tensor, plan: QCPlan) -> torch.Tensor:
        """Hard-decision decode: (B, n) LLRs -> (B, n) float32 bits."""
        soft, _ = self(llr, plan)
        return (soft > 0.5).to(torch.float32)


def make_standard_decoder(plan: QCPlan, num_iterations: int = 5, depth_L: int = 2,
                          **kw) -> NeuralMinSumDecoder:
    """The standard decoder: one channel weight per lifted edge."""
    return NeuralMinSumDecoder(plan, num_iterations=num_iterations, depth_L=depth_L,
                               weight_sharing="edge", **kw)


def make_tied_decoder(plan: QCPlan, num_iterations: int = 5, depth_L: int = 2,
                      sharing: str = "cell", **kw) -> NeuralMinSumDecoder:
    """The tied decoder: channel weights shared across the Z lifted copies of
    each base-graph cell (or per shift type, or one scalar)."""
    return NeuralMinSumDecoder(plan, num_iterations=num_iterations, depth_L=depth_L,
                               weight_sharing=sharing, **kw)
