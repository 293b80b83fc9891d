"""Message-centered GNN LDPC decoder family (counterpart of
``ldpc_tpu.models.message_gnn``).

Messages (Tanner-graph edges) are the GNN nodes; two relations connect
messages sharing a variable or a check; weights are shared by base-graph
*message type* (= circulant shift value).  The aggregation over each relation
is the within-group mean of :func:`ldpc_tpu_torch.ops.qc_msg.var_group_mean`
and :func:`~ldpc_tpu_torch.ops.qc_msg.check_group_mean`.

``var_mode`` / ``check_mode`` select a neural half-update, the classical
min-sum half-update, or ``"corrected"``: min-sum *plus* a GNN correction
whose projection starts at zero, so the untrained decoder is exactly scaled
min-sum.  The corrected decoder is served on the card by the kernels of
:mod:`ldpc_tpu_torch.ops.fused_gnn`; this module is the reference forward
and what :class:`ldpc_tpu_torch.training.LDPCDecoderTrainer` differentiates.

Parameter names follow the flax module (``check_3_gnn.var_to_check_update.
Dense_0.weight`` for ``check_3_gnn/var_to_check_update/Dense_0/kernel``), so
:mod:`ldpc_tpu_torch.convert` carries checkpoints across by renaming alone.
``remat=True`` recomputes each GNN layer on the backward pass
(``torch.utils.checkpoint``), as the flax module's ``nn.remat`` does.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ldpc_tpu_torch.ops import qc_msg
from ldpc_tpu_torch.ops.qc_msg import QCPlan

MODES = ("neural", "minsum", "corrected")


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """Truncated normal at +-2 sigma with variance 1 / fan_in (flax's default
    ``Dense`` kernel initialiser)."""
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


def _dense(in_dim: int, out_dim: int, generator: torch.Generator, zero_kernel=False) -> nn.Linear:
    lin = nn.Linear(in_dim, out_dim)
    with torch.no_grad():
        if zero_kernel:
            lin.weight.zero_()
        else:
            _lecun_normal_(lin.weight, generator)
        lin.bias.zero_()
    return lin


def _apply_dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x @ W^T + b`` in ``dtype``: the product and the bias add each round
    to ``dtype``, as flax's ``Dense(dtype=...)`` does."""
    return torch.matmul(x.to(dtype), lin.weight.to(dtype).t()) + lin.bias.to(dtype)


def _embed(lin: nn.Linear, msgs: torch.Tensor) -> torch.Tensor:
    """``Linear(1 -> h)`` of a scalar per message, in float32: a multiply and
    an add, each rounded (the order the fused kernels repeat)."""
    return msgs[..., None] * lin.weight[:, 0] + lin.bias


def _project(lin: nn.Linear, feats: torch.Tensor) -> torch.Tensor:
    """``Linear(h -> 1)`` in float32, last axis dropped."""
    return _apply_dense(lin, feats, torch.float32)[..., 0]


class MLP2(nn.Module):
    """Linear(in -> h) / ReLU / Linear(h -> h)."""

    def __init__(self, in_dim: int, hidden_dim: int, compute_dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.Dense_0 = _dense(in_dim, hidden_dim, generator)
        self.Dense_1 = _dense(hidden_dim, hidden_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(_apply_dense(self.Dense_0, x, self.compute_dtype))
        return _apply_dense(self.Dense_1, x, self.compute_dtype)


class MessageGNNLayer(nn.Module):
    """One message-GNN iteration: type embedding + two relation MLPs.

    ``combined = f + type_emb``; var-relation update MLP([combined,
    var_mean(combined)]); check-relation update MLP([combined,
    check_mean(combined)]); sum of both halves.  ``llr_feats`` (with
    ``input_injection``) are per-message channel-LLR features appended to
    both MLP inputs.  ``compute_dtype=torch.bfloat16`` (default) runs the MLPs
    in bf16 with float32 parameters; ``torch.float32`` works too.
    """

    def __init__(self, hidden_dim: int = 64, num_message_types: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16, input_injection: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.compute_dtype = compute_dtype
        te = torch.empty((num_message_types, hidden_dim))
        nn.init.normal_(te, std=0.1, generator=gen)  # moderate embedding scale
        self.message_type_embeddings = nn.Parameter(te)
        in_dim = (3 if input_injection else 2) * hidden_dim
        self.var_to_check_update = MLP2(in_dim, hidden_dim, compute_dtype, gen)
        self.check_to_var_update = MLP2(in_dim, hidden_dim, compute_dtype, gen)

    def forward(self, feats: torch.Tensor, plan: QCPlan,
                llr_feats: torch.Tensor | None = None) -> torch.Tensor:
        te = self.message_type_embeddings[plan.edge_type][:, None, None, :]
        combined = (feats + te).to(self.compute_dtype)
        parts_v = [combined, qc_msg.var_group_mean(combined, plan)]
        parts_c = [combined, qc_msg.check_group_mean(combined, plan)]
        if llr_feats is not None:
            parts_v.append(llr_feats)
            parts_c.append(llr_feats)
        v2c = self.var_to_check_update(torch.cat(parts_v, dim=-1))
        c2v = self.check_to_var_update(torch.cat(parts_c, dim=-1))
        return (v2c + c2v).to(self.compute_dtype)


class MessageGNNDecoder(nn.Module):
    """Message-centered GNN decoder: ``forward(llr, plan, ground_truth=None)
    -> (soft_bits (B, n), per-frame loss (B,) or None)``.

    ========================  =========  ===========
    family member             var_mode   check_mode
    ========================  =========  ===========
    fully neural              neural     neural
    custom variable           minsum     neural
    custom check              neural     minsum
    custom min-sum            minsum     minsum
    corrected (flagship)      corrected  corrected
    ========================  =========  ===========

    ``loss_mode="mean"`` is the per-frame mean BCE, ``"max"`` its maximum (a
    FER surrogate).  ``multiloss`` adds the BCE of every iteration's marginals
    to the loss; the decode output is unchanged.  ``depth_L`` is the length of
    the FIFO of past v2c messages the classical variable update adds back
    through ``w_res``; ``damping`` mixes the new v2c with c2v after the first
    iteration.  Initialisation (from ``generator``) keeps the untrained
    identities: projections zero, ``w_ch`` one, ``alpha`` 0.8.  ``remat``
    keeps only each GNN layer's inputs for the backward pass and recomputes
    the layer there: less activation memory for about one more forward of
    the layers; the function and its gradients are unchanged.
    """

    def __init__(self, num_iterations: int = 5, hidden_dim: int = 64,
                 num_message_types: int = 1, var_mode: str = "neural",
                 check_mode: str = "neural", share_layers: bool = False, depth_L: int = 3,
                 damping: float = 0.5, loss_mode: str = "mean",
                 compute_dtype: torch.dtype = torch.bfloat16, input_injection: bool = False,
                 multiloss: bool = False, remat: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if var_mode not in MODES or check_mode not in MODES:
            raise ValueError(f"modes must be among {MODES}, got {var_mode!r}, {check_mode!r}")
        if loss_mode not in ("mean", "max"):
            raise ValueError(f"unknown loss_mode {loss_mode!r}")
        if compute_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"compute_dtype must be bfloat16 or float32, got {compute_dtype}")
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.num_iterations = int(num_iterations)
        self.hidden_dim = int(hidden_dim)
        self.num_message_types = int(num_message_types)
        self.var_mode, self.check_mode = var_mode, check_mode
        self.share_layers = bool(share_layers)
        self.depth_L = int(depth_L)
        self.damping = float(damping)
        self.loss_mode = loss_mode
        self.compute_dtype = compute_dtype
        self.input_injection = bool(input_injection)
        self.multiloss = bool(multiloss)
        self.remat = bool(remat)
        self.fully_neural = var_mode == "neural" and check_mode == "neural"

        def layer():
            return MessageGNNLayer(hidden_dim, num_message_types, compute_dtype,
                                   input_injection, gen)

        T = self.num_iterations
        if self.fully_neural or input_injection or {var_mode, check_mode} != {"minsum"}:
            self.input_embedding = _dense(1, hidden_dim, gen)
        if self.fully_neural:
            for name in (["gnn_layer"] if share_layers else [f"gnn_layer_{i}" for i in range(T)]):
                self.add_module(name, layer())
            # Zero projection: the untrained decoder is a channel pass-through.
            self.output_projection = _dense(hidden_dim, 1, gen, zero_kernel=True)
        else:
            self.w_ch = nn.Parameter(torch.ones(()))
            self.w_res = nn.Parameter(torch.ones((self.depth_L,)))
            self.alpha = nn.Parameter(torch.full((), 0.8))
            # Parameter creation order follows the flax module: per iteration,
            # check half then variable half.
            for i in ([None] if share_layers else range(T)):
                for prefix, mode in (("check", check_mode), ("var", var_mode)):
                    if mode == "minsum":
                        continue
                    name = prefix if i is None else f"{prefix}_{i}"
                    self.add_module(f"{name}_gnn", layer())
                    # Zero projection: neural half-updates start as no-ops.
                    self.add_module(f"{name}_proj", _dense(hidden_dim, 1, gen, zero_kernel=True))

    # -- forward ------------------------------------------------------------

    def _layer(self, layer: MessageGNNLayer, feats: torch.Tensor, plan: QCPlan,
               llr_feats: torch.Tensor | None) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return checkpoint(layer, feats, plan, llr_feats, use_reentrant=False)
        return layer(feats, plan, llr_feats)

    def forward(self, llr: torch.Tensor, plan: QCPlan, ground_truth: torch.Tensor | None = None):
        llr_cz = qc_msg.llr_to_cz(llr, plan)
        edge_llr = llr_cz[plan.edge_col]  # (K, Z, B): message (v, c) starts from LLR of v
        collect = self.multiloss and ground_truth is not None
        per_iter_msgs: list[torch.Tensor] = []

        if self.fully_neural:
            feats = _embed(self.input_embedding, edge_llr).to(self.compute_dtype)  # (K, Z, B, h)
            llr_feats = feats if self.input_injection else None
            for i in range(self.num_iterations):
                layer = self.gnn_layer if self.share_layers else getattr(self, f"gnn_layer_{i}")
                new = self._layer(layer, feats, plan, llr_feats)
                if i > 0:  # residual skip from iteration 2 on
                    new = new + feats
                feats = new
                if collect and i < self.num_iterations - 1:
                    per_iter_msgs.append(_project(self.output_projection, feats))
            msg_llr = _project(self.output_projection, feats)
        else:
            msg_llr = self._hybrid_loop(edge_llr, plan, per_iter_msgs if collect else None)

        def to_logits(msgs):  # bit-1 logits: -(channel LLR + summed message LLRs)
            return -qc_msg.cz_to_llr(llr_cz + qc_msg.col_sum(msgs, plan))

        logits = to_logits(msg_llr)
        soft_bits = torch.sigmoid(logits)

        loss = None
        if ground_truth is not None:
            sign = 1.0 - 2.0 * ground_truth

            def frame_loss(lg):
                bce = torch.logaddexp(sign * lg, torch.zeros_like(lg))  # softplus
                return bce.mean(dim=-1) if self.loss_mode == "mean" else bce.amax(dim=-1)

            loss = frame_loss(logits)
            if collect:
                for m in per_iter_msgs:
                    loss = loss + frame_loss(to_logits(m))
                loss = loss / (len(per_iter_msgs) + 1)
        return soft_bits, loss

    def _half(self, prefix: str, i: int):
        name = prefix if self.share_layers else f"{prefix}_{i}"
        return getattr(self, f"{name}_gnn"), getattr(self, f"{name}_proj")

    def _hybrid_loop(self, edge_llr, plan: QCPlan, per_iter_msgs: list | None):
        """LLR-domain loop with neural, classical or corrected half-updates."""
        v2c = edge_llr  # var-aligned LLR-domain messages
        c2v = torch.zeros_like(edge_llr)
        fifo = edge_llr.new_zeros((self.depth_L,) + tuple(edge_llr.shape))
        llr_feats = (_embed(self.input_embedding, edge_llr).to(self.compute_dtype)
                     if self.input_injection else None)

        def gnn(prefix, i, msgs):
            layer, proj = self._half(prefix, i)
            feats = _embed(self.input_embedding, msgs)
            return _project(proj, self._layer(layer, feats, plan, llr_feats))

        for i in range(self.num_iterations):
            # ---- check half ----
            if self.check_mode == "neural":
                c2v = gnn("check", i, v2c)
            else:
                pre = v2c  # the correction sees the update's inputs
                c2v = qc_msg.check_update_minsum(v2c, plan, alpha=self.alpha)
                if self.check_mode == "corrected":
                    c2v = c2v + gnn("check", i, pre)
            if per_iter_msgs is not None and i < self.num_iterations - 1:
                per_iter_msgs.append(c2v)  # this iteration's marginal messages
            # ---- variable half ----
            if self.var_mode == "neural":
                v2c = gnn("var", i, c2v)
            else:
                colsum = qc_msg.col_sum(c2v, plan)
                loo = colsum[plan.edge_col] - c2v
                new_v2c = loo + self.w_ch * edge_llr
                if self.depth_L:
                    new_v2c = new_v2c + torch.tensordot(self.w_res, fifo, dims=1)
                if i > 0 and self.damping != 1.0:  # damping after the first iteration
                    new_v2c = self.damping * new_v2c + (1.0 - self.damping) * c2v
                if self.var_mode == "corrected":
                    new_v2c = new_v2c + gnn("var", i, c2v)
                if self.depth_L:
                    fifo = torch.cat([new_v2c[None], fifo[:-1]], dim=0)
                v2c = new_v2c
        return c2v

    @torch.no_grad()
    def decode(self, llr: torch.Tensor, plan: QCPlan) -> torch.Tensor:
        """Hard-decision decode: (B, n) LLRs -> (B, n) float32 bits."""
        soft, _ = self(llr, plan)
        return (soft > 0.5).to(torch.float32)


# ---------------------------------------------------------------------------
# Factories.  The module is created on the plan's device (make_plan defaults
# to the card); ``generator`` seeds the initialisation.
# ---------------------------------------------------------------------------


def _build(plan: QCPlan, **kw) -> MessageGNNDecoder:
    model = MessageGNNDecoder(num_message_types=plan.num_edge_types, **kw)
    return model.to(plan.edge_col.device)


def create_message_gnn_decoder(plan: QCPlan, num_iterations=5, hidden_dim=64, **kw):
    """Fully-neural message GNN with per-shift-type weight sharing."""
    return _build(plan, num_iterations=num_iterations, hidden_dim=hidden_dim, **kw)


def create_custom_variable_message_gnn_decoder(plan: QCPlan, num_iterations=5, hidden_dim=64,
                                               depth_L=3, **kw):
    """Classical residual/damped variable update + neural check update."""
    return _build(plan, num_iterations=num_iterations, hidden_dim=hidden_dim,
                  var_mode="minsum", check_mode="neural", depth_L=depth_L, loss_mode="max", **kw)


def create_custom_check_message_gnn_decoder(plan: QCPlan, num_iterations=5, hidden_dim=64, **kw):
    """Neural variable update + classical min-sum check update (learnable alpha)."""
    return _build(plan, num_iterations=num_iterations, hidden_dim=hidden_dim,
                  var_mode="neural", check_mode="minsum", **kw)


def create_corrected_minsum_gnn_decoder(plan: QCPlan, num_iterations=5, hidden_dim=64, **kw):
    """Min-sum with zero-init GNN corrections on both half-updates (flagship).

    ``depth_L=0`` / ``damping=1.0`` make the classical skeleton exactly scaled
    min-sum (learnable alpha, init 0.8; learnable channel weight, init 1), so
    the untrained decoder decodes at the min-sum baseline and training learns
    pure message corrections.
    """
    return _build(plan, num_iterations=num_iterations, hidden_dim=hidden_dim,
                  var_mode="corrected", check_mode="corrected", depth_L=0, damping=1.0, **kw)


def create_custom_minsum_message_gnn_decoder(plan: QCPlan, num_iterations=5, hidden_dim=8,
                                             depth=2, **kw):
    """Both half-updates classical inside the GNN scaffolding."""
    return _build(plan, num_iterations=num_iterations, hidden_dim=hidden_dim,
                  var_mode="minsum", check_mode="minsum", depth_L=depth, **kw)
