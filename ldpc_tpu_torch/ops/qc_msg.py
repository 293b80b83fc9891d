"""Core QC message-passing operations, plain PyTorch (counterpart of
``ldpc_tpu.ops.qc_msg``).

* Messages are stored **var-aligned** as (K, Z, B) blocks (K base edges,
  Z lifted lanes, B batch).  See :mod:`ldpc_tpu_torch.codes.edge_layout` for
  the alignment conventions.
* Per-variable sums are an incidence matmul (C, K) @ (K, Z*B).
* The check<->variable regrouping is a precomputed index gather that composes
  the row grouping with the circulant roll.
* Leave-one-out is computed by total-reduce + exclusion (sum: subtract own;
  min: min/second-min select).

These ops run on any device and are differentiable; they back the tensor-op
decoders in :mod:`ldpc_tpu_torch.models.classical`.  The serving path runs
the hand-written kernels of :mod:`ldpc_tpu_torch.ops.fused_minsum` instead.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ldpc_tpu_torch._device import resolve_device
from ldpc_tpu_torch.codes.edge_layout import QCLayout

# Stand-in for +inf.  Deliberately moderate: sentinel values must stay far
# from the float32 overflow boundary even when multiplied together
# (1e9^2 = 1e18 is safe).  Real message magnitudes are bounded by ~1e4.
_BIG = 1e9


@dataclasses.dataclass(frozen=True)
class QCPlan:
    """Device-resident index tensors derived from a :class:`QCLayout`.

    The dimensions are plain ints; every array is a tensor on one device.
    """

    Z: int
    R: int
    C: int
    K: int
    dr_max: int
    num_edge_types: int
    edge_col: torch.Tensor  # (K,) int64
    edge_type: torch.Tensor  # (K,) int64
    row_gather_var: torch.Tensor  # (R*dr_max*Z,) flat, int64
    ungroup_to_var: torch.Tensor  # (K*Z,) flat, int64
    row_valid: torch.Tensor  # (R, dr_max) bool
    col_incidence: torch.Tensor  # (C, K) f32
    edge_check_var_aligned: torch.Tensor  # (K*Z,) flat idx into (R*Z): my check node
    row_incidence: torch.Tensor  # (R, K) f32
    edge_row: torch.Tensor  # (K,) int64
    roll_to_check: torch.Tensor  # (K, Z): var-aligned -> check-aligned lane index
    roll_to_var: torch.Tensor  # (K, Z): check-aligned -> var-aligned lane index

    def to(self, device) -> "QCPlan":
        """A copy of the plan with every tensor on ``device``."""
        dev = resolve_device(device)
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(dev)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })


def make_plan(qc: QCLayout, device="cuda") -> QCPlan:
    """Decode plan for ``qc`` with its index tensors on ``device``."""
    dev = resolve_device(device)
    # Check index of the var-aligned edge (k, z_c): (edge_row, (z_c - s) % Z).
    Z = qc.Z
    zc = np.arange(Z)[None, :]
    chk = qc.edge_row[:, None] * Z + (zc - qc.edge_shift[:, None]) % Z
    row_inc = np.zeros((qc.num_base_rows, qc.num_base_edges), dtype=np.float32)
    row_inc[qc.edge_row, np.arange(qc.num_base_edges)] = 1.0
    roll_to_check = (zc + qc.edge_shift[:, None]) % Z  # (K, Z)
    roll_to_var = (zc - qc.edge_shift[:, None]) % Z

    def idx(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

    return QCPlan(
        Z=Z,
        R=qc.num_base_rows,
        C=qc.num_base_cols,
        K=qc.num_base_edges,
        dr_max=qc.dr_max,
        num_edge_types=qc.num_edge_types,
        edge_col=idx(qc.edge_col),
        edge_type=idx(qc.edge_type),
        row_gather_var=idx(qc.row_gather_var.reshape(-1)),
        ungroup_to_var=idx(qc.ungroup_to_var.reshape(-1)),
        row_valid=torch.as_tensor(qc.row_edges != qc.num_base_edges, device=dev),
        col_incidence=torch.as_tensor(qc.col_incidence, device=dev),
        edge_check_var_aligned=idx(chk.reshape(-1)),
        row_incidence=torch.as_tensor(row_inc, device=dev),
        edge_row=idx(qc.edge_row),
        roll_to_check=idx(roll_to_check),
        roll_to_var=idx(roll_to_var),
    )


def plan_from_H(H, device="cuda") -> QCPlan:
    """Decode plan for an arbitrary dense binary parity-check matrix.

    Wraps H as a Z=1 base graph (each 1 = a size-1 circulant) and builds the
    normal QC plan, so every decoder accepts a non-QC code.
    """
    from ldpc_tpu_torch.codes.base_graphs import base_graph_from_H
    from ldpc_tpu_torch.codes.edge_layout import qc_layout

    return make_plan(qc_layout(base_graph_from_H(H), 1), device)


# ---------------------------------------------------------------------------
# Layout helpers
# ---------------------------------------------------------------------------


def llr_to_cz(llr: torch.Tensor, plan: QCPlan) -> torch.Tensor:
    """(B, n) channel LLRs -> (C, Z, B) grid."""
    B = llr.shape[0]
    return llr.reshape(B, plan.C, plan.Z).permute(1, 2, 0)


def cz_to_llr(grid: torch.Tensor) -> torch.Tensor:
    """(C, Z, B) -> (B, n)."""
    C, Z, B = grid.shape
    return grid.permute(2, 0, 1).reshape(B, C * Z)


def col_sum(msgs_var: torch.Tensor, plan: QCPlan) -> torch.Tensor:
    """Sum messages per variable: (K, Z, B) -> (C, Z, B), as a matmul."""
    K, Z, B = msgs_var.shape
    flat = msgs_var.reshape(K, Z * B)
    return torch.matmul(plan.col_incidence, flat).reshape(plan.C, Z, B)


def group_to_check(msgs_var: torch.Tensor, plan: QCPlan, pad_value: float = 0.0) -> torch.Tensor:
    """Var-aligned (K, Z, B) -> check-grouped (R, dr_max, Z, B).

    Composes the row grouping and circulant roll in one index gather.
    """
    K, Z, B = msgs_var.shape
    padded = torch.cat(
        [msgs_var.reshape(K * Z, B),
         torch.full((1, B), pad_value, dtype=msgs_var.dtype, device=msgs_var.device)],
        dim=0,
    )
    return padded[plan.row_gather_var].reshape(plan.R, plan.dr_max, Z, B)


def ungroup_to_var(grouped: torch.Tensor, plan: QCPlan) -> torch.Tensor:
    """Check-grouped (R, dr_max, Z, B) -> var-aligned (K, Z, B)."""
    R, D, Z, B = grouped.shape
    return grouped.reshape(R * D * Z, B)[plan.ungroup_to_var].reshape(plan.K, Z, B)


# ---------------------------------------------------------------------------
# Variable-node update
# ---------------------------------------------------------------------------


def var_update(c2v_var: torch.Tensor, llr_cz: torch.Tensor, plan: QCPlan):
    """Leave-one-out variable update.

    Returns ``(v2c_var, beliefs)`` where ``beliefs = llr + sum_in`` and
    ``v2c[e] = beliefs[var(e)] - c2v[e]`` (total-sum minus own message).
    """
    beliefs = llr_cz + col_sum(c2v_var, plan)
    v2c = beliefs[plan.edge_col] - c2v_var
    return v2c, beliefs


# ---------------------------------------------------------------------------
# Check-node updates
# ---------------------------------------------------------------------------


def _signs_and_mags(grouped: torch.Tensor, valid: torch.Tensor):
    """Masked signs (pad -> +1; sign(0) = +1, never ``torch.sign``) and
    magnitudes (pad -> big)."""
    one = torch.ones((), dtype=grouped.dtype, device=grouped.device)
    sign = torch.where(grouped < 0, -one, one)
    sign = torch.where(valid, sign, one)
    mag = torch.where(valid, grouped.abs(), torch.full_like(grouped, _BIG))
    return sign, mag


def check_update_minsum(v2c_var: torch.Tensor, plan: QCPlan, alpha=1.0, offset=0.0) -> torch.Tensor:
    """Scaled / offset min-sum check update, leave-one-out via min / 2nd-min.

    For the (first) arg-min edge the excluded minimum is the second minimum,
    for every other edge it is the minimum.  ``offset``: offset-min-sum
    correction |c2v| = max(min - offset, 0); alpha and offset compose:
    c2v = alpha * sign * max(min_loo - offset, 0).
    """
    grouped = group_to_check(v2c_var, plan)  # (R, D, Z, B)
    valid = plan.row_valid[:, :, None, None]
    sign, mag = _signs_and_mags(grouped, valid)

    total_sign = torch.prod(sign, dim=1, keepdim=True)
    m1 = torch.amin(mag, dim=1, keepdim=True)
    is_min = mag == m1
    # knock out ONE occurrence of the minimum (the first) before re-minning
    first_min = torch.cumsum(is_min.to(torch.int32), dim=1) * is_min == 1
    m2 = torch.amin(torch.where(first_min, torch.full_like(mag, _BIG), mag), dim=1, keepdim=True)

    loo_sign = total_sign * sign  # sign in {-1, +1}: multiply == divide
    loo_mag = torch.where(first_min, m2, m1)
    # Mask before the multiply: no sentinel-scale value may enter a product.
    loo_mag = torch.where(valid & (loo_mag < _BIG), loo_mag, torch.zeros_like(loo_mag))
    loo_mag = torch.clamp(loo_mag - offset, min=0.0)
    c2v = alpha * loo_sign * loo_mag
    return ungroup_to_var(c2v, plan)


def _phi(x: torch.Tensor) -> torch.Tensor:
    """phi(x) = -log(tanh(x/2)), self-inverse."""
    return -torch.log(torch.tanh(x / 2.0) + 1e-30)


def check_update_sumproduct(v2c_var: torch.Tensor, plan: QCPlan, clip: float = 20.0) -> torch.Tensor:
    """Sum-product (belief propagation) check update in the phi domain.

    |c2v_i| = phi(sum_j phi(|v2c_j|) - phi(|v2c_i|)), sign = leave-one-out
    sign product.  ``clip`` bounds magnitudes for stability (phi explodes at 0).
    """
    grouped = group_to_check(v2c_var, plan)
    valid = plan.row_valid[:, :, None, None]
    sign, mag = _signs_and_mags(grouped, valid)
    mag = torch.clamp(mag, 1e-7, clip)

    phis = torch.where(valid, _phi(mag), torch.zeros_like(mag))
    total_phi = torch.sum(phis, dim=1, keepdim=True)
    total_sign = torch.prod(sign, dim=1, keepdim=True)
    loo = torch.clamp(total_phi - phis, min=1e-7)
    c2v = total_sign * sign * _phi(loo)
    c2v = torch.where(valid, c2v, torch.zeros_like(c2v))
    return ungroup_to_var(c2v, plan)


# ---------------------------------------------------------------------------
# Syndrome
# ---------------------------------------------------------------------------


def syndrome_ok(bits_cz: torch.Tensor, plan: QCPlan) -> torch.Tensor:
    """Per-frame parity validity: (C, Z, B) hard bits -> (B,) bool."""
    bits_edge = bits_cz[plan.edge_col]  # (K, Z, B) var-aligned
    grouped = group_to_check(bits_edge, plan, pad_value=0.0)
    parity = torch.remainder(torch.sum(grouped, dim=1), 2.0)  # (R, Z, B)
    return torch.all((parity == 0.0).reshape(-1, parity.shape[-1]), dim=0)


# ---------------------------------------------------------------------------
# Feature-space group aggregations (message-GNN support)
# ---------------------------------------------------------------------------
#
# The normalized-adjacency aggregation of the message GNN is exactly the
# within-group mean (the same-variable and same-check graphs are disjoint
# unions of cliques), so both are incidence products over the QC layout.


def _incidence_sum(inc: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """(G, K) 0/1 incidence times (K, ...) features, accumulated in float32."""
    K = feats.shape[0]
    flat = feats.reshape(K, -1).to(torch.float32)
    return torch.matmul(inc, flat).reshape((inc.shape[0],) + tuple(feats.shape[1:]))


def var_group_mean(feats: torch.Tensor, plan: QCPlan) -> torch.Tensor:
    """Mean over messages sharing my variable: (K, Z, B, H) -> (K, Z, B, H).

    Sums accumulate in float32; the mean is cast back to the input dtype.
    """
    sums = _incidence_sum(plan.col_incidence, feats)
    counts = plan.col_incidence.sum(dim=1)[:, None, None, None]
    mean = (sums / torch.clamp(counts, min=1.0)).to(feats.dtype)
    return mean[plan.edge_col]


def check_group_mean(feats: torch.Tensor, plan: QCPlan) -> torch.Tensor:
    """Mean over messages sharing my check: (K, Z, B, H) -> (K, Z, B, H).

    Roll to check alignment, incidence product, distribute, roll back.  Sums
    accumulate in float32; the mean is cast back to the input dtype.
    """
    K, Z, B, H = feats.shape
    to_check = plan.roll_to_check[:, :, None, None].expand(K, Z, B, H)
    rolled = torch.gather(feats, 1, to_check)
    rowsum = _incidence_sum(plan.row_incidence, rolled)
    counts = plan.row_incidence.sum(dim=1)[:, None, None, None]
    rowmean = (rowsum / torch.clamp(counts, min=1.0)).to(feats.dtype)
    per_edge_chk = rowmean[plan.edge_row]  # (K, Z, B, H) check-aligned
    to_var = plan.roll_to_var[:, :, None, None].expand(K, Z, B, H)
    return torch.gather(per_edge_chk, 1, to_var)


# ---------------------------------------------------------------------------
# Per-edge parameter plumbing
# ---------------------------------------------------------------------------


def flat_to_qc_var(flat_params, qc: QCLayout):
    """Reference-ordered flat per-edge vector (E,) -> var-aligned (K, Z)."""
    idx = qc.flat_edge_id_var_aligned()
    if isinstance(flat_params, torch.Tensor):
        return flat_params[torch.as_tensor(idx, dtype=torch.int64, device=flat_params.device)]
    return flat_params[idx]
