"""Edge layouts for Tanner-graph message passing (counterpart of
``ldpc_tpu.codes.edge_layout``).

:class:`EdgeLayout`
    A flat per-edge layout derived from a dense H, edges enumerated in
    row-major order of H^T (sorted by (variable, check)), with the -1-padded
    "all other edges in my row / column" neighbor tables.

:class:`QCLayout`
    The layout the decoders use, built on the quasi-cyclic structure.
    Messages live as (K base-edges, Z lanes) blocks; the check<->variable
    regrouping is a circulant roll along Z, precomputed as index arrays.

Alignment conventions for QC message tensors of shape (K, Z, ...):

* **var-aligned**: lane ``z`` of base-edge ``k`` is the edge incident to
  variable ``(edge_col[k], z)``.  Its check is ``(edge_row[k], (z - shift_k)
  mod Z)``.
* **check-aligned**: lane ``z`` is the edge incident to check
  ``(edge_row[k], z)``.  Its variable is ``(edge_col[k], (z + shift_k) mod Z)``
  (lifting semantics ``H[r*Z + i, c*Z + (i+s) % Z] = 1``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ldpc_tpu_torch.codes.base_graphs import BaseGraph


# ---------------------------------------------------------------------------
# Flat layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EdgeLayout:
    """Flat per-edge layout of a Tanner graph, edges sorted by (var, check)."""

    num_checks: int
    num_vars: int
    edge_var: np.ndarray  # (E,) variable index of each edge
    edge_check: np.ndarray  # (E,) check index of each edge
    check_nbr: np.ndarray  # (E, dc_max-1) other edges sharing my check, -1 pad
    var_nbr: np.ndarray  # (E, dv_max-1) other edges sharing my variable, -1 pad

    @property
    def num_edges(self) -> int:
        return int(self.edge_var.shape[0])

    @property
    def output_index(self) -> np.ndarray:
        """Per-edge variable index."""
        return self.edge_var


def edge_layout_from_H(H: np.ndarray) -> EdgeLayout:
    """Build the flat edge layout from a dense binary parity-check matrix."""
    return edge_layout_from_H_numpy(H)


def edge_layout_from_H_numpy(H: np.ndarray) -> EdgeLayout:
    """Numpy implementation of :func:`edge_layout_from_H`."""
    H = np.asarray(H)
    m, n = H.shape
    vv, cc = np.nonzero(H.T != 0)  # sorted by (var, check)
    E = vv.shape[0]
    edge_var = vv.astype(np.int32)
    edge_check = cc.astype(np.int32)

    check_nbr = _others_in_group(edge_check, m, E)
    var_nbr = _others_in_group(edge_var, n, E)
    return EdgeLayout(
        num_checks=m,
        num_vars=n,
        edge_var=edge_var,
        edge_check=edge_check,
        check_nbr=check_nbr,
        var_nbr=var_nbr,
    )


def _others_in_group(group_of_edge: np.ndarray, num_groups: int, E: int) -> np.ndarray:
    """For each edge, the indices of all *other* edges in its group (-1 pad)."""
    members: list[list[int]] = [[] for _ in range(num_groups)]
    for e in range(E):
        members[group_of_edge[e]].append(e)
    width = max(0, max((len(g) for g in members), default=1) - 1)
    out = np.full((E, max(width, 1)), -1, dtype=np.int32)
    for g in members:
        for i, e in enumerate(g):
            others = g[:i] + g[i + 1 :]
            out[e, : len(others)] = others
    return out


# ---------------------------------------------------------------------------
# QC block layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QCLayout:
    """Quasi-cyclic message-passing layout for a lifted base graph.

    All index arrays are numpy int32.  ``K`` = number of base edges,
    ``Z`` = lifting factor, ``E = K * Z``.
    """

    Z: int
    num_base_rows: int  # R
    num_base_cols: int  # C
    edge_row: np.ndarray  # (K,) base row of each base edge
    edge_col: np.ndarray  # (K,) base column
    edge_shift: np.ndarray  # (K,) circulant shift mod Z
    edge_type: np.ndarray  # (K,) dense index of the shift value (weight sharing)
    num_edge_types: int
    row_edges: np.ndarray  # (R, dr_max) base-edge ids per check row, pad = K
    col_edges: np.ndarray  # (C, dv_max) base-edge ids per var column, pad = K
    row_slot: np.ndarray  # (K,) my slot within row_edges[edge_row[k]]
    col_slot: np.ndarray  # (K,) my slot within col_edges[edge_col[k]]
    # Composed static gathers for the decode loop:
    row_gather_var: np.ndarray  # (R, dr_max, Z) flat idx into var-aligned (K*Z)+dummy
    ungroup_to_var: np.ndarray  # (K, Z) flat idx into (R*dr_max*Z) check-aligned groups
    col_incidence: np.ndarray  # (C, K) float32 0/1 — colsum as a matmul

    @property
    def num_base_edges(self) -> int:
        return int(self.edge_row.shape[0])

    @property
    def num_edges(self) -> int:
        return self.num_base_edges * self.Z

    @property
    def num_checks(self) -> int:
        return self.num_base_rows * self.Z

    @property
    def num_vars(self) -> int:
        return self.num_base_cols * self.Z

    @property
    def dr_max(self) -> int:
        return int(self.row_edges.shape[1])

    @property
    def dv_max(self) -> int:
        return int(self.col_edges.shape[1])

    def flat_edge_id_var_aligned(self) -> np.ndarray:
        """(K, Z) -> flat edge id in the (var, check)-sorted flat order."""
        K, Z = self.num_base_edges, self.Z
        # Edge (k, z_c): var v = edge_col*Z + z_c, check c = edge_row*Z + (z_c - s) % Z.
        v = self.edge_col[:, None] * Z + np.arange(Z)[None, :]
        zc = np.arange(Z)[None, :]
        chk = self.edge_row[:, None] * Z + (zc - self.edge_shift[:, None]) % Z
        order = np.lexsort((chk.ravel(), v.ravel()))  # sort by (v, check)
        flat_id = np.empty(K * Z, dtype=np.int64)
        flat_id[order] = np.arange(K * Z)
        return flat_id.reshape(K, Z).astype(np.int32)


def qc_layout(base: BaseGraph, Z: int) -> QCLayout:
    """Build the QC message-passing layout for ``base`` lifted by ``Z``."""
    if Z < 1:
        raise ValueError(f"lifting factor must be >= 1, got {Z}")
    shifts = base.shifts_mod(Z)
    R, C = shifts.shape
    rr, cc = np.nonzero(shifts >= 0)  # base edges in row-major order
    K = rr.shape[0]
    if K == 0:
        raise ValueError("base graph has no edges (all entries are -1)")
    edge_row = rr.astype(np.int32)
    edge_col = cc.astype(np.int32)
    edge_shift = shifts[rr, cc].astype(np.int32)

    types = np.unique(edge_shift)
    type_of_shift = {int(s): i for i, s in enumerate(types)}
    edge_type = np.array([type_of_shift[int(s)] for s in edge_shift], dtype=np.int32)

    row_edges, row_slot = _group_edges(edge_row, R, K)
    col_edges, col_slot = _group_edges(edge_col, C, K)
    dr_max = row_edges.shape[1]

    # Check-side grouped gather, with the circulant roll composed in:
    # v2c_grouped[r, slot, z_r] = v2c_var[row_edges[r, slot], (z_r + shift) % Z]
    z = np.arange(Z)
    ks = row_edges  # (R, dr_max), pad = K
    pad = ks == K
    shift_g = np.where(pad, 0, edge_shift[np.minimum(ks, K - 1)])
    src = ks[:, :, None] * Z + (z[None, None, :] + shift_g[:, :, None]) % Z
    row_gather_var = np.where(pad[:, :, None], K * Z, src).astype(np.int32)

    # Inverse: c2v computed in grouped check alignment (R, dr_max, Z) back to
    # var alignment: c2v_var[k, z_c] = grouped[edge_row[k], row_slot[k], (z_c - shift_k) % Z]
    zr = (z[None, :] - edge_shift[:, None]) % Z  # (K, Z)
    ungroup_to_var = (
        (edge_row[:, None] * dr_max + row_slot[:, None]) * Z + zr
    ).astype(np.int32)

    col_incidence = np.zeros((C, K), dtype=np.float32)
    col_incidence[edge_col, np.arange(K)] = 1.0

    return QCLayout(
        Z=Z,
        num_base_rows=R,
        num_base_cols=C,
        edge_row=edge_row,
        edge_col=edge_col,
        edge_shift=edge_shift,
        edge_type=edge_type,
        num_edge_types=len(types),
        row_edges=row_edges,
        col_edges=col_edges,
        row_slot=row_slot,
        col_slot=col_slot,
        row_gather_var=row_gather_var,
        ungroup_to_var=ungroup_to_var,
        col_incidence=col_incidence,
    )


def _group_edges(group_of_edge: np.ndarray, num_groups: int, K: int):
    """Pad-group base-edge ids by row/col.  Returns (groups, slot_of_edge)."""
    counts = np.bincount(group_of_edge, minlength=num_groups)
    width = int(counts.max()) if K else 1
    groups = np.full((num_groups, width), K, dtype=np.int32)
    slot_of_edge = np.zeros(K, dtype=np.int32)
    fill = np.zeros(num_groups, dtype=np.int64)
    for k in range(K):
        g = group_of_edge[k]
        groups[g, fill[g]] = k
        slot_of_edge[k] = fill[g]
        fill[g] += 1
    return groups, slot_of_edge
