"""5G NR base-graph registry and loaders (counterpart of ``ldpc_tpu.codes.base_graphs``).

A *base graph* is an (R, C) integer matrix of circulant shift coefficients:
``-1`` means "no edge" (Z x Z zero block), ``s >= 0`` means an identity matrix
cyclically shifted by ``s`` columns (QC-LDPC lifting).

Pure numpy: code structure is host-side, compile-time data; the decoders copy
the index arrays they need to the device once.  The shipped assets in
``data/`` are byte-identical copies of the JAX package's, so this package
never reads another package's files.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

_DATA_DIR = Path(__file__).parent / "data"


@dataclasses.dataclass(frozen=True)
class BaseGraph:
    """An immutable base graph of circulant shift coefficients."""

    name: str
    shifts: np.ndarray  # (R, C) int32, -1 = no edge

    def __post_init__(self):
        object.__setattr__(self, "shifts", np.asarray(self.shifts, dtype=np.int32))
        if self.shifts.ndim != 2:
            raise ValueError(f"base graph must be 2-D, got {self.shifts.shape}")

    @property
    def num_check_rows(self) -> int:
        return self.shifts.shape[0]

    @property
    def num_var_cols(self) -> int:
        return self.shifts.shape[1]

    @property
    def num_base_edges(self) -> int:
        return int((self.shifts >= 0).sum())

    def shifts_mod(self, Z: int) -> np.ndarray:
        """Shift table reduced mod Z (padding -1 kept)."""
        s = self.shifts.copy()
        s[s >= 0] %= Z
        return s

    def unique_shift_types(self, Z: int | None = None) -> np.ndarray:
        """Sorted unique non-negative shift values (message "types")."""
        s = self.shifts if Z is None else self.shifts_mod(Z)
        return np.unique(s[s >= 0])


def load_base_matrix(path: str | Path) -> BaseGraph:
    """Load a base graph from a whitespace text file or a JSON asset.

    Text format: one row per line, whitespace-separated shift values,
    -1 = no edge.
    """
    path = Path(path)
    if path.suffix == ".json":
        payload = json.loads(path.read_text())
        return BaseGraph(name=payload.get("name", path.stem), shifts=np.array(payload["shifts"]))
    rows = [[int(float(v)) for v in ln.split()] for ln in path.read_text().splitlines() if ln.split()]
    return BaseGraph(name=path.stem, shifts=np.array(rows))


def available_base_graphs() -> list[str]:
    return sorted(p.stem for p in _DATA_DIR.glob("*.json"))


def get_base_graph(name: str) -> BaseGraph:
    """Fetch a shipped base graph by name (e.g. ``nr_2_0_4``, ``nr_2_0_32``, ``toy_4x8``)."""
    path = _DATA_DIR / f"{name.lower()}.json"
    if not path.exists():
        raise KeyError(f"unknown base graph {name!r}; available: {available_base_graphs()}")
    return load_base_matrix(path)


def base_graph_from_H(H: np.ndarray, name: str = "from_H") -> BaseGraph:
    """Wrap an arbitrary dense binary parity-check matrix as a Z=1 base graph.

    At Z=1 each H entry of 1 is a size-1 circulant with shift 0, so
    ``expand_base_matrix(base_graph_from_H(H), 1)`` reproduces H exactly and
    every decoder runs on it through the normal ``qc_layout`` path.
    """
    H = np.asarray(H)
    if H.ndim != 2:
        raise ValueError(f"H must be 2-D, got shape {H.shape}")
    if not np.isin(H, (0, 1)).all():
        raise ValueError("H must be binary (0/1)")
    return BaseGraph(name=name, shifts=np.where(H > 0, 0, -1).astype(np.int32))


def expand_base_matrix(base: BaseGraph | np.ndarray, Z: int) -> np.ndarray:
    """QC-lift a base graph into a dense binary parity-check matrix H.

    Each shift ``s >= 0`` becomes an identity cyclically shifted by ``s``
    columns, ``H[r*Z + i, c*Z + (i + s) % Z] = 1``; ``-1`` becomes a zero
    block.  For tests and small demos only: the decoders consume the
    structured :class:`~ldpc_tpu_torch.codes.edge_layout.QCLayout`.
    """
    shifts = base.shifts if isinstance(base, BaseGraph) else np.asarray(base, dtype=np.int64)
    R, C = shifts.shape
    H = np.zeros((R * Z, C * Z), dtype=np.int8)
    i = np.arange(Z)
    for r in range(R):
        for c in range(C):
            s = int(shifts[r, c])
            if s >= 0:
                H[r * Z + i, c * Z + (i + s) % Z] = 1
    return H
