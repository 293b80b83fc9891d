"""Carry state across from the JAX package.

This package never imports ``ldpc_tpu``; what the JAX side hands over
arrives as numpy arrays and plain ints.  For classical decoding that is the
code structure: :func:`qc_layout_from_numpy` rebuilds a :class:`QCLayout`
from the fields of a JAX ``QCLayout`` (``dataclasses.asdict`` of it, or any
mapping with the same keys), so both packages can be fed one layout.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np

from ldpc_tpu_torch.codes.edge_layout import QCLayout

_INT_FIELDS = ("Z", "num_base_rows", "num_base_cols", "num_edge_types")


def qc_layout_from_numpy(fields: Mapping[str, np.ndarray | int]) -> QCLayout:
    """Build the port's :class:`QCLayout` from the JAX layout's fields."""
    names = {f.name for f in dataclasses.fields(QCLayout)}
    missing = names - set(fields)
    if missing:
        raise KeyError(f"QCLayout fields missing: {sorted(missing)}")
    kwargs = {}
    for name in names:
        value = fields[name]
        if name in _INT_FIELDS:
            kwargs[name] = int(value)
        elif name == "col_incidence":
            kwargs[name] = np.asarray(value, dtype=np.float32)
        else:
            kwargs[name] = np.asarray(value, dtype=np.int32)
    return QCLayout(**kwargs)
