"""Carry state across from the JAX package.

This package never imports ``ldpc_tpu``; what the JAX side hands over
arrives as numpy arrays and plain ints.  For classical decoding that is the
code structure: :func:`qc_layout_from_numpy` rebuilds a :class:`QCLayout`
from the fields of a JAX ``QCLayout`` (``dataclasses.asdict`` of it, or any
mapping with the same keys), so both packages can be fed one layout.

For the message GNN it is the trained weights.  Checkpoints are flax msgpack
files; :func:`read_flax_msgpack` reads them with a small msgpack reader of
this package's own (``struct`` and numpy), :func:`message_gnn_state_dict_from_numpy`
renames and transposes the flax tree into the ``state_dict`` of
:class:`ldpc_tpu_torch.models.message_gnn.MessageGNNDecoder`, and
:func:`load_message_gnn` does both for a model.  A neural min-sum tree
(``w_ch``, ``w_res``, ``alpha``, ``offset``) carries over as stored:
:func:`neural_min_sum_state_dict_from_numpy` and :func:`load_neural_min_sum`;
so does a node-centered GNN tree (``w_ch``, ``w_c2v``, ``w_res``):
:func:`gnn_state_dict_from_numpy` and :func:`load_gnn`.
:func:`state_dict_from_flax` picks the conversion by the model's class.
"""
from __future__ import annotations

import dataclasses
import struct
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

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


# ---------------------------------------------------------------------------
# flax msgpack checkpoints
# ---------------------------------------------------------------------------

_EXT_NDARRAY = 1  # flax.serialization: ext payload = msgpack (shape, dtype name, bytes)
_ARRAY_DTYPES = ("float32", "float64", "float16", "int8", "int16", "int32", "int64",
                 "uint8", "uint16", "uint32", "uint64", "bool")
_FIXED = {  # type code -> struct format of the value that follows
    0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
_LENGTH = {  # type code -> (struct format of the length, kind)
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
    0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    """Sequential msgpack reader over one bytes object."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside a value")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def number(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        code = self.number(">B")
        if code <= 0x7F:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0x80 <= code <= 0x8F:
            return self.container("map", code & 0x0F)
        if 0x90 <= code <= 0x9F:
            return self.container("array", code & 0x0F)
        if 0xA0 <= code <= 0xBF:
            return self.container("str", code & 0x1F)
        if code == 0xC0:
            return None
        if code in (0xC2, 0xC3):
            return code == 0xC3
        if code in _FIXED:
            return self.number(_FIXED[code])
        if code in _FIXEXT:
            return self.container("ext", _FIXEXT[code])
        if code in _LENGTH:
            fmt, kind = _LENGTH[code]
            return self.container(kind, self.number(fmt))
        raise ValueError(f"unknown msgpack type code 0x{code:02x} at byte {self.pos - 1}")

    def container(self, kind: str, n: int):
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            return bytes(self.take(n)).decode("utf-8")
        if kind == "array":
            return [self.value() for _ in range(n)]
        if kind == "map":
            out = {}
            for _ in range(n):
                key = self.value()
                if not isinstance(key, (str, int)):
                    raise ValueError(f"unsupported msgpack map key {type(key).__name__}")
                out[key] = self.value()
            return out
        ext_type = self.number(">b")
        payload = bytes(self.take(n))
        if ext_type != _EXT_NDARRAY:
            raise ValueError(f"unknown msgpack ext type {ext_type}")
        return _ndarray_from_ext(payload)


def _ndarray_from_ext(payload: bytes) -> np.ndarray:
    inner = _Reader(payload)
    fields = inner.value()
    if inner.pos != len(payload) or not isinstance(fields, list) or len(fields) != 3:
        raise ValueError("malformed flax ndarray payload")
    shape, dtype_name, raw = fields
    if dtype_name not in _ARRAY_DTYPES:
        raise ValueError(f"unsupported array dtype {dtype_name!r} in checkpoint")
    dtype = np.dtype(dtype_name)
    count = int(np.prod(shape, dtype=np.int64))
    if len(raw) != count * dtype.itemsize:
        raise ValueError("flax ndarray payload size does not match its shape")
    return np.frombuffer(raw, dtype=dtype, count=count).reshape(shape).copy()


def read_flax_msgpack(path) -> dict:
    """Read a flax ``msgpack_serialize`` file into nested dicts of numpy arrays.

    Handles what such checkpoints hold: maps, strings, numbers, lists and
    arrays (msgpack ext type 1).  Any other type code raises ``ValueError``.
    """
    data = Path(path).read_bytes()
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} bytes follow the msgpack value in {path}")
    return tree


def _flax_params(tree: Mapping) -> Mapping:
    """The innermost ``params`` mapping of a checkpoint or a flax variables dict."""
    while "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    return tree


def _dense(out: dict, name: str, node: Mapping) -> None:
    # flax Dense.kernel is (in, out); nn.Linear.weight is (out, in).
    out[f"{name}.weight"] = np.ascontiguousarray(np.asarray(node["kernel"]).T)
    out[f"{name}.bias"] = np.asarray(node["bias"])


def message_gnn_state_dict_from_numpy(tree: Mapping, dtype=torch.float32) -> dict:
    """flax parameter tree of a ``MessageGNNDecoder`` -> the port module's
    ``state_dict`` (tensors of ``dtype`` on the CPU).

    ``tree`` is the checkpoint (``{"params": {"params": ...}}``), the flax
    variables dict or the bare parameter mapping.  Names carry over with
    ``/`` as ``.``: ``check_{t}_gnn``, ``check_{t}_proj`` (or the shared
    ``check_gnn`` ...), ``gnn_layer_{t}``, ``input_embedding``,
    ``output_projection``, ``alpha``, ``w_ch``, ``w_res``.
    """
    p = _flax_params(tree)
    out: dict[str, np.ndarray] = {}
    for name, node in p.items():
        if not isinstance(node, Mapping):
            out[name] = np.asarray(node)  # alpha, w_ch, w_res
        elif "kernel" in node:
            _dense(out, name, node)  # input_embedding, *_proj, output_projection
        elif "message_type_embeddings" in node:
            out[f"{name}.message_type_embeddings"] = np.asarray(node["message_type_embeddings"])
            for rel in ("var_to_check_update", "check_to_var_update"):
                for dense in ("Dense_0", "Dense_1"):
                    _dense(out, f"{name}.{rel}.{dense}", node[rel][dense])
        else:
            raise KeyError(f"unexpected entry {name!r} in a MessageGNNDecoder parameter tree")
    return {k: torch.as_tensor(np.array(v), dtype=dtype) for k, v in out.items()}


def load_message_gnn(path, model) -> None:
    """Load a flax checkpoint's parameters into ``model`` (a
    ``MessageGNNDecoder`` with matching hyperparameters), strictly: a missing
    or unexpected entry raises.  The training history in the file is ignored.
    """
    tree = read_flax_msgpack(path)
    if "params" not in tree:
        raise KeyError(f"{path} holds no 'params' entry")
    model.load_state_dict(message_gnn_state_dict_from_numpy(tree["params"]), strict=True)


_NEURAL_MIN_SUM_PARAMS = ("w_ch", "w_res", "alpha", "offset")


def neural_min_sum_state_dict_from_numpy(tree: Mapping, dtype=torch.float32) -> dict:
    """flax parameter tree of a ``NeuralMinSumDecoder`` -> the port module's
    ``state_dict``: the same names, the shapes as stored."""
    p = _flax_params(tree)
    unknown = set(p) - set(_NEURAL_MIN_SUM_PARAMS)
    if unknown:
        raise KeyError(f"unexpected entries {sorted(unknown)} in a NeuralMinSumDecoder "
                       "parameter tree")
    return {k: torch.as_tensor(np.array(v), dtype=dtype) for k, v in p.items()}


def load_neural_min_sum(path, model) -> None:
    """Load a flax checkpoint's parameters into ``model`` (a
    ``NeuralMinSumDecoder`` with matching hyperparameters), strictly."""
    tree = read_flax_msgpack(path)
    if "params" not in tree:
        raise KeyError(f"{path} holds no 'params' entry")
    model.load_state_dict(neural_min_sum_state_dict_from_numpy(tree["params"]), strict=True)


_GNN_PARAMS = ("w_ch", "w_c2v", "w_res")


def gnn_state_dict_from_numpy(tree: Mapping, dtype=torch.float32) -> dict:
    """flax parameter tree of a ``GNNLDPCDecoder`` -> the port module's
    ``state_dict``: the same names, the shapes as stored."""
    p = _flax_params(tree)
    unknown = set(p) - set(_GNN_PARAMS)
    if unknown:
        raise KeyError(f"unexpected entries {sorted(unknown)} in a GNNLDPCDecoder parameter tree")
    return {k: torch.as_tensor(np.array(v), dtype=dtype) for k, v in p.items()}


def load_gnn(path, model) -> None:
    """Load a flax checkpoint's parameters into ``model`` (a
    ``GNNLDPCDecoder`` with matching hyperparameters), strictly."""
    tree = read_flax_msgpack(path)
    if "params" not in tree:
        raise KeyError(f"{path} holds no 'params' entry")
    model.load_state_dict(gnn_state_dict_from_numpy(tree["params"]), strict=True)


def state_dict_from_flax(tree: Mapping, model) -> dict:
    """The ``state_dict`` for ``model`` (a ``MessageGNNDecoder``,
    ``NeuralMinSumDecoder`` or ``GNNLDPCDecoder``) from a flax parameter tree."""
    from ldpc_tpu_torch.models import GNNLDPCDecoder, MessageGNNDecoder, NeuralMinSumDecoder

    for cls, convert in ((MessageGNNDecoder, message_gnn_state_dict_from_numpy),
                         (NeuralMinSumDecoder, neural_min_sum_state_dict_from_numpy),
                         (GNNLDPCDecoder, gnn_state_dict_from_numpy)):
        if isinstance(model, cls):
            return convert(tree)
    raise TypeError(f"no flax conversion for {type(model).__name__}")
