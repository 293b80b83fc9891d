"""One typed configuration consumed by every entry point (counterpart of
``ldpc_tpu.config``).

The same fields, types, defaults and order as the JAX package's ``Config``,
so that a JSON file written by either package loads in the other and
``Config().to_json()`` is the same string.  The device is not a field (that
would change the JSON): the CLI takes it as ``--device``.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any


@dataclasses.dataclass
class Config:
    # model
    model_type: str = "standard"  # standard | tied | gnn | base_graph_gnn |
    # message_gnn | message_gnn_var_minsum | message_gnn_check_minsum |
    # message_gnn_minsum | message_gnn_corrected
    num_iterations: int = 5
    depth_L: int = 2
    hidden_dim: int = 64
    share_layers: bool = False
    # code
    base_graph: str = "nr_2_0_4"  # registry name or path to a shift-table file
    lifting_factor: int = 16
    # channel
    modulation: str = "qpsk"  # qpsk | bpsk
    convention: str = "consistent"  # | reference_package
    # training
    num_epochs: int = 100
    batch_size: int = 32
    learning_rate: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 1e-4
    snr_min: float = -2.0
    snr_max: float = 6.0
    snr_step: float = 2.0
    validation_interval: int = 5
    seed: int = 42
    data_mode: str = "random_bits"  # | zero_codewords | random_codewords
    optimizer: str = "sgd"  # | adam
    # evaluation
    eval_snr_step: float = 1.0
    num_trials: int = 100
    # classical comparison
    bp_max_iterations: int = 50
    ms_scaling_factor: float = 0.75
    compare_with_traditional: bool = True  # include BP/min-sum rows in `compare`
    compare_models: str = ""  # comma-separated model types for multi-model compare
    random_codewords: bool = False  # evaluate on encoder-generated codewords
    # parallel
    mesh_data: int = 0  # 0 = no mesh: one process
    mesh_model: int = 1
    # io
    model_path: str = "checkpoints/model.msgpack"
    results_dir: str = "results"
    paper_style: bool = False

    def train_snr_range(self) -> list[float]:
        return _arange(self.snr_min, self.snr_max, self.snr_step)

    def eval_snr_range(self) -> list[float]:
        return _arange(self.snr_min, self.snr_max, self.eval_snr_step)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_file(cls, path: str | Path) -> "Config":
        return cls(**json.loads(Path(path).read_text()))

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


def _arange(lo: float, hi: float, step: float) -> list[float]:
    out, v = [], lo
    while v <= hi + 1e-9:
        out.append(round(v, 6))
        v += step
    return out
