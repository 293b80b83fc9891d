"""Comparative evaluation of classical and neural decoders (counterpart of
``ldpc_tpu.training.evaluator``).

Any mix of decoders runs over an SNR grid of Monte-Carlo trials
(:func:`ldpc_tpu_torch.parallel.mc_sweep`), tracking BER, FER and, for the
classical decoders, the mean convergence iteration; results save and load as
the JAX package's JSON (``snr_range``, ``decoders`` -> ``ber``, ``fer``,
``param_count``, ``avg_iterations``) and print as a text summary.

``fused=True`` runs a classical decoder on the hand-written kernels of
:mod:`ldpc_tpu_torch.ops.fused_minsum` (their plain versions on a CPU
device).  Where no kernel takes the code it raises: unlike the JAX package,
which falls back to XLA there, the port never falls back quietly.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Callable

import torch

from ldpc_tpu_torch._device import resolve_device
from ldpc_tpu_torch.models.classical import (_make_fused, _resolve_backend, decode_bp,
                                             decode_min_sum)
from ldpc_tpu_torch.ops.qc_msg import QCPlan
from ldpc_tpu_torch.parallel.sharding import (channel_llr, mc_sweep, require_one_device,
                                              trial_generator)
from ldpc_tpu_torch.utils.logging import get_logger
from ldpc_tpu_torch.utils.metrics import REGISTRY, MetricsRegistry, decode_throughput

_LOG = get_logger("ldpc_tpu_torch.evaluator")


class ComparativeEvaluator:
    """Evaluate registered decoders over an SNR range.

    A decoder is registered as ``name -> decode_bits`` (a callable from
    (B, n) LLRs to (B, n) hard bits), with an optional callable giving each
    frame's convergence iteration.  ``add_min_sum``,
    ``add_belief_propagation`` and ``add_model`` cover the classical and
    neural decoders.  Everything runs on ``device`` (default the card).
    """

    def __init__(self, plan: QCPlan, snr_range=None, batch_size: int = 32,
                 num_trials: int = 100, mesh=None, modulation: str = "qpsk",
                 convention: str = "consistent", seed: int = 4321, encoder=None,
                 device="cuda"):
        require_one_device(mesh)
        self.device = resolve_device(device)
        self.plan = plan.to(self.device)
        self.snr_range = [float(s) for s in (snr_range if snr_range is not None
                                             else range(-2, 7))]
        self.batch_size = batch_size
        self.num_trials = num_trials
        self.modulation = modulation
        self.convention = convention
        self.seed = seed
        self.encoder = encoder
        self._decoders: dict[str, dict[str, Any]] = {}
        self.results: dict[str, Any] = {}

    # -- registration ----------------------------------------------------------

    def add_decoder(self, name: str, decode_bits: Callable, avg_iters_fn: Callable | None = None,
                    param_count: int = 0) -> None:
        self._decoders[name] = {"decode": decode_bits, "iters": avg_iters_fn,
                                "params": param_count}

    def _add_fused(self, name: str, qc, max_iterations: int, mode: str, alpha: float,
                   early_exit: bool) -> None:
        if qc is None:
            raise ValueError("fused=True needs qc=, the code's QCLayout")
        kernel = _make_fused(_resolve_backend("auto", qc), qc, max_iterations, mode=mode,
                             alpha=alpha, early_exit=early_exit, device=self.device)
        self.add_decoder(name, lambda llr: kernel(llr)[0], lambda llr: kernel(llr)[1])

    def add_belief_propagation(self, max_iterations: int = 50, name: str = "Belief Propagation",
                               qc=None, fused: bool = False, early_exit: bool = True):
        """Sum-product BP.  ``fused=True`` (``qc=`` the QCLayout) decodes on
        the fused kernels: ``retire_sumproduct``, or ``retire_zlane_sumproduct``
        at large Z.  Otherwise the tensor-op ``decode_bp``, which with
        ``early_exit`` stops once the whole batch is valid (same decisions
        and statistics)."""
        if fused:
            return self._add_fused(name, qc, max_iterations, "sumproduct", 1.0, early_exit)
        plan = self.plan
        self.add_decoder(
            name,
            lambda llr: decode_bp(llr, plan, max_iterations, early_exit=early_exit).bits,
            lambda llr: decode_bp(llr, plan, max_iterations, early_exit=early_exit).conv_iter)

    def add_min_sum(self, max_iterations: int = 50, scaling_factor: float = 0.75,
                    name: str = "Min-Sum Scaled", qc=None, fused: bool = False,
                    early_exit: bool = True):
        """Scaled min-sum; ``fused=True`` decodes on ``fused_retire`` (or
        ``retire_zlane`` at large Z), otherwise the tensor-op ``decode_min_sum``."""
        if fused:
            return self._add_fused(name, qc, max_iterations, "minsum", scaling_factor,
                                   early_exit)
        plan = self.plan
        self.add_decoder(
            name,
            lambda llr: decode_min_sum(llr, plan, max_iterations, scaling_factor,
                                       early_exit=early_exit).bits,
            lambda llr: decode_min_sum(llr, plan, max_iterations, scaling_factor,
                                       early_exit=early_exit).conv_iter)

    def add_model(self, name: str, model) -> None:
        """Register a decoder module (neural min-sum, node GNN or message
        GNN); its forward runs under ``torch.no_grad()``."""
        plan = self.plan

        def decode(llr):
            with torch.no_grad():
                soft, _ = model(llr, plan)
            return (soft > 0.5).to(torch.float32)

        n_params = sum(p.numel() for p in model.parameters())
        self.add_decoder(name, decode, None, param_count=n_params)

    # -- evaluation ------------------------------------------------------------

    def evaluate_all(self, log: Callable[[str], None] | None = _LOG.info,
                     metrics: MetricsRegistry = REGISTRY) -> dict[str, Any]:
        """Sweep every registered decoder; returns and stores the results.
        Each decoder's wall time and decoded bits/s go to ``metrics``."""
        out: dict[str, Any] = {"snr_range": self.snr_range, "decoders": {}}
        n = self.plan.C * self.plan.Z
        for name, spec in self._decoders.items():
            if log:
                log(f"evaluating {name} ...")
            t0 = time.time()
            sweep = mc_sweep(spec["decode"], self.plan, self.snr_range, self.batch_size,
                             self.num_trials, seed=self.seed,
                             modulation=self.modulation, convention=self.convention,
                             encoder=self.encoder, device=self.device)
            seconds = time.time() - t0
            frames = self.batch_size * self.num_trials * len(self.snr_range)
            metrics.record(f"eval_{name}_s", seconds)
            decode_throughput(frames, n, seconds, metrics, name=f"eval_{name}")
            entry: dict[str, Any] = {"ber": sweep["ber"], "fer": sweep["fer"],
                                     "param_count": spec["params"]}
            if spec["iters"] is not None:
                entry["avg_iterations"] = self._avg_iterations(spec["iters"])
            out["decoders"][name] = entry
        self.results = out
        return out

    def _avg_iterations(self, iters_fn) -> list[float]:
        """Mean convergence iteration per SNR point, on the all-zero
        codeword LLRs of each trial's generator (the sweep's own LLRs when
        there is no encoder)."""
        n = self.plan.C * self.plan.Z
        avg = []
        for i, snr_db in enumerate(self.snr_range):
            total = torch.zeros((), dtype=torch.float64, device=self.device)
            for t in range(self.num_trials):
                gen = trial_generator(self.seed, i, t, self.device)
                bits = torch.zeros((self.batch_size, n), dtype=torch.float32, device=self.device)
                total += iters_fn(channel_llr(gen, bits, snr_db, self.modulation,
                                              self.convention)).double().sum()
            avg.append(float(total) / (self.num_trials * self.batch_size))
        return avg

    # -- persistence and reporting -----------------------------------------------

    def save_results(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps(self.results, indent=2))

    def load_results(self, path: str | Path) -> dict[str, Any]:
        self.results = json.loads(Path(path).read_text())
        return self.results

    def print_summary(self, log: Callable[[str], None] = print) -> None:
        """BER and FER per SNR and decoder, then parameter counts."""
        res = self.results
        if not res:
            log("no results — run evaluate_all() first")
            return
        log(f"{'SNR (dB)':>8} | " + " | ".join(f"{n[:20]:>20}" for n in res["decoders"]))
        for i, snr in enumerate(res["snr_range"]):
            row = [f"{snr:8.1f}"]
            for entry in res["decoders"].values():
                row.append(f"BER {entry['ber'][i]:.2e} FER {entry['fer'][i]:.3f}"[:20].rjust(20))
            log(" | ".join(row))
        for name, entry in res["decoders"].items():
            if entry.get("param_count"):
                log(f"{name}: {entry['param_count']} trainable parameters")
