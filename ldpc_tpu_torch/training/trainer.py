"""Training and Monte-Carlo evaluation of neural LDPC decoders (counterpart
of ``ldpc_tpu.training.trainer``).

:class:`LDPCDecoderTrainer` trains any module called as ``model(llr, plan,
bits) -> (soft_bits, per-frame loss)``: ``NeuralMinSumDecoder``,
``MessageGNNDecoder`` (every factory) and ``GNNLDPCDecoder``.  Autograd
differentiates the module's plain PyTorch forward; no kernel runs in
training (the JAX package has no backward kernel either).

The optimizer is optax's chain as the JAX trainer builds it:
``clip_by_global_norm`` (only when ``grad_clip > 0``), then
``add_decayed_weights``, then ``sgd`` or ``adam``.  In torch that is
``clip_grad_norm_`` followed by ``SGD(momentum, dampening=0)`` or
``Adam(eps=1e-8)`` with ``weight_decay``: L2 added to the gradient, not
AdamW.  A parameter that gets no gradient gets a zero one, so that the decay
still applies to it as in optax.  ``train_steps``' cosine schedule is
``optax.warmup_cosine_decay_schedule(0, lr, max(warmup, 1), max(num_steps,
2))``, a ``LambdaLR`` read at the update count before each update: with no
warm-up the first update has rate 0.

Data come from the trainer's own ``torch.Generator`` on the device; its
state is part of :meth:`save_state`, so a ``train_steps`` run saved after k
steps and resumed runs the same trajectory as one never interrupted.
"""
from __future__ import annotations

import json
import math
import os
import time
import zipfile
from pathlib import Path
from typing import Any, Callable

import torch

from ldpc_tpu_torch import convert
from ldpc_tpu_torch._device import resolve_device
from ldpc_tpu_torch.ops.qc_msg import QCPlan
from ldpc_tpu_torch.parallel.sharding import channel_llr, mc_sweep, trial_generator
from ldpc_tpu_torch.utils.channel import compute_ber_fer
from ldpc_tpu_torch.utils.logging import get_logger
from ldpc_tpu_torch.utils.metrics import REGISTRY, MetricsRegistry

_LOG = get_logger("ldpc_tpu_torch.trainer")
DATA_MODES = ("random_bits", "zero_codewords", "random_codewords")
HISTORY_KEYS = ("train_losses", "val_losses", "ber_history", "fer_history")
VALIDATION_SEED = 1234


def make_optimizer(params, optimizer: str, learning_rate: float, weight_decay: float,
                   momentum: float = 0.9) -> torch.optim.Optimizer:
    """``add_decayed_weights(weight_decay)`` then ``sgd(lr, momentum)`` or
    ``adam(lr)`` of optax, as one torch optimizer."""
    params = list(params)
    if optimizer == "sgd":
        return torch.optim.SGD(params, lr=learning_rate, momentum=momentum, dampening=0.0,
                               nesterov=False, weight_decay=weight_decay)
    if optimizer == "adam":
        return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {optimizer!r}")


def warmup_cosine_factor(step: int, warmup_steps: int, num_steps: int) -> float:
    """``optax.warmup_cosine_decay_schedule(0, 1, max(warmup_steps, 1),
    max(num_steps, 2))`` at ``step``: linear from 0 over the warm-up, then a
    cosine to 0 at the decay steps (which include the warm-up), 0 after."""
    warmup, decay = max(warmup_steps, 1), max(num_steps, 2)
    if decay <= warmup:
        raise ValueError(f"num_steps ({num_steps}) must exceed warmup_steps ({warmup_steps})")
    if step < warmup:
        return step / warmup
    count = min(step - warmup, decay - warmup)
    return 0.5 * (1.0 + math.cos(math.pi * count / (decay - warmup)))


def train_step(model, plan: QCPlan, opt: torch.optim.Optimizer, llr: torch.Tensor,
               bits: torch.Tensor, grad_clip: float = 0.0) -> torch.Tensor:
    """One update on one batch: the mean per-frame loss, its gradients,
    global-norm clipping when ``grad_clip > 0``, the optimizer's step.
    Returns the loss (detached, on the device)."""
    params = [p for group in opt.param_groups for p in group["params"]]
    opt.zero_grad(set_to_none=True)
    _, loss = model(llr, plan, bits)
    loss = loss.mean()
    loss.backward()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if grad_clip > 0:
        torch.nn.utils.clip_grad_norm_(params, grad_clip)
    opt.step()
    return loss.detach()


def _load_opt_state(opt: torch.optim.Optimizer, state: dict) -> None:
    """Per-parameter buffers into ``opt``; its hyperparameters stay its own."""
    sd = opt.state_dict()
    sd["state"] = state
    opt.load_state_dict(sd)


class LDPCDecoderTrainer:
    """Trainer for a built decoder module (its parameters live in the module).

    ``plan`` and the module move to ``device`` (default the card; raises
    without one).  ``encoder`` (a :class:`ldpc_tpu_torch.codes.Encoder`)
    enables ``data_mode="random_codewords"``.
    """

    def __init__(self, model, plan: QCPlan, seed: int = 0, convention: str = "consistent",
                 modulation: str = "qpsk", encoder=None, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.plan = plan.to(self.device)
        self.convention = convention
        self.modulation = modulation
        self.encoder = encoder
        self.n = plan.C * plan.Z
        self.data_generator = torch.Generator(device=self.device)
        self.data_generator.manual_seed(int(seed))
        self._optimizer: torch.optim.Optimizer | None = None  # train_steps' (resumable)
        self._pending_opt_state = None
        self.step = 0
        self.train_losses: list[float] = []
        self.val_losses: list[float] = []
        self.ber_history: list[float] = []
        self.fer_history: list[float] = []

    @property
    def opt_state(self) -> dict | None:
        """The per-parameter buffers of ``train_steps``' optimizer, or None
        before the first ``train_steps``."""
        return None if self._optimizer is None else self._optimizer.state_dict()["state"]

    # -- data ----------------------------------------------------------------

    def _check_data_mode(self, data_mode: str) -> None:
        if data_mode not in DATA_MODES:
            raise ValueError(f"unknown data_mode {data_mode!r}")
        if data_mode == "random_codewords" and self.encoder is None:
            raise ValueError("data_mode='random_codewords' requires encoder=")

    def _batch(self, gen: torch.Generator, batch_size: int, snr_db, data_mode: str):
        """(bits, llr) of one batch drawn from ``gen``."""
        if data_mode == "zero_codewords":
            bits = torch.zeros((batch_size, self.n), dtype=torch.float32, device=self.device)
        elif data_mode == "random_codewords":
            bits = self.encoder.random_codewords(gen, batch_size)
        else:
            bits = torch.randint(0, 2, (batch_size, self.n), generator=gen,
                                 device=self.device).to(torch.float32)
        return bits, channel_llr(gen, bits, snr_db, self.modulation, self.convention)

    # -- training --------------------------------------------------------------

    def train(self, num_epochs: int, batch_size: int, learning_rate: float, snr_range=None,
              momentum: float = 0.9, weight_decay: float = 1e-4, validation_interval: int = 5,
              log: Callable[[str], None] | None = _LOG.info, data_mode: str = "random_bits",
              optimizer: str = "sgd", grad_clip: float = 0.0,
              metrics: MetricsRegistry = REGISTRY) -> dict[str, Any]:
        """SNR-mixed training: each epoch takes one step at each SNR of
        ``snr_range``, validating every ``validation_interval`` epochs.

        ``data_mode``: "random_bits" (random bits, not codewords: the model
        learns as a denoiser), "zero_codewords" (valid for sign-symmetric
        decoders) or "random_codewords" (``encoder=`` needed; the honest mode
        for decoders that are not sign-symmetric, such as the message GNN).
        """
        snr_range = [float(s) for s in (snr_range if snr_range is not None
                                        else [-2.0, 0.0, 2.0, 4.0])]
        opt = make_optimizer(self.model.parameters(), optimizer, learning_rate, weight_decay,
                             momentum)
        self._check_data_mode(data_mode)
        for epoch in range(num_epochs):
            losses = []
            for snr_db in snr_range:
                bits, llr = self._batch(self.data_generator, batch_size, snr_db, data_mode)
                losses.append(train_step(self.model, self.plan, opt, llr, bits, grad_clip))
            values = torch.stack(losses).tolist()
            epoch_loss = sum(values) / len(values)
            self.train_losses.append(epoch_loss)
            metrics.record("train_loss", epoch_loss)
            metrics.count("train_steps", len(values))
            if log:
                log(f"epoch {epoch + 1}/{num_epochs} loss {epoch_loss:.6f}")
            if (epoch + 1) % validation_interval == 0:
                vl, ber, fer = self.validate(batch_size, snr_range, data_mode)
                self.val_losses.append(vl)
                self.ber_history.append(ber)
                self.fer_history.append(fer)
                metrics.record("val_loss", vl)
                metrics.gauge("val_ber", ber)
                metrics.gauge("val_fer", fer)
                if log:
                    log(f"  val loss {vl:.6f} ber {ber:.6f} fer {fer:.6f}")
        return self.history()

    def train_steps(self, num_steps: int, batch_size: int, learning_rate: float, snr_range=None,
                    data_mode: str = "random_codewords", optimizer: str = "adam",
                    weight_decay: float = 0.0, grad_clip: float = 0.0, scan_steps: int = 100,
                    lr_schedule: str = "cosine", warmup_steps: int = 0,
                    log: Callable[[str], None] | None = None,
                    checkpoint_fn: Callable[[], None] | None = None,
                    metrics: MetricsRegistry = REGISTRY) -> dict[str, Any]:
        """Production training up to update ``num_steps``, in chunks of
        ``scan_steps`` updates.  Each update draws its SNR uniformly over
        [min(snr_range), max(snr_range)] from the data generator.  A chunk's
        losses stay on the device and are fetched once at its end, when
        ``train_loss``, ``train_steps`` and ``train_steps_per_s`` go to
        ``metrics`` and ``checkpoint_fn`` (if given) runs.  SGD's momentum is
        0.9, as in the JAX trainer.

        Resumable: the optimizer state and the update count carry over from
        an earlier call or from :meth:`load_state`.
        """
        snr_range = snr_range if snr_range is not None else [-2.0, 0.0, 2.0, 4.0]
        lo, hi = float(min(snr_range)), float(max(snr_range))
        if lr_schedule == "cosine":
            warmup_cosine_factor(0, warmup_steps, num_steps)  # raises on a bad schedule

            def factor(k):
                return warmup_cosine_factor(k, warmup_steps, num_steps)
        elif lr_schedule == "constant":
            def factor(k):
                return 1.0
        else:
            raise ValueError(f"unknown lr_schedule {lr_schedule!r}")
        opt = make_optimizer(self.model.parameters(), optimizer, learning_rate, weight_decay)
        self._check_data_mode(data_mode)
        if self._optimizer is None:
            if self._pending_opt_state is not None:  # load_state ran before the first call
                _load_opt_state(opt, self._pending_opt_state)
                self._pending_opt_state = None
            else:
                self.step = 0
        else:
            _load_opt_state(opt, self.opt_state)
        self._optimizer = opt
        start = self.step
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda k: factor(start + k))
        gen = self.data_generator
        while self.step < num_steps:
            k = min(scan_steps, num_steps - self.step)
            t0 = time.time()
            losses = []
            for _ in range(k):
                snr_db = lo + (hi - lo) * torch.rand((), generator=gen, device=self.device)
                bits, llr = self._batch(gen, batch_size, snr_db, data_mode)
                losses.append(train_step(self.model, self.plan, opt, llr, bits, grad_clip))
                sched.step()
            values = torch.stack(losses).tolist()  # the chunk's one fetch
            self.train_losses.extend(values)
            self.step += k
            mean = sum(values) / k
            metrics.record("train_loss", mean)
            metrics.count("train_steps", k)
            metrics.gauge("train_steps_per_s", k / max(time.time() - t0, 1e-9))
            if log:
                log(f"step {self.step}/{num_steps} loss {mean:.6f}")
            if checkpoint_fn is not None:
                checkpoint_fn()
        return self.history()

    @torch.no_grad()
    def validate(self, batch_size: int, snr_range,
                 data_mode: str = "random_bits") -> tuple[float, float, float]:
        """Mean loss, BER and FER over ``snr_range`` on a fixed validation
        set (one batch an SNR from a generator seeded by the SNR's index)."""
        self._check_data_mode(data_mode)
        total_l = total_ber = total_fer = 0.0
        for i, snr_db in enumerate(snr_range):
            gen = trial_generator(VALIDATION_SEED, i, 0, self.device)
            bits, llr = self._batch(gen, batch_size, float(snr_db), data_mode)
            soft, loss = self.model(llr, self.plan, bits)
            ber, fer = compute_ber_fer(bits, (soft > 0.5).to(torch.float32))
            total_l += float(loss.mean())
            total_ber += float(ber)
            total_fer += float(fer)
        k = len(snr_range)
        return total_l / k, total_ber / k, total_fer / k

    def evaluate_snr_range(self, snr_range, batch_size: int, num_trials: int, seed: int = 4321,
                           use_encoder: bool = False) -> tuple[list[float], list[float]]:
        """Monte-Carlo BER and FER: all-zero codewords or, with
        ``use_encoder=True``, random codewords of ``self.encoder``; each
        trial a pure function of (seed, SNR index, trial index)."""
        def decode(llr):
            with torch.no_grad():
                soft, _ = self.model(llr, self.plan)
            return (soft > 0.5).to(torch.float32)

        sweep = mc_sweep(decode, self.plan, snr_range, batch_size, num_trials, seed=seed,
                         modulation=self.modulation, convention=self.convention,
                         encoder=self.encoder if use_encoder else None, device=self.device)
        return sweep["ber"], sweep["fer"]

    # -- persistence -----------------------------------------------------------

    def history(self) -> dict[str, Any]:
        return {"train_losses": self.train_losses, "val_losses": self.val_losses,
                "ber_history": self.ber_history, "fer_history": self.fer_history}

    def _set_history(self, hist) -> None:
        for name in HISTORY_KEYS:
            values = hist.get(name, [])
            setattr(self, name, [float(x) for x in
                                 (values.tolist() if hasattr(values, "tolist") else values)])

    def save_model(self, path: str | Path) -> None:
        """The parameters and the history (``torch.save``)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"params": self.model.state_dict(), "history": self.history()}, path)

    def load_model(self, path: str | Path) -> None:
        """Load :meth:`save_model`'s file, or a flax msgpack checkpoint of
        the JAX trainer (``results/*.msgpack``), strictly."""
        path = Path(path)
        if zipfile.is_zipfile(path):  # torch.save writes a zip archive
            payload = torch.load(path, map_location="cpu", weights_only=True)
            params = payload["params"]
        else:
            payload = convert.read_flax_msgpack(path)
            if "params" not in payload:
                raise KeyError(f"{path} holds no 'params' entry")
            params = convert.state_dict_from_flax(payload["params"], self.model)
        self.model.load_state_dict(params, strict=True)
        self._set_history(payload.get("history", {}))

    def _state_payload(self) -> dict[str, Any]:
        return {"params": self.model.state_dict(), "opt_state": self.opt_state,
                "step": self.step, "data_generator": self.data_generator.get_state(),
                "history": self.history()}

    def _restore_state(self, payload: dict[str, Any], step: int, data_generator) -> None:
        self.model.load_state_dict(payload["params"], strict=True)
        opt_state = payload.get("opt_state")
        if self._optimizer is not None and opt_state is not None:
            _load_opt_state(self._optimizer, opt_state)
        self._pending_opt_state = opt_state
        self.step = int(step)
        self.data_generator.set_state(data_generator)
        self._set_history(payload.get("history", {}))

    def save_state(self, path: str | Path) -> None:
        """The whole resumable state: parameters, optimizer state, update
        count, data generator state and history, written under a temporary
        name and moved into place (a kill mid-write leaves the old file)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(path.suffix + ".tmp")
        torch.save(self._state_payload(), tmp)
        os.replace(tmp, path)

    def load_state(self, path: str | Path) -> None:
        """Restore :meth:`save_state`'s file.  Before the first
        ``train_steps`` the optimizer state waits for it."""
        payload = torch.load(Path(path), map_location="cpu", weights_only=True)
        self._restore_state(payload, payload["step"], payload["data_generator"])

    def save_history_json(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.history(), indent=2))

    def save_checkpoint(self, mgr) -> None:
        """The resumable state through a
        :class:`ldpc_tpu_torch.training.checkpoint.CheckpointManager`, at
        step ``self.step`` (the update count and the generator state ride in
        the history, as in the JAX trainer)."""
        payload = self._state_payload()
        mgr.save(self.step, params=payload["params"], opt_state=payload["opt_state"],
                 history={**payload["history"], "step": self.step,
                          "data_generator": payload["data_generator"]})

    def load_checkpoint(self, mgr, step: int | None = None) -> None:
        """Restore the latest (or a given) step saved by :meth:`save_checkpoint`."""
        payload = mgr.restore(step)
        hist = payload.get("history", {})
        self._restore_state(payload, hist["step"], hist["data_generator"])

    # -- plotting (imports matplotlib only when called) ---------------------------

    def plot_training_history(self):
        """(loss figure, BER/FER figure or None) of this trainer's history."""
        from ldpc_tpu_torch.visualization.plots import plot_training_history

        return plot_training_history(self.history())

    def plot_snr_performance(self, snr_range, ber_results, fer_results,
                             comparison_ber=None, comparison_fer=None):
        """(BER figure, FER figure) over ``snr_range``, each with a
        conventional decoder's curve where given."""
        from ldpc_tpu_torch.visualization.plots import plot_snr_performance

        return plot_snr_performance(snr_range, ber_results, fer_results, comparison_ber,
                                    comparison_fer)
