"""Classical LDPC decoders: sum-product BP and scaled min-sum (counterpart of
``ldpc_tpu.models.classical``).

Two paths, as in the JAX package:

* The tensor-op path — :func:`decode_min_sum`, :func:`decode_bp` and
  :func:`make_layered_minsum` — is plain PyTorch over the QC message ops, on
  any device, differentiable (fixed-trip form), and later used by training.
  A fixed-iteration loop with per-frame convergence tracked in the state
  (identical decisions and iteration statistics to stopping per frame).
* The serving path — :class:`MinSumScaledDecoder` and
  :class:`BeliefPropagationDecoder` with ``backend="auto"`` — runs the
  hand-written fused kernels of :mod:`ldpc_tpu_torch.ops.fused_minsum` on a
  CUDA tensor (their plain versions on a CPU tensor).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ldpc_tpu_torch._device import resolve_device
from ldpc_tpu_torch.codes.edge_layout import QCLayout
from ldpc_tpu_torch.ops import fused_minsum as fm
from ldpc_tpu_torch.ops import qc_msg
from ldpc_tpu_torch.ops.qc_msg import QCPlan


class DecodeResult(NamedTuple):
    """Result of a batched decode.

    bits: (B, n) float32 hard decisions — for early-stopped frames, the bits
        at the first iteration whose syndrome was zero.
    beliefs: (B, n) final a-posteriori LLRs (positive -> bit 0).
    conv_iter: (B,) int32, 1-based first iteration with a valid syndrome, or
        ``max_iterations`` when the frame never converged.
    converged: (B,) bool.
    """

    bits: torch.Tensor
    beliefs: torch.Tensor
    conv_iter: torch.Tensor
    converged: torch.Tensor


def _track(bits_cz, plan, frozen, conv, t):
    """Freeze frames whose syndrome first became valid at iteration t."""
    ok = qc_msg.syndrome_ok(bits_cz, plan)
    newly = ok & (conv == 0)
    frozen = torch.where(newly[None, None, :], bits_cz, frozen)
    conv = torch.where(newly, t + 1, conv).to(torch.int32)
    return frozen, conv


def _finish(beliefs_cz, frozen, conv, max_iterations: int) -> DecodeResult:
    final_bits = (beliefs_cz < 0).to(torch.float32)
    converged = conv > 0
    bits = torch.where(converged[None, None, :], frozen, final_bits)
    conv_iter = torch.where(converged, conv, max_iterations).to(torch.int32)
    return DecodeResult(
        bits=qc_msg.cz_to_llr(bits),
        beliefs=qc_msg.cz_to_llr(beliefs_cz),
        conv_iter=conv_iter,
        converged=converged,
    )


def _decode_loop(llr: torch.Tensor, plan: QCPlan, max_iterations: int,
                 check_update: Callable, early_exit: bool) -> DecodeResult:
    """Shared BP/min-sum decode loop.

    ``early_exit`` stops as soon as every frame in the batch has a valid
    syndrome (batch-global); ``bits``, ``conv_iter`` and ``converged`` are
    identical to the fixed-trip loop, ``beliefs`` are as of the exit.
    """
    B = llr.shape[0]
    llr_cz = qc_msg.llr_to_cz(llr, plan)
    c2v = torch.zeros((plan.K, plan.Z, B), dtype=torch.float32, device=llr.device)
    frozen = torch.zeros((plan.C, plan.Z, B), dtype=torch.float32, device=llr.device)
    conv = torch.zeros((B,), dtype=torch.int32, device=llr.device)
    beliefs = llr_cz
    for t in range(max_iterations):
        if early_exit and bool((conv > 0).all()):
            break
        v2c, _ = qc_msg.var_update(c2v, llr_cz, plan)
        c2v = check_update(v2c, plan)
        beliefs = llr_cz + qc_msg.col_sum(c2v, plan)
        bits = (beliefs < 0).to(torch.float32)
        frozen, conv = _track(bits, plan, frozen, conv, t)
    return _finish(beliefs, frozen, conv, max_iterations)


def decode_min_sum(llr: torch.Tensor, plan: QCPlan, max_iterations: int = 50,
                   scaling_factor=0.75, early_exit: bool = False) -> DecodeResult:
    """Scaled min-sum decode of (B, n) channel LLRs (tensor-op path).

    ``early_exit=True`` stops once the whole batch is valid — identical
    decisions and iteration statistics.  Keep the default for training.
    """
    def upd(v2c, p):
        return qc_msg.check_update_minsum(v2c, p, alpha=scaling_factor)

    return _decode_loop(llr, plan, max_iterations, upd, early_exit)


def decode_bp(llr: torch.Tensor, plan: QCPlan, max_iterations: int = 50,
              early_exit: bool = False) -> DecodeResult:
    """Sum-product belief-propagation decode of (B, n) channel LLRs.

    ``early_exit`` as in :func:`decode_min_sum`.
    """
    return _decode_loop(llr, plan, max_iterations, qc_msg.check_update_sumproduct, early_exit)


def make_layered_minsum(qc: QCLayout, max_iterations: int = 20, alpha: float = 0.75,
                        early_exit: bool = False, device="cuda"):
    """Layered (base-row-sequential) scaled min-sum — tensor-op path.

    Base rows are processed in order, each layer forming v2c from the
    *current* beliefs and folding its new c2v back into them immediately
    (``beliefs[col] += new - old``).  The Z lifted rows of one base row are
    variable-disjoint, so updating them in parallel is exactly
    row-sequential processing.  The fused kernels take ``schedule="layered"``
    for the on-chip form.

    Returns ``decode(llr) -> DecodeResult``.
    """
    dev = resolve_device(device)
    st = fm._structure(qc)
    plan = qc_msg.make_plan(qc, dev)
    Z, C, R = st.Z, st.C, st.R

    def sweep(c2v, beliefs):
        # One full pass over all R layers, in place on c2v (K, Z, B) and
        # beliefs (C, Z, B), which the decode owns.
        for r in range(R):
            ms = st.row_members[r]
            X = torch.stack([
                torch.roll(beliefs[st.cols[k]] - c2v[k], -st.shifts[k], dims=0)
                for k in ms
            ])  # (d, Z, B) check-aligned v2c
            sgn = torch.where(X < 0, -1.0, 1.0)
            mag = X.abs()
            sp = torch.prod(sgn, dim=0)
            m1 = torch.amin(mag, dim=0)
            is_min = mag == m1
            first_min = (torch.cumsum(is_min.to(torch.int32), dim=0) * is_min) == 1
            m2 = torch.amin(torch.where(first_min, torch.inf, mag), dim=0)
            loo = torch.where(first_min, m2[None], m1[None])
            loo = torch.where(torch.isfinite(loo), loo, 0.0)
            out = alpha * sp[None] * sgn * loo  # (d, Z, B)
            for i, k in enumerate(ms):
                new = torch.roll(out[i], st.shifts[k], dims=0)
                beliefs[st.cols[k]] = beliefs[st.cols[k]] + (new - c2v[k])
                c2v[k] = new

    def decode(llr: torch.Tensor) -> DecodeResult:
        if llr.device.type != dev.type:
            raise ValueError(f"decoder was built for {dev}, llr is on {llr.device}")
        B = llr.shape[0]
        llr_cz = qc_msg.llr_to_cz(llr, plan)
        c2v = torch.zeros((st.K, Z, B), dtype=torch.float32, device=llr.device)
        beliefs = llr_cz.clone()
        frozen = torch.zeros((C, Z, B), dtype=torch.float32, device=llr.device)
        conv = torch.zeros((B,), dtype=torch.int32, device=llr.device)
        for t in range(max_iterations):
            if early_exit and bool((conv > 0).all()):
                break
            sweep(c2v, beliefs)
            bits = (beliefs < 0).to(torch.float32)
            frozen, conv = _track(bits, plan, frozen, conv, t)
        return _finish(beliefs, frozen, conv, max_iterations)

    return decode


def _resolve_backend(backend: str, qc: QCLayout | None = None) -> str:
    """``auto`` -> ``fused`` when one frame's state fits a block's shared
    memory, else ``fused_zlane``; raises when neither kernel takes the code.

    ``plain`` is the tensor-op path (the JAX package's ``xla``), for tests
    and comparisons; it is never chosen by ``auto``.
    """
    if backend not in ("auto", "fused", "fused_zlane", "plain"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend != "auto":
        return backend
    if qc is None or fm.fused_kernel_fits(qc):
        return "fused"
    if fm.zlane_kernel_fits(qc):
        return "fused_zlane"
    raise ValueError(
        f"no fused kernel takes this code (Z={qc.Z}): one frame exceeds the "
        f"fused kernel's shared memory and the zlane kernel needs Z % 8 == 0 "
        f"and {fm.zlane_smem_bytes(qc)} <= {fm._SMEM_BUDGET} bytes; "
        f"pass backend='plain' for the tensor-op path"
    )


def _make_fused(backend: str, qc: QCLayout, max_iterations: int, *,
                mode: str = "minsum", alpha: float = 0.75, early_exit: bool = False,
                schedule: str = "flooding", device="cuda"):
    if backend == "fused":
        return fm.make_fused_minsum(qc, max_iterations, alpha, mode=mode,
                                    early_exit=early_exit, schedule=schedule, device=device)
    if backend == "fused_zlane":
        return fm.make_fused_minsum_zlane(qc, max_iterations, alpha, mode=mode,
                                          early_exit=early_exit, schedule=schedule,
                                          device=device)
    return None


@dataclasses.dataclass(frozen=True)
class BeliefPropagationDecoder:
    """Object-style wrapper.

    ``decode(llr) -> (bits, iterations)``; ``iterations`` is the batch maximum
    of per-frame convergence iterations (or ``max_iterations`` without early
    stopping).

    ``backend``: "auto" (the fused kernel that takes the code), "fused",
    "fused_zlane", or "plain" (the tensor-op path).
    """

    qc: QCLayout
    max_iterations: int = 50
    early_stopping: bool = True
    backend: str = "auto"
    device: str = "cuda"

    def __post_init__(self):
        dev = resolve_device(self.device)
        object.__setattr__(self, "_plan", qc_msg.make_plan(self.qc, dev))
        resolved = _resolve_backend(self.backend, self.qc)
        object.__setattr__(
            self, "_fused",
            _make_fused(resolved, self.qc, self.max_iterations, mode="sumproduct",
                        alpha=1.0, early_exit=self.early_stopping, device=dev),
        )

    def decode_full(self, llr: torch.Tensor) -> DecodeResult:
        return decode_bp(llr, self._plan, self.max_iterations)

    def decode(self, llr: torch.Tensor):
        if self._fused is not None:
            bits, conv = self._fused(llr)
            iters = int(conv.max()) if self.early_stopping else self.max_iterations
            return bits, iters
        res = decode_bp(llr, self._plan, self.max_iterations,
                        early_exit=self.early_stopping)
        iters = int(res.conv_iter.max()) if self.early_stopping else self.max_iterations
        return res.bits, iters


@dataclasses.dataclass(frozen=True)
class MinSumScaledDecoder:
    """Object-style wrapper for scaled min-sum.  ``backend`` as in
    :class:`BeliefPropagationDecoder`."""

    qc: QCLayout
    max_iterations: int = 50
    scaling_factor: float = 0.75
    early_stopping: bool = True
    backend: str = "auto"
    schedule: str = "flooding"  # or "layered" (serial-C; ~2x faster convergence)
    device: str = "cuda"

    def __post_init__(self):
        dev = resolve_device(self.device)
        object.__setattr__(self, "_plan", qc_msg.make_plan(self.qc, dev))
        resolved = _resolve_backend(self.backend, self.qc)
        object.__setattr__(
            self, "_fused",
            _make_fused(resolved, self.qc, self.max_iterations,
                        alpha=self.scaling_factor, early_exit=self.early_stopping,
                        schedule=self.schedule, device=dev),
        )
        # The tensor-op layered path backs decode_full whatever the backend
        # (the JAX package builds it only when no fused kernel serves, so
        # there decode_full floods when a fused layered kernel is in use).
        object.__setattr__(
            self, "_layered",
            make_layered_minsum(self.qc, self.max_iterations, self.scaling_factor,
                                early_exit=self.early_stopping, device=dev)
            if self.schedule == "layered" else None,
        )

    def decode_full(self, llr: torch.Tensor) -> DecodeResult:
        if self._layered is not None:
            return self._layered(llr)
        return decode_min_sum(llr, self._plan, self.max_iterations, self.scaling_factor)

    def decode(self, llr: torch.Tensor):
        if self._fused is not None:
            bits, conv = self._fused(llr)
            iters = int(conv.max()) if self.early_stopping else self.max_iterations
            return bits, iters
        if self._layered is not None:
            res = self._layered(llr)
        else:
            res = decode_min_sum(llr, self._plan, self.max_iterations,
                                 self.scaling_factor, early_exit=self.early_stopping)
        iters = int(res.conv_iter.max()) if self.early_stopping else self.max_iterations
        return res.bits, iters
