"""Monte-Carlo BER/FER sweeps, batch-sharded decoding and the data-parallel
train step (counterpart of ``ldpc_tpu.parallel.sharding``).

Each trial's data comes from a ``torch.Generator`` that is a pure function
of (seed, SNR index, trial index), as the JAX package's
``fold_in(fold_in(key(seed), i), t)`` is: a sweep, or any trial of it, gives
the same counts whenever it runs, and :func:`trial_data` lets another
statistic (``ComparativeEvaluator``'s iteration counts) see the very LLRs of
a trial.  Bits and LLRs are made on the target device, and the counts stay
there until a point of the sweep is done.

Under a ``mesh`` (:func:`ldpc_tpu_torch.parallel.make_mesh`) the JAX
package's one controller over N devices becomes N processes, one a rank:

* every rank draws the *whole* batch from the same generator and works on
  its own contiguous rows (:func:`data_rows`), so the batch must divide by
  the data axis;
* error counts are integers summed over the ranks, so an N-rank sweep
  equals the 1-rank sweep bit for bit;
* :func:`shard_decode` gathers every batch-leading output, so it equals the
  decoder on the whole batch bit for bit;
* :func:`make_sharded_train_step` averages the ranks' gradients and losses
  (a sum over the ranks divided by their number: ``ReduceOp.AVG`` is NCCL's
  alone), so it equals the 1-rank step up to the order of the sums.

A ``model`` axis over 1 (tensor parallelism) waits for ROADMAP §A6b.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ldpc_tpu_torch._device import resolve_device
from ldpc_tpu_torch.ops.qc_msg import QCPlan
from ldpc_tpu_torch.parallel.mesh import MESH_DIMS, TENSOR_PARALLEL_ITEM
from ldpc_tpu_torch.utils import channel as ch


def _data_axis(mesh) -> tuple[int, int, object]:
    """(this rank's place on the data axis, the axis's size, its process group)."""
    if tuple(getattr(mesh, "mesh_dim_names", None) or ()) != MESH_DIMS:
        raise TypeError(f"mesh must be the ('data', 'model') DeviceMesh of make_mesh, "
                        f"got {type(mesh).__name__}")
    if mesh.size(1) > 1:
        raise NotImplementedError(f"a model axis of {mesh.size(1)} (tensor parallelism) is not "
                                  f"ported: it waits for {TENSOR_PARALLEL_ITEM}")
    return mesh.get_local_rank("data"), mesh.size(0), mesh.get_group("data")


def data_rows(batch_size: int, mesh) -> slice:
    """This rank's contiguous rows of a batch of ``batch_size`` (all of it
    without a mesh).  Raises unless the batch divides by the data axis."""
    if mesh is None:
        return slice(0, batch_size)
    rank, size, _ = _data_axis(mesh)
    if batch_size % size:
        raise ValueError(f"batch {batch_size} does not divide by the data axis ({size} ranks)")
    rows = batch_size // size
    return slice(rank * rows, (rank + 1) * rows)


def reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over the data axis, in place (``t`` itself without a mesh)."""
    if mesh is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=_data_axis(mesh)[2])
    return t


def _gather_rows(out, size: int, group):
    """Every rank's batch-leading ``out`` (a tensor or a tuple of them),
    concatenated in rank order."""
    if isinstance(out, (tuple, list)):
        parts = [_gather_rows(o, size, group) for o in out]
        return type(out)(*parts) if hasattr(out, "_fields") else type(out)(parts)
    out = out.contiguous()
    parts = [torch.empty_like(out) for _ in range(size)]
    dist.all_gather(parts, out, group=group)
    return torch.cat(parts)


def trial_generator(seed: int, snr_index: int, trial: int, device) -> torch.Generator:
    """The generator of one trial, on ``device``: seeded from (seed,
    snr_index, trial) alone."""
    words = np.random.SeedSequence([int(seed), int(snr_index), int(trial)]).generate_state(
        2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(words[0]) << 31) ^ int(words[1]))
    return gen


def channel_llr(gen: torch.Generator, bits: torch.Tensor, snr_db, modulation: str = "qpsk",
                convention: str = "consistent") -> torch.Tensor:
    """(B, n) bits -> (B, n) channel LLRs with noise from ``gen``."""
    if modulation == "qpsk":
        return ch.qpsk_awgn_llr(gen, bits, snr_db, convention)
    if modulation == "bpsk":
        return ch.bpsk_awgn_llr(gen, bits, snr_db)
    raise ValueError(f"unknown modulation {modulation!r}")


def trial_data(gen: torch.Generator, n: int, batch_size: int, snr_db, modulation: str = "qpsk",
               convention: str = "consistent", encoder=None):
    """(bits, llr) of one trial on ``gen``'s device: all-zero codewords, or
    random codewords of ``encoder`` drawn from ``gen`` before the noise."""
    if encoder is None:
        bits = torch.zeros((batch_size, n), dtype=torch.float32, device=gen.device)
    else:
        bits = encoder.random_codewords(gen, batch_size)
    return bits, channel_llr(gen, bits, snr_db, modulation, convention)


def count_errors(tx_bits: torch.Tensor, rx_bits: torch.Tensor) -> torch.Tensor:
    """(bit_errors, frame_errors, bits, frames) of (B, n) bit tensors, as
    one int64 tensor on their device: exact at any batch (a float32 count
    rounds past 2**24)."""
    errs = tx_bits != rx_bits
    return torch.stack([errs.sum(), errs.any(dim=-1).sum(),
                        torch.tensor(errs.numel(), device=errs.device),
                        torch.tensor(errs.shape[0], device=errs.device)])


def make_mc_trial(decode_bits: Callable[[torch.Tensor], torch.Tensor], n: int, batch_size: int,
                  mesh=None, modulation: str = "qpsk", convention: str = "consistent",
                  encoder=None):
    """A Monte-Carlo trial: ``trial(gen, snr_db) -> (bit_errors, frame_errors,
    bits, frames)``, int64 scalars on ``gen``'s device.

    Transmits all-zero codewords (valid for sign-symmetric decoders) or, with
    an ``encoder``, random codewords (needed for the neural decoders, which
    are not sign-symmetric).  ``decode_bits`` maps (B, n) LLRs to (B, n)
    hard bits.  Under a ``mesh`` each rank decodes its rows of the batch and
    the counts are summed over the ranks.
    """
    rows = data_rows(batch_size, mesh)

    def trial(gen: torch.Generator, snr_db):
        bits, llr = trial_data(gen, n, batch_size, snr_db, modulation, convention, encoder)
        counts = count_errors(bits[rows], decode_bits(llr[rows].contiguous()))
        return tuple(reduce_sum(counts, mesh))

    return trial


def mc_sweep(decode_bits: Callable[[torch.Tensor], torch.Tensor], plan: QCPlan, snr_range,
             batch_size: int, num_trials: int, mesh=None, seed: int = 4321,
             modulation: str = "qpsk", convention: str = "consistent", encoder=None,
             device="cuda") -> dict[str, list[float]]:
    """BER/FER sweep over ``snr_range``, ``num_trials`` batches a point,
    sharded over ``mesh``'s data axis where given.  Returns {"snr", "ber",
    "fer"} lists, the same on every rank and for any number of ranks."""
    dev = resolve_device(device)
    n = plan.C * plan.Z
    trial = make_mc_trial(decode_bits, n, batch_size, mesh, modulation, convention, encoder)
    bers, fers = [], []
    for i, snr_db in enumerate(snr_range):
        totals = torch.zeros(4, dtype=torch.int64, device=dev)
        for t in range(num_trials):
            totals += torch.stack(trial(trial_generator(seed, i, t, dev), float(snr_db)))
        be, fe, nb, nf = totals.tolist()
        bers.append(be / nb)
        fers.append(fe / nf)
    return {"snr": [float(s) for s in snr_range], "ber": bers, "fer": fers}


def shard_decode(decode_fn: Callable, mesh, axis: str = "data") -> Callable:
    """``decode_fn`` over the mesh's data axis: the returned callable takes
    the global (B, n) batch (the same on every rank), runs ``decode_fn`` on
    this rank's rows and gathers every batch-leading output (a tensor or a
    tuple of them) from all ranks, so that it returns ``decode_fn(batch)``
    on every rank.  Decoding never crosses frames, so a hand-written
    kernel's decoder shards as it is.  The batch must divide by the axis.
    """
    if axis != "data":
        raise ValueError(f"only the 'data' axis shards a batch, not {axis!r}")
    _, size, group = _data_axis(mesh)

    def decode(llr: torch.Tensor):
        rows = data_rows(llr.shape[0], mesh)
        return _gather_rows(decode_fn(llr[rows].contiguous()), size, group)

    return decode


def _average(tensors: list[torch.Tensor], size: int, group) -> None:
    """Each tensor replaced by its mean over the ranks (one SUM all-reduce a
    dtype, divided by ``size``)."""
    for dtype in {t.dtype for t in tensors}:
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat /= size
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def make_sharded_train_step(model, plan: QCPlan, optimizer: torch.optim.Optimizer, mesh,
                            batch_size: int, modulation: str = "qpsk",
                            convention: str = "consistent"):
    """A data-parallel train step: ``step(gen, snr_db) -> loss``.

    Each rank draws the whole batch of random bits and their LLRs from
    ``gen`` (the same generator state on every rank), takes its rows,
    computes their mean loss and backpropagates; the gradients and the loss
    are averaged over the ranks and ``optimizer`` steps on every rank, so the
    parameters stay the same everywhere.  ``mesh=None`` is the 1-rank step
    on the whole batch.  A parameter without a gradient gets a zero one, as
    in the trainer.
    """
    n = plan.C * plan.Z
    rows = data_rows(batch_size, mesh)
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(gen: torch.Generator, snr_db) -> torch.Tensor:
        bits = torch.randint(0, 2, (batch_size, n), generator=gen,
                             device=gen.device).to(torch.float32)
        llr = channel_llr(gen, bits, snr_db, modulation, convention)
        optimizer.zero_grad(set_to_none=True)
        _, loss = model(llr[rows].contiguous(), plan, bits[rows])
        loss = loss.mean()
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        loss = loss.detach()
        if mesh is not None:
            _, size, group = _data_axis(mesh)
            _average([p.grad for p in params] + [loss], size, group)
        optimizer.step()
        return loss

    return step
