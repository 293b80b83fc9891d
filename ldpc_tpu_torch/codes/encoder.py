"""GF(2) systematic encoder derived from the parity-check matrix
(counterpart of ``ldpc_tpu.codes.encoder``).

The generator comes from GF(2) Gaussian elimination of H in numpy (host-side,
once per code); encoding is a mod-2 matmul in torch on the caller's device.
Random codewords take an explicit ``torch.Generator`` and are made on the
generator's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Encoder:
    """Systematic GF(2) encoder: info bits (k,) -> codeword (n,)."""

    generator: np.ndarray  # (k, n) uint8, G H^T = 0
    info_cols: np.ndarray  # (k,) columns of H carrying the information bits

    @property
    def k(self) -> int:
        return self.generator.shape[0]

    @property
    def n(self) -> int:
        return self.generator.shape[1]

    def encode(self, info_bits: torch.Tensor) -> torch.Tensor:
        """(..., k) info bits -> (..., n) float32 codewords (mod-2 matmul).

        Exact in float32: each output is an integer sum of at most k ones.
        """
        G = torch.as_tensor(self.generator, dtype=torch.float32, device=info_bits.device)
        return torch.remainder(info_bits.to(torch.float32) @ G, 2.0)

    def random_codewords(self, generator: torch.Generator, batch: int) -> torch.Tensor:
        """(batch, n) uniformly random codewords on ``generator``'s device."""
        info = torch.randint(0, 2, (batch, self.k), generator=generator,
                             device=generator.device).to(torch.float32)
        return self.encode(info)


def encoder_from_H(H: np.ndarray) -> Encoder:
    """Build a systematic encoder by GF(2) Gaussian elimination of H.

    Finds m' pivot columns (m' = rank of H), leaving k = n - m' free
    columns as information positions; each generator row is the codeword
    with a single 1 in one free position and parity bits solved from the
    reduced system.
    """
    H = (np.asarray(H) % 2).astype(np.uint8)
    m, n = H.shape
    R = H.copy()
    pivot_cols: list[int] = []
    r = 0
    for c in range(n):
        if r >= m:
            break
        rows = np.nonzero(R[r:, c])[0]
        if rows.size == 0:
            continue
        pr = r + rows[0]
        if pr != r:
            R[[r, pr]] = R[[pr, r]]
        # eliminate c from every other row
        mask = R[:, c].copy()
        mask[r] = 0
        R[mask == 1] ^= R[r]
        pivot_cols.append(c)
        r += 1
    rank = r
    R = R[:rank]
    pivots = np.array(pivot_cols, dtype=np.int64)
    free = np.setdiff1d(np.arange(n), pivots)
    k = free.size

    # For each free column f: codeword with bit f = 1 and pivot bits solved:
    # pivot row i gives x[pivots[i]] = R[i, f] (since R is reduced).
    G = np.zeros((k, n), dtype=np.uint8)
    G[np.arange(k), free] = 1
    G[:, pivots] = R[:, free].T  # (k, rank)
    if np.any((G @ H.T) % 2):
        raise AssertionError("encoder construction failed: G H^T != 0")
    return Encoder(generator=G, info_cols=free)
