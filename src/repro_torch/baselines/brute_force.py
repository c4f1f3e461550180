"""Exact k-NN by full scan — the recall ground truth."""

from __future__ import annotations

import dataclasses

import torch


# Queries per distance block: a (4096, n) f32 block is 16 GB at n = 1M.
_CHUNK = 4096


@dataclasses.dataclass
class BruteForce:
    data: torch.Tensor        # (n, d) f32, on the device that answers

    def query(self, queries: torch.Tensor,
              k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(ids (B, k) int64, dists (B, k) f32) of the k nearest points,
        in f32 (``qq - 2 q.x + xx``), a block of queries at a time."""
        xx = (self.data * self.data).sum(-1)[None, :]
        ids, dists = [], []
        for q in torch.split(queries, _CHUNK):
            d2 = (q * q).sum(-1, keepdim=True) - 2.0 * (q @ self.data.T) + xx
            neg, sel = torch.topk(-torch.clamp_min(d2, 0.0), k, dim=1)
            ids.append(sel)
            dists.append(torch.sqrt(-neg))
        return torch.cat(ids), torch.cat(dists)
