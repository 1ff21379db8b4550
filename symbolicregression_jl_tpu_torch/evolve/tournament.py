"""Tournament selection (port of ``evolve/tournament.py``).

Sample ``tournament_n`` members without replacement, scale their costs
by the adaptive-parsimony factor ``exp(scaling * frequency)``, then pick
the k-th best, k following the truncated geometric place distribution
``p (1-p)^k``. Batched: one tournament per key.
"""

from __future__ import annotations

import torch

from . import rng

__all__ = ["tournament_select"]


def tournament_select(key: torch.Tensor, cost: torch.Tensor, complexity: torch.Tensor,
                      normalized_frequencies: torch.Tensor, *, tournament_n: int, p: float,
                      use_frequency: bool, adaptive_parsimony_scaling: float,
                      maxsize: int) -> torch.Tensor:
    """Selected member index per tournament.

    ``key`` [..., 2] (a batch of keys); ``cost``/``complexity`` [..., P] (the population
    each tournament draws from, broadcast against the key batch)."""
    P = cost.shape[-1]
    ks = rng.split(key, 2)
    k1, k2 = ks[..., 0, :], ks[..., 1, :]
    picks = rng.permutation(k1, P)[..., :tournament_n]
    c = torch.gather(cost.expand(*picks.shape[:-1], P), -1, picks)
    if use_frequency:
        size = torch.gather(complexity.expand(*picks.shape[:-1], P), -1, picks)
        in_range = (size > 0) & (size <= maxsize)
        freq = torch.where(
            in_range,
            normalized_frequencies[torch.clamp(size.long() - 1, 0, maxsize - 1)],
            0.0,
        )
        c = c * torch.exp(adaptive_parsimony_scaling * freq)
    c = torch.where(torch.isnan(c), torch.inf, c)
    if p >= 1.0:
        best = torch.argmin(c, dim=-1, keepdim=True)
        return torch.gather(picks, -1, best)[..., 0].to(torch.int32)
    ks_ = torch.arange(tournament_n, device=cost.device,
                       dtype=torch.float64 if cost.dtype == torch.float64 else torch.float32)
    place_weights = p * (1 - p) ** ks_
    place = rng.categorical(k2, torch.log(place_weights))
    order = torch.argsort(c, dim=-1, stable=True)
    chosen = torch.gather(order, -1, place[..., None].long())
    return torch.gather(picks, -1, chosen)[..., 0].to(torch.int32)
