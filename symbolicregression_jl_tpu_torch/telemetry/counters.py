"""Device-side search telemetry accumulators.

Port of the JAX package's ``telemetry/counters.py``. What happens inside
the generation steps — which mutation kinds get sampled, how many
candidates survive constraints and annealing, how many evals produce
non-finite losses — is invisible to the host unless it is counted on the
device. These counters are small int32 tensors accumulated over an
iteration's cycles (`CycleTelemetry`, one row per island), summed over
islands in the iteration epilogue and stored on the engine state
(`IterationTelemetry` on ``SearchDeviceState.telem``), so the host
fetches them with the per-iteration state pull it already performs.
Every function here is a fixed-shape tensor op: no ``.item()``, no
``nonzero``, no data-dependent shapes, so counting adds no host sync.

Integer results equal the JAX package's exactly on the same inputs,
including the 32-bit wraparound of the member hashes (computed in int64
and masked to 32 bits, as ``evolve/rng.py`` does for threefry).

Counters are PER ITERATION (rebuilt at each iteration, not cumulative):
int32 cannot overflow within one iteration at any plausible config, and
the host-side `Telemetry` hub does the cross-iteration accumulation in
Python ints.

Counter semantics (schema ``graftscope.v2``, docs/OBSERVABILITY.md):

- ``proposed[k]`` — generation-step slots whose sampled operation was
  mutation kind ``k`` (index order = ``MUTATION_KINDS``; the last index
  is crossover). One proposal per slot per cycle.
- ``accepted[k]`` — proposals that replaced a member with the *new*
  genome (mutations: passed constraints + finite cost + annealing;
  immediate kinds count as accepted; crossover: both-children-valid
  replacement). Kept-parent fallbacks are NOT accepts.
- ``reject_reasons[r]`` — slot-level rejection reason histogram (0 none,
  1 constraint/no-valid-candidate, 2 non-finite cost, 3
  annealing/frequency rejection).
- ``candidates`` — candidate evals actually needed (the raw
  ``num_evals`` increments, before any minibatch fraction scaling).
- ``invalid`` — needed candidates whose evaluated cost came back
  non-finite.
- ``eval_rows`` / ``eval_launches`` — candidate trees through / launches
  of the candidate eval, counted as the JAX package counts them: per
  island in the cycle part (the port launches once per cycle for all
  islands), and the iteration epilogue adds the finalize re-eval (every
  member, one launch).
- ``screen_rows`` / ``screen_launches`` / ``rescore_rows`` /
  ``rescore_launches`` — graftstage staged-eval counters
  (docs/PRECISION.md), per island in the same way; all zero when staging
  is off.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ..core.options import MUTATION_KINDS

__all__ = [
    "N_KIND_SLOTS",
    "N_REASONS",
    "LOSS_HIST_BINS",
    "LOSS_HIST_LO",
    "LOSS_HIST_HI",
    "CycleTelemetry",
    "IterationTelemetry",
    "empty_cycle_telemetry",
    "empty_iteration_telemetry",
    "step_telemetry",
    "add_cycle_telemetry",
    "member_dup_stats",
    "member_hash_keys",
    "unique_key_count",
    "loss_histogram",
]

# Mutation kinds + 1 crossover pseudo-kind (same convention as
# CycleEvents.kind in evolve/step.py).
N_KIND_SLOTS = len(MUTATION_KINDS) + 1
N_REASONS = 4  # none / constraint / invalid / annealing

# Population-loss histogram: log10(loss) bins over [LO, HI); finite
# losses <= 0 (perfect fits) clamp into the first bin, non-finite losses
# are not counted.
LOSS_HIST_BINS = 32
LOSS_HIST_LO = -8.0
LOSS_HIST_HI = 8.0

_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass
class CycleTelemetry:
    """Counters accumulated over an iteration's cycles. Every field has
    a leading batch shape (``[I]`` per island in the cycles, ``[]`` once
    summed over islands)."""

    proposed: torch.Tensor        # [..., N_KIND_SLOTS] int32
    accepted: torch.Tensor        # [..., N_KIND_SLOTS] int32
    reject_reasons: torch.Tensor  # [..., N_REASONS] int32
    candidates: torch.Tensor      # [...] int32
    invalid: torch.Tensor         # [...] int32
    eval_rows: torch.Tensor       # [...] int32
    eval_launches: torch.Tensor   # [...] int32
    screen_rows: torch.Tensor     # [...] int32 (staged eval only, else 0)
    screen_launches: torch.Tensor
    rescore_rows: torch.Tensor
    rescore_launches: torch.Tensor

    def fields(self):
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))


@dataclasses.dataclass
class IterationTelemetry:
    """One iteration's telemetry, stored on ``SearchDeviceState.telem``.

    ``finalize_rows`` / ``finalize_unique`` measure structural member
    duplication of the iteration's final population (constants
    included): ``finalize_rows - finalize_unique`` is the duplication the
    finalize's dedup exploits."""

    cycle: CycleTelemetry
    finalize_rows: torch.Tensor    # [] int32
    finalize_unique: torch.Tensor  # [] int32
    loss_hist: torch.Tensor        # [LOSS_HIST_BINS] int32
    cx_hist: torch.Tensor          # [maxsize] int32


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.int32, device=device)


def empty_cycle_telemetry(batch_shape=(), device=None) -> CycleTelemetry:
    """All-zero counters with leading shape ``batch_shape``."""
    b = tuple(batch_shape)
    return CycleTelemetry(
        proposed=_zeros(b + (N_KIND_SLOTS,), device),
        accepted=_zeros(b + (N_KIND_SLOTS,), device),
        reject_reasons=_zeros(b + (N_REASONS,), device),
        **{name: _zeros(b, device) for name in (
            "candidates", "invalid", "eval_rows", "eval_launches", "screen_rows",
            "screen_launches", "rescore_rows", "rescore_launches")},
    )


def empty_iteration_telemetry(maxsize: int, device=None) -> IterationTelemetry:
    return IterationTelemetry(
        cycle=empty_cycle_telemetry((), device),
        finalize_rows=_zeros((), device),
        finalize_unique=_zeros((), device),
        loss_hist=_zeros((LOSS_HIST_BINS,), device),
        cx_hist=_zeros((maxsize,), device),
    )


def add_cycle_telemetry(a: CycleTelemetry, b: CycleTelemetry) -> CycleTelemetry:
    return CycleTelemetry(*(x + y for x, y in zip(a.fields(), b.fields())))


def _count(mask: torch.Tensor) -> torch.Tensor:
    """int32 count of True over the last axis."""
    return mask.sum(dim=-1, dtype=torch.int32)


def _histogram(idx: torch.Tensor, n: int, weight: torch.Tensor) -> torch.Tensor:
    """[..., n] int32 counts of ``idx`` over the last axis, each entry
    weighted by the int32 ``weight`` (0 or 1): a comparison against the
    bins, so the shape is fixed and nothing syncs."""
    bins = torch.arange(n, dtype=idx.dtype, device=idx.device)
    return ((idx[..., None] == bins) * weight[..., None]).sum(dim=-2, dtype=torch.int32)


def step_telemetry(
    *,
    kind: torch.Tensor,          # [..., B] int32 sampled mutation kind
    is_xover: torch.Tensor,      # [..., B] bool
    immediate: torch.Tensor,     # [..., B] bool
    accepted_mut: torch.Tensor,  # [..., B] bool
    xo_replace: torch.Tensor,    # [..., B] bool
    mut_success: torch.Tensor,   # [..., B] bool
    xo_success: torch.Tensor,    # [..., B] bool
    after_cost: torch.Tensor,    # [..., B] candidate-1 cost
    xo_nan: torch.Tensor,        # [..., B] bool either crossover child non-finite
    anneal_ok: torch.Tensor,     # [..., B] bool
    cost: torch.Tensor,          # [..., B, 2] both babies' costs
    needs_eval1: torch.Tensor,   # [..., B] bool
    needs_eval2: torch.Tensor,   # [..., B] bool
    n_eval_rows: int,            # candidate trees per island in this step's eval
    n_screen_rows: int = 0,      # candidates screened per island (staged eval)
    n_rescore_rows: int = 0,     # candidates rescored per island (staged eval)
) -> CycleTelemetry:
    """Counters for one generation step of every island (leading axes
    ``[...]``, the slot axis last), from values the step already computed
    (no extra RNG draws, no change to the search dataflow — the
    telemetry=on/off search trajectories are bit-identical)."""
    nk = len(MUTATION_KINDS)
    k_eff = torch.where(is_xover, nk, kind)
    one = torch.ones_like(kind)
    proposed = _histogram(k_eff, N_KIND_SLOTS, one)
    acc = torch.where(is_xover, xo_replace, immediate | accepted_mut)
    accepted = _histogram(k_eff, N_KIND_SLOTS, acc.to(kind.dtype))

    # Same reject-reason chain as CycleEvents (evolve/step.py), so the
    # recorder's aggregate counts and these counters agree on "invalid".
    mut_reason = torch.where(
        ~mut_success, 1,
        torch.where(~torch.isfinite(after_cost), 2, torch.where(~anneal_ok, 3, 0)))
    xo_reason = torch.where(~xo_success, 1, torch.where(xo_nan, 2, 0))
    reason = torch.where(is_xover, xo_reason, torch.where(immediate, 0, mut_reason))
    reject_reasons = _histogram(reason, N_REASONS, one)

    inv = (_count(needs_eval1 & ~torch.isfinite(cost[..., 0]))
           + _count(needs_eval2 & ~torch.isfinite(cost[..., 1])))
    cands = _count(needs_eval1) + _count(needs_eval2)
    fill = lambda v: torch.full(cands.shape, v, dtype=torch.int32, device=cands.device)
    return CycleTelemetry(
        proposed=proposed,
        accepted=accepted,
        reject_reasons=reject_reasons,
        candidates=cands,
        invalid=inv,
        eval_rows=fill(n_eval_rows),
        eval_launches=fill(2 if n_screen_rows else 1),
        screen_rows=fill(n_screen_rows),
        screen_launches=fill(1 if n_screen_rows else 0),
        rescore_rows=fill(n_rescore_rows),
        rescore_launches=fill(1 if n_rescore_rows else 0),
    )


# ---------------------------------------------------------------------------
# Member duplication stats (the dedup hit-rate counter)
# ---------------------------------------------------------------------------

# Fixed odd multipliers for 3 independent linear 32-bit-wraparound hashes
# (the JAX package's constants, from the same fixed seed): collisions
# over the 3x31-bit combined key are negligible at population scales.
@functools.lru_cache(maxsize=8)
def _dup_hash_consts(width: int) -> np.ndarray:
    rng = np.random.default_rng(0x5C09E)
    return (rng.integers(1, 2**31, size=(3, width), dtype=np.int64)
            .astype(np.int32) | 1)


@functools.lru_cache(maxsize=8)
def _dup_hash_tensor(width: int, device: str) -> torch.Tensor:
    """The multipliers as an int64 tensor on ``device``, copied there once
    (from pinned memory without waiting, so no iteration pays a sync)."""
    host = torch.from_numpy(_dup_hash_consts(width).astype(np.int64))
    if torch.device(device).type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 with the same low 32 bits."""
    x = x & _MASK32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def member_hash_keys(trees) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Three independent [N] int32 member-identity hash keys over the
    member axes of a TreeBatch ([I, P, L] or template [I, P, K, L]):
    structurally identical members (constants included, by their float32
    bits) hash to the same 3-key tuple. Bit-equal to the JAX package's
    int32 wraparound sums."""
    L = trees.arity.shape[-1]
    I, P = trees.arity.shape[0], trees.arity.shape[1]
    N = I * P
    lane = torch.arange(L, device=trees.arity.device) < trees.length[..., None]
    word = torch.where(
        lane,
        (trees.arity.to(torch.int32) << 28) ^ (trees.op.to(torch.int32) << 20)
        ^ (trees.feat.to(torch.int32) << 8),
        0)
    cbits = torch.where(lane, trees.const.to(torch.float32).contiguous().view(torch.int32), 0)
    word2 = word.reshape(N, -1).to(torch.int64)
    cbits2 = cbits.reshape(N, -1).to(torch.int64)
    W = word2.shape[1]
    R = _dup_hash_tensor(2 * W, str(word2.device))
    # Each product fits int64 exactly; masked to its low 32 bits, W of
    # them sum without overflow, and the low 32 bits of the sum are the
    # int32 wraparound sum.
    keys = tuple(
        _wrap32(((word2 * R[k, :W]) & _MASK32).sum(dim=1)
                + ((cbits2 * R[k, W:]) & _MASK32).sum(dim=1))
        for k in range(3))
    return keys


def unique_key_count(keys) -> torch.Tensor:
    """Number of distinct 3-key tuples among ``keys`` (three [N] int32
    tensors): two stable sorts (the third key, then the first two packed
    in one int64) put equal tuples side by side; neighbours are compared."""
    k0, k1, k2 = keys
    order = torch.argsort(k2, stable=True)
    k01 = (k0.to(torch.int64) << 32) | (k1.to(torch.int64) & _MASK32)
    order = order[torch.argsort(k01[order], stable=True)]
    a, c = k01[order], k2[order]
    differs = (a[1:] != a[:-1]) | (c[1:] != c[:-1])
    return 1 + differs.sum(dtype=torch.int32)


def member_dup_stats(trees) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, unique) over the member axes of a TreeBatch ([I, P, L] or
    template [I, P, K, L]): how many member rows are structurally
    identical copies (constants included); ``rows - unique`` = dedup
    hits. Hash-only count: a 93-bit collision would undercount uniques
    by 1, acceptable for a telemetry counter."""
    keys = member_hash_keys(trees)
    N = trees.arity.shape[0] * trees.arity.shape[1]
    rows = torch.full((), N, dtype=torch.int32, device=trees.arity.device)
    return rows, unique_key_count(keys)


def loss_histogram(loss: torch.Tensor) -> torch.Tensor:
    """[LOSS_HIST_BINS] int32 histogram of log10(loss) over finite
    population losses (finite losses <= 0 land in bin 0)."""
    flat = loss.reshape(-1)
    finite = torch.isfinite(flat)
    lg = torch.log10(torch.clamp(torch.where(finite, flat, 1.0), min=1e-30))
    idx = torch.clamp(
        ((lg - LOSS_HIST_LO) / (LOSS_HIST_HI - LOSS_HIST_LO) * LOSS_HIST_BINS).to(torch.int32),
        0, LOSS_HIST_BINS - 1)
    hist = torch.zeros(LOSS_HIST_BINS, dtype=torch.int32, device=flat.device)
    return hist.index_add_(0, idx, finite.to(torch.int32))
