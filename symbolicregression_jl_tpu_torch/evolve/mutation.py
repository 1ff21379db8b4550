"""Tree mutations on the postfix encoding (port of ``evolve/mutation.py``).

Each function mirrors one tree-edit primitive of SymbolicRegression.jl's
MutationFunctions.jl, here applied to a batch of N trees at once (fields
[N, L]; the reference's per-tree scalars are [N] tensors). Structural
edits are piece concatenations (:mod:`.pieces`); value edits are masked
writes. Every function returns ``(tree, ok)``, ``ok`` False marking a
structurally impossible attempt.

Randomness: a mutation takes a uniform(0,1) slice ``u`` [N, nu] of a
fixed budget (:func:`branch_nu`), consumed in the same order as the JAX
package, so the same uniforms give the same trees.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple, Union

import torch

from ..ops.encoding import (LEAF_CONST, LEAF_PARAM, LEAF_VAR, MAX_ARITY, TreeBatch, lane_take,
                            select_tree, structure_from_arity)
from . import rng
from .pieces import combine_sources, concat_pieces, splice_span
from .rng import USlice, u_bernoulli, u_categorical_weights, u_masked_choice, u_normal, u_randint

__all__ = [
    "MutationContext", "branch_nu", "gen_tree_nu", "mutate_constant", "mutate_operator",
    "mutate_feature", "swap_operands", "rotate_tree", "add_node", "insert_random_op",
    "delete_node", "randomize_tree", "crossover_trees", "gen_random_tree", "mutate_parameter_row",
    "gen_random_tree_fixed_size_u",
]


class MutationContext(NamedTuple):
    """Context shared by the mutation functions. ``nfeatures`` is an int,
    or for template expressions an int tensor [N] with the argument count
    of each row's chosen subexpression. ``n_params`` > 0 (parametric
    expressions) adds parameter leaves to the random-leaf draws."""

    nops: Tuple[int, ...]      # per-arity operator counts (1-based arity)
    nfeatures: Union[int, torch.Tensor]
    max_nodes: int             # L
    perturbation_factor: float
    probability_negate_constant: float
    n_params: int = 0
    dtype: torch.dtype = torch.float32   # constants and the draws they come from


_SCRATCH_NU = 4 * MAX_ARITY


def branch_nu(ctx: MutationContext) -> Dict[str, int]:
    """Uniform budget of each mutation branch."""
    L = ctx.max_nodes
    D = len(ctx.nops)
    S = _SCRATCH_NU
    return {
        "mutate_constant": L + 3,
        "mutate_operator": L + D,
        "mutate_feature": L + 1,
        "swap_operands": L,
        "rotate_tree": L + MAX_ARITY + 1,
        "add_node": 1 + (L + 2 * D + S) + (2 * D + 1 + S),
        "insert_node": L + 2 * D + 1 + S,
        "delete_node": L + 1,
        "randomize": 1 + 8 * L,
    }


def gen_tree_nu(ctx: MutationContext) -> int:
    return 8 * ctx.max_nodes


def _at_least_1(v):
    return torch.clamp(v, min=1) if isinstance(v, torch.Tensor) else max(v, 1)


def _per_row(v):
    """A per-row tensor [N] as a column [N, 1]; an int as it is."""
    return v[:, None] if isinstance(v, torch.Tensor) else v


def _slot_mask(tree: TreeBatch) -> torch.Tensor:
    return torch.arange(tree.max_nodes, device=tree.device) < tree.length[:, None]


def _structure(tree: TreeBatch, structure=None):
    if structure is not None:
        return structure
    return structure_from_arity(tree.arity, need_depth=False)


def _lane_get(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``x[n, k[n]]`` for [N, L] ``x`` and [N] ``k`` (0 out of range)."""
    return lane_take(x, k[:, None])[:, 0]


def _row_get(mat: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``mat[n, k[n], :]`` for [N, L, A] ``mat`` (0 out of range)."""
    return lane_take(mat.transpose(1, 2), k[:, None, None].expand(-1, mat.shape[2], 1))[..., 0]


def _span(size, k):
    sz = _lane_get(size, k)
    return k - sz + 1, sz


def _set_at(x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    out = x.clone()
    out[torch.arange(x.shape[0], device=x.device), idx.long()] = val.to(x.dtype)
    return out


# ---------------------------------------------------------------------------
# Value mutations
# ---------------------------------------------------------------------------


def _mutate_factor(u3, temperature, ctx: MutationContext):
    """Constant perturbation factor; negates with probability
    ``probability_negate_constant`` (the documented semantics)."""
    bottom = 0.1
    max_change = ctx.perturbation_factor * temperature + 1.0 + bottom
    factor = torch.pow(max_change, u3[:, 0])
    factor = torch.where(u_bernoulli(u3[:, 1]), factor, 1.0 / factor)
    negate = u_bernoulli(u3[:, 2], ctx.probability_negate_constant)
    return torch.where(negate, -factor, factor)


def mutate_constant(u, tree: TreeBatch, temperature, ctx: MutationContext):
    s = USlice(u)
    mask = _slot_mask(tree) & (tree.arity == 0) & (tree.op == LEAF_CONST)
    idx, has_any = u_masked_choice(s.take(ctx.max_nodes), mask)
    factor = _mutate_factor(s.take(3), temperature, ctx)
    picked = torch.gather(tree.const, 1, idx[:, None].long())[:, 0]
    new_const = _set_at(tree.const, idx, picked * factor)
    const = torch.where(has_any[:, None], new_const, tree.const)
    return TreeBatch(tree.arity, tree.op, tree.feat, const, tree.length), _true(tree)


def mutate_parameter_row(u, params: torch.Tensor, temperature, ctx: MutationContext):
    """Scale one whole parameter row (all classes) of each member's bank
    by a mutate factor: the parametric branch of mutate_constant.
    ``params`` [N, NP, NC], ``u`` [N, 4]."""
    if params.shape[-2] == 0:
        return params
    s = USlice(u)
    row = u_randint(s.take1(), params.shape[-2])
    factor = _mutate_factor(s.take(3), temperature, ctx)
    hit = torch.arange(params.shape[-2], device=params.device) == row[:, None]
    return torch.where(hit[:, :, None], params * factor[:, None, None], params)


def _true(tree: TreeBatch) -> torch.Tensor:
    return torch.ones(tree.length.shape, dtype=torch.bool, device=tree.device)


def mutate_operator(u, tree: TreeBatch, ctx: MutationContext):
    s = USlice(u)
    mask = _slot_mask(tree) & (tree.arity > 0)
    idx, has_any = u_masked_choice(s.take(ctx.max_nodes), mask)
    u_ops = s.take(len(ctx.nops))
    a = _lane_get(tree.arity, idx)
    new_op = torch.zeros_like(a)
    for d, n in enumerate(ctx.nops, start=1):
        new_op = torch.where(a == d, u_randint(u_ops[:, d - 1], max(n, 1)), new_op)
    op = torch.where(has_any[:, None], _set_at(tree.op, idx, new_op), tree.op)
    return TreeBatch(tree.arity, op, tree.feat, tree.const, tree.length), _true(tree)


def mutate_feature(u, tree: TreeBatch, ctx: MutationContext):
    s = USlice(u)
    mask = _slot_mask(tree) & (tree.arity == 0) & (tree.op == LEAF_VAR)
    idx, has_any = u_masked_choice(s.take(ctx.max_nodes), mask)
    u_delta = s.take1()
    nf = ctx.nfeatures
    if isinstance(nf, int) and nf <= 1:
        return tree, _true(tree)
    delta = u_randint(u_delta, _at_least_1(nf - 1)) + 1
    new_feat = torch.remainder(_lane_get(tree.feat, idx) + delta, _at_least_1(nf))
    # An int nf is > 1 here; a per-row one leaves rows with one argument as they are.
    changed = has_any & (nf > 1) if isinstance(nf, torch.Tensor) else has_any
    feat = torch.where(changed[:, None], _set_at(tree.feat, idx, new_feat), tree.feat)
    return TreeBatch(tree.arity, tree.op, feat, tree.const, tree.length), _true(tree)


# ---------------------------------------------------------------------------
# Structural mutations
# ---------------------------------------------------------------------------


def _stack(xs):
    return torch.stack([x.long() if isinstance(x, torch.Tensor) else x for x in xs], dim=-1)


def swap_operands(u, tree: TreeBatch, ctx: MutationContext, structure=None):
    """Swap the two child spans of a random binary node."""
    L = ctx.max_nodes
    child, size, _ = _structure(tree, structure)
    mask = _slot_mask(tree) & (tree.arity == 2)
    k_node, has_any = u_masked_choice(u, mask)
    crow = _row_get(child, k_node)
    s1, l1 = _span(size, crow[:, 0])
    s2, l2 = _span(size, crow[:, 1])
    zero = torch.zeros_like(k_node)
    starts = _stack([zero, s2, s1, k_node, k_node + 1])
    lens = _stack([s1, l2, l1, zero + 1, tree.length - (k_node + 1)])
    new_tree, ok = concat_pieces((tree.arity, tree.op, tree.feat, tree.const), starts, lens, L)
    return select_tree(has_any, new_tree, tree), ok | ~has_any


def delete_node(u, tree: TreeBatch, ctx: MutationContext, structure=None):
    """Splice out a random operator node, keeping one child."""
    L = ctx.max_nodes
    s = USlice(u)
    child, size, _ = _structure(tree, structure)
    mask = _slot_mask(tree) & (tree.arity > 0)
    k_node, has_any = u_masked_choice(s.take(L), mask)
    carry_i = u_randint(s.take1(), torch.clamp(_lane_get(tree.arity, k_node), min=1))
    carry = _lane_get(_row_get(child, k_node), torch.clamp(carry_i, 0, MAX_ARITY - 1))
    node_start, _ = _span(size, k_node)
    carry_start, carry_len = _span(size, carry)
    sources = (tree.arity, tree.op, tree.feat, tree.const)
    new_tree, ok = splice_span(tree, node_start, k_node, sources, carry_start, carry_len, L)
    return select_tree(has_any, new_tree, tree), ok | ~has_any


def _sample_leaf(u4, ctx: MutationContext):
    """(op_code, feat, const) of one random leaf per row from 4 uniforms:
    50/50 constant ~ randn / variable ~ uniform feature; with parameters,
    uniform thirds constant / variable / parameter ~ uniform index."""
    val = u_normal(u4[:, 1])
    nf = ctx.nfeatures
    f = u_randint(u4[:, 2], _at_least_1(nf))
    if ctx.n_params > 0:
        choice = u_randint(u4[:, 0], 3)
        p = u_randint(u4[:, 3], ctx.n_params)
        is_const = (choice == 0) | (nf <= 0)
        code = torch.where(is_const, LEAF_CONST, torch.where(choice == 1, LEAF_VAR, LEAF_PARAM))
        feat = torch.where(is_const, 0, torch.where(choice == 1, f, p))
    else:
        is_const = u_bernoulli(u4[:, 0]) | (nf <= 0)
        code = torch.where(is_const, LEAF_CONST, LEAF_VAR)
        feat = torch.where(is_const, 0, f)
    return code.to(torch.int32), feat.to(torch.int32), torch.where(is_const, val, 0.0)


def _make_leaf_scratch(u, ctx: MutationContext):
    """Scratch fields [N, MAX_ARITY + 1]: random leaves in the first
    MAX_ARITY slots, the last slot reserved for a new operator node."""
    N = u.shape[0]
    S = MAX_ARITY + 1
    dev = u.device
    arity = torch.zeros((N, S), dtype=torch.int32, device=dev)
    op = torch.zeros((N, S), dtype=torch.int32, device=dev)
    feat = torch.zeros((N, S), dtype=torch.int32, device=dev)
    const = torch.zeros((N, S), dtype=ctx.dtype, device=dev)
    for j in range(MAX_ARITY):
        code, fj, cj = _sample_leaf(u[:, 4 * j:4 * j + 4], ctx)
        op[:, j] = code
        feat[:, j] = fj
        const[:, j] = cj
    return [arity, op, feat, const]


def _sample_new_op(u, ctx: MutationContext):
    """(arity, op index, any_op) of a new operator, arity drawn in
    proportion to the per-arity operator counts, from ``2 * D`` uniforms."""
    D = len(ctx.nops)
    s = USlice(u)
    weights = torch.tensor(ctx.nops, dtype=torch.float32, device=u.device)
    a = u_categorical_weights(s.take(D), weights) + 1
    u_ops = s.take(D)
    o = torch.zeros_like(a)
    for d, n in enumerate(ctx.nops, start=1):
        o = torch.where(a == d, u_randint(u_ops[:, d - 1], max(n, 1)), o)
    return a.to(torch.int32), o, sum(ctx.nops) > 0


def _expand_leaf_pieces(tree, scratch, node_start, node_len, new_arity, carry_slot, ctx):
    """Replace span [node_start, node_start + node_len) with a new
    operator node whose children are scratch leaves, except child
    ``carry_slot``, which carries the original span (-1: no carry)."""
    L = ctx.max_nodes
    scratch_tree = TreeBatch(scratch[0], scratch[1], scratch[2], scratch[3],
                             torch.full_like(tree.length, MAX_ARITY + 1))
    sources = combine_sources(tree, scratch_tree)
    starts = [torch.zeros_like(node_start)]
    lens = [node_start]
    for j in range(MAX_ARITY):
        in_use = j < new_arity
        is_carry = carry_slot == j
        starts.append(torch.where(is_carry, node_start, L + j))
        lens.append(torch.where(in_use, torch.where(is_carry, node_len, 1), 0))
    starts.append(torch.full_like(node_start, L + MAX_ARITY))
    lens.append(torch.ones_like(node_start))
    starts.append(node_start + node_len)
    lens.append(tree.length - (node_start + node_len))
    return concat_pieces(sources, _stack(starts), _stack(lens), L)


def _write_op_slot(scratch, a, o):
    scratch[0][:, MAX_ARITY] = a
    scratch[1][:, MAX_ARITY] = o
    return scratch


def add_node(u, tree: TreeBatch, ctx: MutationContext, structure=None):
    """Append or prepend a random operator, 50/50."""
    L, D = ctx.max_nodes, len(ctx.nops)
    s = USlice(u)
    do_append = u_bernoulli(s.take1())
    appended, ok_a = append_random_op(s.take(L + 2 * D + _SCRATCH_NU), tree, ctx, structure)
    prepended, ok_p = prepend_random_op(s.take(2 * D + 1 + _SCRATCH_NU), tree, ctx)
    out = select_tree(do_append, appended, prepended)
    return out, torch.where(do_append, ok_a, ok_p)


def append_random_op(u, tree: TreeBatch, ctx: MutationContext, structure=None):
    """Replace a random leaf with op(random leaves)."""
    L, D = ctx.max_nodes, len(ctx.nops)
    s = USlice(u)
    mask = _slot_mask(tree) & (tree.arity == 0)
    k_leaf, has_any = u_masked_choice(s.take(L), mask)
    a, o, any_op = _sample_new_op(s.take(2 * D), ctx)
    scratch = _write_op_slot(_make_leaf_scratch(s.take(_SCRATCH_NU), ctx), a, o)
    new_tree, ok = _expand_leaf_pieces(tree, scratch, k_leaf, torch.ones_like(k_leaf), a,
                                       torch.full_like(k_leaf, -1), ctx)
    valid = has_any & any_op
    return select_tree(valid, new_tree, tree), ok | ~valid


def insert_random_op(u, tree: TreeBatch, ctx: MutationContext, structure=None):
    """Wrap a random node inside a new operator."""
    L, D = ctx.max_nodes, len(ctx.nops)
    s = USlice(u)
    _, size, _ = _structure(tree, structure)
    k_node, has_any = u_masked_choice(s.take(L), _slot_mask(tree))
    a, o, any_op = _sample_new_op(s.take(2 * D), ctx)
    carry = u_randint(s.take1(), torch.clamp(a, min=1))
    scratch = _write_op_slot(_make_leaf_scratch(s.take(_SCRATCH_NU), ctx), a, o)
    node_start, node_len = _span(size, k_node)
    new_tree, ok = _expand_leaf_pieces(tree, scratch, node_start, node_len, a, carry, ctx)
    valid = has_any & any_op
    return select_tree(valid, new_tree, tree), ok | ~valid


def prepend_random_op(u, tree: TreeBatch, ctx: MutationContext):
    """New root with the old tree as a random child."""
    D = len(ctx.nops)
    s = USlice(u)
    a, o, any_op = _sample_new_op(s.take(2 * D), ctx)
    carry = u_randint(s.take1(), torch.clamp(a, min=1))
    scratch = _write_op_slot(_make_leaf_scratch(s.take(_SCRATCH_NU), ctx), a, o)
    zero = torch.zeros_like(tree.length)
    new_tree, ok = _expand_leaf_pieces(tree, scratch, zero, tree.length, a, carry, ctx)
    if not any_op:
        return tree, _true(tree)
    return new_tree, ok


def rotate_tree(u, tree: TreeBatch, ctx: MutationContext, structure=None):
    """Random tree rotation: root R (operator with an operator child),
    pivot P (operator child of R), grandchild G (child of P); the rotated
    subtree is P with G's slot replaced by R' = R with P's slot replaced
    by G. A permutation of spans, done as one 9-piece gather."""
    L = ctx.max_nodes
    s = USlice(u)
    child, size, _ = _structure(tree, structure)
    slot_ok = _slot_mask(tree)
    child_arity = lane_take(tree.arity[:, None, :], torch.clamp(child, 0, L - 1))  # [N, L, A]
    has_op_child = ((child_arity > 0)
                    & (torch.arange(MAX_ARITY, device=u.device) < tree.arity[:, :, None])).any(-1)
    root_mask = slot_ok & (tree.arity > 0) & has_op_child
    r, has_root = u_masked_choice(s.take(L), root_mask)

    arity_r = _lane_get(tree.arity, r)
    pivot_mask = ((torch.arange(MAX_ARITY, device=u.device) < arity_r[:, None])
                  & (_row_get(child_arity, r) > 0))
    pi, _ = u_masked_choice(s.take(MAX_ARITY), pivot_mask)
    row_r = _row_get(child, r)
    p = _lane_get(row_r, pi)
    arity_p = _lane_get(tree.arity, p)
    gi = u_randint(s.take1(), torch.clamp(arity_p, min=1))
    row_p = _row_get(child, p)
    g = _lane_get(row_p, torch.clamp(gi, 0, MAX_ARITY - 1))

    def span_of(x):
        sz = _lane_get(size, x)
        return x - sz + 1, sz

    zero = torch.zeros_like(r)
    g_start, g_len = span_of(g)
    rp_starts, rp_lens = [], []
    for i in range(MAX_ARITY):
        in_use = i < arity_r
        ci_start, ci_len = span_of(row_r[:, i])
        st = torch.where(pi == i, g_start, ci_start)
        ln = torch.where(pi == i, g_len, ci_len)
        rp_starts.append(torch.where(in_use, st, zero))
        rp_lens.append(torch.where(in_use, ln, zero))
    rp_starts.append(r)
    rp_lens.append(zero + 1)

    starts, lens = [], []
    span_start, span_len = span_of(r)
    starts.append(zero)
    lens.append(span_start)
    for j in range(MAX_ARITY):
        in_use = j < arity_p
        cj_start, cj_len = span_of(row_p[:, j])
        is_g = gi == j
        starts.append(torch.where(is_g, rp_starts[0], cj_start))
        lens.append(torch.where(in_use, torch.where(is_g, rp_lens[0], cj_len), zero))
        starts.append(torch.where(is_g, rp_starts[1], zero))
        lens.append(torch.where(in_use & is_g, rp_lens[1], zero))
        starts.append(torch.where(is_g, rp_starts[2], zero))
        lens.append(torch.where(in_use & is_g, rp_lens[2], zero))
    starts.append(p)
    lens.append(zero + 1)
    starts.append(span_start + span_len)
    lens.append(tree.length - (span_start + span_len))

    sources = (tree.arity, tree.op, tree.feat, tree.const)
    new_tree, ok = concat_pieces(sources, _stack(starts), _stack(lens), L)
    return select_tree(has_root, new_tree, tree), ok | ~has_root


def crossover_trees(u, tree1: TreeBatch, tree2: TreeBatch, ctx: MutationContext,
                    structure1=None, structure2=None):
    """Random subtree exchange. ``u``: [N, 2L]."""
    L = ctx.max_nodes
    s = USlice(u)
    _, size1, _ = _structure(tree1, structure1)
    _, size2, _ = _structure(tree2, structure2)
    n1, _ = u_masked_choice(s.take(L), _slot_mask(tree1))
    n2, _ = u_masked_choice(s.take(L), _slot_mask(tree2))
    s1, l1 = _span(size1, n1)
    s2, l2 = _span(size2, n2)
    child1, ok1 = splice_span(tree1, s1, n1, combine_sources(tree1, tree2), L + s2, l2, L)
    child2, ok2 = splice_span(tree2, s2, n2, combine_sources(tree2, tree1), L + s1, l1, L)
    return child1, child2, ok1, ok2


# ---------------------------------------------------------------------------
# Random tree generation
# ---------------------------------------------------------------------------


def _random_postfix_from_counts(u, n_binary, n_unary, ctx: MutationContext):
    """Uniform random postfix trees with the given operator-arity counts
    (``u``: [N, 7L]): shuffle the arity multiset with a masked argsort,
    rotate it into the unique valid postfix order (cycle lemma: start
    right after the last prefix-sum minimum), then fill operator indices
    and leaf payloads."""
    L = ctx.max_nodes
    N = u.shape[0]
    dev = u.device
    s = USlice(u)
    slot = torch.arange(L, dtype=torch.int32, device=dev)[None, :].expand(N, L)
    m = (2 * n_binary + n_unary + 1).to(torch.int32)
    live = slot < m[:, None]

    vals = torch.where(slot < n_binary[:, None], 2,
                       torch.where(slot < (n_binary + n_unary)[:, None], 1, 0)).to(torch.int32)
    prio = torch.where(live, s.take(L), 2.0)
    perm = torch.argsort(prio, dim=-1, stable=True)
    arity = torch.where(live, lane_take(vals, perm), 0)

    S = torch.cumsum(1 - arity, dim=-1).to(torch.int32)
    S_masked = torch.where(live, S, torch.iinfo(torch.int32).max)
    minS = S_masked.amin(dim=-1, keepdim=True)
    t = torch.where(S_masked == minS, slot, -1).amax(dim=-1)
    p = torch.where(t + 1 >= m, 0, t + 1)
    src = torch.where(live, torch.remainder(p[:, None] + slot, torch.clamp(m, min=1)[:, None]), slot)
    arity = torch.where(live, lane_take(arity, src), 0).to(torch.int32)

    nuna = ctx.nops[0] if len(ctx.nops) >= 1 else 0
    nbin = ctx.nops[1] if len(ctx.nops) >= 2 else 0
    op_u = u_randint(s.take(L), max(nuna, 1))
    op_b = u_randint(s.take(L), max(nbin, 1))

    nf = _per_row(ctx.nfeatures)
    u_choice = s.take(L)
    const_vals = u_normal(s.take(L))
    feat_vals = u_randint(s.take(L), _at_least_1(nf))
    u_param = s.take(L)
    if ctx.n_params > 0:
        choice = u_randint(u_choice, 3)
        p_vals = u_randint(u_param, ctx.n_params)
        is_const = (choice == 0) | (nf <= 0)
        leaf_code = torch.where(is_const, LEAF_CONST,
                                torch.where(choice == 1, LEAF_VAR, LEAF_PARAM)).to(torch.int32)
        leaf_feat = torch.where(is_const, 0, torch.where(choice == 1, feat_vals, p_vals))
    else:
        is_const = (u_choice < 0.5) | (nf <= 0)
        leaf_code = torch.where(is_const, LEAF_CONST, LEAF_VAR).to(torch.int32)
        leaf_feat = torch.where(is_const, 0, feat_vals)

    op = torch.where(arity == 2, op_b, torch.where(arity == 1, op_u, leaf_code)).to(torch.int32)
    feat = torch.where((arity == 0) & live, leaf_feat, 0).to(torch.int32)
    const = torch.where((arity == 0) & live & is_const, const_vals, 0.0)
    return TreeBatch(arity=arity, op=op, feat=feat, const=const, length=m)


def _sample_arity_counts(u_L, budget, ctx: MutationContext):
    """(n_binary, n_unary) from iid arity draws filling ``budget`` size
    increments (binary costs 2, unary 1). ``u_L``: [N, L]."""
    nuna = ctx.nops[0] if len(ctx.nops) >= 1 else 0
    nbin = ctx.nops[1] if len(ctx.nops) >= 2 else 0
    if nbin == 0 and nuna == 0:
        z = torch.zeros_like(budget, dtype=torch.int32)
        return z, z
    pb = nbin / max(nbin + nuna, 1)
    draw_bin = u_L < pb
    if nuna == 0:
        draw_bin = torch.ones_like(draw_bin)
    if nbin == 0:
        draw_bin = torch.zeros_like(draw_bin)
    cost = torch.where(draw_bin, 2, 1).to(torch.int32)
    csum = torch.cumsum(cost, dim=-1)
    take = csum <= budget[:, None]
    n_binary = (take & draw_bin).sum(-1).to(torch.int32)
    n_unary = (take & ~draw_bin).sum(-1).to(torch.int32)
    if nuna > 0:
        total = torch.where(take, csum, 0).amax(dim=-1)
        n_unary = n_unary + torch.where(budget - total >= 1, 1, 0).to(torch.int32)
    return n_binary, n_unary


def gen_random_tree_fixed_size_u(u, node_count, ctx: MutationContext):
    """Random trees of about ``node_count`` nodes. ``u``: [N, 8L]."""
    s = USlice(u)
    budget = torch.clamp(node_count, 1, ctx.max_nodes) - 1
    n_binary, n_unary = _sample_arity_counts(s.take(ctx.max_nodes), budget, ctx)
    return _random_postfix_from_counts(s.take(7 * ctx.max_nodes), n_binary, n_unary, ctx)


def _single_leaf(u4, ctx: MutationContext):
    code, f0, c0 = _sample_leaf(u4, ctx)
    N, L = u4.shape[0], ctx.max_nodes
    dev = u4.device
    z = lambda dt: torch.zeros((N, L), dtype=dt, device=dev)
    op, feat, const = z(torch.int32), z(torch.int32), z(ctx.dtype)
    op[:, 0], feat[:, 0], const[:, 0] = code, f0, c0
    return TreeBatch(z(torch.int32), op, feat, const,
                     torch.ones(N, dtype=torch.int32, device=dev))


def gen_random_tree(keys: torch.Tensor, nlength: int, ctx: MutationContext) -> TreeBatch:
    """One random tree per key (keys [N, 2]) from ``nlength`` weighted
    operator draws; sizes land in [nlength + 1, 2 nlength + 1]."""
    L = ctx.max_nodes
    u = rng.uniform(keys, (8 * L,), dtype=ctx.dtype)
    s = USlice(u)
    nuna = ctx.nops[0] if len(ctx.nops) >= 1 else 0
    nbin = ctx.nops[1] if len(ctx.nops) >= 2 else 0
    if nbin == 0 and nuna == 0:
        return _single_leaf(s.take(4), ctx)
    pb = nbin / max(nbin + nuna, 1)
    draw_bin = s.take(L) < pb
    if nuna == 0:
        draw_bin = torch.ones_like(draw_bin)
    if nbin == 0:
        draw_bin = torch.zeros_like(draw_bin)
    cost = torch.where(draw_bin, 2, 1).to(torch.int32)
    n_ops = min(int(nlength), L)
    slot = torch.arange(L, device=u.device)
    take = (slot < n_ops) & (torch.cumsum(cost, dim=-1) <= L - 1)
    n_binary = (take & draw_bin).sum(-1).to(torch.int32)
    n_unary = (take & ~draw_bin).sum(-1).to(torch.int32)
    return _random_postfix_from_counts(s.take(7 * L), n_binary, n_unary, ctx)


def randomize_tree(u, tree: TreeBatch, cur_maxsize, ctx: MutationContext):
    """Replace with a fresh random tree of size ~U(1, cur_maxsize).
    ``u``: [N, 1 + 8L]."""
    s = USlice(u)
    cm = torch.clamp(torch.as_tensor(cur_maxsize, device=u.device), min=1)
    target = u_randint(s.take1(), cm) + 1
    new_tree = gen_random_tree_fixed_size_u(s.take(gen_tree_nu(ctx)), target, ctx)
    return new_tree, _true(tree)
