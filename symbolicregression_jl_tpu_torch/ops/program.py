"""Leaf-free tree programs for the interpreter kernel (port of ``ops/program.py``).

A TreeBatch compiles into a program over one value buffer per row:

    buf[0 : F]               X feature values
    buf[F : F+CMAX]          the tree's constant-leaf values
    buf[BASE : BASE+L]       one slot per program step (BASE = F + CMAX)

Each step is an internal node in postfix order: a merged opcode
(0 = identity/copy, 1..B = binary, B+1..B+U = unary) plus one or two
buffer addresses for its operands. Leaves vanish from the instruction
stream: a variable child is an address < F, a constant child an address
in [F, BASE). Single-leaf trees compile to one identity step.

Validity: the kernel checks finiteness of every step's output per row;
non-finite constants are caught by ``const_ok`` computed here, so
``exp(c)`` with c = -inf is invalid although its output is finite.
"""

from __future__ import annotations

import dataclasses

import torch

from .encoding import LEAF_VAR, TreeBatch, lane_take, structure_from_arity

__all__ = ["TreeProgram", "compile_program", "program_cmax"]


def program_cmax(max_nodes: int) -> int:
    """Max constant leaves a tree of `max_nodes` slots can hold."""
    return (max_nodes + 1) // 2


@dataclasses.dataclass
class TreeProgram:
    """Leaf-free postfix program for a flat [T] batch of trees.

    ``code``/``src1``/``src2`` are [T, L] (identity steps past
    ``nsteps``); ``cvals``/``cslot`` are [T, CMAX] with ``cslot == L``
    marking unused constant slots; ``nsteps >= 1``."""

    code: torch.Tensor      # int32 [T, L]
    src1: torch.Tensor      # int32 [T, L]
    src2: torch.Tensor      # int32 [T, L]
    nsteps: torch.Tensor    # int32 [T]
    cvals: torch.Tensor     # float32 [T, CMAX]
    cslot: torch.Tensor     # int32 [T, CMAX]
    nconst: torch.Tensor    # int32 [T]
    const_ok: torch.Tensor  # bool [T]

    @property
    def max_steps(self) -> int:
        return self.code.shape[-1]

    @property
    def cmax(self) -> int:
        return self.cvals.shape[-1]


def compile_program(trees: TreeBatch, nfeatures: int, n_binary: int) -> TreeProgram:
    """Lower a flat [T, L] TreeBatch to a TreeProgram (plain expressions:
    LEAF_PARAM leaves alias constant leaves, as in the JAX package with
    ``n_params == 0``)."""
    arity, op, feat, const, length = trees.fields()
    T, L = arity.shape
    dev = arity.device
    cmax = program_cmax(L)
    CBASE = nfeatures
    BASE = CBASE + cmax
    slot = torch.arange(L, dtype=torch.int32, device=dev)

    live = slot[None, :] < length[:, None]
    internal = live & (arity > 0)
    ci = torch.cumsum(internal.int(), dim=-1) - internal.int()
    is_cleaf = live & (arity == 0) & (op != LEAF_VAR)
    cj = torch.cumsum(is_cleaf.int(), dim=-1) - is_cleaf.int()

    leaf_addr = torch.where(op == LEAF_VAR, torch.clamp(feat, 0, nfeatures - 1),
                            CBASE + torch.clamp(cj, 0, cmax - 1))
    addr = torch.where(internal, BASE + ci, leaf_addr).to(torch.int32)

    child, _, _ = structure_from_arity(arity, need_depth=False)
    zero = torch.zeros_like(op)
    code_slot = torch.where(arity == 2, 1 + op,
                            torch.where(arity == 1, 1 + n_binary + op, zero)).to(torch.int32)
    src1_slot = lane_take(addr, child[..., 0])
    src2_slot = torch.where(arity == 2, lane_take(addr, child[..., 1]), src1_slot)

    # Internal slots first, in postfix order (keys are unique).
    order = torch.argsort(torch.where(internal, slot[None, :], L + slot[None, :]),
                          dim=-1, stable=True)
    code = lane_take(code_slot, order)
    src1 = lane_take(src1_slot, order)
    src2 = lane_take(src2_slot, order)

    m = internal.sum(dim=-1)
    root_slot = torch.clamp(length - 1, 0, L - 1)
    root_addr = lane_take(addr, root_slot[:, None].long())[:, 0]
    leaf_only = m == 0
    code[:, 0] = torch.where(leaf_only, 0, code[:, 0])
    src1[:, 0] = torch.where(leaf_only, root_addr, src1[:, 0])
    src2[:, 0] = torch.where(leaf_only, root_addr, src2[:, 0])
    nsteps = torch.clamp(m, min=1).to(torch.int32)

    # Constant-leaf table: const-leaf slots first, in slot order.
    nconst = is_cleaf.sum(dim=-1).to(torch.int32)
    order_c = torch.argsort(torch.where(is_cleaf, slot[None, :], L + slot[None, :]),
                            dim=-1, stable=True)
    used = torch.arange(cmax, dtype=torch.int32, device=dev)[None, :] < nconst[:, None]
    cslot = torch.where(used, order_c[:, :cmax].to(torch.int32),
                        torch.full_like(order_c[:, :cmax], L, dtype=torch.int32))
    cvals = torch.where(used, lane_take(const, torch.clamp(cslot, 0, L - 1)), 0.0)
    const_ok = torch.all(torch.isfinite(const) | ~is_cleaf, dim=-1)

    return TreeProgram(code=code.to(torch.int32), src1=src1.to(torch.int32),
                       src2=src2.to(torch.int32), nsteps=nsteps,
                       cvals=cvals.to(const.dtype), cslot=cslot, nconst=nconst,
                       const_ok=const_ok)
