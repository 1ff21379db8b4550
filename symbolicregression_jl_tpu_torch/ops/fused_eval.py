"""Fused program evaluation: the interpreter kernels and their wrappers.

Port of the program-kernel part of ``symbolicregression_jl_tpu/ops/fused_eval.py``.
A TreeBatch compiles to a leaf-free program (ops/program.py);
:func:`_pack_instr` packs each step into one int32 word
``sign << 30 | code << 24 | src1 << 12 | src2`` with the same dispatch
layout as the JAX package (``_dispatch_plan``). Five CUDA kernels run the
programs over every row:

- ``csrc/program_eval.cu`` (:data:`PROGRAM_EVAL`, ``_program_launch``):
  per-tree loss and validity, optionally with the loss -> cost epilogue;
  its parametric form (:data:`PROGRAM_EVAL_PARAM`) reads each tree's
  parameter bank by the row's class; its bf16 forms
  (:data:`PROGRAM_EVAL_BF16`, :data:`PROGRAM_EVAL_PARAM_BF16`, kernel 1b)
  keep the value buffer in bfloat16;
- ``csrc/program_multi.cu`` (:data:`PROGRAM_MULTI`, ``fused_loss_multi``):
  loss and validity for every (tree, constant vector) pair; its bf16 form
  :data:`PROGRAM_MULTI_BF16` (kernel 2b) is the bf16 line search;
- ``csrc/program_grad.cu`` (:data:`PROGRAM_GRAD`, ``fused_grad_multi``):
  the same plus d(loss)/d(constants), by a forward and an adjoint sweep;
- ``csrc/program_predict.cu`` (:data:`PROGRAM_PREDICT`,
  ``fused_predict_program``): raw row predictions and validity per tree,
  for template expressions' subexpression call sites;
- ``csrc/program_predict_vjp.cu`` (:data:`PROGRAM_PREDICT_VJP`,
  ``fused_predict_vjp_program``): its backward, seeded with row cotangents
  (the ``torch.autograd.Function`` :func:`fused_predict_ad`).

Each wrapper, given tensors on the CPU, runs its plain PyTorch version
(``program_*_plain``: the CPU path and the kernel's test oracle);
given CUDA tensors it launches the kernel or raises, never falling back.

A bf16 value buffer (graftstage, ``docs/PRECISION.md``) is storage only:
X, the constants and the parameter values round to bfloat16 (round to
nearest even) where the buffer takes them, every step reads bf16
operands, computes in float32, checks finiteness on the float32 value
and stores the value rounded to bf16; the root (the prediction) is the
stored value. y, w, the loss, the row sums and the cost epilogue stay in
the data's dtype: float32, or float64 (the ``_bf16_f64`` forms of 1b and
2b: float32 steps, a float64 loss spine, as the JAX kernel casts the
prediction to y's dtype). Losses rank reliably but are not bit-exact
against float32. ``bf16="data"`` (``eval_dtype="bfloat16"``, bf16 data)
runs the ``_bf16_data`` forms, which round each loss term, each sum and
the cost epilogue's results to bf16 as well (a bf16 loss spine).

float64 (``eval_dtype="float64"``, the JAX package under x64): kernels #1,
#1p, #2, #3, #4 and #5 have ``double`` forms (:data:`PROGRAM_EVAL_F64`,
:data:`PROGRAM_EVAL_PARAM_F64`, :data:`PROGRAM_MULTI_F64`,
:data:`PROGRAM_GRAD_F64`, :data:`PROGRAM_PREDICT_F64`,
:data:`PROGRAM_PREDICT_VJP_F64`) that store and compute every value in
double; the entry points pick each kernel's form from X's dtype and
``bf16`` (``_pick``). Every library loss (core/losses.py ``KernelLoss``)
runs in the kernels, named by its kind and parameter. A user elementwise
callable takes the user-loss route (:func:`user_loss_program`,
:func:`user_loss_multi`, :func:`user_grad_multi`), which the entry points
below pick for it: kernel #4's predictions in chunks of trees (its
``double``, bf16 or per-member form for float64, bf16 or parametric
searches), the callable applied in PyTorch, and for its gradient kernel
#5 under ``torch.autograd``. A user operator (ops/user_ops.py) runs in
every kernel as generated device functions, in the libraries built for
its operator set; the plain versions call its function and differentiate
it with ``torch.autograd``.
The TPU kernels' V-chunking and tree blocks worked around VMEM and are not
carried over: each call is one launch.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import weakref
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.losses import baseline_normalization, kernel_loss
from ..parallel.collectives import active_row_shard, shard_all, shard_reduce
from .encoding import LEAF_PARAM, TreeBatch
from .operators import OPERATOR_REGISTRY, OperatorSet
from .program import TreeProgram, compile_program, scatter_const_grads
from .vjp import loss_vjp, vjp_binary, vjp_unary

__all__ = ["PROGRAM_EVAL", "PROGRAM_EVAL_PARAM", "PROGRAM_EVAL_BF16", "PROGRAM_EVAL_PARAM_BF16",
           "PROGRAM_EVAL_F64", "PROGRAM_EVAL_PARAM_F64", "PROGRAM_MULTI_F64", "PROGRAM_GRAD_F64",
           "PROGRAM_MULTI", "PROGRAM_MULTI_BF16", "PROGRAM_GRAD", "PROGRAM_PREDICT",
           "PROGRAM_PREDICT_VJP", "strided_sample_indices", "fused_loss", "fused_loss_program",
           "fused_loss_dedup",
           "fused_cost", "fused_cost_program", "fused_loss_multi", "fused_grad_multi",
           "fused_grad_program", "fused_loss_and_const_grad", "fused_predict_program",
           "fused_predict_vjp_program", "fused_predict", "fused_predict_ad",
           "program_eval_plain", "program_multi_plain", "program_grad_plain",
           "program_predict_plain", "program_predict_vjp_plain", "supports_fused_eval",
           "user_loss_program", "user_loss_multi", "user_grad_multi", "USER_LOSS_CHUNK_BYTES"]


def supports_fused_eval(operators: OperatorSet) -> bool:
    """The kernel handles arity <= 2 operator sets."""
    return all(d in (1, 2) for d in operators.ops.keys())


def strided_sample_indices(n_rows: int, sample_rows: int) -> np.ndarray:
    """[sample_rows] int32 row indices of graftstage's screening sample:
    an even stride over the dataset, ``(k * n) // sample_rows``.
    Deterministic in (n_rows, sample_rows), no RNG, so a resumed or
    replayed search screens the same rows."""
    k = int(min(sample_rows, n_rows))
    if k <= 0:
        raise ValueError("sample_rows must be positive")
    return ((np.arange(k, dtype=np.int64) * int(n_rows)) // k).astype(np.int32)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Values rounded to bfloat16 (round to nearest even) and back to their
    dtype (float32 for bfloat16 values)."""
    dt = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    return x.to(torch.bfloat16).to(dt)


# ---------------------------------------------------------------------------
# Dispatch layout and instruction packing (host side, same words as JAX)
# ---------------------------------------------------------------------------


class _DispatchPlan(NamedTuple):
    """Branch layout of the opcode switch.

    ``merged``: '+' is present, so identity steps become ``a + ZERO``
    against a zero buffer row and, when '-' is present too, ``a - b``
    rides the '+' branch through a sign bit (``a + sgn*b``). Without '+'
    the legacy layout (identity, binaries, unaries) stays.

    Packed word, merged: sign << 30 | code << 24 | src1 << 12 | src2."""

    merged: bool
    has_sub: bool
    n_branches: int
    nb_class: int
    other_bin: Tuple[int, ...]
    old2new: Tuple[int, ...]
    sign_old: Tuple[int, ...]


@functools.lru_cache(maxsize=None)
def _dispatch_plan(operators: OperatorSet) -> _DispatchPlan:
    names = [op.name for op in operators.binary]
    B, U = len(operators.binary), len(operators.unary)
    n_old = 1 + B + U
    if "+" not in names:
        return _DispatchPlan(False, False, n_old, 1 + B,
                             tuple(range(B)), tuple(range(n_old)),
                             (0,) * n_old)
    add_i = names.index("+")
    sub_i = names.index("-") if "-" in names else None
    old2new = [0] * n_old
    sign_old = [0] * n_old
    other = []
    nxt = 1
    for j in range(B):
        if j == add_i:
            old2new[1 + j] = 0
        elif sub_i is not None and j == sub_i:
            old2new[1 + j] = 0
            sign_old[1 + j] = 1
        else:
            old2new[1 + j] = nxt
            other.append(j)
            nxt += 1
    nb_class = nxt
    for u in range(U):
        old2new[1 + B + u] = nb_class + u
    return _DispatchPlan(True, sub_i is not None, nb_class + U, nb_class,
                         tuple(other), tuple(old2new), tuple(sign_old))


def _zero_rows(operators: OperatorSet) -> int:
    """Extra buffer rows for the dispatch plan (1 zero row when merged)."""
    return 1 if _dispatch_plan(operators).merged else 0


def _check_packable(operators: OperatorSet, base: int, max_steps: int) -> None:
    """Fail loudly when a configuration overflows the packed fields:
    12-bit operand addresses (the zero row at ``base + max_steps``
    included), 6-bit opcodes when merged, 7-bit otherwise."""
    plan = _dispatch_plan(operators)
    if base + max_steps + _zero_rows(operators) > 4096:
        raise ValueError(
            f"Buffer address space {base + max_steps + _zero_rows(operators)} "
            f"exceeds the packed 12-bit operand field "
            f"(nfeatures + cmax + max_nodes <= 4096)."
        )
    if plan.merged and plan.n_branches > 63:
        raise ValueError(
            f"{plan.n_branches} merged opcodes exceed the packed 6-bit field.")
    if not plan.merged and plan.n_branches > 127:
        raise ValueError(
            f"{plan.n_branches} opcodes exceed the packed 7-bit field.")


def _pack_instr(prog: TreeProgram, operators: OperatorSet, zero_addr: int) -> torch.Tensor:
    """[T, L] int32 instruction words for the plan's dispatch layout."""
    plan = _dispatch_plan(operators)
    if not plan.merged:
        return (prog.code << 24) | (prog.src1 << 12) | prog.src2
    dev = prog.code.device
    code = prog.code.long()
    new_code = torch.tensor(plan.old2new, dtype=torch.int32, device=dev)[code]
    sign = torch.tensor(plan.sign_old, dtype=torch.int32, device=dev)[code]
    src2 = torch.where(prog.code == 0, zero_addr, prog.src2)
    return ((sign << 30) | (new_code << 24) | (prog.src1 << 12) | src2).to(torch.int32)


# ---------------------------------------------------------------------------
# Plain PyTorch version of the kernel
# ---------------------------------------------------------------------------


def _branches(operators: OperatorSet):
    """(code -> callable(a, b, sign)) in the plan's dispatch order."""
    plan = _dispatch_plan(operators)
    out = []
    if plan.merged:
        out.append(lambda a, b, s: a + (1 - 2 * s).to(a.dtype)[:, None] * b)
        for j in plan.other_bin:
            out.append(lambda a, b, s, f=operators.binary[j].fn: f(a, b))
    else:
        out.append(lambda a, b, s: a)
        for op in operators.binary:
            out.append(lambda a, b, s, f=op.fn: f(a, b))
    for op in operators.unary:
        out.append(lambda a, b, s, f=op.fn: f(a))
    return out


def _plain_forward(instr, nsteps, cvals, X, operators: OperatorSet, prows=None,
                   bf16=False):
    """Forward sweep of packed programs on a [T, F + NP + CMAX + L + 1, n]
    value buffer (X rows, parameter rows, constants, one row per step, the
    zero row), as the kernels run it. ``X`` is [F, n] (shared) or [T, F,
    n] (one argument block per tree); ``prows`` [T, NP, n] are the rows'
    parameter values (parametric expressions), else NP = 0. ``bf16`` keeps
    bf16 values in the (float32) buffer: X, the parameters and the
    constants round as they enter it, each step computes on them in
    float32, is checked finite before rounding and is stored rounded.
    Returns (buf, vmask [T, n]: every live step finite on the row, the
    decoded (code, src1, src2, sign) of each step)."""
    plan = _dispatch_plan(operators)
    T, L = instr.shape
    F, n = X.shape[-2:]
    R = F + (0 if prows is None else prows.shape[1])
    BASE = R + cvals.shape[1]
    dev = X.device
    store = (lambda v: _round_bf16(v).to(torch.float32)) if bf16 else (lambda v: v)
    if bf16:
        X = X.to(torch.float32) if X.dtype == torch.bfloat16 else store(X)
    branches = _branches(operators)
    code_mask = 0x3F if plan.merged else 0x7F
    m = nsteps.long()
    rows = torch.arange(T, device=dev)
    buf = torch.zeros((T, BASE + L + 1, n), dtype=X.dtype, device=dev)
    buf[:, :F] = store(X)
    if prows is not None:
        buf[:, F:R] = store(prows)
    buf[:, R:BASE] = store(cvals)[:, :, None]
    vmask = torch.ones((T, n), dtype=torch.bool, device=dev)
    words = []
    for k in range(int(m.max()) if T else 0):
        word = instr[:, k]
        code = (word >> 24) & code_mask
        i1 = ((word >> 12) & 0xFFF).long()
        i2 = (word & 0xFFF).long()
        sign = (word >> 30) & 1
        words.append((code, i1, i2, sign))
        a = buf[rows, i1]
        b = buf[rows, i2]
        val = None
        for c in torch.unique(code).tolist():
            v = branches[c](a, b, sign)
            val = v if val is None else torch.where((code == c)[:, None], v, val)
        buf[:, BASE + k] = store(val)
        vmask &= torch.isfinite(val) | ~(k < m)[:, None]
    return buf, vmask, words


def _weighted_rows(w) -> int:
    """The rows up to the last one of positive weight. A row of weight 0
    adds exactly +0.0 to every sum of the kernels (csrc/interp.cuh
    ``loss_term``; its loss cotangent is 0 too), and the kernels' lanes
    take the rows in order, so trailing rows of weight 0 change no bit of
    a kernel's sums. The plain versions leave them out of their row sums
    to the same end: a request padded with zero-weight rows to its bucket
    (pack/padding.py) sums the same terms in the same layout as the
    unpadded request. Their validity still reads every row."""
    pos = torch.nonzero(w > 0)
    return int(pos[-1]) + 1 if pos.numel() else 0


# id(w) -> (weak reference to w, w's version counter, _weighted_rows(w)):
# kernel #3's wrapper needs the count on the host at every launch, and a
# search passes the same weights every time, so it is read back once.
_WEIGHTED_ROWS: dict = {}
_WEIGHTED_LOCK = threading.Lock()


def weighted_rows(w) -> int:
    """``_weighted_rows(w)``, cached while ``w`` lives unmodified (one host
    read of a CUDA tensor per weights tensor)."""
    with _WEIGHTED_LOCK:
        hit = _WEIGHTED_ROWS.get(id(w))
        if hit is not None and hit[0]() is w and hit[1] == w._version:
            return hit[2]
        rows = _weighted_rows(w)
        for k in [k for k, v in _WEIGHTED_ROWS.items() if v[0]() is None]:
            del _WEIGHTED_ROWS[k]
        _WEIGHTED_ROWS[id(w)] = (weakref.ref(w), w._version, rows)
        return rows


def _root(buf, nsteps, base: int):
    """Each tree's last step row [T, n]."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    return buf[rows, base + nsteps.long() - 1]


def _param_rows(bank, class_idx):
    """Each row's parameter values [T, NP, n]: ``bank[t, p, class_idx[r]]``
    (class indices clipped to [0, NC), as the kernel reads them)."""
    cls = torch.clamp(class_idx.long(), 0, bank.shape[-1] - 1)
    return bank[:, :, cls]


def program_eval_plain(instr, nsteps, cvals, const_ok, X, y, w, operators: OperatorSet,
                       loss_fn: Callable, cx=None, scal=None, bank=None, class_idx=None,
                       max_elems: int = 1 << 26, bf16=False):
    """Eager version of the kernel: an explicit loop over program steps on
    [trees, rows] tensors with the kernel's masking and reduction.

    Returns (loss_sum, valid) for the plain form, or (loss, valid, cost)
    with the cost epilogue when ``cx`` [T] and ``scal`` [3] are given.
    The parametric form takes ``bank`` [T, NP, NC] and ``class_idx`` [n]:
    parameter p of row r is ``bank[t, p, class_idx[r]]`` (a gather).
    ``bf16`` is kernel 1b's bf16 value buffer (``X`` float32, float64 or
    bfloat16; with float64 data the prediction enters a float64 loss), and
    ``bf16="data"`` its bf16-data form: each row's loss term, the sum and
    the cost epilogue's results rounded to bf16 (interp.cuh ``round_to``).
    Trees run in chunks of at most ``max_elems`` buffer elements."""
    T, L = instr.shape
    F, n = X.shape
    NP = 0 if bank is None else bank.shape[1]
    BASE = F + NP + cvals.shape[1]
    n_sum = _weighted_rows(w)
    # chunks and row blocks by the summed rows, so a padded request's sums
    # run over the same shapes as the unpadded one's (CUDA's reductions
    # split by shape); n // 2 bounds the memory of a sparse tail
    chunk = max(1, max_elems // max((BASE + L + 1) * max(n_sum, n // 2), 1))
    spine = _round_bf16 if bf16 == "data" else (lambda v: v)
    loss_parts, valid_parts = [], []
    for s in range(0, T, chunk):
        e = s + chunk
        prows = None if bank is None else _param_rows(bank[s:e], class_idx)
        buf, vmask, _ = _plain_forward(instr[s:e], nsteps[s:e], cvals[s:e], X, operators,
                                       prows, bf16=bf16)
        elt = loss_fn(_root(buf, nsteps[s:e], BASE).to(y.dtype), y)
        elt = torch.where(w > 0, elt, 0.0)
        total = torch.sum(spine((elt * w)[..., :n_sum]).contiguous(), dim=-1)
        valid = vmask.all(dim=-1) & torch.isfinite(total) & (const_ok[s:e] != 0)
        loss_parts.append(total)
        valid_parts.append(valid)
    dev = X.device
    total = torch.cat(loss_parts) if loss_parts else torch.zeros(0, dtype=y.dtype, device=dev)
    total = spine(total)
    valid = torch.cat(valid_parts) if valid_parts else torch.zeros(0, dtype=torch.bool, device=dev)
    if cx is None:
        return total, valid
    mean = spine(total / scal[0])
    loss = torch.where(valid & torch.isfinite(mean), mean, torch.inf)
    cost = spine(spine(loss / scal[1]) + spine(scal[2] * cx))
    return loss, valid, cost


def program_multi_plain(instr, nsteps, cvals_v, X, y, w, operators: OperatorSet,
                        loss_fn: Callable, bf16=False):
    """Eager version of kernel #2: the plain form of :func:`program_eval_plain`
    for every (tree, variant) pair of ``cvals_v`` [T, V, CMAX]. Returns
    (loss_sum [T, V], valid [T, V]); constant validity is the caller's.
    ``bf16`` is kernel 2b's bf16 value buffer (``"data"``: its bf16-data
    form)."""
    T, V, CMAX = cvals_v.shape
    ok = torch.ones(T * V, dtype=torch.int32, device=X.device)
    loss, valid = program_eval_plain(
        instr.repeat_interleave(V, dim=0), nsteps.repeat_interleave(V, dim=0),
        cvals_v.reshape(T * V, CMAX), ok, X, y, w, operators, loss_fn, bf16=bf16)
    return loss.reshape(T, V), valid.reshape(T, V)


def _bwd_branches(operators: OperatorSet):
    """(code -> callable(a, b, sign, ct) -> (d1, d2 or None)) in the plan's
    dispatch order, mirroring the JAX package's ``_bwd_dispatch``."""
    plan = _dispatch_plan(operators)
    out = []
    if plan.merged:
        out.append(lambda a, b, s, ct: (ct, (1 - 2 * s).to(ct.dtype)[:, None] * ct))
        for j in plan.other_bin:
            out.append(lambda a, b, s, ct, f=vjp_binary(operators.binary[j]): f(a, b, ct))
    else:
        out.append(lambda a, b, s, ct: (ct, None))
        for op in operators.binary:
            out.append(lambda a, b, s, ct, f=vjp_binary(op): f(a, b, ct))
    for op in operators.unary:
        out.append(lambda a, b, s, ct, f=vjp_unary(op): (f(a, ct), None))
    return out


def _plain_backward(buf, words, nsteps, seed, base: int, operators: OperatorSet,
                    acc_below: int = 0):
    """Reverse sweep of :func:`_plain_forward`'s buffer: the adjoint of
    every buffer row [T, nbuf, n] from the root's cotangent ``seed``
    [T, n], with the derivative table of ops/vjp.py. Operand adjoints at
    addresses below ``acc_below`` accumulate (operand 1, then operand 2);
    the others are stored, every node having one parent."""
    bwd = _bwd_branches(operators)
    T = buf.shape[0]
    rows = torch.arange(T, device=buf.device)
    m = nsteps.long()
    adj = torch.zeros_like(buf)
    adj[rows, base + m - 1] = seed

    def store(idx, val, sel):
        if acc_below:
            val = torch.where((idx < acc_below)[:, None], adj[rows, idx] + val, val)
        adj[rows[sel], idx[sel]] = val[sel]

    for k in reversed(range(len(words))):
        code, i1, i2, sign = words[k]
        active = k < m
        ct = adj[rows, base + k]
        a, b = buf[rows, i1], buf[rows, i2]
        d1 = torch.zeros_like(ct)
        d2 = torch.zeros_like(ct)
        two = torch.zeros_like(active)
        for c in torch.unique(code[active]).tolist():
            sel = (code == c) & active
            o1, o2 = bwd[c](a, b, sign, ct)
            d1 = torch.where(sel[:, None], o1, d1)
            if o2 is not None:
                d2 = torch.where(sel[:, None], o2, d2)
                two |= sel
        store(i1, d1, active)
        store(i2, d2, two)
    return adj


def _const_sums(adj, nconst, F: int, CMAX: int, n_sum: int):
    """Row sums over the first ``n_sum`` rows of the constants' adjoints
    [T, CMAX] (0 past nconst) and of their absolute values."""
    cadj = adj[:, F:F + CMAX, :n_sum]
    used = torch.arange(CMAX, device=adj.device)[None, :] < nconst.long()[:, None]
    return (torch.where(used, cadj.sum(dim=-1), 0.0),
            torch.where(used, cadj.abs().sum(dim=-1), 0.0))


def program_grad_plain(instr, nsteps, nconst, cvals_v, X, y, w, operators: OperatorSet,
                       loss_fn: Callable, max_elems: int = 1 << 25, return_abs: bool = False):
    """Eager version of kernel #3: kernel #2's loss and validity plus
    d(loss_sum)/d(cvals) for every (tree, variant) pair, by a forward sweep
    and a reverse adjoint sweep with the derivative table of ops/vjp.py.

    Returns (loss_sum [T, V], valid [T, V], gcomp [T, V, CMAX]); with
    ``return_abs`` also the row sums of the constants' absolute adjoints
    [T, V, CMAX] (the scale a comparison of two summation orders needs)."""
    T, V, CMAX = cvals_v.shape
    L = instr.shape[1]
    F, n = X.shape
    BASE = F + CMAX
    dev = X.device
    dloss = loss_vjp(loss_fn)
    P = T * V
    ins_all = instr.repeat_interleave(V, dim=0)
    m_all = nsteps.repeat_interleave(V, dim=0)
    nc_all = nconst.repeat_interleave(V, dim=0)
    cv_all = cvals_v.reshape(P, CMAX)
    n_sum = _weighted_rows(w)
    chunk = max(1, max_elems // max(2 * (BASE + L + 1) * max(n_sum, n // 2), 1))
    parts = []
    for s in range(0, P, chunk):
        e = s + chunk
        buf, vmask, words = _plain_forward(ins_all[s:e], m_all[s:e], cv_all[s:e], X, operators)
        pred = _root(buf, m_all[s:e], BASE)
        elt = torch.where(w > 0, loss_fn(pred, y), 0.0)
        total = torch.sum((elt * w)[..., :n_sum].contiguous(), dim=-1)
        valid = vmask.all(dim=-1) & torch.isfinite(total)
        seed = torch.where(w > 0, dloss(pred, y, w.expand_as(pred)), 0.0)
        adj = _plain_backward(buf, words, m_all[s:e], seed, BASE, operators)
        gcomp, gabs = _const_sums(adj, nc_all[s:e], F, CMAX, n_sum)
        parts.append((total, valid, gcomp, gabs))
    if parts:
        total, valid, gcomp, gabs = (torch.cat(z) for z in zip(*parts))
    else:
        total = torch.zeros(0, dtype=X.dtype, device=dev)
        valid = torch.zeros(0, dtype=torch.bool, device=dev)
        gcomp = gabs = torch.zeros((0, CMAX), dtype=X.dtype, device=dev)
    out = (total.reshape(T, V), valid.reshape(T, V), gcomp.reshape(T, V, CMAX))
    return out + (gabs.reshape(T, V, CMAX),) if return_abs else out


def program_predict_plain(instr, nsteps, cvals, const_ok, X, operators: OperatorSet,
                          max_elems: int = 1 << 26, bf16: bool = False):
    """Eager version of kernel #4: each tree's raw row predictions (the
    last step's value) and validity (every step finite on every row, and
    ``const_ok``). ``X`` is [F, n] or [T, F, n]. Returns (pred [T, n],
    valid [T]); ``bf16``: #4's bf16 form (a bf16 value buffer as kernel
    1b's, float32 predictions)."""
    T, L = instr.shape
    F, n = X.shape[-2:]
    BASE = F + cvals.shape[1]
    per_member = X.dim() == 3
    chunk = max(1, max_elems // max((BASE + L + 1) * n, 1))
    preds, valids = [], []
    for s in range(0, T, chunk):
        e = s + chunk
        buf, vmask, _ = _plain_forward(instr[s:e], nsteps[s:e], cvals[s:e],
                                       X[s:e] if per_member else X, operators, bf16=bf16)
        preds.append(_root(buf, nsteps[s:e], BASE))
        valids.append(vmask.all(dim=-1) & (const_ok[s:e] != 0))
    if not preds:
        return (torch.zeros((0, n), dtype=torch.float32 if bf16 else X.dtype, device=X.device),
                torch.zeros(0, dtype=torch.bool, device=X.device))
    return torch.cat(preds), torch.cat(valids)


def program_predict_vjp_plain(instr, nsteps, nconst, cvals, X, ct, operators: OperatorSet,
                              max_elems: int = 1 << 25, return_abs: bool = False):
    """Eager version of kernel #5: d(sum_r ct * pred)/d(cvals) [T, CMAX]
    (raw, 0 past nconst) and, for per-member ``X`` [T, F, n], the raw
    d/dX [T, F, n] (None for shared X), by the forward sweep and a reverse
    sweep seeded with ``ct`` [T, n]. X-region adjoints accumulate. With
    ``return_abs`` also the row sums of the constants' absolute adjoints."""
    T, L = instr.shape
    F, n = X.shape[-2:]
    CMAX = cvals.shape[1]
    BASE = F + CMAX
    per_member = X.dim() == 3
    chunk = max(1, max_elems // max(2 * (BASE + L + 1) * n, 1))
    parts = []
    for s in range(0, T, chunk):
        e = s + chunk
        buf, _, words = _plain_forward(instr[s:e], nsteps[s:e], cvals[s:e],
                                       X[s:e] if per_member else X, operators)
        adj = _plain_backward(buf, words, nsteps[s:e], ct[s:e], BASE, operators, acc_below=F)
        gcomp, gabs = _const_sums(adj, nconst[s:e], F, CMAX, n)
        parts.append((gcomp, gabs, adj[:, :F] if per_member else None))
    if parts:
        gcomp = torch.cat([p[0] for p in parts])
        gabs = torch.cat([p[1] for p in parts])
        gx = torch.cat([p[2] for p in parts]) if per_member else None
    else:
        gcomp = gabs = torch.zeros((0, CMAX), dtype=X.dtype, device=X.device)
        gx = torch.zeros((0, F, n), dtype=X.dtype, device=X.device) if per_member else None
    return (gcomp, gx, gabs) if return_abs else (gcomp, gx)


# ---------------------------------------------------------------------------
# The CUDA kernels' wrappers
# ---------------------------------------------------------------------------

# Operator ids of csrc/interp.cuh, by canonical operator name.
_KERNEL_OP_IDS = {
    "+": 0, "-": 1, "*": 2, "/": 3, "^": 4, "mod": 5, "max": 6, "min": 7,
    "atan2": 8, "greater": 9, "less": 10, "greater_equal": 11,
    "less_equal": 12, "cond": 13, "logical_or": 14, "logical_and": 15,
    "exp": 32, "abs": 33, "log": 34, "log2": 35, "log10": 36, "log1p": 37,
    "sqrt": 38, "cbrt": 39, "sin": 40, "cos": 41, "tan": 42, "sinh": 43,
    "cosh": 44, "tanh": 45, "asin": 46, "acos": 47, "atan": 48, "asinh": 49,
    "acosh": 50, "atanh": 51, "atanh_clip": 52, "erf": 53, "erfc": 54,
    "gamma": 55, "square": 56, "cube": 57, "neg": 58, "inv": 59, "relu": 60,
    "round": 61, "floor": 62, "ceil": 63, "sign": 64,
}
_K_IDENTITY, _K_BINARY, _K_UNARY, _K_ADDSUB = 0, 1, 2, 3

_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use


def _kernel_op_id(op, operators: OperatorSet) -> int:
    """The kernels' id of ``op``: a built-in operator's, or its number
    among the operator set's user operators (ops/user_ops.py, whose tracer
    refuses an operator it cannot take)."""
    from .user_ops import is_builtin, user_op_set

    if is_builtin(op):
        return _KERNEL_OP_IDS[op.name]
    return user_op_set(operators).op_id(op)


@functools.lru_cache(maxsize=None)
def _optab_list(operators: OperatorSet) -> Tuple[int, ...]:
    """Kernel dispatch table: ``kind << 8 | op id`` per merged opcode."""
    plan = _dispatch_plan(operators)
    tab = []
    if plan.merged:
        tab.append(_K_ADDSUB << 8)
        for j in plan.other_bin:
            tab.append(_K_BINARY << 8 | _kernel_op_id(operators.binary[j], operators))
    else:
        tab.append(_K_IDENTITY << 8)
        for op in operators.binary:
            tab.append(_K_BINARY << 8 | _kernel_op_id(op, operators))
    for op in operators.unary:
        tab.append(_K_UNARY << 8 | _kernel_op_id(op, operators))
    return tuple(tab)


class _ProgramKernel:
    """Shared parts of the kernels' wrappers: the library (built at first
    use), the block size, the opcode table on the device and the input
    checks. ``launches`` counts kernel launches; each wrapper increments
    it where it launches its kernel and nowhere else. An operator set with
    user operators binds the library built with its generated header
    (ops/user_ops.py, ops/cuda_build.py), one per operator set, or one
    already loaded whose operator set covers it (``UserOpSet.covers``). ``bf16`` wrappers
    run the kernel over a bfloat16 value buffer and take X as bfloat16;
    ``f64`` wrappers take every float operand as float64. Serve tenants
    launch from threads of one process: the count is kept under a lock,
    and the library binds once under it."""

    name = ""
    source = ""
    replaces = ""
    bf16 = False
    f64 = False
    bf16_data = False
    _file = ""
    _entry = ""
    _smem = ""        # the shared-memory size function ("": ``_entry + "_smem"``)
    _smem_nargs = 4

    def __init__(self):
        self.launches = 0
        self._libs = {}
        self._user_sets = []   # (UserOpSet, library) of each user-op library loaded
        self._optab = {}
        self._lock = threading.Lock()

    def _bind(self, lib):
        raise NotImplementedError

    def _smem_fn(self, lib):
        return getattr(lib, self._smem or self._entry + "_smem")

    def _smem_extra(self, NP: int, NC: int) -> tuple:
        """The size function's arguments after (block, L, CMAX, F)."""
        return ()

    @property
    def plain_bf16(self):
        """The plain version's ``bf16``: False, True or "data"."""
        return "data" if self.bf16_data else self.bf16

    def library(self, operators: Optional[OperatorSet] = None):
        """Build (at first use) and bind the shared library: the built-in
        one, or that of ``operators``' user operators."""
        from .user_ops import user_op_set

        uset = None if operators is None else user_op_set(operators)
        key = None if uset is None else uset.digest
        lib = self._libs.get(key)
        if lib is None:
            from .cuda_build import load_library

            with self._lock:
                lib = self._libs.get(key)
                if lib is None and uset is not None:
                    lib = next((olib for oset, olib in self._user_sets if oset.covers(uset)),
                               None)
                if lib is None:
                    lib = load_library(self._file, None if uset is None else uset.header)
                    self._smem_fn(lib).argtypes = [ctypes.c_int] * self._smem_nargs
                    self._smem_fn(lib).restype = ctypes.c_size_t
                    getattr(lib, self._entry).restype = ctypes.c_int
                    self._bind(lib)
                    if uset is not None:
                        self._user_sets.append((uset, lib))
                self._libs[key] = lib
        return lib

    def _block(self, L: int, CMAX: int, F: int, NP: int = 0, NC: int = 0, lib=None) -> int:
        """The lane count W: the largest block whose shared-memory layout
        fits (a bf16 buffer takes half the bytes, so it fits a larger block
        sooner). The tile kernels run W / 4 (#1, #2, #4) or W / 2 (#3, #5)
        threads and keep W lanes, so each sum keeps the same order
        (csrc/interp.cuh). #1-#3 and #5 size W by their old per-row layout;
        #4, which sums nothing, by its tile layout."""
        smem = self._smem_fn(lib if lib is not None else self.library())
        extra = self._smem_extra(NP, NC)
        for block in (256, 128, 64, 32):
            if smem(block, L, CMAX, F, *extra) <= _SMEM_LIMIT:
                return block
        raise ValueError(f"{F} features and {L} steps do not fit one block's shared memory")

    def _device_optab(self, operators: OperatorSet, device) -> torch.Tensor:
        key = (operators, str(device))
        tab = self._optab.get(key)
        if tab is None:
            tab = torch.tensor(_optab_list(operators), dtype=torch.int32, device=device)
            self._optab[key] = tab
        return tab

    def _layout(self, operators: OperatorSet, X, L: int, CMAX: int, F: int, NP: int = 0,
                NC: int = 0):
        """(opcode table on the device, block size, opcode mask) of a launch."""
        _check_packable(operators, F + NP + CMAX, L)
        code_mask = 0x3F if _dispatch_plan(operators).merged else 0x7F
        block = self._block(L, CMAX, F, NP, NC, self.library(operators))
        return self._device_optab(operators, X.device), block, code_mask

    @property
    def dtype(self) -> torch.dtype:
        """The dtype of the wrapper's float operands and outputs."""
        return torch.float64 if self.f64 else torch.float32

    def _check(self, X, loss_fn, ints, floats):
        """Device, dtype and contiguity of every input (``X`` bfloat16 for a
        bf16 wrapper, the other floats float32, or float64 for an f64
        wrapper); the loss's (kind, parameter) (None for the kernels that
        compute no loss)."""
        if X.device.type != "cuda":
            raise ValueError(f"{self.name}: unsupported device {X.device}")
        loss = None
        if loss_fn is not None:
            kl = kernel_loss(loss_fn)
            if kl is None:
                raise NotImplementedError(
                    f"the CUDA kernel {self.name} implements the library elementwise losses "
                    f"(core/losses.py), not the user callable {loss_fn!r}")
            loss = (kl.kind, kl.param)
        for group, dtype in ((ints, torch.int32), (floats, self.dtype)):
            for nm, t in group.items():
                want = torch.bfloat16 if (nm == "X" and self.bf16) else dtype
                if t.device != X.device:
                    raise ValueError(f"{self.name}: {nm} is on {t.device}, X on {X.device}")
                if not t.is_contiguous():
                    raise ValueError(f"{self.name}: {nm} must be contiguous")
                if t.dtype != want:
                    raise TypeError(f"{self.name}: {nm} must be {str(want)[6:]}")
        return loss

    def _launch(self, operators: OperatorSet, *args):
        rc = getattr(self.library(operators), self._entry)(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error {rc}")
        with self._lock:
            self.launches += 1


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else None


def _stream(X):
    return ctypes.c_void_p(torch.cuda.current_stream(X.device).cuda_stream)


class ProgramEvalKernel(_ProgramKernel):
    """Wrapper of ``sr_program_eval`` (csrc/program_eval.cu).
    ``cost_launches`` counts the launches of its cost-epilogue form (a
    part of ``launches``)."""

    name = "program_eval"
    source = "symbolicregression_jl_tpu_torch/csrc/program_eval.cu"
    replaces = "symbolicregression_jl_tpu/ops/fused_eval.py:505 (_program_launch / _make_program_kernel)"
    _file = "program_eval.cu"
    _entry = "sr_program_eval"
    _smem = "sr_program_eval_smem"
    _smem_nargs = 7

    def __init__(self):
        super().__init__()
        self.cost_launches = 0

    def _smem_extra(self, NP, NC):
        return (NP, NC, 2 if self.bf16 else (8 if self.f64 else 4))

    def _bind(self, lib):
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        getattr(lib, self._entry).argtypes = [p] * 10 + [i] * 7 + [d, i, i] + [p, p, p, p]

    def __call__(self, instr, nsteps, cvals, const_ok, X, y, w, operators: OperatorSet,
                 loss_fn: Callable, cx=None, scal=None):
        if X.device.type == "cpu":
            return program_eval_plain(instr, nsteps, cvals, const_ok, X, y, w,
                                      operators, loss_fn, cx=cx, scal=scal, bf16=self.plain_bf16)
        T, L = instr.shape
        F, n = X.shape
        CMAX = cvals.shape[1]
        cost_form = cx is not None
        floats = dict(cvals=cvals, X=X, y=y, w=w)
        if cost_form:
            floats.update(cx=cx, scal=scal)
        loss_kind, loss_param = self._check(X, loss_fn, dict(instr=instr, nsteps=nsteps,
                                                             const_ok=const_ok), floats)
        if (nsteps.shape != (T,) or const_ok.shape != (T,) or cvals.shape[0] != T
                or y.shape != (n,) or w.shape != (n,)
                or (cost_form and (cx.shape != (T,) or scal.shape != (3,)))):
            raise ValueError("program_eval: inconsistent shapes")
        optab, block, code_mask = self._layout(operators, X, L, CMAX, F)
        loss = torch.empty(T, dtype=self.dtype, device=X.device)
        valid = torch.empty(T, dtype=torch.int32, device=X.device)
        cost = torch.empty(T, dtype=self.dtype, device=X.device) if cost_form else None
        self._launch(
            operators,
            _ptr(instr), _ptr(nsteps), _ptr(cvals), _ptr(const_ok), _ptr(X), _ptr(y), _ptr(w),
            _ptr(cx), _ptr(scal), _ptr(optab), T, L, CMAX, F, n, block, loss_kind, loss_param,
            code_mask, 30, _ptr(loss), _ptr(valid), _ptr(cost),
            _stream(X))
        if cost_form:
            with self._lock:
                self.cost_launches += 1
            return loss, valid.bool(), cost
        return loss, valid.bool()


class ProgramEvalParamKernel(_ProgramKernel):
    """Wrapper of ``sr_program_eval_param`` (csrc/program_eval.cu), the
    parametric form of kernel #1: (loss_sum, valid) [T] with each tree's
    parameter bank [T, NP, NC] read by the row's class. Its own launch
    count keeps it apart from the plain form's on the main path."""

    name = "program_eval_param"
    source = "symbolicregression_jl_tpu_torch/csrc/program_eval.cu"
    replaces = ("symbolicregression_jl_tpu/ops/fused_eval.py:379 (_make_program_kernel "
                "nparam > 0 / _program_launch params, class_oh)")
    _file = "program_eval.cu"
    _entry = "sr_program_eval_param"
    _smem = "sr_program_eval_smem"
    _smem_nargs = 7

    def _smem_extra(self, NP, NC):
        return (NP, NC, 2 if self.bf16 else (8 if self.f64 else 4))

    def _bind(self, lib):
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        getattr(lib, self._entry).argtypes = [p] * 10 + [i] * 9 + [d, i, i] + [p, p, p]

    def __call__(self, instr, nsteps, cvals, const_ok, bank, class_idx, X, y, w,
                 operators: OperatorSet, loss_fn: Callable):
        if X.device.type == "cpu":
            return program_eval_plain(instr, nsteps, cvals, const_ok, X, y, w, operators,
                                      loss_fn, bank=bank, class_idx=class_idx,
                                      bf16=self.plain_bf16)
        T, L = instr.shape
        F, n = X.shape
        CMAX = cvals.shape[1]
        NP, NC = bank.shape[1:]
        loss_kind, loss_param = self._check(
            X, loss_fn, dict(instr=instr, nsteps=nsteps, const_ok=const_ok, class_idx=class_idx),
            dict(cvals=cvals, bank=bank, X=X, y=y, w=w))
        if (nsteps.shape != (T,) or const_ok.shape != (T,) or cvals.shape[0] != T
                or bank.shape[0] != T or NP < 1 or NC < 1 or class_idx.shape != (n,)
                or y.shape != (n,) or w.shape != (n,)):
            raise ValueError("program_eval_param: inconsistent shapes")
        optab, block, code_mask = self._layout(operators, X, L, CMAX, F, NP, NC)
        loss = torch.empty(T, dtype=self.dtype, device=X.device)
        valid = torch.empty(T, dtype=torch.int32, device=X.device)
        self._launch(
            operators,
            _ptr(instr), _ptr(nsteps), _ptr(cvals), _ptr(const_ok), _ptr(bank), _ptr(class_idx),
            _ptr(X), _ptr(y), _ptr(w), _ptr(optab), T, L, CMAX, F, NP, NC, n, block,
            loss_kind, loss_param, code_mask, 30, _ptr(loss), _ptr(valid), _stream(X))
        return loss, valid.bool()


class ProgramMultiKernel(_ProgramKernel):
    """Wrapper of ``sr_program_multi`` (csrc/program_multi.cu): (loss_sum,
    valid) [T, V] for every (tree, constant vector) pair."""

    name = "program_multi"
    source = "symbolicregression_jl_tpu_torch/csrc/program_multi.cu"
    replaces = "symbolicregression_jl_tpu/ops/fused_eval.py:830 (fused_loss_multi / _make_multi_kernel)"
    _file = "program_multi.cu"
    _entry = "sr_program_multi"
    _smem = "sr_program_multi_smem"
    _smem_nargs = 5

    def _smem_extra(self, NP, NC):
        return (2 if self.bf16 else (8 if self.f64 else 4),)

    def _bind(self, lib):
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        getattr(lib, self._entry).argtypes = [p] * 7 + [i] * 8 + [d, i, i] + [p, p, p]

    def __call__(self, instr, nsteps, cvals_v, X, y, w, operators: OperatorSet,
                 loss_fn: Callable):
        if X.device.type == "cpu":
            return program_multi_plain(instr, nsteps, cvals_v, X, y, w, operators, loss_fn,
                                       bf16=self.plain_bf16)
        T, L = instr.shape
        F, n = X.shape
        V, CMAX = cvals_v.shape[1], cvals_v.shape[2]
        loss_kind, loss_param = self._check(X, loss_fn, dict(instr=instr, nsteps=nsteps),
                                            dict(cvals_v=cvals_v, X=X, y=y, w=w))
        if (nsteps.shape != (T,) or cvals_v.shape[0] != T or y.shape != (n,)
                or w.shape != (n,)):
            raise ValueError("program_multi: inconsistent shapes")
        optab, block, code_mask = self._layout(operators, X, L, CMAX, F)
        loss = torch.empty((T, V), dtype=self.dtype, device=X.device)
        valid = torch.empty((T, V), dtype=torch.int32, device=X.device)
        self._launch(
            operators,
            _ptr(instr), _ptr(nsteps), _ptr(cvals_v), _ptr(X), _ptr(y), _ptr(w), _ptr(optab),
            T, V, L, CMAX, F, n, block, loss_kind, loss_param, code_mask, 30,
            _ptr(loss), _ptr(valid), _stream(X))
        return loss, valid.bool()


class ProgramGradKernel(_ProgramKernel):
    """Wrapper of ``sr_program_grad`` (csrc/program_grad.cu): (loss_sum,
    valid) [T, V] and d(loss_sum)/d(cvals) [T, V, CMAX] for every pair."""

    name = "program_grad"
    source = "symbolicregression_jl_tpu_torch/csrc/program_grad.cu"
    replaces = ("symbolicregression_jl_tpu/ops/fused_eval.py:1250 "
                "(fused_grad_multi / _make_multi_grad_kernel)")
    _file = "program_grad.cu"
    _entry = "sr_program_grad"

    def _bind(self, lib):
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        getattr(lib, self._entry).argtypes = [p] * 8 + [i] * 9 + [d, i, i] + [p, p, p, p]

    def __call__(self, instr, nsteps, nconst, cvals_v, X, y, w, operators: OperatorSet,
                 loss_fn: Callable, n_grad: Optional[int] = None):
        """``n_grad``: the gradient sums rows up to it (default: up to the
        last row of positive weight, ``weighted_rows(w)``, which the plain
        version always takes); the loss and validity read every row."""
        if X.device.type == "cpu":
            return program_grad_plain(instr, nsteps, nconst, cvals_v, X, y, w, operators,
                                      loss_fn)
        T, L = instr.shape
        F, n = X.shape
        V, CMAX = cvals_v.shape[1], cvals_v.shape[2]
        loss_kind, loss_param = self._check(
            X, loss_fn, dict(instr=instr, nsteps=nsteps, nconst=nconst),
            dict(cvals_v=cvals_v, X=X, y=y, w=w))
        if (nsteps.shape != (T,) or nconst.shape != (T,) or cvals_v.shape[0] != T
                or y.shape != (n,) or w.shape != (n,)):
            raise ValueError("program_grad: inconsistent shapes")
        optab, block, code_mask = self._layout(operators, X, L, CMAX, F)
        if n_grad is None:
            n_grad = weighted_rows(w)
        loss = torch.empty((T, V), dtype=self.dtype, device=X.device)
        valid = torch.empty((T, V), dtype=torch.int32, device=X.device)
        gcomp = torch.empty((T, V, CMAX), dtype=self.dtype, device=X.device)
        self._launch(
            operators,
            _ptr(instr), _ptr(nsteps), _ptr(nconst), _ptr(cvals_v), _ptr(X), _ptr(y), _ptr(w),
            _ptr(optab), T, V, L, CMAX, F, n, int(n_grad), block, loss_kind, loss_param,
            code_mask, 30, _ptr(loss), _ptr(valid), _ptr(gcomp),
            _stream(X))
        return loss, valid.bool(), gcomp


class ProgramPredictKernel(_ProgramKernel):
    """Wrapper of ``sr_program_predict`` (csrc/program_predict.cu): (pred
    [T, n], valid [T]) per tree over shared X [F, n] or per-member X
    [T, F, n]."""

    name = "program_predict"
    source = "symbolicregression_jl_tpu_torch/csrc/program_predict.cu"
    replaces = ("symbolicregression_jl_tpu/ops/fused_eval.py:1612 "
                "(fused_predict_program / _make_program_predict_kernel)")
    _file = "program_predict.cu"
    _entry = "sr_program_predict"

    def _bind(self, lib):
        p, i = ctypes.c_void_p, ctypes.c_int
        getattr(lib, self._entry).argtypes = [p] * 6 + [i] * 9 + [p, p, p]

    def __call__(self, instr, nsteps, cvals, const_ok, X, operators: OperatorSet):
        if X.device.type == "cpu":
            return program_predict_plain(instr, nsteps, cvals, const_ok, X, operators,
                                         bf16=self.bf16)
        T, L = instr.shape
        F, n = X.shape[-2:]
        CMAX = cvals.shape[1]
        per_member = X.dim() == 3
        self._check(X, None, dict(instr=instr, nsteps=nsteps, const_ok=const_ok),
                    dict(cvals=cvals, X=X))
        if (nsteps.shape != (T,) or const_ok.shape != (T,) or cvals.shape[0] != T
                or X.dim() not in (2, 3) or (per_member and X.shape[0] != T)):
            raise ValueError("program_predict: inconsistent shapes")
        optab, block, code_mask = self._layout(operators, X, L, CMAX, F)
        pred = torch.empty((T, n), dtype=self.dtype, device=X.device)
        valid = torch.empty(T, dtype=torch.int32, device=X.device)
        self._launch(
            operators,
            _ptr(instr), _ptr(nsteps), _ptr(cvals), _ptr(const_ok), _ptr(X), _ptr(optab),
            T, L, CMAX, F, n, block, int(per_member), code_mask, 30,
            _ptr(pred), _ptr(valid), _stream(X))
        return pred, valid.bool()


class ProgramPredictVjpKernel(_ProgramKernel):
    """Wrapper of ``sr_program_predict_vjp`` (csrc/program_predict_vjp.cu):
    the raw d(sum ct * pred)/d(cvals) [T, CMAX] and, for per-member X, the
    raw d/dX [T, F, n] (None for shared X)."""

    name = "program_predict_vjp"
    source = "symbolicregression_jl_tpu_torch/csrc/program_predict_vjp.cu"
    replaces = ("symbolicregression_jl_tpu/ops/fused_eval.py:1832 "
                "(_fused_predict_vjp_program / _make_program_predict_vjp_kernel)")
    _file = "program_predict_vjp.cu"
    _entry = "sr_program_predict_vjp"

    def _bind(self, lib):
        p, i = ctypes.c_void_p, ctypes.c_int
        getattr(lib, self._entry).argtypes = [p] * 7 + [i] * 9 + [p, p, p]

    def __call__(self, instr, nsteps, nconst, cvals, X, ct, operators: OperatorSet):
        if X.device.type == "cpu":
            return program_predict_vjp_plain(instr, nsteps, nconst, cvals, X, ct, operators)
        T, L = instr.shape
        F, n = X.shape[-2:]
        CMAX = cvals.shape[1]
        per_member = X.dim() == 3
        self._check(X, None, dict(instr=instr, nsteps=nsteps, nconst=nconst),
                    dict(cvals=cvals, X=X, ct=ct))
        if (nsteps.shape != (T,) or nconst.shape != (T,) or cvals.shape[0] != T
                or ct.shape != (T, n) or X.dim() not in (2, 3)
                or (per_member and X.shape[0] != T)):
            raise ValueError("program_predict_vjp: inconsistent shapes")
        optab, block, code_mask = self._layout(operators, X, L, CMAX, F)
        gcomp = torch.empty((T, CMAX), dtype=self.dtype, device=X.device)
        gx = (torch.empty((T, F, n), dtype=self.dtype, device=X.device)
              if per_member else None)
        self._launch(
            operators,
            _ptr(instr), _ptr(nsteps), _ptr(nconst), _ptr(cvals), _ptr(X), _ptr(ct),
            _ptr(optab), T, L, CMAX, F, n, block, int(per_member), code_mask, 30,
            _ptr(gcomp), _ptr(gx), _stream(X))
        return gcomp, gx


class ProgramEvalBf16Kernel(ProgramEvalKernel):
    """Wrapper of ``sr_program_eval_bf16`` (csrc/program_eval.cu), kernel
    1b: kernel #1's cost and plain forms over a bfloat16 value buffer, X
    [F, n] bfloat16. Its own launch count keeps it apart from #1's."""

    name = "program_eval_bf16"
    replaces = ("symbolicregression_jl_tpu/ops/fused_eval.py:519 (_program_launch bf16=True, "
                "_make_program_kernel bdt stores :417-470)")
    bf16 = True
    _entry = "sr_program_eval_bf16"


class ProgramEvalParamBf16Kernel(ProgramEvalParamKernel):
    """Wrapper of ``sr_program_eval_param_bf16`` (csrc/program_eval.cu):
    kernel 1b's parametric form, the bank rounded to bf16 as it loads."""

    name = "program_eval_param_bf16"
    replaces = ("symbolicregression_jl_tpu/ops/fused_eval.py:379 (_make_program_kernel "
                "nparam > 0 with a bf16 buffer, :417-436)")
    bf16 = True
    _entry = "sr_program_eval_param_bf16"


class ProgramMultiBf16Kernel(ProgramMultiKernel):
    """Wrapper of ``sr_program_multi_bf16`` (csrc/program_multi.cu), kernel
    2b: kernel #2 over a bfloat16 value buffer, X [F, n] bfloat16."""

    name = "program_multi_bf16"
    replaces = ("symbolicregression_jl_tpu/ops/fused_eval.py:855 (fused_loss_multi bf16=True "
                "/ _make_multi_kernel bdt stores)")
    bf16 = True
    _entry = "sr_program_multi_bf16"


class ProgramEvalF64Kernel(ProgramEvalKernel):
    """Wrapper of ``sr_program_eval_f64`` (csrc/program_eval.cu): kernel
    #1's cost and plain forms in float64 (every operand, step and sum in
    double)."""

    name = "program_eval_f64"
    replaces = ("symbolicregression_jl_tpu/ops/fused_eval.py:505 (_program_launch / "
                "_make_program_kernel under jax_enable_x64)")
    f64 = True
    _entry = "sr_program_eval_f64"


class ProgramEvalParamF64Kernel(ProgramEvalParamKernel):
    """Wrapper of ``sr_program_eval_param_f64`` (csrc/program_eval.cu):
    kernel #1p in float64."""

    name = "program_eval_param_f64"
    replaces = ("symbolicregression_jl_tpu/ops/fused_eval.py:379 (_make_program_kernel "
                "nparam > 0 under jax_enable_x64)")
    f64 = True
    _entry = "sr_program_eval_param_f64"


class ProgramMultiF64Kernel(ProgramMultiKernel):
    """Wrapper of ``sr_program_multi_f64`` (csrc/program_multi.cu): kernel
    #2 in float64."""

    name = "program_multi_f64"
    replaces = ("symbolicregression_jl_tpu/ops/fused_eval.py:830 (fused_loss_multi under "
                "jax_enable_x64)")
    f64 = True
    _entry = "sr_program_multi_f64"


class ProgramGradF64Kernel(ProgramGradKernel):
    """Wrapper of ``sr_program_grad_f64`` (csrc/program_grad.cu): kernel #3
    in float64."""

    name = "program_grad_f64"
    replaces = ("symbolicregression_jl_tpu/ops/fused_eval.py:1250 (fused_grad_multi under "
                "jax_enable_x64)")
    f64 = True
    _entry = "sr_program_grad_f64"


class ProgramEvalBf16F64Kernel(ProgramEvalKernel):
    """Wrapper of ``sr_program_eval_bf16_f64`` (csrc/program_eval.cu):
    kernel 1b for float64 data, a bf16 value buffer with float32 steps and
    a float64 loss spine (y, w, the loss, the sums and the cost)."""

    name = "program_eval_bf16_f64"
    replaces = ("symbolicregression_jl_tpu/ops/fused_eval.py:519 (_program_launch bf16=True "
                "under jax_enable_x64: f32 steps :224-228, the f64 loss :465-468)")
    bf16 = True
    f64 = True
    _entry = "sr_program_eval_bf16_f64"


class ProgramEvalParamBf16F64Kernel(ProgramEvalParamKernel):
    """Wrapper of ``sr_program_eval_param_bf16_f64``: the parametric form
    of float64 data on a bf16 buffer."""

    name = "program_eval_param_bf16_f64"
    replaces = ("symbolicregression_jl_tpu/ops/fused_eval.py:379 (_make_program_kernel "
                "nparam > 0, bf16 buffer, under jax_enable_x64)")
    bf16 = True
    f64 = True
    _entry = "sr_program_eval_param_bf16_f64"


class ProgramEvalBf16DataKernel(ProgramEvalKernel):
    """Wrapper of ``sr_program_eval_bf16_data``: kernel 1b for bf16 data
    (``eval_dtype="bfloat16"``), each loss term, sum and cost rounded to
    bf16 (y and w hold bf16 values in float32)."""

    name = "program_eval_bf16_data"
    replaces = ("symbolicregression_jl_tpu/ops/fused_eval.py:505 (_program_launch with "
                "bfloat16 data: pred cast to y's dtype :465-468)")
    bf16 = True
    bf16_data = True
    _entry = "sr_program_eval_bf16_data"


class ProgramEvalParamBf16DataKernel(ProgramEvalParamKernel):
    """Wrapper of ``sr_program_eval_param_bf16_data``: the parametric form
    of bf16 data."""

    name = "program_eval_param_bf16_data"
    replaces = ("symbolicregression_jl_tpu/ops/fused_eval.py:379 (_make_program_kernel "
                "nparam > 0 with bfloat16 data)")
    bf16 = True
    bf16_data = True
    _entry = "sr_program_eval_param_bf16_data"


class ProgramMultiBf16F64Kernel(ProgramMultiKernel):
    """Wrapper of ``sr_program_multi_bf16_f64`` (csrc/program_multi.cu):
    kernel 2b for float64 data (a float64 loss spine)."""

    name = "program_multi_bf16_f64"
    replaces = ("symbolicregression_jl_tpu/ops/fused_eval.py:855 (fused_loss_multi bf16=True "
                "under jax_enable_x64)")
    bf16 = True
    f64 = True
    _entry = "sr_program_multi_bf16_f64"


class ProgramMultiBf16DataKernel(ProgramMultiKernel):
    """Wrapper of ``sr_program_multi_bf16_data``: kernel 2b for bf16 data
    (the loss terms and sums rounded to bf16)."""

    name = "program_multi_bf16_data"
    replaces = ("symbolicregression_jl_tpu/ops/fused_eval.py:830 (fused_loss_multi with "
                "bfloat16 data)")
    bf16 = True
    bf16_data = True
    _entry = "sr_program_multi_bf16_data"


class ProgramPredictF64Kernel(ProgramPredictKernel):
    """Wrapper of ``sr_program_predict_f64`` (csrc/program_predict.cu):
    kernel #4 in float64 (float64 templates, the float64 user-loss route)."""

    name = "program_predict_f64"
    replaces = ("symbolicregression_jl_tpu/ops/fused_eval.py:1612 (fused_predict_program under "
                "jax_enable_x64)")
    f64 = True
    _entry = "sr_program_predict_f64"


class ProgramPredictBf16Kernel(ProgramPredictKernel):
    """Wrapper of ``sr_program_predict_bf16``: kernel #4 over a bf16 value
    buffer, as kernel 1b stores and computes, X bfloat16, float32
    predictions (the user-loss route of a bf16 search)."""

    name = "program_predict_bf16"
    replaces = ("symbolicregression_jl_tpu/ops/fused_eval.py:519 (_program_launch bf16=True, "
                "the user loss traced in at :466)")
    bf16 = True
    _entry = "sr_program_predict_bf16"


class ProgramPredictVjpF64Kernel(ProgramPredictVjpKernel):
    """Wrapper of ``sr_program_predict_vjp_f64``
    (csrc/program_predict_vjp.cu): kernel #5 in float64."""

    name = "program_predict_vjp_f64"
    replaces = ("symbolicregression_jl_tpu/ops/fused_eval.py:1832 (_fused_predict_vjp_program "
                "under jax_enable_x64)")
    f64 = True
    _entry = "sr_program_predict_vjp_f64"


PROGRAM_EVAL = ProgramEvalKernel()
PROGRAM_EVAL_PARAM = ProgramEvalParamKernel()
PROGRAM_EVAL_BF16 = ProgramEvalBf16Kernel()
PROGRAM_EVAL_PARAM_BF16 = ProgramEvalParamBf16Kernel()
PROGRAM_MULTI = ProgramMultiKernel()
PROGRAM_MULTI_BF16 = ProgramMultiBf16Kernel()
PROGRAM_GRAD = ProgramGradKernel()
PROGRAM_PREDICT = ProgramPredictKernel()
PROGRAM_PREDICT_VJP = ProgramPredictVjpKernel()
PROGRAM_EVAL_F64 = ProgramEvalF64Kernel()
PROGRAM_EVAL_PARAM_F64 = ProgramEvalParamF64Kernel()
PROGRAM_MULTI_F64 = ProgramMultiF64Kernel()
PROGRAM_GRAD_F64 = ProgramGradF64Kernel()
PROGRAM_EVAL_BF16_F64 = ProgramEvalBf16F64Kernel()
PROGRAM_EVAL_PARAM_BF16_F64 = ProgramEvalParamBf16F64Kernel()
PROGRAM_EVAL_BF16_DATA = ProgramEvalBf16DataKernel()
PROGRAM_EVAL_PARAM_BF16_DATA = ProgramEvalParamBf16DataKernel()
PROGRAM_MULTI_BF16_F64 = ProgramMultiBf16F64Kernel()
PROGRAM_MULTI_BF16_DATA = ProgramMultiBf16DataKernel()
PROGRAM_PREDICT_F64 = ProgramPredictF64Kernel()
PROGRAM_PREDICT_BF16 = ProgramPredictBf16Kernel()
PROGRAM_PREDICT_VJP_F64 = ProgramPredictVjpF64Kernel()


# The forms of each kernel by (X's dtype, bf16): False, True (a bf16 value
# buffer) or "data" (bf16 data, a bf16 loss spine); the wrappers by their
# module names, looked up at each call.
_FORMS = {
    "eval": {(torch.float32, False): "PROGRAM_EVAL", (torch.float32, True): "PROGRAM_EVAL_BF16",
             (torch.float32, "data"): "PROGRAM_EVAL_BF16_DATA",
             (torch.float64, False): "PROGRAM_EVAL_F64",
             (torch.float64, True): "PROGRAM_EVAL_BF16_F64"},
    "param": {(torch.float32, False): "PROGRAM_EVAL_PARAM",
              (torch.float32, True): "PROGRAM_EVAL_PARAM_BF16",
              (torch.float32, "data"): "PROGRAM_EVAL_PARAM_BF16_DATA",
              (torch.float64, False): "PROGRAM_EVAL_PARAM_F64",
              (torch.float64, True): "PROGRAM_EVAL_PARAM_BF16_F64"},
    "multi": {(torch.float32, False): "PROGRAM_MULTI", (torch.float32, True): "PROGRAM_MULTI_BF16",
              (torch.float32, "data"): "PROGRAM_MULTI_BF16_DATA",
              (torch.float64, False): "PROGRAM_MULTI_F64",
              (torch.float64, True): "PROGRAM_MULTI_BF16_F64"},
    "grad": {(torch.float32, False): "PROGRAM_GRAD", (torch.float64, False): "PROGRAM_GRAD_F64"},
    "predict": {(torch.float32, False): "PROGRAM_PREDICT",
                (torch.float32, True): "PROGRAM_PREDICT_BF16",
                (torch.float64, False): "PROGRAM_PREDICT_F64",
                (torch.float64, True): "PROGRAM_PREDICT_BF16"},
    "vjp": {(torch.float32, False): "PROGRAM_PREDICT_VJP",
            (torch.float64, False): "PROGRAM_PREDICT_VJP_F64"},
}


def _pick(kind: str, X, bf16=False):
    """The wrapper of kernel ``kind`` for X's dtype and ``bf16``."""
    dt = torch.float64 if X.dtype == torch.float64 else torch.float32
    key = (dt, bf16 if bf16 == "data" else bool(bf16))
    if key not in _FORMS[kind]:
        raise ValueError(f"kernel {kind} has no form for {dt} data with bf16={bf16!r}")
    return globals()[_FORMS[kind][key]]


# ---------------------------------------------------------------------------
# Entry points (same names and semantics as the JAX package)
# ---------------------------------------------------------------------------


# X rounded to bfloat16 for the bf16 kernels, one copy per dataset tensor:
# id(X) -> (weak reference to X, X's version counter, the bf16 copy). A
# search reads the same X every cycle, so the copy is made once. Served
# searches share the cache from several threads, hence its lock.
_BF16_ROWS: dict = {}
_BF16_LOCK = threading.Lock()


def _bf16_rows(X: torch.Tensor) -> torch.Tensor:
    """``X`` as a contiguous bfloat16 tensor (round to nearest even),
    cached while ``X`` lives unmodified."""
    with _BF16_LOCK:
        hit = _BF16_ROWS.get(id(X))
        if hit is not None and hit[0]() is X and hit[1] == X._version:
            return hit[2]
        xb = X.to(torch.bfloat16).contiguous()
        for k in [k for k, v in _BF16_ROWS.items() if v[0]() is None]:
            del _BF16_ROWS[k]
        _BF16_ROWS[id(X)] = (weakref.ref(X), X._version, xb)
        return xb


def _launch_inputs(prog: TreeProgram, X, y, weights, nfeatures: int,
                   operators: OperatorSet, n_params: int = 0, bf16=False):
    T, L = prog.code.shape
    CMAX = prog.cmax
    n = X.shape[1]
    BASE = nfeatures + n_params + CMAX
    _check_packable(operators, BASE, L)
    instr = _pack_instr(prog, operators, BASE + L).contiguous()
    w = (torch.ones(n, dtype=X.dtype, device=X.device) if weights is None
         else weights.to(X.dtype).contiguous())
    return (instr, prog.nsteps.to(torch.int32).contiguous(),
            prog.cvals.to(X.dtype).contiguous(),
            prog.const_ok.to(torch.int32).contiguous(),
            _bf16_rows(X) if bf16 else X.contiguous(), y.contiguous(), w)


def _denominator(weights, X):
    n = X.shape[1]
    if weights is None:
        return torch.tensor(float(n), dtype=X.dtype, device=X.device)
    return torch.sum(weights.to(X.dtype))


def _row_totals(sums, valid, weights, X):
    """(sums, valid, denominator) of a launch's per-tree row sums ``sums``
    (a list: the loss sums, and the constants' cotangent sums of #3 or #5)
    and validity, before the mean. Without a row shard: as given, and the
    rows' count or weight sum. Under an active data-row shard
    (parallel/collectives.RowShard) the rows are this rank's part: each
    sum is added over every shard in shard order, validity taken over
    every shard (and the total's finiteness, as one launch over every row
    has it), and the denominator is the whole dataset's row count or
    weight sum, all in one collective."""
    shard = active_row_shard()
    if shard is None:
        return sums, valid, _denominator(weights, X)
    wsum = None if weights is None else torch.sum(weights.to(X.dtype))
    sums, valid, wsum = shard_reduce(shard, sums, valid, wsum)
    valid = valid & torch.isfinite(sums[0])
    if weights is None:
        return sums, valid, torch.tensor(float(shard.n_rows), dtype=X.dtype, device=X.device)
    return sums, valid, wsum


def _no_rows(X) -> bool:
    """A rank whose part of a sharded dataset holds none of the rows (a
    minibatch that missed it): its partials are zeros and it is "all
    valid", without a launch over zero rows."""
    return X.shape[-1] == 0


def fused_loss_program(prog: TreeProgram, X, y, weights, nfeatures: int,
                       operators: OperatorSet, loss_fn: Callable, *, params=None,
                       class_idx=None, bf16=False):
    """Mean elementwise loss per compiled program (flat [T]); invalid
    programs get loss inf. Returns (loss, valid).

    Parametric programs (compiled with ``n_params = NP``) pass their
    banks ``params`` [T, NP, NC] and the rows' ``class_idx`` [n]; they run
    the parametric form of the kernel. ``bf16`` runs kernel 1b (a
    bfloat16 value buffer; the loss in X's dtype, float32 or float64), and
    ``bf16="data"`` its bf16-data form (the loss rounded to bf16). A user
    elementwise callable takes the user-loss route."""
    if kernel_loss(loss_fn) is None:
        return user_loss_program(prog, X, y, weights, nfeatures, operators, loss_fn,
                                 params=params, class_idx=class_idx, bf16=bf16)
    spine = _round_bf16 if bf16 == "data" else (lambda v: v)
    T = prog.code.shape[0]
    if _no_rows(X):
        loss_sum = torch.zeros(T, dtype=X.dtype, device=X.device)
        valid = torch.ones(T, dtype=torch.bool, device=X.device)
    elif params is None:
        args = _launch_inputs(prog, X, y, weights, nfeatures, operators, bf16=bf16)
        loss_sum, valid = _pick("eval", X, bf16)(*args, operators, loss_fn)
    else:
        instr, nsteps, cvals, ok, Xc, yc, w = _launch_inputs(prog, X, y, weights, nfeatures,
                                                             operators, params.shape[1], bf16)
        loss_sum, valid = _pick("param", X, bf16)(
            instr, nsteps, cvals, ok, params.to(X.dtype).contiguous(),
            class_idx.to(torch.int32).contiguous(), Xc, yc, w, operators, loss_fn)
    (loss_sum,), valid, denom = _row_totals([loss_sum], valid, weights, X)
    loss = spine(loss_sum / denom)
    loss = torch.where(valid & torch.isfinite(loss), loss, torch.inf)
    return loss, valid


def fused_cost_program(prog: TreeProgram, X, y, weights, complexity, nfeatures: int,
                       operators: OperatorSet, loss_fn: Callable, *, baseline_loss,
                       use_baseline, parsimony, bf16=False):
    """(cost, loss, valid) per compiled program, the cost computed in the
    kernel's epilogue with ``core.losses.loss_to_cost``'s operation order
    (kernel 1b with ``bf16``). A user elementwise callable takes the
    user-loss route, and the cost follows on the host in the same order; so
    does a data-row shard's (the epilogue needs the whole loss)."""
    denom = _denominator(weights, X)
    norm = baseline_normalization(baseline_loss.to(X.dtype), use_baseline)
    if kernel_loss(loss_fn) is None or active_row_shard() is not None:
        loss, valid = fused_loss_program(prog, X, y, weights, nfeatures, operators, loss_fn,
                                         bf16=bf16)
        return loss / norm.to(X.dtype) + parsimony * complexity.to(X.dtype), loss, valid
    scal = torch.stack([denom.to(X.dtype), norm.to(X.dtype),
                        torch.tensor(parsimony, dtype=X.dtype, device=X.device)])
    args = _launch_inputs(prog, X, y, weights, nfeatures, operators, bf16=bf16)
    loss, valid, cost = _pick("eval", X, bf16)(*args, operators, loss_fn,
                                               cx=complexity.to(X.dtype).contiguous(), scal=scal)
    return cost, loss, valid


def fused_loss_dedup(prog: TreeProgram, X, y, weights, nfeatures: int,
                     operators: OperatorSet, loss_fn: Callable):
    """`fused_loss_program` semantics, running each distinct program once.

    Programs group by (live instruction words, used constant bits,
    nsteps) with ``torch.unique``; the first member of each group runs
    the kernel and every member takes its result through a gather. The
    kernel computes each tree independently, so the result is bit-equal
    to the plain path."""
    T, L = prog.code.shape
    CMAX = prog.cmax
    dev = prog.code.device
    live = torch.arange(L, device=dev)[None, :] < prog.nsteps[:, None]
    word = torch.where(live, (prog.code << 24) | (prog.src1 << 12) | prog.src2, 0)
    cbits = prog.cvals.to(X.dtype).contiguous()
    cbits = cbits.view(torch.int64 if cbits.dtype == torch.float64 else torch.int32)
    cused = torch.arange(CMAX, device=dev)[None, :] < prog.nconst[:, None]
    cbits = torch.where(cused, cbits, 0)
    key = torch.cat([word, cbits, prog.nsteps[:, None]], dim=1)
    _, inverse = torch.unique(key, dim=0, return_inverse=True)
    n_groups = int(inverse.max()) + 1 if T else 0
    leader = torch.full((n_groups,), T, dtype=torch.long, device=dev).scatter_reduce(
        0, inverse, torch.arange(T, device=dev), reduce="amin")
    sub = TreeProgram(*(f[leader] for f in (
        prog.code, prog.src1, prog.src2, prog.nsteps, prog.cvals, prog.cslot,
        prog.nconst, prog.const_ok)))
    loss_u, valid_u = fused_loss_program(sub, X, y, weights, nfeatures, operators, loss_fn)
    return loss_u[inverse], valid_u[inverse]


def _params_ok(trees: TreeBatch, params, class_idx):
    """[T]: every parameter a tree reads is finite for every class some row
    has, the verdict the interpreter reaches by checking each parameter
    leaf's value on every row (a non-finite value that an operator absorbs,
    as exp(-inf) = 0, would otherwise pass). Leaves read parameter
    ``clip(feat, 0, NP - 1)``."""
    T, NP, NC = params.shape
    live = torch.arange(trees.max_nodes, device=params.device) < trees.length[:, None]
    pleaf = live & (trees.arity == 0) & (trees.op == LEAF_PARAM)
    pidx = torch.clamp(trees.feat.long(), 0, NP - 1)
    used = torch.zeros((T, NP + 1), dtype=torch.bool, device=params.device)
    used = used.scatter(1, torch.where(pleaf, pidx, NP), True)[:, :NP]
    present = torch.bincount(torch.clamp(class_idx.long(), 0, NC - 1), minlength=NC) > 0
    bad = ~torch.isfinite(params) & used[:, :, None] & present[None, None, :]
    return ~bad.reshape(T, -1).any(dim=1)


def fused_loss(trees: TreeBatch, X, y, weights, operators: OperatorSet,
               loss_fn: Callable, *, params=None, class_idx=None, dedup: bool = False,
               bf16=False):
    """Mean elementwise loss per tree (batch dims kept); invalid trees get
    loss inf. ``dedup`` evaluates each distinct (structure, constants)
    program once and shares the result (bit-equal). ``bf16`` runs kernel
    1b (plain or parametric form) and takes the plain launch even with
    ``dedup``, as the JAX package does.

    Parametric members pass their banks ``params`` [..., NP, NC] and the
    dataset's ``class_idx`` [n]: parameter leaves then read
    ``params[..., p, class_idx[r]]`` per row, through the parametric form
    of the kernel (dedup does not apply to them). A tree is invalid where
    a parameter it reads is non-finite for a class some row has, as on the
    interpreter path."""
    batch_shape = trees.batch_shape
    flat = trees.reshape(-1)
    F = X.shape[0]
    NP = 0 if params is None else params.shape[-2]
    prog = compile_program(flat, F, len(operators.binary), n_params=NP)
    if NP > 0:
        p_flat = params.reshape(-1, NP, params.shape[-1])
        loss, valid = fused_loss_program(prog, X, y, weights, F, operators, loss_fn,
                                         params=p_flat, class_idx=class_idx, bf16=bf16)
        ok = _params_ok(flat, p_flat, class_idx)
        shard = active_row_shard()
        if shard is not None:   # the classes of every shard's rows
            ok = shard_all(ok, shard)
        valid = valid & ok
        loss = torch.where(valid, loss, torch.inf)
    elif dedup and not bf16:
        loss, valid = fused_loss_dedup(prog, X, y, weights, F, operators, loss_fn)
    else:
        loss, valid = fused_loss_program(prog, X, y, weights, F, operators, loss_fn, bf16=bf16)
    return loss.reshape(batch_shape), valid.reshape(batch_shape)


def fused_cost(trees: TreeBatch, X, y, weights, complexity, operators: OperatorSet,
               loss_fn: Callable, *, baseline_loss, use_baseline, parsimony,
               bf16=False):
    """(cost, loss, valid) per tree with the loss -> cost epilogue in the
    kernel: the candidate-scoring hot path of the evolve cycle (kernel 1b
    with ``bf16``)."""
    batch_shape = trees.batch_shape
    flat = trees.reshape(-1)
    F = X.shape[0]
    prog = compile_program(flat, F, len(operators.binary))
    cost, loss, valid = fused_cost_program(
        prog, X, y, weights, complexity.reshape(-1), F, operators, loss_fn,
        baseline_loss=baseline_loss, use_baseline=use_baseline, parsimony=parsimony, bf16=bf16)
    return (cost.reshape(batch_shape), loss.reshape(batch_shape),
            valid.reshape(batch_shape))


# ---------------------------------------------------------------------------
# Multi-variant entry points (the constant optimizer's line search and
# gradient; same names and semantics as the JAX package)
# ---------------------------------------------------------------------------


def _multi_inputs(prog: TreeProgram, cvals_v, X, y, weights, nfeatures: int,
                  operators: OperatorSet, bf16=False):
    """Kernel #2/#3 inputs and each pair's constant validity [T, V]."""
    instr, nsteps, _, _, Xc, yc, w = _launch_inputs(prog, X, y, weights, nfeatures, operators,
                                                    bf16=bf16)
    used = torch.arange(prog.cmax, device=X.device)[None, None, :] < prog.nconst[:, None, None]
    ok_v = torch.all(torch.isfinite(cvals_v) | ~used, dim=-1)
    return (instr, nsteps, cvals_v.to(X.dtype).contiguous(), Xc, yc, w), ok_v


def fused_loss_multi(prog: TreeProgram, cvals_v, X, y, weights, nfeatures: int,
                     operators: OperatorSet, loss_fn: Callable, *, bf16=False):
    """Mean loss for every (tree, constant-variant) pair: (loss, valid)
    [T, V] each, from one launch of kernel #2. Invalid pairs (a non-finite
    step or loss, or a non-finite used constant) get loss inf.

    ``bf16`` runs kernel 2b (a bfloat16 value buffer, float32 loss): the
    losses rank reliably but are not bit-exact, so a caller re-verifies an
    accepted point in float32 (the L-BFGS line search does, through the
    gradient kernel's loss and its descent check); ``bf16="data"`` is its
    bf16-data form. A user elementwise callable takes the user-loss route
    (kernel #4's bf16 form with ``bf16``)."""
    if kernel_loss(loss_fn) is None:
        return user_loss_multi(prog, cvals_v, X, y, weights, nfeatures, operators, loss_fn,
                               bf16=bf16)
    (instr, nsteps, cv, Xc, yc, w), ok_v = _multi_inputs(prog, cvals_v, X, y, weights,
                                                         nfeatures, operators, bf16)
    if _no_rows(X):
        loss_sum = torch.zeros(cvals_v.shape[:2], dtype=X.dtype, device=X.device)
        valid = torch.ones(cvals_v.shape[:2], dtype=torch.bool, device=X.device)
    else:
        loss_sum, valid = _pick("multi", X, bf16)(instr, nsteps, cv, Xc, yc, w, operators,
                                                  loss_fn)
    (loss_sum,), valid, denom = _row_totals([loss_sum], valid, weights, X)
    valid = valid & ok_v
    loss = loss_sum / denom
    if bf16 == "data":
        loss = _round_bf16(loss)
    loss = torch.where(valid & torch.isfinite(loss), loss, torch.inf)
    return loss, valid


def fused_grad_multi(prog: TreeProgram, cvals_v, X, y, weights, nfeatures: int,
                     operators: OperatorSet, loss_fn: Callable):
    """(loss [T, V], valid [T, V], dloss/dcvals [T, V, CMAX]) per (tree,
    constant-variant) pair, from one launch of kernel #3. A bad pair (an
    invalid one, or one whose mean loss is not finite) gets loss inf and a
    zero gradient; a non-finite gradient component becomes 0. A user
    elementwise callable takes the user-loss route."""
    if kernel_loss(loss_fn) is None:
        return user_grad_multi(prog, cvals_v, X, y, weights, nfeatures, operators, loss_fn)
    (instr, nsteps, cv, Xc, yc, w), ok_v = _multi_inputs(prog, cvals_v, X, y, weights,
                                                         nfeatures, operators)
    nconst = prog.nconst.to(torch.int32).contiguous()
    if _no_rows(X):
        loss_sum = torch.zeros(cvals_v.shape[:2], dtype=X.dtype, device=X.device)
        valid = torch.ones(cvals_v.shape[:2], dtype=torch.bool, device=X.device)
        gcomp = torch.zeros(cvals_v.shape, dtype=X.dtype, device=X.device)
    else:
        # a row shard's own last row of positive weight bounds its sums
        n_grad = X.shape[1] if weights is None else weighted_rows(weights)
        loss_sum, valid, gcomp = _pick("grad", X)(instr, nsteps, nconst, cv, Xc, yc, w,
                                                  operators, loss_fn, n_grad=n_grad)
    (loss_sum, gcomp), valid, denom = _row_totals([loss_sum, gcomp], valid, weights, X)
    valid = valid & ok_v
    loss = loss_sum / denom
    grad = gcomp / denom
    bad = ~(valid & torch.isfinite(loss))
    loss = torch.where(bad, torch.inf, loss)
    grad = torch.where(bad[..., None] | ~torch.isfinite(grad), 0.0, grad)
    return loss, valid, grad


def fused_grad_program(prog: TreeProgram, X, y, weights, nfeatures: int,
                       operators: OperatorSet, loss_fn: Callable):
    """(loss [T], valid [T], dloss/dcvals [T, CMAX]): the single-variant
    view of :func:`fused_grad_multi` (constants from ``prog.cvals``)."""
    loss, valid, grad = fused_grad_multi(prog, prog.cvals[:, None, :], X, y, weights,
                                         nfeatures, operators, loss_fn)
    return loss[:, 0], valid[:, 0], grad[:, 0]


def fused_loss_and_const_grad(trees: TreeBatch, child, X, y, weights,
                              operators: OperatorSet, loss_fn: Callable):
    """(loss, valid, dloss/dconst) per tree: the gradient with respect to
    every constant-leaf slot of ``trees.const`` (zero elsewhere, zero for
    invalid trees). ``child`` is accepted for the JAX signature and unused."""
    del child
    batch_shape = trees.batch_shape
    flat = trees.reshape(-1) if batch_shape else trees.reshape(1)
    L = flat.arity.shape[-1]
    F = X.shape[0]
    prog = compile_program(flat, F, len(operators.binary))
    loss, valid, gcomp = fused_grad_program(prog, X, y, weights, F, operators, loss_fn)
    grad = scatter_const_grads(prog, gcomp, L)
    if batch_shape:
        return (loss.reshape(batch_shape), valid.reshape(batch_shape),
                grad.reshape(*batch_shape, L))
    return loss[0], valid[0], grad[0]


# ---------------------------------------------------------------------------
# Predict entry points (template expressions; same names and semantics as
# the JAX package)
# ---------------------------------------------------------------------------


def _predict_inputs(prog: TreeProgram, X, nfeatures: int, operators: OperatorSet):
    T, L = prog.code.shape
    BASE = nfeatures + prog.cmax
    _check_packable(operators, BASE, L)
    return (_pack_instr(prog, operators, BASE + L).contiguous(),
            prog.nsteps.to(torch.int32).contiguous(), prog.cvals.to(X.dtype).contiguous(),
            X.contiguous())


def fused_predict_program(prog: TreeProgram, X, nfeatures: int, operators: OperatorSet, *,
                          plain: bool = False):
    """Per-tree row predictions (pred [T, n], valid [T]) of compiled
    programs from one launch of kernel #4. ``X`` is shared dataset columns
    [F, n] or per-member argument rows [T, F, n]; ``plain`` runs the
    kernel's plain version (the turbo-off path)."""
    if _no_rows(X):
        T = prog.code.shape[0]
        return (torch.zeros((T, 0), dtype=X.dtype, device=X.device),
                torch.ones(T, dtype=torch.bool, device=X.device))
    instr, nsteps, cvals, Xc = _predict_inputs(prog, X, nfeatures, operators)
    ok = prog.const_ok.to(torch.int32).contiguous()
    run = program_predict_plain if plain else _pick("predict", X)
    return run(instr, nsteps, cvals, ok, Xc, operators)


def fused_predict_vjp_program(prog: TreeProgram, X, ct, nfeatures: int,
                              operators: OperatorSet, *, plain: bool = False):
    """d(sum(ct * pred))/d(cvals) [T, CMAX], non-finite entries zeroed,
    and in per-member mode the raw d/dX [T, F, n] (None for shared X), from
    one launch of kernel #5 (none over zero rows)."""
    if _no_rows(X):
        gcomp = torch.zeros((prog.code.shape[0], prog.cmax), dtype=X.dtype, device=X.device)
        return gcomp, (torch.zeros_like(X) if X.dim() == 3 else None)
    instr, nsteps, cvals, Xc = _predict_inputs(prog, X, nfeatures, operators)
    nconst = prog.nconst.to(torch.int32).contiguous()
    run = program_predict_vjp_plain if plain else _pick("vjp", X)
    gcomp, gx = run(instr, nsteps, nconst, cvals, Xc, ct.to(X.dtype).contiguous(), operators)
    return torch.where(torch.isfinite(gcomp), gcomp, 0.0), gx


def fused_predict(trees: TreeBatch, X, operators: OperatorSet):
    """Per-tree predictions over all rows of shared ``X`` [F, n]: (pred
    [..., n], valid [...]) with the TreeBatch's batch dims. Validity is the
    interpreter's: a non-finite step output on any row, or a non-finite
    constant, invalidates the tree."""
    batch_shape = trees.batch_shape
    flat = trees.reshape(-1)
    F, n = X.shape
    prog = compile_program(flat, F, len(operators.binary))
    pred, valid = fused_predict_program(prog, X, F, operators)
    return pred.reshape(*batch_shape, n), valid.reshape(batch_shape)


class _PredictAD(torch.autograd.Function):
    """Kernel #4 forward, kernel #5 backward. The program compiled by the
    forward is kept on ``ctx`` for the backward."""

    @staticmethod
    def forward(ctx, const, X, trees: TreeBatch, operators: OperatorSet, plain: bool):
        F = X.shape[-2]
        prog = compile_program(TreeBatch(trees.arity, trees.op, trees.feat, const, trees.length),
                               F, len(operators.binary))
        pred, valid = fused_predict_program(prog, X, F, operators, plain=plain)
        ctx.prog, ctx.operators, ctx.plain, ctx.L = prog, operators, plain, trees.max_nodes
        ctx.save_for_backward(X)
        ctx.mark_non_differentiable(valid)
        return pred, valid

    @staticmethod
    def backward(ctx, ct_pred, _ct_valid):
        (X,) = ctx.saved_tensors
        gcomp, gx = fused_predict_vjp_program(ctx.prog, X, ct_pred, X.shape[-2], ctx.operators,
                                              plain=ctx.plain)
        gconst = scatter_const_grads(ctx.prog, gcomp, ctx.L) if ctx.needs_input_grad[0] else None
        gX = None
        if ctx.needs_input_grad[1]:
            gX = gx if gx is not None else torch.zeros_like(X)
        return gconst, gX, None, None, None


def fused_predict_ad(trees: TreeBatch, X, operators: OperatorSet, *, plain: bool = False):
    """`fused_predict` differentiable by ``torch.autograd``: (pred [T, n],
    valid [T]) for flat [T, L] trees. Gradients flow into ``trees.const``
    (kernel #5, scattered to slot order); per-member ``X`` [T, F, n]
    receives its row cotangents, shared ``X`` [F, n] zeros; ``valid`` takes
    no gradient. ``plain`` runs the kernels' plain versions."""
    return _PredictAD.apply(trees.const, X, trees, operators, plain)


# ---------------------------------------------------------------------------
# User elementwise losses: kernel #4's predictions, the callable in PyTorch
# (the JAX package traces the callable into kernels #1-#3, :466, :805 and
# the VJP at :1187-1193)
# ---------------------------------------------------------------------------

#: Bytes one chunk of the user-loss route may take: its [rows, n]
#: predictions and the loss's temporaries, about _USER_LOSS_TEMPS tensors
#: of that size (the elementwise loss, the masked and weighted terms, and
#: under autograd their gradients).
USER_LOSS_CHUNK_BYTES = 1 << 30
_USER_LOSS_TEMPS = 6


class _RowsPredictAD(torch.autograd.Function):
    """Kernel #4 forward and kernel #5 backward over packed program rows,
    differentiable in their compressed constants ``cvals`` [R, CMAX]
    (``fused_predict_ad`` in the optimizer's constant space)."""

    @staticmethod
    def forward(ctx, cvals, instr, nsteps, nconst, ok, X, operators, plain):
        run = program_predict_plain if plain else _pick("predict", X)
        pred, valid = run(instr, nsteps, cvals, ok, X, operators)
        ctx.save_for_backward(instr, nsteps, nconst, cvals, X)
        ctx.operators, ctx.plain = operators, plain
        ctx.mark_non_differentiable(valid)
        return pred, valid

    @staticmethod
    def backward(ctx, ct_pred, _ct_valid):
        instr, nsteps, nconst, cvals, X = ctx.saved_tensors
        run = program_predict_vjp_plain if ctx.plain else _pick("vjp", X)
        gcomp, _ = run(instr, nsteps, nconst, cvals, X, ct_pred.contiguous(), ctx.operators)
        return gcomp, None, None, None, None, None, None, None


def _user_loss_sum(pred, y, w, loss_fn):
    """sum_r w_r * loss_fn(pred, y)_r over the rows, zero-weight rows inert."""
    elt = loss_fn(pred, y)
    return torch.sum(torch.where(w > 0, elt, 0.0) * w, dim=-1)


def _user_route(prog: TreeProgram, cv, ok, tree, X, y, weights, nfeatures: int,
                operators: OperatorSet, loss_fn: Callable, grad: bool, plain: bool = False,
                params=None, class_idx=None, bf16=False):
    """(loss [R], valid [R], dloss/dcv [R, CMAX] or None) of R program rows:
    row r is tree ``tree[r]`` with constants ``cv[r]`` and constant
    validity ``ok[r]``. The rows run in chunks of at most
    USER_LOSS_CHUNK_BYTES: kernel #4 predicts, ``loss_fn`` takes the
    predictions, and with ``grad`` kernel #5 runs in the backward of
    ``torch.autograd`` through it, the rows' cotangents zeroed where the
    weight is 0 (as the JAX kernel masks its loss VJP). The kernels'
    contract follows: a row whose steps, loss sum or mean are not finite
    is invalid, with loss inf and a zero gradient; a non-finite gradient
    component becomes 0. ``plain`` runs the kernels' plain versions.

    The forms: X's dtype (float32, or float64 on #4's and #5's ``double``
    forms); parametric rows (``params`` [R, NP, NC] by row, the program
    compiled with ``n_params = NP``) predict on #4's per-member form, each
    row's X block carrying its parameter rows by class after the features;
    ``bf16`` predicts on #4's bf16 form (a bf16 value buffer, float32
    steps) and the loss takes the predictions in X's dtype (rounded to bf16
    with ``bf16="data"``). The gradient stays on the float forms of #4 and
    #5, as kernel #3 computes a bf16 search's gradient."""
    NP = 0 if params is None else params.shape[1]
    nf = nfeatures + NP
    instr, nsteps, _, Xc = _predict_inputs(prog, X, nf, operators)
    nconst = prog.nconst.to(torch.int32)
    n = X.shape[1]
    w = (torch.ones(n, dtype=X.dtype, device=X.device) if weights is None
         else weights.to(X.dtype).contiguous())
    R = cv.shape[0]
    pb16 = bool(bf16) and not grad
    cdt = torch.float32 if pb16 else X.dtype
    Xk = (_bf16_rows(Xc) if pb16 else Xc)
    cls = None if params is None else torch.clamp(class_idx.long(), 0, params.shape[-1] - 1)
    per_row = X.element_size() * (_USER_LOSS_TEMPS + NP + (nfeatures if NP else 0))
    step = max(1, USER_LOSS_CHUNK_BYTES // (per_row * max(n, 1)))
    spine = _round_bf16 if bf16 == "data" else (lambda v: v)
    sums, valids, grads = [], [], []
    for s in range(0, R if n else 0, step):
        t = tree[s:s + step]
        args = (instr[t].contiguous(), nsteps[t].contiguous(), nconst[t].contiguous(),
                ok[s:s + step].to(torch.int32).contiguous())
        c = cv[s:s + step].to(cdt).contiguous()
        Xr = Xk
        if params is not None:
            prow = params[s:s + step][:, :, cls].to(Xk.dtype)
            Xr = torch.cat([Xk[None].expand(prow.shape[0], -1, -1), prow], dim=1).contiguous()
        if not grad:
            run = program_predict_plain if plain else _pick("predict", X, pb16)
            if plain:
                pred, valid = run(args[0], args[1], c, args[3], Xr, operators, bf16=pb16)
            else:
                pred, valid = run(args[0], args[1], c, args[3], Xr, operators)
            sums.append(spine(_user_loss_sum(pred.to(X.dtype), y, w, loss_fn)))
            valids.append(valid)
            continue
        with torch.enable_grad():
            c = c.detach().requires_grad_(True)
            pred, valid = _RowsPredictAD.apply(c, *args, Xr, operators, plain)
            pred.register_hook(lambda g: torch.where(w > 0, g, 0.0))
            total = _user_loss_sum(pred, y, w, loss_fn)
            (g,) = torch.autograd.grad(total.sum(), c)
        sums.append(total.detach())
        valids.append(valid)
        grads.append(g)
    if not sums:   # no rows, or no programs: zero partials, all valid
        sums = [torch.zeros(R, dtype=X.dtype, device=X.device)]
        valids = [torch.ones(R, dtype=torch.bool, device=X.device)]
        grads = [torch.zeros((R, cv.shape[1]), dtype=X.dtype, device=X.device)]
    total = torch.cat(sums)
    valid = torch.cat(valids) & torch.isfinite(total)
    parts = [total, torch.cat(grads)] if grad else [total]
    parts, valid, denom = _row_totals(parts, valid, weights, X)
    total = parts[0]
    loss = spine(total / denom)
    bad = ~(valid & torch.isfinite(loss))
    loss = torch.where(bad, torch.inf, loss)
    if not grad:
        return loss, valid, None
    g = parts[1] / denom
    return loss, valid, torch.where(bad[:, None] | ~torch.isfinite(g), 0.0, g)


def user_loss_program(prog: TreeProgram, X, y, weights, nfeatures: int,
                      operators: OperatorSet, loss_fn: Callable, *, plain: bool = False,
                      params=None, class_idx=None, bf16=False):
    """`fused_loss_program` for a user elementwise callable ``loss_fn``:
    (loss [T], valid [T]) by kernel #4's predictions and the callable
    (``plain``: its plain version); parametric programs pass ``params``
    [T, NP, NC] and ``class_idx``, a bf16 search ``bf16``."""
    T = prog.code.shape[0]
    tree = torch.arange(T, device=X.device)
    loss, valid, _ = _user_route(prog, prog.cvals, prog.const_ok, tree, X, y, weights,
                                 nfeatures, operators, loss_fn, grad=False, plain=plain,
                                 params=params, class_idx=class_idx, bf16=bf16)
    return loss, valid


def _pair_rows(prog: TreeProgram, cvals_v):
    """Rows of every (tree, variant) pair: constants [T * V, CMAX], their
    validity (every used constant finite) and each row's tree."""
    T, V, CM = cvals_v.shape
    used = torch.arange(CM, device=cvals_v.device)[None, None, :] < prog.nconst[:, None, None]
    ok = torch.all(torch.isfinite(cvals_v) | ~used, dim=-1)
    tree = torch.arange(T, device=cvals_v.device).repeat_interleave(V)
    return cvals_v.reshape(T * V, CM), ok.reshape(T * V), tree


def user_loss_multi(prog: TreeProgram, cvals_v, X, y, weights, nfeatures: int,
                    operators: OperatorSet, loss_fn: Callable, *, plain: bool = False,
                    bf16=False):
    """`fused_loss_multi` for a user elementwise callable: (loss, valid)
    [T, V] of every (tree, constant-variant) pair, by kernel #4 (its bf16
    form with ``bf16``)."""
    T, V, _ = cvals_v.shape
    cv, ok, tree = _pair_rows(prog, cvals_v)
    loss, valid, _ = _user_route(prog, cv, ok, tree, X, y, weights, nfeatures, operators,
                                 loss_fn, grad=False, plain=plain, bf16=bf16)
    return loss.reshape(T, V), valid.reshape(T, V)


def user_grad_multi(prog: TreeProgram, cvals_v, X, y, weights, nfeatures: int,
                    operators: OperatorSet, loss_fn: Callable, *, plain: bool = False):
    """`fused_grad_multi` for a user elementwise callable: (loss [T, V],
    valid [T, V], dloss/dcvals [T, V, CMAX]), kernel #4 forward and #5
    backward under ``torch.autograd`` through the callable."""
    T, V, CM = cvals_v.shape
    cv, ok, tree = _pair_rows(prog, cvals_v)
    loss, valid, grad = _user_route(prog, cv, ok, tree, X, y, weights, nfeatures, operators,
                                    loss_fn, grad=True, plain=plain)
    return loss.reshape(T, V), valid.reshape(T, V), grad.reshape(T, V, CM)
