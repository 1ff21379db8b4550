"""Fused program evaluation: the interpreter kernel and its wrappers.

Port of the program-kernel part of ``symbolicregression_jl_tpu/ops/fused_eval.py``
(``_program_launch`` / ``_make_program_kernel``). A TreeBatch compiles to a
leaf-free program (ops/program.py); :func:`_pack_instr` packs each step into
one int32 word ``sign << 30 | code << 24 | src1 << 12 | src2`` with the same
dispatch layout as the JAX package (``_dispatch_plan``), and the kernel in
``csrc/program_eval.cu`` runs every program over every row, returning the
per-tree loss and validity, optionally with the loss -> cost epilogue.

:data:`PROGRAM_EVAL` is the kernel's wrapper. Given tensors on the CPU it
runs :func:`program_eval_plain`, the eager PyTorch version of the same
function (the CPU path and the kernel's test oracle); given CUDA tensors
it launches the kernel or raises, never falling back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Tuple

import torch

from ..core.losses import LOSS_REGISTRY, baseline_normalization, l1_dist_loss, l2_dist_loss
from .encoding import TreeBatch
from .operators import OPERATOR_REGISTRY, OperatorSet
from .program import TreeProgram, compile_program

__all__ = ["PROGRAM_EVAL", "fused_loss", "fused_loss_program", "fused_loss_dedup",
           "fused_cost", "fused_cost_program", "program_eval_plain",
           "supports_fused_eval"]


def supports_fused_eval(operators: OperatorSet) -> bool:
    """The kernel handles arity <= 2 operator sets."""
    return all(d in (1, 2) for d in operators.ops.keys())


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


def program_eval_plain(instr, nsteps, cvals, const_ok, X, y, w, operators: OperatorSet,
                       loss_fn: Callable, cx=None, scal=None, max_elems: int = 1 << 26):
    """Eager version of the kernel: an explicit loop over program steps on
    [trees, rows] tensors with the kernel's masking and reduction.

    Returns (loss_sum, valid) for the plain form, or (loss, valid, cost)
    with the cost epilogue when ``cx`` [T] and ``scal`` [3] are given.
    Trees run in chunks of at most ``max_elems`` buffer elements."""
    plan = _dispatch_plan(operators)
    T, L = instr.shape
    F, n = X.shape
    CMAX = cvals.shape[1]
    BASE = F + CMAX
    nbuf = BASE + L + 1
    dev = X.device
    branches = _branches(operators)
    code_mask = 0x3F if plan.merged else 0x7F
    chunk = max(1, max_elems // max(nbuf * n, 1))
    loss_parts, valid_parts = [], []
    for s in range(0, T, chunk):
        ins = instr[s:s + chunk]
        m = nsteps[s:s + chunk].long()
        Tc = ins.shape[0]
        rows = torch.arange(Tc, device=dev)
        buf = torch.zeros((Tc, nbuf, n), dtype=X.dtype, device=dev)
        buf[:, :F] = X
        buf[:, F:BASE] = cvals[s:s + chunk, :, None]
        vmask = torch.ones((Tc, n), dtype=torch.bool, device=dev)
        kmax = int(m.max()) if Tc else 0
        for k in range(kmax):
            word = ins[:, k]
            code = (word >> 24) & code_mask
            i1 = ((word >> 12) & 0xFFF).long()
            i2 = (word & 0xFFF).long()
            sign = (word >> 30) & 1
            a = buf[rows, i1]
            b = buf[rows, i2]
            val = None
            for c in torch.unique(code).tolist():
                v = branches[c](a, b, sign)
                val = v if val is None else torch.where((code == c)[:, None], v, val)
            active = k < m
            buf[:, BASE + k] = val
            vmask &= torch.isfinite(val) | ~active[:, None]
        pred = buf[rows, BASE + m - 1]
        elt = loss_fn(pred, y)
        elt = torch.where(w > 0, elt, 0.0)
        total = torch.sum(elt * w, dim=-1)
        valid = vmask.all(dim=-1) & torch.isfinite(total) & (const_ok[s:s + chunk] != 0)
        loss_parts.append(total)
        valid_parts.append(valid)
    total = torch.cat(loss_parts) if loss_parts else torch.zeros(0, dtype=X.dtype, device=dev)
    valid = torch.cat(valid_parts) if valid_parts else torch.zeros(0, dtype=torch.bool, device=dev)
    if cx is None:
        return total, valid
    mean = total / scal[0]
    loss = torch.where(valid & torch.isfinite(mean), mean, torch.inf)
    cost = loss / scal[1] + scal[2] * cx
    return loss, valid, cost


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper
# ---------------------------------------------------------------------------

# Operator ids of csrc/program_eval.cu, by canonical operator name.
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

# Elementwise losses the kernel implements (identity of the function).
_KERNEL_LOSS = {
    l2_dist_loss: 0,
    l1_dist_loss: 1,
    LOSS_REGISTRY["HuberLoss"]: 2,
    LOSS_REGISTRY["huber"]: 2,
}

_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use


def _kernel_op_id(op) -> int:
    builtin = OPERATOR_REGISTRY.get(op.name)
    if builtin is None or builtin.fn is not op.fn or op.name not in _KERNEL_OP_IDS:
        raise NotImplementedError(
            f"operator {op.name!r} is not a built-in operator; the CUDA "
            f"interpreter kernel runs built-in operators only")
    return _KERNEL_OP_IDS[op.name]


@functools.lru_cache(maxsize=None)
def _optab_list(operators: OperatorSet) -> Tuple[int, ...]:
    """Kernel dispatch table: ``kind << 8 | op id`` per merged opcode."""
    plan = _dispatch_plan(operators)
    tab = []
    if plan.merged:
        tab.append(_K_ADDSUB << 8)
        for j in plan.other_bin:
            tab.append(_K_BINARY << 8 | _kernel_op_id(operators.binary[j]))
    else:
        tab.append(_K_IDENTITY << 8)
        for op in operators.binary:
            tab.append(_K_BINARY << 8 | _kernel_op_id(op))
    for op in operators.unary:
        tab.append(_K_UNARY << 8 | _kernel_op_id(op))
    return tuple(tab)


class ProgramEvalKernel:
    """Wrapper of ``sr_program_eval`` (csrc/program_eval.cu).

    ``launches`` counts kernel launches; it is incremented where the
    kernel is launched and nowhere else."""

    name = "program_eval"
    source = "symbolicregression_jl_tpu_torch/csrc/program_eval.cu"
    replaces = "symbolicregression_jl_tpu/ops/fused_eval.py:505 (_program_launch / _make_program_kernel)"

    def __init__(self):
        self.launches = 0
        self._lib = None
        self._optab = {}

    def library(self):
        """Build (at first use) and bind the shared library."""
        if self._lib is None:
            from .cuda_build import load_library

            lib = load_library("program_eval.cu")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.sr_program_eval.argtypes = [p] * 10 + [i] * 9 + [p, p, p, p]
            lib.sr_program_eval.restype = ctypes.c_int
            lib.sr_program_eval_smem.argtypes = [i, i, i, i]
            lib.sr_program_eval_smem.restype = ctypes.c_size_t
            self._lib = lib
        return self._lib

    def _block(self, L: int, CMAX: int, F: int) -> int:
        lib = self.library()
        for block in (256, 128, 64, 32):
            if lib.sr_program_eval_smem(block, L, CMAX, F) <= _SMEM_LIMIT:
                return block
        raise ValueError(f"{F} features and {L} steps do not fit one block's shared memory")

    def _device_optab(self, operators: OperatorSet, device) -> torch.Tensor:
        key = (operators, str(device))
        tab = self._optab.get(key)
        if tab is None:
            tab = torch.tensor(_optab_list(operators), dtype=torch.int32, device=device)
            self._optab[key] = tab
        return tab

    def __call__(self, instr, nsteps, cvals, const_ok, X, y, w, operators: OperatorSet,
                 loss_fn: Callable, cx=None, scal=None):
        if X.device.type == "cpu":
            return program_eval_plain(instr, nsteps, cvals, const_ok, X, y, w,
                                      operators, loss_fn, cx=cx, scal=scal)
        if X.device.type != "cuda":
            raise ValueError(f"program_eval: unsupported device {X.device}")
        loss_kind = _KERNEL_LOSS.get(loss_fn)
        if loss_kind is None:
            raise NotImplementedError(
                "the CUDA interpreter kernel implements the L2, L1 and Huber "
                "elementwise losses only")
        T, L = instr.shape
        F, n = X.shape
        CMAX = cvals.shape[1]
        cost_form = cx is not None
        named = dict(instr=instr, nsteps=nsteps, cvals=cvals, const_ok=const_ok,
                     X=X, y=y, w=w)
        if cost_form:
            named.update(cx=cx, scal=scal)
        for nm, t in named.items():
            if t.device != X.device:
                raise ValueError(f"program_eval: {nm} is on {t.device}, X on {X.device}")
            if not t.is_contiguous():
                raise ValueError(f"program_eval: {nm} must be contiguous")
        for nm in ("instr", "nsteps", "const_ok"):
            if named[nm].dtype != torch.int32:
                raise TypeError(f"program_eval: {nm} must be int32")
        for nm in ("cvals", "X", "y", "w") + (("cx", "scal") if cost_form else ()):
            if named[nm].dtype != torch.float32:
                raise TypeError(f"program_eval: {nm} must be float32")
        if (nsteps.shape != (T,) or const_ok.shape != (T,) or cvals.shape[0] != T
                or y.shape != (n,) or w.shape != (n,)
                or (cost_form and (cx.shape != (T,) or scal.shape != (3,)))):
            raise ValueError("program_eval: inconsistent shapes")
        plan = _dispatch_plan(operators)
        _check_packable(operators, F + CMAX, L)
        optab = self._device_optab(operators, X.device)
        block = self._block(L, CMAX, F)
        loss = torch.empty(T, dtype=torch.float32, device=X.device)
        valid = torch.empty(T, dtype=torch.int32, device=X.device)
        cost = torch.empty(T, dtype=torch.float32, device=X.device) if cost_form else None
        ptr = lambda t: ctypes.c_void_p(t.data_ptr()) if t is not None else None
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = self.library().sr_program_eval(
            ptr(instr), ptr(nsteps), ptr(cvals), ptr(const_ok), ptr(X), ptr(y), ptr(w),
            ptr(cx), ptr(scal), ptr(optab), T, L, CMAX, F, n, block, loss_kind,
            0x3F if plan.merged else 0x7F, 30, ptr(loss), ptr(valid), ptr(cost),
            ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"program_eval kernel launch failed: CUDA error {rc}")
        self.launches += 1
        if cost_form:
            return loss, valid.bool(), cost
        return loss, valid.bool()


PROGRAM_EVAL = ProgramEvalKernel()


# ---------------------------------------------------------------------------
# Entry points (same names and semantics as the JAX package)
# ---------------------------------------------------------------------------


def _launch_inputs(prog: TreeProgram, X, y, weights, nfeatures: int,
                   operators: OperatorSet):
    T, L = prog.code.shape
    CMAX = prog.cmax
    n = X.shape[1]
    BASE = nfeatures + CMAX
    _check_packable(operators, BASE, L)
    instr = _pack_instr(prog, operators, BASE + L).contiguous()
    w = (torch.ones(n, dtype=X.dtype, device=X.device) if weights is None
         else weights.to(X.dtype).contiguous())
    return (instr, prog.nsteps.to(torch.int32).contiguous(),
            prog.cvals.to(X.dtype).contiguous(),
            prog.const_ok.to(torch.int32).contiguous(),
            X.contiguous(), y.contiguous(), w)


def _denominator(weights, X):
    n = X.shape[1]
    if weights is None:
        return torch.tensor(float(n), dtype=X.dtype, device=X.device)
    return torch.sum(weights.to(X.dtype))


def fused_loss_program(prog: TreeProgram, X, y, weights, nfeatures: int,
                       operators: OperatorSet, loss_fn: Callable):
    """Mean elementwise loss per compiled program (flat [T]); invalid
    programs get loss inf. Returns (loss, valid)."""
    args = _launch_inputs(prog, X, y, weights, nfeatures, operators)
    loss_sum, valid = PROGRAM_EVAL(*args, operators, loss_fn)
    loss = loss_sum / _denominator(weights, X)
    loss = torch.where(valid & torch.isfinite(loss), loss, torch.inf)
    return loss, valid


def fused_cost_program(prog: TreeProgram, X, y, weights, complexity, nfeatures: int,
                       operators: OperatorSet, loss_fn: Callable, *, baseline_loss,
                       use_baseline, parsimony):
    """(cost, loss, valid) per compiled program, the cost computed in the
    kernel's epilogue with ``core.losses.loss_to_cost``'s operation order."""
    denom = _denominator(weights, X)
    norm = baseline_normalization(baseline_loss.to(X.dtype), use_baseline)
    scal = torch.stack([denom.to(X.dtype), norm.to(X.dtype),
                        torch.tensor(parsimony, dtype=X.dtype, device=X.device)])
    args = _launch_inputs(prog, X, y, weights, nfeatures, operators)
    loss, valid, cost = PROGRAM_EVAL(*args, operators, loss_fn,
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
    cbits = prog.cvals.to(torch.float32).contiguous().view(torch.int32)
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


def fused_loss(trees: TreeBatch, X, y, weights, operators: OperatorSet,
               loss_fn: Callable, *, dedup: bool = False):
    """Mean elementwise loss per tree (batch dims kept); invalid trees get
    loss inf. ``dedup`` evaluates each distinct (structure, constants)
    program once and shares the result (bit-equal)."""
    batch_shape = trees.batch_shape
    flat = trees.reshape(-1)
    F = X.shape[0]
    prog = compile_program(flat, F, len(operators.binary))
    if dedup:
        loss, valid = fused_loss_dedup(prog, X, y, weights, F, operators, loss_fn)
    else:
        loss, valid = fused_loss_program(prog, X, y, weights, F, operators, loss_fn)
    return loss.reshape(batch_shape), valid.reshape(batch_shape)


def fused_cost(trees: TreeBatch, X, y, weights, complexity, operators: OperatorSet,
               loss_fn: Callable, *, baseline_loss, use_baseline, parsimony):
    """(cost, loss, valid) per tree with the loss -> cost epilogue in the
    kernel: the candidate-scoring hot path of the evolve cycle."""
    batch_shape = trees.batch_shape
    flat = trees.reshape(-1)
    F = X.shape[0]
    prog = compile_program(flat, F, len(operators.binary))
    cost, loss, valid = fused_cost_program(
        prog, X, y, weights, complexity.reshape(-1), F, operators, loss_fn,
        baseline_loss=baseline_loss, use_baseline=use_baseline, parsimony=parsimony)
    return (cost.reshape(batch_shape), loss.reshape(batch_shape),
            valid.reshape(batch_shape))
