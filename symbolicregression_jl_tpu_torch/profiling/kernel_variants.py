"""A/B kernel-structure variants of the program interpreter, on the card.

Port of the repo's ``profiling/kernel_variants.py``. It times copies of the
legacy interpreter of kernel #1 (a buffer row per step, every step stored,
the opcode switch over the unmerged codes), each with one mechanism changed,
so that the difference in ns/step prices that mechanism on the H100:

  base       the legacy switch (identity, binary, unary codes), steps in pairs
  noswitch   every step a + b on its operands (loop, loads, store, track)
  static     a + b of buffer rows 0 and 1 (no operand addressing either)
  nostore    noswitch storing to one row (the floor without per-step stores)
  novmask    base without the finiteness track
  cond2      two-level dispatch: class, then operator
  signmerge  + and - in one case by a sign bit (exact)
  muldiv     signmerge plus * and / in one case, a * (1 / b) (two roundings)
  opgroup    muldiv plus every unary computed, one selected by a 3-bit index
  nounroll   one step per loop turn
  tb16/tb32  16 or 32 trees a block share each tile of X
  cvec       the constants staged once per block, stored from there
  custatic   CMAX unrolled constant stores (no nconst)
  bf16       a bf16 value buffer, one step per turn
  combo      signmerge + nounroll + tb16

and the shipped kernel's rows (they add no kernel):

  prod       ``fused_loss_program`` (#1), every row
  prodbf16   the same with a bf16 buffer (1b)
  screen[D]  #1 on the strided 1/D row sample (default D = 8)

The kernel is ``csrc/program_variants.cu`` (:data:`PROGRAM_VARIANTS`); on
CPU tensors its wrapper runs :func:`loss_variant_plain`, the plain PyTorch
version of every variant, and times then are the host's.

    python -m symbolicregression_jl_tpu_torch.profiling.kernel_variants [T] [which...]
        [--device DEV]

T trees (8,192) of ``STEPS`` steps (the environment's, 8) from
:func:`synth_program` over the bench problem's 10,000 rows x 5
(``_common.make_bench_problem``); one warm-up and 30 timed launches a row
(CUDA events on the card), each launch's constants raised by the previous
launch's smallest finite loss times 1e-30 so that the launches form a
chain. Each row prints ms/launch, trees/s, ns/step, its check against base
(``loss==base``, ``loss~=base@1e-3``; on the card ``bits==base`` for the
exact variants), the bound (T x steps x rows FP32 operations at 67 TFLOP/s)
and the card's name and power limit. Exits 1 when a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import os
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..core.losses import LOSS_L2, kernel_loss
from ..device import resolve_device
from ..ops.fused_eval import _KERNEL_OP_IDS, fused_loss_program, strided_sample_indices
from ..ops.operators import OperatorSet
from ..ops.program import TreeProgram

__all__ = ["VARIANTS", "VARIANT_IDS", "EXACT", "APPROX", "ROWS", "PROGRAM_VARIANTS",
           "synth_program", "pack_words", "op_table", "loss_variant", "loss_variant_plain",
           "approx_deviation", "harness", "main"]

# csrc/program_variants.cu's variant ids.
VARIANT_IDS = {"base": 0, "noswitch": 1, "static": 2, "nostore": 3, "novmask": 4, "cond2": 5,
               "signmerge": 6, "muldiv": 7, "opgroup": 8, "nounroll": 9, "cvec": 10,
               "custatic": 11, "bf16": 12, "combo": 13}
VARIANTS = tuple(VARIANT_IDS)
# The variants that give base's bits, and the two that round a / b as a * (1 / b).
EXACT = ("cond2", "signmerge", "nounroll", "cvec", "custatic", "combo")
APPROX = ("muldiv", "opgroup")
# Every row of the harness: the variants, the tree blocks, the shipped kernel.
ROWS = ("base", "noswitch", "static", "nostore", "novmask", "cond2", "signmerge", "muldiv",
        "opgroup", "nounroll", "tb16", "tb32", "cvec", "custatic", "bf16", "combo", "prod",
        "prodbf16", "screen")
# The JAX script's default rows.
DEFAULT_ROWS = ("base", "noswitch", "novmask", "cond2", "signmerge", "muldiv", "opgroup",
                "nounroll", "tb16", "tb32", "prod", "prodbf16", "screen")

H100_FP32_FLOPS = 67e12     # non-tensor-core FP32 peak, H100 SXM data sheet
BENCH_BINARY = ("+", "-", "*", "/")
BENCH_UNARY = ("exp", "abs", "cos")
_OPX_ADDSUB, _OPX_IDENT, _OPX_NAN, _OPX_MULDIV, _OPX_UGROUP = 16, 17, 18, 19, 20
_VOPS = 128
_UNPAIRED = ("nounroll", "combo", "bf16")
# The TPU kernel's bf16 finiteness test: |v| <= bf16(3.38e38) (0x7F7E).
_BF16_FIN = float(torch.tensor(3.38e38).to(torch.bfloat16))


def _round_bf16(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).to(torch.float32)


def synth_program(T: int, S: int, L: int, F: int, CMAX: int, n_codes: int, seed: int = 0,
                  device=None) -> TreeProgram:
    """Random valid TreeProgram with exactly S steps per tree: the JAX
    script's draws from numpy's ``default_rng(seed)``, so its arrays are
    bit-equal. ``device``: None means the card."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    BASE = F + CMAX
    code = np.zeros((T, L), np.int32)
    src1 = np.zeros((T, L), np.int32)
    src2 = np.zeros((T, L), np.int32)
    code[:, :S] = rng.integers(1, n_codes, (T, S))
    for k in range(S):
        hi = BASE + k
        src1[:, k] = rng.integers(0, hi, T)
        src2[:, k] = rng.integers(0, hi, T)
    ncon = np.full((T,), CMAX, np.int32)
    cvals = rng.uniform(0.5, 1.5, (T, CMAX)).astype(np.float32)
    cslot = np.tile(np.arange(CMAX, dtype=np.int32), (T, 1))
    t = lambda a: torch.as_tensor(a, device=dev)
    return TreeProgram(code=t(code), src1=t(src1), src2=t(src2),
                       nsteps=torch.full((T,), S, dtype=torch.int32, device=dev),
                       cvals=t(cvals), cslot=t(cslot), nconst=t(ncon),
                       const_ok=torch.ones(T, dtype=torch.bool, device=dev))


def _names(ops) -> Tuple[str, ...]:
    return tuple(op.name for op in ops)


def _check_variant(operators: OperatorSet, variant: str) -> None:
    """The operator set a variant's remap or fixed operator assumes (the JAX
    script's remaps read the bench set's codes by position)."""
    if variant not in VARIANT_IDS:
        raise ValueError(f"unknown variant {variant!r}; one of {', '.join(VARIANTS)}")
    binary, unary = _names(operators.binary), _names(operators.unary)
    if variant in ("signmerge", "combo", "muldiv", "opgroup") and binary != BENCH_BINARY:
        raise ValueError(f"variant {variant} remaps the codes of the binary operators "
                         f"{' '.join(BENCH_BINARY)} in that order; the operator set has "
                         f"{' '.join(binary) or 'none'}")
    if variant == "opgroup" and unary != BENCH_UNARY:
        raise ValueError(f"variant opgroup groups the unary operators {' '.join(BENCH_UNARY)} "
                         f"in that order; the operator set has {' '.join(unary) or 'none'}")
    if variant in ("noswitch", "static", "nostore") and binary[:1] != ("+",):
        raise ValueError(f"variant {variant} computes binary operator 0 as +; the operator "
                         f"set's is {binary[0] if binary else 'missing'}")


def pack_words(prog: TreeProgram, variant: str) -> torch.Tensor:
    """[T, L] int32 words of ``variant``: the legacy ``code << 24 | src1 <<
    12 | src2``, or the JAX script's remaps: signmerge and combo put + and -
    on code 1 with the sign in bit 30 (* -> 2, / -> 3, unary from 4);
    muldiv and opgroup put * and / on code 2 with the div bit 29 (unary from
    3, or all on 3 with the unary index in bits 26-28 for opgroup)."""
    o, s1, s2 = prog.code.to(torch.int32), prog.src1.to(torch.int32), prog.src2.to(torch.int32)
    low = (s1 << 12) | s2
    if variant in ("signmerge", "combo"):
        is_sub = (o == 2).to(torch.int32)
        o2 = torch.where(o <= 2, torch.clamp(o, max=1), o - 1)
        return ((is_sub << 30) | (o2 << 24) | low).to(torch.int32)
    if variant in ("muldiv", "opgroup"):
        is_sub = (o == 2).to(torch.int32)
        is_div = (o == 4).to(torch.int32)
        if variant == "muldiv":
            o2 = torch.where(o <= 2, torch.clamp(o, max=1), torch.where(o <= 4, 2, o - 2))
            uidx = torch.zeros_like(o)
        else:
            o2 = torch.where(o <= 2, torch.clamp(o, max=1), torch.where(o <= 4, 2, 3))
            uidx = torch.clamp(o - 5, min=0)
        return ((is_sub << 30) | (is_div << 29) | (uidx << 26) | (o2 << 24) | low).to(torch.int32)
    return ((o << 24) | low).to(torch.int32)


def op_table(operators: OperatorSet, variant: str) -> List[int]:
    """The kernel's code -> operator table of ``variant`` (interp.cuh's
    operator ids; 16 the merged add/sub, 17 identity, 18 NaN, 19 the
    reciprocal-select multiply, 20 the grouped unary), 128 entries."""
    binary = [_KERNEL_OP_IDS[op.name] for op in operators.binary]
    unary = [_KERNEL_OP_IDS[op.name] for op in operators.unary]
    if variant in ("signmerge", "combo"):
        tab = [_OPX_IDENT, _OPX_ADDSUB, binary[2], binary[3]] + unary
    elif variant == "muldiv":
        tab = [_OPX_IDENT, _OPX_ADDSUB, _OPX_MULDIV] + unary
    elif variant == "opgroup":
        tab = [_OPX_IDENT, _OPX_ADDSUB, _OPX_MULDIV, _OPX_UGROUP]
    else:
        tab = [_OPX_IDENT] + binary + unary
    if len(tab) > _VOPS:
        raise ValueError(f"{len(tab)} codes do not fit the kernel's table of {_VOPS}")
    return tab + [_OPX_NAN] * (_VOPS - len(tab))


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _branches(operators: OperatorSet, variant: str) -> List[Callable]:
    """(code -> fn(a, b, word)) of ``variant``'s words, with the operator
    set's own functions."""
    binary = [op.fn for op in operators.binary]
    unary = [op.fn for op in operators.unary]
    ident = lambda a, b, w: a
    addsub = lambda a, b, w: a + (1 - 2 * ((w >> 30) & 1)).to(a.dtype)[:, None] * b
    muldiv = lambda a, b, w: a * torch.where((((w >> 29) & 1) > 0)[:, None], 1.0 / b, b)
    bins = [lambda a, b, w, f=f: f(a, b) for f in binary]
    uns = [lambda a, b, w, f=f: f(a) for f in unary]
    if variant in ("signmerge", "combo"):
        return [ident, addsub, bins[2], bins[3]] + uns

    def group(a, b, w):
        uidx = ((w >> 26) & 0x7)[:, None]
        val = unary[0](a)
        for u, f in enumerate(unary[1:], 1):
            val = torch.where(uidx == u, f(a), val)
        return val

    if variant == "muldiv":
        return [ident, addsub, muldiv] + uns
    if variant == "opgroup":
        return [ident, addsub, muldiv, group]
    return [ident] + bins + uns


_CODE_MASK = {"signmerge": 0x3F, "combo": 0x3F, "muldiv": 0x1F, "opgroup": 0x3}


def _plain_chunk(words, nsteps, nconst, cvals, const_ok, X, y, operators, loss_fn,
                 variant: str):
    T, L = words.shape
    F, n = X.shape
    CMAX = cvals.shape[1]
    BASE = F + CMAX
    dev = X.device
    store = _round_bf16 if variant == "bf16" else (lambda v: v)
    rows = torch.arange(T, device=dev)
    buf = torch.zeros((T, BASE + L, n), dtype=torch.float32, device=dev)
    buf[:, :F] = store(X.to(torch.float32))
    if variant in ("cvec", "custatic"):
        cmask = torch.ones((T, CMAX), dtype=torch.bool, device=dev)
    else:
        cmask = torch.arange(CMAX, device=dev)[None, :] < nconst.long()[:, None]
    buf[:, F:BASE] = torch.where(cmask, store(cvals.to(torch.float32)), 0.0)[:, :, None]
    m = torch.clamp(nsteps.long(), max=L)
    # Steps executed: pairs run 2 ceil(m / 2) of them, the padding one at min(j, L - 1).
    executed = m if variant in _UNPAIRED else 2 * ((m + 1) >> 1)
    branches = _branches(operators, variant)
    mask = _CODE_MASK.get(variant, 0x7F)
    fn0 = operators.binary[0].fn if operators.binary else None
    fin = torch.ones((T, n), dtype=torch.bool, device=dev)
    for j in range(int(executed.max()) if T else 0):
        k = min(j, L - 1)
        active = (j < executed)[:, None]
        word = words[:, k]
        a = buf[rows, ((word >> 12) & 0xFFF).long()]
        b = buf[rows, (word & 0xFFF).long()]
        if variant == "static":
            val = fn0(buf[:, 0], buf[:, 1])
        elif variant in ("noswitch", "nostore"):
            val = fn0(a, b)
        else:
            code = (word >> 24) & mask
            val = torch.full_like(a, float("nan"))
            for c in torch.unique(code).tolist():
                if c < len(branches):
                    val = torch.where((code == c)[:, None], branches[c](a, b, word), val)
        stored = store(val)
        row = BASE if variant == "nostore" else BASE + k
        buf[:, row] = torch.where(active, stored, buf[:, row])
        if variant != "novmask":
            ok = stored.abs() <= _BF16_FIN if variant == "bf16" else torch.isfinite(stored)
            fin &= ok | ~active
    root = buf[rows, BASE + m - 1]
    elt = loss_fn(root, y)
    total = torch.sum(elt, dim=-1)
    valid = fin.all(dim=-1) & torch.isfinite(total) & (const_ok != 0)
    return total, valid.to(torch.int32)


def loss_variant_plain(prog: TreeProgram, X, y, nfeatures: int, operators: OperatorSet,
                       loss_fn: Callable, tree_block: int = 8, variant: str = "base",
                       max_elems: int = 1 << 26):
    """Eager version of every variant on the device of ``X`` ([F, n]):
    the buffer of F + CMAX + L rows per tree (rows of steps never written
    read 0, as the kernel zero-fills them for nostore; a program reads no
    constant past its nconst, whose rows hold 0 here), the steps each
    variant executes (pairs run one padding step more for an odd step
    count), the finiteness track on the stored value (bf16: the TPU
    kernel's magnitude test), the elementwise loss of the root summed over
    rows. ``tree_block`` changes no output. Returns (loss_sum [T], valid [T]
    int32). Trees run in chunks of at most ``max_elems`` buffer elements."""
    del tree_block
    _check_variant(operators, variant)
    if X.shape[0] != nfeatures:
        raise ValueError(f"X has {X.shape[0]} features, nfeatures is {nfeatures}")
    words = pack_words(prog, variant)
    T, L = words.shape
    n = X.shape[1]
    chunk = max(1, max_elems // max((nfeatures + prog.cmax + L) * n, 1))
    parts = [_plain_chunk(words[s:s + chunk], prog.nsteps[s:s + chunk],
                          prog.nconst[s:s + chunk], prog.cvals[s:s + chunk],
                          prog.const_ok[s:s + chunk], X, y, operators, loss_fn, variant)
             for s in range(0, T, chunk)]
    if not parts:
        return (torch.zeros(0, dtype=torch.float32, device=X.device),
                torch.zeros(0, dtype=torch.int32, device=X.device))
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper
# ---------------------------------------------------------------------------


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def bind(lib):
    """``lib`` (a build of csrc/program_variants.cu) with its functions'
    argument types."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sr_program_variants.argtypes = [i] + [p] * 8 + [i] * 7 + [p, p, p]
    lib.sr_program_variants.restype = i
    lib.sr_program_variants_lanes.argtypes = [i] * 3
    lib.sr_program_variants_lanes.restype = i
    return lib


def launch_args(prog: TreeProgram, X, y, nfeatures: int, operators: OperatorSet,
                tree_block: int, variant: str, optab: torch.Tensor):
    """(the arguments of ``sr_program_variants`` before the stream, the
    loss and valid outputs it fills, the input tensors its pointers address,
    to be held until the call): the variant's words and the program's counts
    and constants on X's device, X in the variant's storage type."""
    F, n = X.shape
    T, L = prog.code.shape
    if F != nfeatures or y.shape != (n,):
        raise ValueError(f"{PROGRAM_VARIANTS.name}: X [{F}, {n}], y {tuple(y.shape)}, "
                         f"nfeatures {nfeatures} do not agree")
    dev = X.device
    ins = dict(words=pack_words(prog, variant), nsteps=prog.nsteps.to(torch.int32),
               nconst=prog.nconst.to(torch.int32), cvals=prog.cvals.to(torch.float32),
               const_ok=prog.const_ok.to(torch.int32),
               X=X.to(torch.bfloat16 if variant == "bf16" else torch.float32),
               y=y.to(torch.float32), optab=optab)
    for nm, t in ins.items():
        if t.device != dev:
            raise ValueError(f"{PROGRAM_VARIANTS.name}: {nm} is on {t.device}, X on {dev}")
        ins[nm] = t.contiguous()
    loss = torch.empty(T, dtype=torch.float32, device=dev)
    valid = torch.empty(T, dtype=torch.int32, device=dev)
    args = (VARIANT_IDS[variant], *(_ptr(t) for t in ins.values()), T, tree_block, L,
            prog.cmax, F, n, len(operators.binary), _ptr(loss), _ptr(valid))
    return args, loss, valid, ins


class ProgramVariantsKernel:
    """Wrapper of ``sr_program_variants`` (csrc/program_variants.cu). On CPU
    tensors it runs :func:`loss_variant_plain`; on CUDA tensors it launches
    the kernel or raises. ``launches`` counts its launches, and
    ``variant_launches`` them by (variant, tree block); both grow where the
    kernel launches and nowhere else."""

    name = "program_variants"
    source = "symbolicregression_jl_tpu_torch/csrc/program_variants.cu"
    replaces = "profiling/kernel_variants.py:311 (loss_variant :246 / _make_kernel :80-240)"
    _file = "program_variants.cu"

    def __init__(self):
        self.launches = 0
        self.variant_launches: Dict[Tuple[str, int], int] = {}
        self._lib = None
        self._optab = {}
        self._lock = threading.Lock()

    def library(self):
        """Build (at first use) and bind the shared library."""
        if self._lib is None:
            from ..ops.cuda_build import load_library

            with self._lock:
                if self._lib is None:
                    self._lib = bind(load_library(self._file))
        return self._lib

    def _device_optab(self, operators: OperatorSet, variant: str, device) -> torch.Tensor:
        key = (operators, variant, str(device))
        tab = self._optab.get(key)
        if tab is None:
            tab = torch.tensor(op_table(operators, variant), dtype=torch.int32, device=device)
            self._optab[key] = tab
        return tab

    def __call__(self, prog: TreeProgram, X, y, nfeatures: int, operators: OperatorSet,
                 loss_fn: Callable, tree_block: int = 8, variant: str = "base"):
        if X.device.type == "cpu":
            return loss_variant_plain(prog, X, y, nfeatures, operators, loss_fn, tree_block,
                                      variant)
        if X.device.type != "cuda":
            raise ValueError(f"{self.name}: unsupported device {X.device}")
        from ..ops.user_ops import is_builtin

        _check_variant(operators, variant)
        kl = kernel_loss(loss_fn)
        if kl is None or kl.kind != LOSS_L2:
            raise NotImplementedError(f"{self.name} computes the L2 loss, not {loss_fn!r}")
        for op in operators.binary + operators.unary:
            if not is_builtin(op):
                raise NotImplementedError(f"{self.name} runs the built-in operators, not {op}")
        if not 1 <= tree_block <= 32:
            raise ValueError(f"{self.name}: tree_block {tree_block} is not in 1..32")
        args, loss, valid, held = launch_args(prog, X, y, nfeatures, operators, tree_block, variant,
                                        self._device_optab(operators, variant, X.device))
        rc = self.library().sr_program_variants(
            *args, ctypes.c_void_p(torch.cuda.current_stream(X.device).cuda_stream))
        del held
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed ({variant}): CUDA error {rc}")
        with self._lock:
            self.launches += 1
            key = (variant, tree_block)
            self.variant_launches[key] = self.variant_launches.get(key, 0) + 1
        return loss, valid


PROGRAM_VARIANTS = ProgramVariantsKernel()


def loss_variant(prog: TreeProgram, X, y, nfeatures: int, operators: OperatorSet,
                 loss_fn: Callable, tree_block: int = 8, variant: str = "base", device=None):
    """(loss_sum [T], valid [T] int32) of ``variant`` with ``tree_block``
    trees a block, the JAX script's ``loss_variant``. ``device``: None means
    the card (the kernel); ``"cpu"`` runs the plain version."""
    dev = resolve_device(device)
    prog = TreeProgram(**{f.name: getattr(prog, f.name).to(dev)
                          for f in dataclasses.fields(TreeProgram)})
    return PROGRAM_VARIANTS(prog, X.to(dev), y.to(dev), nfeatures, operators, loss_fn,
                            tree_block, variant)


# ---------------------------------------------------------------------------
# The harness
# ---------------------------------------------------------------------------


def card_label(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or what
    ran instead."""
    if dev.type != "cuda":
        return "cpu: the plain versions on the host, no card"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={dev.index or 0}"],
                             capture_output=True, text=True, check=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"


def _row_spec(row: str) -> Tuple[str, int]:
    """(variant, tree block) of a harness row."""
    if row.startswith("tb"):
        return "base", int(row[2:])
    return row, 16 if row == "combo" else 8


def _chained(fn):
    """A launch whose constants next take this launch's smallest finite loss
    times 1e-30 (the JAX script's chain)."""
    def step(p):
        loss, valid = fn(p)
        eps = torch.min(torch.where(torch.isfinite(loss), loss, torch.inf))
        return dataclasses.replace(p, cvals=p.cvals + eps * 1e-30), loss, valid
    return step


def harness(T: int = 8192, which=DEFAULT_ROWS, steps: int = 8, device=None, reps: int = 30,
            out=print) -> Tuple[List[dict], dict]:
    """Time the rows ``which`` at T trees of ``steps`` steps over the bench
    problem on ``device`` (None: the card), one warm-up and ``reps`` chained
    launches each, and print one line a row. Returns (one record a row:
    row, variant, tree_block, ms, ns_step, bound_ms, tag and the last
    launch's loss; the context: options, dataset, program, card)."""
    from ._common import make_bench_problem

    dev = resolve_device(device)
    options, ds, engine = make_bench_problem(device=dev)
    ops = engine.cfg.operators
    X, y = ds.data.Xt, ds.data.y
    F, n = X.shape
    n_codes = 1 + len(ops.binary) + len(ops.unary)
    prog = synth_program(T, steps, 30, F, 15, n_codes, seed=0, device=dev)
    mean_steps = float(prog.nsteps.double().mean())
    card = card_label(dev)
    out(f"T={T} steps: mean {mean_steps:.2f} max {int(prog.nsteps.max())}; {card}")
    cuda = dev.type == "cuda"
    records, base_loss = [], None
    for row in which:
        variant, tb = _row_spec(row)
        n_row = n
        if row in ("prod", "prodbf16") or row.startswith("screen"):
            Xv, yv = X, y
            if row.startswith("screen"):
                k = max(64, n // int(row[len("screen"):] or "8"))
                idx = torch.as_tensor(strided_sample_indices(n, k), device=dev).long()
                Xv, yv, n_row = X[:, idx].contiguous(), y[idx].contiguous(), k
            bf = row == "prodbf16"
            fn = lambda p, Xv=Xv, yv=yv, bf=bf: fused_loss_program(
                p, Xv, yv, None, F, ops, options.elementwise_loss, bf16=bf)
        else:
            fn = lambda p, tb=tb, variant=variant: loss_variant(
                p, X, y, F, ops, options.elementwise_loss, tree_block=tb, variant=variant,
                device=dev)
        step = _chained(fn)
        step(prog)
        if cuda:
            torch.cuda.synchronize(dev)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        p = prog
        for _ in range(reps):
            p, loss, valid = step(p)
        if cuda:
            end.record()
            torch.cuda.synchronize(dev)
            dt = start.elapsed_time(end) / 1e3 / reps
        else:
            dt = (time.perf_counter() - t0) / reps
        tag = ""
        if row == "base" and base_loss is None:
            base_loss = loss
        elif base_loss is not None and (variant in EXACT + APPROX or row.startswith("tb")):
            tag = _tag(loss, base_loss, variant, cuda)
        bound_ms = T * mean_steps * n_row / H100_FP32_FLOPS * 1e3
        ns = dt / T / mean_steps * 1e9
        out(f"{row:10s} {dt * 1e3:8.3f} ms/launch  {T / dt:>10.0f} trees/s  {ns:6.1f} ns/step"
            f"{'  ' + tag if tag else ''}  bound {bound_ms:.4g} ms  [{card}]")
        records.append(dict(row=row, variant=variant, tree_block=tb, ms=dt * 1e3, ns_step=ns,
                            bound_ms=bound_ms, tag=tag, loss=loss, valid=valid))
    return records, dict(options=options, dataset=ds, prog=prog, card=card, device=dev)


def approx_deviation(loss, base_loss):
    """(NaN and +-inf where base's are, the worst relative deviation from
    base where both are finite, the trees past 1e-3) of a muldiv or opgroup
    loss."""
    same = (torch.equal(torch.isnan(loss), torch.isnan(base_loss))
            and torch.equal(torch.isposinf(loss), torch.isposinf(base_loss))
            and torch.equal(torch.isneginf(loss), torch.isneginf(base_loss)))
    both = torch.isfinite(loss) & torch.isfinite(base_loss)
    rel = torch.zeros_like(loss)
    rel[both] = (loss[both] - base_loss[both]).abs() / base_loss[both].abs().clamp(min=1e-30)
    worst = float(rel.max()) if rel.numel() else 0.0
    return same, worst, torch.nonzero(rel > 1e-3).flatten()


def _tag(loss, base_loss, variant: str, cuda: bool) -> str:
    """A row's check against base: the exact variants' bits on the card
    (``loss==base`` within rtol 1e-6 elsewhere, as the JAX script); muldiv
    and opgroup ``loss~=base@1e-3``, or their worst relative deviation and
    the trees past 1e-3 (their a * (1 / b) is not a / b: a measurement, not
    a fault); a MISMATCH where NaN or +-inf differ, or exact bits do."""
    if variant in APPROX:
        same, worst, past = approx_deviation(loss, base_loss)
        if not same:
            return "LOSS MISMATCH"
        return ("loss~=base@1e-3" if worst <= 1e-3 else
                f"loss~=base@{worst:.1e} ({past.numel()} of {loss.numel()} past 1e-3)")
    if cuda:
        ok = torch.equal(loss.view(torch.int32), base_loss.view(torch.int32))
        return "bits==base" if ok else "BITS MISMATCH"
    ok = torch.allclose(loss, base_loss, rtol=1e-6, equal_nan=True)
    return "loss==base" if ok else "LOSS MISMATCH"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("T", nargs="?", type=int, default=8192, help="trees (8,192)")
    ap.add_argument("which", nargs="*", help=f"rows ({', '.join(ROWS)}; screenD for 1/D)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    for row in args.which:
        if row not in ROWS and not (row.startswith("screen") and row[6:].isdigit()):
            ap.error(f"unknown row {row!r}")
    steps = int(os.environ.get("STEPS", "8"))
    records, _ = harness(args.T, args.which or DEFAULT_ROWS, steps, args.device)
    return 1 if any("MISMATCH" in r["tag"] for r in records) else 0


if __name__ == "__main__":
    sys.exit(main())
