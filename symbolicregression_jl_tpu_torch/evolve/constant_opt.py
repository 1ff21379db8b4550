"""Batched constant optimization (port of ``evolve/constant_opt.py``).

Every selected member is optimized at once, with ``nrestarts`` perturbed
restarts ``x0 * (1 + 0.5 eps)`` as an extra batch axis; a member takes the
best restart's constants only when that beats its loss before the
optimization. Two forms, as in the JAX package:

- :func:`optimize_constants_fused` (the kernel path, ``turbo``): L-BFGS in
  the compressed constant space of ``compile_program``; each iteration is
  one launch of kernel #2 for all R*C line-search candidates (kernel 2b,
  a bfloat16 value buffer, with ``ls_bf16``) and one of kernel #3 for the
  accepted point's loss and gradient (one more kernel #3
  launch comes before the loop).
- :func:`optimize_constants_batch` (the eager path): dense BFGS with a
  backtracking Armijo line search over the eager interpreter
  (``ops/eval.py``), differentiated by ``torch.autograd``; the JAX
  package's per-member ``vmap`` is a written-out [members, restarts] axis.
  Parametric members optimize their parameter banks jointly with their
  constants here, one flat vector [L + NP * NC] per member.
- :func:`optimize_constants_template` (template expressions): L-BFGS
  over every subexpression's constants at once; each gradient is
  ``torch.autograd`` through the batched template evaluation, whose call
  sites run kernel #4 forward and kernel #5 backward
  (``fused_predict_ad``), and each line search one batched evaluation.
  It runs the same L-BFGS loop as the fused form (:func:`_lbfgs_restarts`)
  with its own evaluator; a template's parameter vector joins the
  constants in the optimized vector.

The JAX ``scan`` loops are Python loops over tensors with no host
synchronisation inside them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..core.losses import aggregate_loss
from ..ops.encoding import LEAF_CONST, TreeBatch
from ..ops.eval import eval_tree_batch
from ..ops.fused_eval import fused_grad_multi, fused_loss_multi
from ..ops.program import _scatter_drop, compile_program
from . import rng

__all__ = ["OptimizerConfig", "optimize_constants_batch", "optimize_constants_fused",
           "optimize_constants_template"]


class OptimizerConfig(NamedTuple):
    """The semantic fields of the JAX package's OptimizerConfig; its
    TPU launch-geometry fields (V-chunks, VMEM budgets, tree blocks) have
    no counterpart here."""

    iterations: int = 8          # optimizer_iterations default
    nrestarts: int = 2           # optimizer_nrestarts
    max_linesearch: int = 8
    c1: float = 1e-4             # Armijo condition coefficient
    shrink: float = 0.5
    ls_bf16: bool = False        # bfloat16 line-search evaluations (graftstage)
    # Freeze rows whose line search failed (1-step programs) and skip
    # members with no constants; f_calls counts only live rows.
    early_exit: bool = False


def _step_sizes(cfg: OptimizerConfig, device) -> torch.Tensor:
    return torch.tensor(cfg.shrink, dtype=torch.float32, device=device) ** torch.arange(
        cfg.max_linesearch, dtype=torch.float32, device=device)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none)."""
    return torch.argmax(mask.to(torch.int32), dim=-1)


def _lbfgs_direction(g, S, Y, rho):
    """L-BFGS two-loop recursion over the history (newest first; empty
    slots have rho == 0) with the gamma scaling of the JAX package."""
    hlen = S.shape[0]
    q = g
    alphas = []
    for i in range(hlen):
        alpha = rho[i] * torch.sum(S[i] * q, dim=1)
        q = q - alpha[:, None] * Y[i]
        alphas.append(alpha)
    yy = torch.sum(Y[0] * Y[0], dim=1)
    sy = torch.sum(S[0] * Y[0], dim=1)
    gamma = torch.where((rho[0] != 0) & (yy > 0), sy / torch.clamp(yy, min=1e-30), 1.0)
    q = q * torch.clamp(gamma, 1e-8, 1e8)[:, None]
    for i in reversed(range(hlen)):
        beta = rho[i] * torch.sum(Y[i] * q, dim=1)
        q = q + (alphas[i] - beta)[:, None] * S[i]
    return -q


def _best_restart(x, fx, baseline, calls, do_opt):
    """Each member's best restart, taken only when it beats ``baseline``
    (the member's loss before the optimization). ``x`` [P, R, D], ``fx``
    and ``calls`` [P * R]. Returns (x_best [P, D], improved [P], new_loss
    [P], f_calls [P])."""
    P, R, D = x.shape
    fs = torch.where(torch.isnan(fx), torch.inf, fx).reshape(P, R)
    best = torch.argmin(fs, dim=1)
    f_best = torch.gather(fs, 1, best[:, None])[:, 0]
    x_best = torch.gather(x, 1, best[:, None, None].expand(P, 1, D))[:, 0]
    improved = do_opt & (f_best < baseline) & torch.isfinite(f_best)
    f_calls = torch.sum(calls.reshape(P, R), dim=1) * do_opt
    return x_best, improved, torch.where(improved, f_best, baseline), f_calls


def _lbfgs_restarts(starts, do_opt, vg, line_losses, cfg: OptimizerConfig, active=None,
                    descent_guard: bool = False):
    """L-BFGS from every restart's start point, with all C step sizes of
    the Armijo line search evaluated in one batch; then each member's best
    restart (:func:`_best_restart` against restart 0's first loss).

    ``starts`` [P, R, D]: restart 0 is the member's own constants.
    ``vg(x [M, D], active)`` gives the loss [M] and gradient [M, D] of the
    M = P * R rows; ``line_losses(cand [M, C, D], active)`` the losses
    [M, C] of every row's candidate steps. ``active`` [M] (early exit)
    freezes a row once its line search fails and is passed on to both
    (None at the first gradient, and throughout without early exit).
    ``descent_guard`` also rejects a step that the accepted point's loss
    calls uphill."""
    P, R, D = starts.shape
    M = P * R
    C = cfg.max_linesearch
    dev = starts.device
    x = starts.reshape(M, D)
    ts = _step_sizes(cfg, dev)
    fx0, g = vg(x, None)
    fx = fx0
    calls = torch.ones(M, dtype=torch.float32, device=dev)

    # L-BFGS two-loop recursion; the history covers the whole fixed
    # budget. Newest (s, y, rho) first; empty slots have rho == 0.
    hlen = min(int(cfg.iterations), 8)
    S = torch.zeros((hlen, M, D), dtype=x.dtype, device=dev)
    Y = torch.zeros_like(S)
    rho = torch.zeros((hlen, M), dtype=x.dtype, device=dev)

    for _ in range(cfg.iterations):
        d = _lbfgs_direction(g, S, Y, rho)
        dg = torch.sum(d * g, dim=1)
        use_sd = (dg >= 0) | ~torch.all(torch.isfinite(d), dim=1)
        d = torch.where(use_sd[:, None], -g, d)
        dg = torch.where(use_sd, -torch.sum(g * g, dim=1), dg)

        # all candidate steps in one batch: [M, C, D]
        with torch.no_grad():
            f_cand = line_losses(x[:, None, :] + ts[None, :, None] * d[:, None, :], active)
        armijo = (f_cand <= fx[:, None] + cfg.c1 * ts[None, :] * dg[:, None]) \
            & torch.isfinite(f_cand)
        any_ok = torch.any(armijo, dim=1)
        if active is not None:
            any_ok = any_ok & active
        t_star = torch.where(any_ok, ts[_first_true(armijo)], 0.0)
        s = t_star[:, None] * d
        x_new = x + s
        f_new, g_new = vg(x_new, active)
        if descent_guard:
            # Reject a step the accepted point's loss calls uphill.
            any_ok = any_ok & (f_new <= fx)
            s = torch.where(any_ok[:, None], s, 0.0)
        x_new = torch.where(any_ok[:, None], x_new, x)
        f_new = torch.where(any_ok, f_new, fx)
        g_new = torch.where(any_ok[:, None], g_new, g)
        yv = g_new - g
        sy = torch.sum(s * yv, dim=1)
        rho_new = torch.where(torch.abs(sy) > 1e-10, 1.0 / sy, 0.0)
        S = torch.cat([s[None], S[:-1]], dim=0)
        Y = torch.cat([yv[None], Y[:-1]], dim=0)
        rho = torch.cat([rho_new[None], rho[:-1]], dim=0)
        if active is None:
            calls = calls + (C + 1)
        else:
            calls = calls + (C + 1) * active.to(calls.dtype)
            active = any_ok
        x, fx, g = x_new, f_new, g_new

    return _best_restart(x.reshape(P, R, D), fx, fx0.reshape(P, R)[:, 0], calls, do_opt)


def optimize_constants_fused(key, trees: TreeBatch, do_opt: torch.Tensor, data,
                             elementwise_loss, operators, cfg: OptimizerConfig):
    """L-BFGS with a batched line search through kernels #2 and #3.

    ``trees`` [P, L], ``do_opt`` [P] bool. Returns (new_const [P, L],
    improved [P], new_loss [P], f_calls [P])."""
    P, L = trees.arity.shape
    R = cfg.nrestarts + 1
    C = cfg.max_linesearch
    X, y, w = data.Xt, data.y, data.weights
    F = X.shape[0]
    dev = X.device

    # Optimize in the program's compressed constant space: the gradient
    # kernel produces gradients there, and the winners scatter back into
    # slot order once at the end.
    prog = compile_program(trees, F, len(operators.binary))
    CM = prog.cmax
    used = torch.arange(CM, device=dev)[None, :] < prog.nconst[:, None]

    eps = rng.normal(key, (P, cfg.nrestarts, CM))
    base = prog.cvals
    starts = torch.cat([base[:, None], base[:, None] * (1.0 + 0.5 * eps)], dim=1)
    mask_r = used.repeat_interleave(R, dim=0)
    M = P * R

    def program(active):
        """With early exit, a tree none of whose restarts is active runs one step."""
        if active is None:
            return prog
        tree_live = torch.any(active.reshape(P, R), dim=1)
        return dataclasses.replace(prog, nsteps=torch.where(tree_live, prog.nsteps, 1))

    def vg(consts, active):
        loss, _, gcomp = fused_grad_multi(program(active), consts.reshape(P, R, CM), X, y, w,
                                          F, operators, elementwise_loss)
        return loss.reshape(M), torch.where(mask_r, gcomp.reshape(M, CM), 0.0)

    def fused_many(cand_x, active):
        # ``ls_bf16``: the candidates' losses from kernel 2b only rank the
        # step sizes; the accepted point's loss is the gradient kernel's
        # float32 one, and the descent guard rejects a step it calls uphill.
        loss, _ = fused_loss_multi(program(active), cand_x.reshape(P, R * C, CM), X, y, w, F,
                                   operators, elementwise_loss, bf16=cfg.ls_bf16)
        return loss.reshape(M, C)

    active = (do_opt & (prog.nconst > 0)).repeat_interleave(R) if cfg.early_exit else None
    x_best, improved, new_loss, f_calls = _lbfgs_restarts(
        starts, do_opt, vg, fused_many, cfg, active=active, descent_guard=True)
    scattered = _scatter_drop(trees.const, prog.cslot, x_best, accumulate=False)
    new_const = torch.where(improved[:, None], scattered, trees.const)
    return new_const, improved, new_loss, f_calls


def optimize_constants_batch(key, trees: TreeBatch, do_opt: torch.Tensor, data,
                             elementwise_loss, operators, cfg: OptimizerConfig,
                             params: Optional[torch.Tensor] = None):
    """Dense BFGS with a backtracking Armijo line search on the eager
    interpreter, per member and restart.

    ``trees`` [P, L] with ``key`` [2], or [I, P, L] with ``key`` [I, 2]
    (one key per island, the JAX package's per-island ``vmap``); member m
    draws its restart perturbations from ``split(key, P)[m]``. Returns
    (new_const, improved, new_loss, f_calls) with the leading dims of
    ``trees``, and new_params last when ``params`` is given.

    ``params`` [..., NP, NC] are parametric members' banks, read through
    the dataset's class column and optimized jointly with the constants
    (one flat vector of L + NP * NC values per member)."""
    lead = trees.batch_shape
    L = trees.max_nodes
    keys = rng.split(key, lead[-1]).reshape(-1, 2)
    flat = trees.reshape(-1)
    do_opt = do_opt.reshape(-1)
    P = flat.arity.shape[0]
    R = cfg.nrestarts + 1
    C = cfg.max_linesearch
    X, y, w = data.Xt, data.y, data.weights
    dev = X.device
    parametric = params is not None and params.shape[-2] > 0
    NP, NC = params.shape[-2:] if parametric else (0, 0)
    D = L + NP * NC
    slot = torch.arange(L, device=dev)
    cmask = (slot[None, :] < flat.length[:, None]) & (flat.arity == 0) & (flat.op == LEAF_CONST)
    x0 = flat.const
    if parametric:
        cmask = torch.cat([cmask, torch.ones((P, NP * NC), dtype=torch.bool, device=dev)], 1)
        x0 = torch.cat([x0, params.reshape(P, NP * NC)], dim=1)
        cls = data.class_idx.long()

    def chunk_loss(xb, idx):
        """Losses of members ``idx`` [m] with the constants (and parameter
        banks) ``xb`` [m, D]."""
        c = torch.where(cmask[idx], xb, x0[idx])
        member = TreeBatch(flat.arity[idx], flat.op[idx], flat.feat[idx], c[:, :L],
                           flat.length[idx])
        prows = c[:, L:].reshape(-1, NP, NC)[..., cls] if parametric else None
        pred, valid = eval_tree_batch(member, X, operators, prows)
        return aggregate_loss(elementwise_loss, pred, y, valid, w)

    # Rows per interpreter call: its [rows, L, n] value buffer holds about
    # 2^28 elements without gradients and 2^27 with them, whose autograd
    # graph (a few such buffers) each chunk frees by its own backward pass,
    # so the memory stays bounded whatever the number of members, and the
    # chunks stay few: each costs the interpreter's eager launches.
    per_row = max(L * X.shape[1], 1)
    chunk_ng, chunk_g = max(1, (1 << 28) // per_row), max(1, (1 << 27) // per_row)

    def loss_of(xb, reps: int):
        """Loss of each row of ``xb`` [P*reps, D]: row j is member j // reps."""
        idx = torch.arange(xb.shape[0], device=dev) // reps
        return torch.cat([chunk_loss(xb[i:i + chunk_ng], idx[i:i + chunk_ng])
                          for i in range(0, xb.shape[0], chunk_ng)])

    mask_r = cmask.repeat_interleave(R, dim=0)

    def value_and_grad(xb):
        """Each tree's loss depends on its own constants only, so the
        gradient of the summed loss is every tree's own gradient; each chunk
        of rows runs its own backward pass."""
        idx = torch.arange(xb.shape[0], device=dev) // R
        losses, grads = [], []
        for i in range(0, xb.shape[0], chunk_g):
            xi = xb[i:i + chunk_g].detach().requires_grad_(True)
            with torch.enable_grad():
                loss = chunk_loss(xi, idx[i:i + chunk_g])
                (g,) = torch.autograd.grad(loss.sum(), xi)
            losses.append(loss.detach())
            grads.append(g)
        g = torch.where(mask_r, torch.cat(grads), 0.0)
        return torch.cat(losses), torch.where(torch.isfinite(g), g, 0.0)

    with torch.no_grad():
        baseline = loss_of(x0, 1)
    eps = rng.normal(keys, (cfg.nrestarts, D))
    x = torch.cat([x0[:, None], x0[:, None] * (1.0 + 0.5 * eps)], dim=1).reshape(P * R, D)
    M = P * R
    ts = _step_sizes(cfg, dev)
    eye = torch.eye(D, dtype=x.dtype, device=dev)
    H = eye.expand(M, D, D)
    fx, g = value_and_grad(x)
    calls = torch.ones(M, dtype=torch.float32, device=dev)
    for _ in range(cfg.iterations):
        d = -(H @ g[:, :, None])[:, :, 0]
        dg = torch.sum(d * g, dim=1)
        use_sd = dg >= 0
        d = torch.where(use_sd[:, None], -g, d)
        dg = torch.where(use_sd, -torch.sum(g * g, dim=1), dg)
        # The C backtracking trial points do not depend on each other's
        # losses: all are evaluated at once and the first Armijo point taken.
        with torch.no_grad():
            f_try = loss_of((x[:, None, :] + ts[None, :, None] * d[:, None, :]).reshape(M * C, D),
                            R * C).reshape(M, C)
        ok = (f_try <= fx[:, None] + cfg.c1 * ts[None, :] * dg[:, None]) & torch.isfinite(f_try)
        found = torch.any(ok, dim=1)
        t_star = torch.where(found, ts[_first_true(ok)], 0.0)
        s = t_star[:, None] * d
        x_new = x + s
        f_new, g_new = value_and_grad(x_new)
        f_new = torch.where(found, f_new, fx)
        x_new = torch.where(found[:, None], x_new, x)
        g_new = torch.where(found[:, None], g_new, g)
        yv = g_new - g
        sy = torch.sum(s * yv, dim=1)
        rho = torch.where(torch.abs(sy) > 1e-10, 1.0 / sy, 0.0)
        I_rs = eye - rho[:, None, None] * (s[:, :, None] * yv[:, None, :])
        H_new = I_rs @ H @ I_rs.transpose(1, 2) + rho[:, None, None] * (s[:, :, None] * s[:, None, :])
        keep = torch.isfinite(H_new).all(dim=(1, 2)) & (rho != 0)
        H = torch.where(keep[:, None, None], H_new, H)
        calls = calls + (C + 1)
        x, fx, g = x_new, f_new, g_new

    x_best, improved, new_loss, f_calls = _best_restart(x.reshape(P, R, D), fx, baseline, calls,
                                                        do_opt)
    new_x = torch.where(improved[:, None] & cmask, x_best, x0)
    out = (new_x[:, :L].reshape(*lead, L), improved.reshape(lead), new_loss.reshape(lead),
           f_calls.reshape(lead))
    if params is None:
        return out
    return out + (new_x[:, L:].reshape(params.shape) if parametric else params,)


def optimize_constants_template(key, trees: TreeBatch, do_opt: torch.Tensor, data,
                                elementwise_loss, operators, cfg: OptimizerConfig, template,
                                fused: bool = False, params: Optional[torch.Tensor] = None):
    """Joint L-BFGS over every subexpression's constants of template
    members and their parameter vectors, one flat vector of K * L + T
    values per member (T = the template's total parameters).

    ``trees`` [P, K, L] with ``key`` [2], or [I, P, K, L] with ``key``
    [I, 2] (one key per island, as the JAX package vmaps it over islands):
    member m of island i draws its restart perturbations from
    ``normal(key[i], (P, nrestarts, K * L))[m]``, and all islands' members
    run as one batch, so each pass launches once per call site. Each
    iteration is one gradient pass (``torch.autograd`` through
    :func:`~..models.template.eval_template_batch`: kernel #4 forward,
    kernel #5 backward when ``fused``) and one batched line search of
    every restart's C candidate steps. ``params`` [..., T, 1] are the
    members' parameter vectors. Returns (new_const, improved, new_loss,
    f_calls) with the leading dims of ``trees``, and new_params last when
    ``params`` is given."""
    from ..models.template import eval_template_batch

    if template.uses_deriv:
        raise NotImplementedError(
            "constant optimization of templates with D(...) call sites needs second-order "
            "derivatives; it comes with the expression-plugin slice (ROADMAP.md queue 1 "
            "item 4).")
    K, L = trees.arity.shape[-2:]
    lead = trees.length.shape[:-1]
    T = template.total_params
    Dm = K * L + T
    eps = rng.normal(key, (lead[-1], cfg.nrestarts, Dm))
    flat = trees.reshape(-1, K)
    do_opt = do_opt.reshape(-1)
    P = flat.length.shape[0]
    R = cfg.nrestarts + 1
    C = cfg.max_linesearch
    X, y, w = data.Xt, data.y, data.weights
    dev = X.device
    slot = torch.arange(L, device=dev)
    cmask = (slot < flat.length[..., None]) & (flat.arity == 0) & (flat.op == LEAF_CONST)
    xmask = torch.cat([cmask.reshape(P, K * L), torch.ones((P, T), dtype=torch.bool, device=dev)],
                      dim=1)
    p0 = (params.reshape(P, T) if params is not None and T
          else torch.zeros((P, T), dtype=flat.const.dtype, device=dev))
    x0 = torch.cat([flat.const.reshape(P, K * L), p0], dim=1)

    def loss_of(xb, reps: int):
        """Loss of each member with the constants and parameters ``xb``
        [P*reps, K*L + T]."""
        m = xb.shape[0]
        rep = lambda a: a.repeat_interleave(reps, dim=0)
        c = torch.where(rep(cmask), xb[:, :K * L].reshape(m, K, L), rep(flat.const))
        member = TreeBatch(rep(flat.arity), rep(flat.op), rep(flat.feat), c, rep(flat.length))
        pred, valid = eval_template_batch(member, X, template, operators,
                                          params=xb[:, K * L:] if T else None, fused=fused)
        return aggregate_loss(elementwise_loss, pred, y, valid, w)

    mask_r = xmask.repeat_interleave(R, dim=0)

    def value_and_grad(xb, _active):
        """Each member's loss depends on its own constants only, so the
        gradient of the summed finite losses is every member's own."""
        xb = xb.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = loss_of(xb, R)
            total = torch.where(torch.isfinite(loss), loss, 0.0).sum()
            (g,) = torch.autograd.grad(total, xb)
        g = torch.where(mask_r, g, 0.0)
        return loss.detach(), torch.where(torch.isfinite(g), g, 0.0)

    def line_losses(cand_x, _active):
        return loss_of(cand_x.reshape(-1, Dm), R * C).reshape(P * R, C)

    eps = eps.reshape(P, cfg.nrestarts, Dm)
    starts = torch.cat([x0[:, None], x0[:, None] * (1.0 + 0.5 * eps)], dim=1)
    x_best, improved, new_loss, f_calls = _lbfgs_restarts(starts, do_opt, value_and_grad,
                                                          line_losses, cfg)
    new_x = torch.where(improved[:, None] & xmask, x_best, x0)
    out = (new_x[:, :K * L].reshape(*lead, K, L), improved.reshape(lead), new_loss.reshape(lead),
           f_calls.reshape(lead))
    if params is None:
        return out
    return out + (new_x[:, K * L:].reshape(*lead, T, 1),)
