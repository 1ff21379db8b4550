"""On-disk checkpoint and resume of the full search state.

Port of ``symbolicregression_jl_tpu/api/checkpoint.py`` for one process.
The engine's state is a tree of dataclasses holding tensors, so it
serializes exactly: a resume continues the identical search. Tensors are
stored as numpy arrays inside the port's own dataclasses (a JAX
checkpoint cannot be read without importing JAX, and the port never
does) and come back on the caller's device.

Format: one pickle file holding the envelope ``{"format": "srckpt.v2",
"sha256": <hex>, "payload": <bytes>}``, whose payload is a dict of the
numpy device states and a compatibility header (the fields the warm start
checks). The digest is verified on write (the ``.bak`` file is read back
before the atomic replace) and on load, so a truncated or bit-flipped file
raises :class:`CheckpointCorruptError` and never a raw unpickling error;
``shield/checkpoints.py`` then falls back to the previous rolling file.
Rank shards of a multi-process run come with the multi-device slice.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import types
import warnings
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from ..device import resolve_device

if TYPE_CHECKING:  # pragma: no cover
    from ..core.options import Options
    from .search import SearchState

__all__ = ["CheckpointCorruptError", "save_search_state", "load_search_state",
           "options_compat_header", "options_fingerprint"]

_FORMAT_VERSION = 2
_ENVELOPE_MAGIC = "srckpt.v2"


class CheckpointCorruptError(ValueError):
    """A checkpoint file exists but cannot be read: truncated, bit-flipped
    (digest mismatch), not unpicklable, or of an unknown format version."""


def options_compat_header(options: "Options") -> dict:
    """Comparable summary of the warm-start compatibility fields.
    Callables (custom operators, template combiners) are compared by name
    and shape; a template combiner also gets a bytecode fingerprint, whose
    mismatch warns rather than fails."""
    spec = options.expression_spec
    spec_desc: object = type(spec).__name__ if spec is not None else None
    if spec is not None and hasattr(spec, "max_parameters"):
        spec_desc = (spec_desc, spec.max_parameters)
    fp = None
    if spec is not None and hasattr(spec, "structure"):
        st = spec.structure
        spec_desc = (spec_desc, st.expr_keys, st.num_features, st.param_keys, st.num_params,
                     st.n_variables)
        code = getattr(st.combine, "__code__", None)
        fp = (getattr(st.combine, "__qualname__", repr(st.combine)),
              _code_digest(code) if code is not None else None)
    header = {f: getattr(options, f) for f in type(options)._WARM_START_FIELDS
              if f != "expression_spec"}
    header["operators"] = (tuple(op.name for op in options.operators.unary),
                           tuple(op.name for op in options.operators.binary))
    header["expression_spec"] = spec_desc
    header["template_combiner_fp"] = fp
    return header


# Options fields that shape only host-side supervision and IO, never the
# search's numerics.
_HOST_ONLY_OPTION_FIELDS = frozenset({
    "output_directory", "save_to_file", "use_recorder", "recorder_file",
    "recorder_verbosity", "verbosity", "print_precision", "progress",
    "telemetry", "telemetry_file", "telemetry_interval",
    "interactive_quit", "checkpoint_keep", "max_retries", "retry_backoff",
    "iteration_deadline", "compile_budget", "shield",
    "early_stop_condition", "timeout_in_seconds", "max_evals", "seed",
})


class _Unfingerprintable(Exception):
    """A value with no process-stable canonical form."""


def _global_name_reads(code) -> set:
    """Names a code object and its nested code objects may read as globals."""
    names = set(code.co_names)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            names |= _global_name_reads(const)
    return names


def _value_fp(v) -> str:
    """Stable stringification of one Options field value."""
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return repr(v)
    if isinstance(v, np.ndarray):
        return f"nd:{v.dtype}:{v.shape}:{hashlib.sha1(v.tobytes()).hexdigest()[:16]}"
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_value_fp(x) for x in v) + "]"
    if isinstance(v, (set, frozenset)):
        return "{" + ",".join(sorted(_value_fp(x) for x in v)) + "}"
    if isinstance(v, dict):
        items = sorted((_value_fp(k), _value_fp(x)) for k, x in v.items())
        return "{" + ",".join(f"{k}:{x}" for k, x in items) + "}"
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return type(v).__name__ + _value_fp(dataclasses.asdict(v))
    if callable(v):
        code = getattr(v, "__code__", None)
        if code is None:
            # Library callables are stable by dotted name, where that name
            # resolves back to this very object.
            import sys

            mod = getattr(v, "__module__", None) or ""
            qn = getattr(v, "__qualname__", None) or getattr(v, "__name__", None)
            if qn and mod.split(".")[0] in ("torch", "numpy", "math"):
                target = sys.modules.get(mod)
                for part in qn.split("."):
                    target = getattr(target, part, None)
                if target is v:
                    return f"lib:{mod}.{qn}"
            raise _Unfingerprintable(repr(v))
        # A non-module global can be rebound between runs without changing
        # the code object.
        g = getattr(v, "__globals__", None)
        if g is not None:
            for name in _global_name_reads(code):
                if name in g and not isinstance(g[name], types.ModuleType):
                    raise _Unfingerprintable(
                        f"{getattr(v, '__qualname__', v)!r} reads global {name!r}")
        extras = ""
        cells = getattr(v, "__closure__", None)
        if cells:
            extras += ":c" + _value_fp(tuple(c.cell_contents for c in cells))
        if getattr(v, "__defaults__", None):
            extras += ":d" + _value_fp(v.__defaults__)
        if getattr(v, "__kwdefaults__", None):
            extras += ":k" + _value_fp(v.__kwdefaults__)
        if getattr(v, "__self__", None) is not None:
            extras += ":s" + _value_fp(v.__self__)
        return f"fn:{getattr(v, '__qualname__', '?')}:{_code_digest(code)}{extras}"
    raise _Unfingerprintable(repr(v))


def options_fingerprint(options: "Options") -> Optional[str]:
    """Digest of everything in ``options`` that can change the search's
    numerics (host-only fields excluded): equal fingerprints run the same
    search. None where a field has no process-stable form (a C callable,
    an arbitrary object)."""
    parts = []
    try:
        for name in sorted(vars(options)):
            if name in _HOST_ONLY_OPTION_FIELDS:
                continue
            value = getattr(options, name)
            if name == "operators":
                value = {d: [(op.name, op.arity, getattr(op, "fn", None)) for op in ops]
                         for d, ops in value.ops.items()}
            elif name == "expression_spec":
                header = options_compat_header(options)
                value = (header["expression_spec"], header["template_combiner_fp"])
            parts.append(f"{name}={_value_fp(value)}")
    except _Unfingerprintable:
        return None
    return hashlib.sha256("\n".join(parts).encode()).hexdigest()


def _code_digest(code) -> str:
    """Process-stable digest of a code object and its nested code objects."""
    h = hashlib.sha1(code.co_code)
    for c in code.co_consts:
        h.update(_code_digest(c).encode() if hasattr(c, "co_code") else repr(c).encode())
    return h.hexdigest()[:16]


def map_arrays(obj, fn):
    """``fn`` applied to every tensor or numpy array in a tree of
    dataclasses (the device state), the structure kept."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: map_arrays(getattr(obj, f.name), fn)
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


def _to_numpy_state(ds):
    return map_arrays(ds, lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                       else t)


def _to_device_state(ds, device):
    dev = resolve_device(device)
    return map_arrays(ds, lambda a: torch.from_numpy(np.array(a)).to(dev))


# ---------------------------------------------------------------------------
# The envelope
# ---------------------------------------------------------------------------

# What a corrupt but honest file makes unpickling raise.
_UNPICKLE_ERRORS = (pickle.UnpicklingError, EOFError, AttributeError, ImportError, IndexError,
                    KeyError, TypeError, ValueError, MemoryError, UnicodeDecodeError, OSError)


def _write_envelope(path: str, payload: dict) -> None:
    """Write ``path + ".bak"``, read it back and check its digest, then
    move it over ``path``: a torn write never replaces a good file."""
    blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    digest = hashlib.sha256(blob).hexdigest()
    envelope = {"format": _ENVELOPE_MAGIC, "sha256": digest, "payload": blob}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".bak"
    with open(tmp, "wb") as f:
        pickle.dump(envelope, f, protocol=pickle.HIGHEST_PROTOCOL)
        f.flush()
        os.fsync(f.fileno())
    try:
        with open(tmp, "rb") as f:
            back = pickle.load(f)
        ok = hashlib.sha256(back["payload"]).hexdigest() == digest
    except _UNPICKLE_ERRORS as e:
        raise CheckpointCorruptError(
            f"checkpoint readback of {tmp} failed after write ({type(e).__name__}: {e}); "
            "the previous checkpoint is left intact") from e
    if not ok:
        raise CheckpointCorruptError(
            f"checkpoint digest mismatch right after writing {tmp}; the previous checkpoint "
            "is left intact")
    os.replace(tmp, path)


def _read_payload(path: str) -> dict:
    """Read and digest-check one checkpoint file. Raises
    CheckpointCorruptError for anything but a well-formed file of a known
    version; FileNotFoundError passes through (absent is not corrupt)."""
    try:
        with open(path, "rb") as f:
            outer = pickle.load(f)
    except FileNotFoundError:
        raise
    except _UNPICKLE_ERRORS as e:
        raise CheckpointCorruptError(
            f"checkpoint {path} is unreadable (truncated or corrupt pickle): "
            f"{type(e).__name__}: {e}") from e
    if isinstance(outer, dict) and outer.get("format") == _ENVELOPE_MAGIC:
        blob = outer.get("payload")
        if not isinstance(blob, (bytes, bytearray)) or (
                hashlib.sha256(blob).hexdigest() != outer.get("sha256")):
            raise CheckpointCorruptError(
                f"checkpoint {path} failed sha256 digest verification")
        try:
            payload = pickle.loads(blob)
        except _UNPICKLE_ERRORS as e:
            raise CheckpointCorruptError(
                f"checkpoint {path} payload failed to unpickle: {type(e).__name__}: {e}") from e
    else:
        payload = outer  # format v1: a bare payload pickle
    if not isinstance(payload, dict) or payload.get("format_version") not in (1, _FORMAT_VERSION):
        got = payload.get("format_version") if isinstance(payload, dict) \
            else type(payload).__name__
        raise CheckpointCorruptError(
            f"checkpoint {path} has unsupported format_version {got!r} "
            f"(this build reads 1..{_FORMAT_VERSION})")
    return payload


# ---------------------------------------------------------------------------
# Save and load
# ---------------------------------------------------------------------------


def save_search_state(path: str, state: "SearchState") -> None:
    """Write a SearchState (``return_state=True``'s result) to ``path``."""
    _write_envelope(path, {
        "format_version": _FORMAT_VERSION,
        "compat": options_compat_header(state.options),
        "num_evals": float(state.num_evals),
        "iterations_done": int(state.iterations_done),
        "key_impl": "threefry2x32",
        "nfeatures": state.nfeatures,
        "device_states": [_to_numpy_state(ds) for ds in state.device_states],
    })


def _check_compat(payload: dict, options: "Options") -> None:
    saved = payload["compat"]
    now = options_compat_header(options)
    issues = [k for k in now if k != "template_combiner_fp" and saved.get(k) != now[k]]
    if issues:
        raise ValueError(f"Checkpoint incompatible with current options; changed: {issues}")
    if saved.get("template_combiner_fp") != now.get("template_combiner_fp"):
        warnings.warn(
            "Checkpoint was saved under a template combine function whose fingerprint "
            "differs from the current one; resuming will score carried-over losses under "
            "the new objective.", stacklevel=3)


def load_search_state(path: str, options: "Options", device=None) -> "SearchState":
    """Load a checkpoint to resume under ``options``, its tensors on
    ``device`` (CUDA unless ``device="cpu"``). Raises
    CheckpointCorruptError for a truncated, corrupt or unknown-format
    file, FileNotFoundError for a missing one, and ValueError where the
    saved state does not fit ``options``."""
    from .search import SearchState

    if not os.path.exists(path):
        raise FileNotFoundError(path)
    payload = _read_payload(path)
    if payload.get("key_impl", "threefry2x32") != "threefry2x32":
        raise CheckpointCorruptError(
            f"checkpoint {path} uses PRNG key impl {payload['key_impl']!r}; the port draws "
            "with threefry2x32 only")
    _check_compat(payload, options)
    return SearchState(
        device_states=[_to_device_state(ds, device) for ds in payload["device_states"]],
        hofs=[], options=options, num_evals=float(payload["num_evals"]),
        nfeatures=payload.get("nfeatures"),
        iterations_done=int(payload.get("iterations_done", 0)))
