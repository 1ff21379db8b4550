"""Two callables that differ only in the names they read (``torch.abs``
against ``torch.square``) have different code digests: different options
fingerprints, different engines from the engine cache, each engine with
its own loss, and different template-combiner fingerprints (the
combiner's digest takes in the user function that ``template_spec``'s
wrapper closes over)."""

import numpy as np
import torch

import symbolicregression_jl_tpu_torch as srt
from symbolicregression_jl_tpu_torch.api.checkpoint import (_code_digest, options_compat_header,
                                                            options_fingerprint)
from symbolicregression_jl_tpu_torch.models import template_spec
from symbolicregression_jl_tpu_torch.ops.encoding import encode_population
from symbolicregression_jl_tpu_torch.serve.cache import ExecutableCache

import torch_parity  # noqa: F401  (caps torch's threads per worker)


def _double(v):
    return v + v


def _triple(v):
    return v + v + v


def _options(loss, **kw):
    return srt.Options(binary_operators=["+", "*"], unary_operators=[], maxsize=6,
                       populations=2, population_size=8, tournament_selection_n=4,
                       save_to_file=False, elementwise_loss=loss, **kw)


def test_losses_differing_in_names_get_their_own_engines():
    a = _options(lambda p, y: torch.abs(p - y))
    b = _options(lambda p, y: torch.square(p - y))
    assert options_fingerprint(a) is not None
    assert options_fingerprint(a) != options_fingerprint(b)
    cache = ExecutableCache()
    kw = dict(nfeatures=1, dtype=torch.float32, n_params=0, n_classes=0, device="cpu", rows=1)
    ea, eb = cache.get_engine(a, **kw), cache.get_engine(b, **kw)
    assert ea is not eb and cache.misses == 2 and cache.hits == 0
    assert cache.get_engine(_options(lambda p, y: torch.abs(p - y)), **kw) is ea
    # each engine scores with its own loss: x1 at (3, 1)
    ds = srt.make_dataset(np.array([[3.0]], np.float32), np.array([1.0], np.float32),
                          device="cpu")
    tree = encode_population([srt.parse_expression("x1", a.operators)], a.maxsize,
                             a.operators, device="cpu")
    for engine, want in ((ea, 2.0), (eb, 4.0)):
        _, loss, _ = engine._eval(tree, engine.cfg.n_params and None, ds.data,
                                  fuse_cost=False)
        assert float(loss[0]) == want


def test_nested_code_names_and_template_combiner():
    def abs_outer(p, y):
        return (lambda v: torch.abs(v))(p - y)

    def square_outer(p, y):
        return (lambda v: torch.square(v))(p - y)

    assert _code_digest(abs_outer.__code__) != _code_digest(square_outer.__code__)
    two = template_spec(expressions=("f",))(lambda f, x1: _double(f(x1)))
    three = template_spec(expressions=("f",))(lambda f, x1: _triple(f(x1)))
    fa = options_compat_header(_options("L2DistLoss", expression_spec=two))
    fb = options_compat_header(_options("L2DistLoss", expression_spec=three))
    assert fa["template_combiner_fp"] != fb["template_combiner_fp"]
    assert fa["expression_spec"] == fb["expression_spec"]
