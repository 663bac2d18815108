"""The port's network and factories against the JAX package's.

Inputs come from seeded numpy and reach both packages as numpy; flax
params cross over through ``gordo_tpu_torch.convert``.  Tolerance: the
ROADMAP parity metric ``max|ref - port| / max|ref|`` per output, <= 1e-5
in float32 (both sides compute in fp32; the two sum each dense layer in
different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.models.factories import feedforward as jax_ff
from gordo_tpu.models.factories.utils import hourglass_calc_dims as jax_dims
from gordo_tpu_torch.convert import flax_to_state_arrays
from gordo_tpu_torch.device import resolve_compute_dtype
from gordo_tpu_torch.kernels.fleet_score import ACT_CODES, fleet_score
from gordo_tpu_torch.models.factories import feedforward as port_ff
from gordo_tpu_torch.models.factories.utils import hourglass_calc_dims as port_dims

TOL = 1e-5


def max_norm_err(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(ref - got)) / max(np.max(np.abs(ref)), 1e-30))


@pytest.mark.parametrize("n_features", [1, 2, 4, 10, 37, 128])
@pytest.mark.parametrize("encoding_layers", [1, 2, 3, 5])
@pytest.mark.parametrize("compression_factor", [0.0, 0.1, 0.25, 0.5, 0.8, 1.0])
def test_hourglass_calc_dims_matches(n_features, encoding_layers, compression_factor):
    assert port_dims(compression_factor, encoding_layers, n_features) == jax_dims(
        compression_factor, encoding_layers, n_features
    )


@pytest.mark.parametrize("args", [(1.5, 3, 10), (-0.1, 3, 10), (0.5, 0, 10)])
def test_hourglass_calc_dims_rejects_what_jax_rejects(args):
    with pytest.raises(ValueError):
        jax_dims(*args)
    with pytest.raises(ValueError):
        port_dims(*args)


def test_activation_tables_match():
    assert set(port_ff.ACTIVATIONS) == set(jax_ff.ACTIVATIONS)
    assert set(ACT_CODES) == set(jax_ff.ACTIVATIONS)


def _flax_and_port(act, seed=0, n_features=6):
    kw = dict(
        n_features=n_features, encoding_dim=(5, 4), decoding_dim=(4, 5),
        encoding_func=act, decoding_func=act, out_func=act,
    )
    module = jax_ff.feedforward_model(compute_dtype="float32", **kw)
    params = module.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, n_features), jnp.float32)
    )["params"]
    params = jax.tree.map(np.asarray, params)
    port = port_ff.feedforward_model(**kw)
    port.load_state_dict(
        {k: torch.from_numpy(v) for k, v in flax_to_state_arrays(params).items()}
    )
    return module, params, port


@pytest.mark.parametrize("act", list(jax_ff.ACTIVATIONS))
def test_feedforward_matches_flax_apply(act):
    module, params, port = _flax_and_port(act)
    X = (2.0 * np.random.default_rng(1).standard_normal((64, 6))).astype(np.float32)
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(X)))
    with torch.no_grad():
        got = port(torch.from_numpy(X)).numpy()
    assert got.shape == ref.shape
    assert max_norm_err(ref, got) <= TOL
    # the fused kernel's CPU path computes the same network
    layers = [
        (torch.from_numpy(lin.weight.detach().numpy().T.copy())[None],
         lin.bias.detach()[None])
        for lin, _ in port.layers()
    ]
    acts = [a for _, a in port.layers()]
    out = fleet_score(torch.from_numpy(X)[None], layers, acts)["model-output"][0]
    assert max_norm_err(ref, out.numpy()) <= TOL


@pytest.mark.parametrize("kind,kwargs", [
    ("feedforward_hourglass", {}),
    ("feedforward_hourglass", {"encoding_layers": 2, "compression_factor": 0.3, "func": "relu"}),
    ("feedforward_symmetric", {"dims": (7, 3), "funcs": ("elu", "selu")}),
    ("feedforward_model", {"encoding_dim": (8,), "decoding_dim": (6, 9)}),
])
def test_factories_build_the_same_layers(kind, kwargs):
    jax_module = getattr(jax_ff, kind)(10, compute_dtype="float32", **kwargs)
    params = jax_module.init(jax.random.PRNGKey(0), jnp.zeros((1, 10)))["params"]
    port = getattr(port_ff, kind)(10, **kwargs)
    want = {k: v.shape for k, v in flax_to_state_arrays(params).items()}
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
    assert port.funcs == tuple(jax_module.funcs)
    assert port.out_func == jax_module.out_func


def test_default_width_is_the_bench_hourglass():
    port = port_ff.feedforward_hourglass(10)
    widths = [port.dense_0.in_features] + [lin.out_features for lin, _ in port.layers()]
    assert widths == [10, 8, 7, 5, 5, 7, 8, 10]
    assert sum(lin.weight.numel() for lin, _ in port.layers()) == 367


def test_compute_dtype_is_float32_only():
    assert resolve_compute_dtype("auto") == torch.float32
    assert resolve_compute_dtype("float32") == torch.float32
    with pytest.raises(NotImplementedError, match="item 2"):
        resolve_compute_dtype("bfloat16")
    with pytest.raises(NotImplementedError):
        port_ff.feedforward_hourglass(4, compute_dtype="bfloat16")
