"""A MinMax step's offset rounds as the fleet programs round it.

``MinMaxScaler.compute_stats`` (``gordo_tpu/ops/scalers.py:139-145``) ends
in ``offset = a - lo * scale``.  Inside ``fleet.exact`` (and
``fleet.padded``) XLA:CPU emits the product and the difference in one loop
fusion (the optimised HLO's ``bitcast_concatenate_fusion`` that gathers
every row list's offsets holds ``multiply`` then ``subtract``), and
contracts them into one FMA, after any earlier step and with none.  The
reference's eager ``fit`` runs the two as separate operations and rounds
twice.  So the port's fleet build asks ``scaler_stats`` for the fused form
(``offset_fma``, ``parallel/anomaly.py::_stats``) and its ``fit`` keeps two
roundings.

Feedforward detectors (4 tags, 1 epoch) of 3 machines × 140–160 rows of
``torch_parity.sine_rows`` plus a level of 0 or 1e4, built by both
packages on the CPU (the port from the JAX package's draws), with a MinMax
step of range (1, -1), so that ``a`` is not 0 and the two forms differ:

- ``Standard → MinMax``: the MinMax step's offsets and scales are
  ``fleet.exact``'s bit for bit (rounded twice they were up to 32 ulp off);
- ``Standard → MinMax → Robust``: so is the Robust step's centre and scale
  after it (it carried those offsets: up to 64 ulp off).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.ops.scalers import MinMaxScaler as JaxMinMaxScaler
from gordo_tpu.parallel.anomaly import FleetDiffBuilder as JaxBuilder
from gordo_tpu.parallel.anomaly import analyze_definition as jax_analyze
from gordo_tpu.serializer import from_definition as jax_from_definition
from gordo_tpu_torch.kernels import scaler_stats as ss
from gordo_tpu_torch.ops.scalers import MinMaxScaler
from gordo_tpu_torch.parallel.anomaly import FleetDiffBuilder, analyze_definition
from gordo_tpu_torch.serializer import from_definition
from torch_parity import jax_draws, sine_rows

TAGS, MACHINES = 4, 3
SCALERS = "gordo_tpu.ops.scalers"
FLIPPED = {f"{SCALERS}.MinMaxScaler": {"feature_range": [1, -1]}}
CHAINS = {
    "standard_minmax": [f"{SCALERS}.StandardScaler", FLIPPED],
    "standard_minmax_robust": [f"{SCALERS}.StandardScaler", FLIPPED, f"{SCALERS}.RobustScaler"],
}
LEVELS = (0.0, 1e4)


def definition(steps):
    estimator = {"gordo_tpu.models.estimator.AutoEncoder": {
        "kind": "feedforward_hourglass", "epochs": 1, "batch_size": 64}}
    return {"gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector": {
        "scaler": f"{SCALERS}.MinMaxScaler",
        "base_estimator": {"gordo_tpu.pipeline.Pipeline": {"steps": [*steps, estimator]}}}}


def inputs(level: float):
    rng = np.random.default_rng(73)
    return [sine_rows(rng, 140 + 10 * i, TAGS, phase=0.6 * i) + np.float32(level)
            for i in range(MACHINES)]


def ulps(want, have) -> int:
    w = np.asarray(want, np.float32).view(np.int32).astype(np.int64)
    h = np.asarray(have, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(w - h).max())


@pytest.mark.parametrize("name", list(CHAINS))
@pytest.mark.parametrize("level", LEVELS)
def test_chain_stats_are_fleet_exact_s(name, level):
    Xs = inputs(level)
    d = definition(CHAINS[name])
    refs = JaxBuilder(jax_analyze(jax_from_definition(d))).build(Xs)
    gots = FleetDiffBuilder(analyze_definition(from_definition(d)), device="cpu",
                            draws=jax_draws).build(Xs)
    for i, (ref, got) in enumerate(zip(refs, gots)):
        ref_steps = [step for _, step in ref.base_estimator.steps[:-1]]
        got_steps = [step for _, step in got.base_estimator.steps[:-1]]
        assert len(ref_steps) == len(got_steps) == len(CHAINS[name])
        for j, (r, g) in enumerate(zip(ref_steps, got_steps)):
            for key, leaf in r.stats_.items():
                assert ulps(leaf, g.stats_[key]) == 0, (i, j, key, ulps(leaf, g.stats_[key]))


def test_the_two_forms_differ_and_the_eager_fit_rounds_twice():
    """The fused and the twice-rounded offsets differ on these rows, and a
    MinMax scaler fitted alone is the reference's eager ``fit`` bit for
    bit, two roundings."""
    X = inputs(0.0)[2]
    x = torch.from_numpy(X)[None].contiguous()
    whole = [np.arange(X.shape[0])]
    _, once = ss.scaler_stats(x, whole, (-1.0, 1.0), offset_fma=True)
    _, twice = ss.scaler_stats(x, whole, (-1.0, 1.0))
    assert ulps(once, twice) > 0
    ref = JaxMinMaxScaler(feature_range=(-1, 1)).fit(jnp.asarray(X)).stats_
    got = MinMaxScaler(feature_range=(-1, 1)).fit(X, device="cpu").stats_
    for key in ("scale", "offset"):
        assert ulps(ref[key], got[key]) == 0, key
