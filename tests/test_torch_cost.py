"""Port parity: the wave cost model (``serve/cost.py``, numpy only) against
the JAX package's.

Fed the same observations, both models predict the same microseconds
exactly (the same numpy least squares), pick the same decode K, and write
and read the same artifacts.  Keying: the port's engine keys its model by
the torch device type, so a JAX-written artifact keyed ``tpu``, ``gpu`` or
``cpu`` never seeds a model keyed ``cuda`` — it is shelved and re-exported
verbatim.
"""
import json

import numpy as np
import pytest

from repro.serve.cost import WaveCostModel as JaxCost
from repro.serve.cost import cost_key as jax_key
from repro_torch.core import esn as tesn
from repro_torch.core.params import ESNConfig
from repro_torch.serve.cost import WaveCostModel, cost_key
from repro_torch.serve.engine import ReservoirEngine

BUCKETS = (16, 32, 64, 128, 256, 512)


def _feed(seed, models):
    """Draw one random observation stream and feed it to every model."""
    rng = np.random.default_rng(seed)
    stream = []
    for _ in range(int(rng.integers(5, 120))):
        kind = str(rng.choice(["prefill", "decode", "page", "refit"],
                              p=[0.55, 0.25, 0.1, 0.1]))
        stream.append((kind, int(rng.integers(0, 9)),
                       float(rng.uniform(-5.0, 4000.0)),
                       int(rng.choice(BUCKETS)),
                       int(rng.choice([1, 2, 4, 8]))))
    for m in models:
        for kind, b, us, t, k in stream:
            if kind == "prefill":
                m.observe(b, t, us)
            elif kind == "decode":
                m.observe_decode(b, us, k=k)
            elif kind == "page":
                m.observe_page(b, us)
            else:
                m.observe_refit(b, us)


def _predictions(m):
    out = [m.predict_us(b, t) for b in range(0, 10) for t in BUCKETS + (8,)]
    out += [m.predict_decode_us(b, k) for b in range(1, 10)
            for k in (1, 2, 3, 8, 64)]
    out += [m.predict_page_us(b) for b in range(0, 10)]
    out += [m.predict_refit_us(b) for b in range(0, 10)]
    out += [m.best_decode_k(b, slo_us=slo) for b in (1, 3, 8)
            for slo in (None, 1.0, 500.0, 5e4)]
    out += [m.throughput(b, t, b * t // 2) for b in (1, 4) for t in BUCKETS]
    return out + [m.n_observations]


@pytest.mark.parametrize("seed", range(8))
def test_predictions_equal_jax_on_the_same_observations(seed):
    port, ref = WaveCostModel(), JaxCost()
    _feed(seed, [port, ref])
    assert _predictions(port) == _predictions(ref)
    assert port.records() == ref.records()


def test_cold_constants_equal_jax():
    kw = dict(base_us=10.0, per_token_us=0.5, decode_base_us=7.0,
              decode_per_row_us=3.0, page_base_us=2.0, page_per_row_us=1.0,
              refit_base_us=9.0, refit_per_row_us=4.0)
    assert _predictions(WaveCostModel(**kw)) == _predictions(JaxCost(**kw))
    assert _predictions(WaveCostModel()) == _predictions(JaxCost())


def test_decode_surface_recovers_affine_fit():
    """``tests/test_decode_aware.py``: alpha + beta B from K = 1 waves."""
    m = WaveCostModel()
    for b in (1, 2, 4, 8, 4):
        m.observe_decode(b, 80.0 + 5.0 * b)
    assert m.predict_decode_us(3) == pytest.approx(95.0, rel=1e-6)
    assert m.predict_decode_us(16) == pytest.approx(160.0, rel=1e-6)
    cold = WaveCostModel()
    assert cold.predict_decode_us(8) > cold.predict_decode_us(1) >= 1.0


def test_artifact_round_trip_and_cross_reading(tmp_path):
    """A port artifact keeps other keys, reloads to the same predictions,
    and reads the same in the JAX model (and the other way round)."""
    path = tmp_path / "costs.json"
    path.write_text(json.dumps({"decode": {"tokens": 123},
                                "wave_costs": [{"b": 9, "t_bucket": 16,
                                                "us": 1.0}]}))
    m = WaveCostModel()
    _feed(3, [m])
    m.to_artifact(str(path))
    data = json.loads(path.read_text())
    assert data["decode"] == {"tokens": 123}
    assert len(data["wave_costs"]) == m.n_observations
    # A reload groups the records by surface, so the least squares sum in
    # another order: the same fit to rounding; and both packages read the
    # file to the same bits.
    back = WaveCostModel.from_artifact(str(path))
    assert _predictions(back) == pytest.approx(_predictions(m), rel=1e-9)
    assert _predictions(JaxCost.from_artifact(str(path))) == \
        _predictions(back)
    jm = JaxCost()
    _feed(4, [jm])
    jpath = tmp_path / "jax.json"
    jm.to_artifact(str(jpath))
    assert _predictions(WaveCostModel.from_artifact(str(jpath))) == \
        _predictions(JaxCost.from_artifact(str(jpath)))
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert WaveCostModel.from_artifact(str(bad)).n_observations == 0
    m.to_artifact(str(bad))
    assert WaveCostModel.from_artifact(str(bad)).n_observations == \
        m.n_observations


@pytest.mark.parametrize("backend", ("tpu", "gpu", "cpu"))
def test_jax_keyed_artifacts_never_seed_a_cuda_model(tmp_path, backend):
    """The existing key rule shelves another machine's records: a JAX
    artifact keyed ``tpu`` / ``gpu`` / ``cpu`` fits nothing in a model keyed
    ``cuda`` and is re-exported verbatim."""
    jm = JaxCost(key=jax_key(backend, 64, 1))
    _feed(5, [jm])
    path = tmp_path / "jax.json"
    jm.to_artifact(str(path))
    port = WaveCostModel.from_artifact(str(path), key=cost_key("cuda", 64, 1))
    assert port.key == ("cuda", 64, 1)
    assert _predictions(port)[:-1] == _predictions(WaveCostModel())[:-1]
    assert port.records() == jm.records()           # shelved, re-exported
    # Un-keyed (legacy) records shelve too, with a warning.
    legacy = WaveCostModel(key=cost_key("cuda", 64, 1))
    with pytest.warns(UserWarning, match="legacy"):
        assert legacy.seed([{"b": 2, "t_bucket": 16, "us": 5.0}]) == 0
    # Same key: the records fit.
    same = WaveCostModel.from_artifact(str(path), key=cost_key(backend, 64, 1))
    assert _predictions(same) == _predictions(
        JaxCost.from_artifact(str(path), key=jax_key(backend, 64, 1)))
    assert same.n_observations == jm.n_observations


def test_engine_builds_a_model_keyed_by_its_device():
    cfg = ESNConfig(n=24, seed=1)
    p = tesn.dpg_params(cfg, device="cpu")
    eng = ReservoirEngine(p, 2, device="cpu", decode_slo_us=100.0)
    assert eng.cost_model.key == ("cpu", 24, 1)
    assert eng.scheduler.cost_model is eng.cost_model
    assert ReservoirEngine(p, 2, device="cpu").cost_model is None
    auto = ReservoirEngine(p, 2, device="cpu", decode_wave_tokens="auto")
    assert auto.cost_model is not None and auto.decode_wave_tokens == 1
    eng.reset()
    assert eng.scheduler.cost_model is eng.cost_model


def test_stats_wave_costs_export_is_not_ring_bounded():
    """``stats().wave_costs`` is the cost model's records, not the
    256-entry wave log."""
    cfg = ESNConfig(n=24, seed=1)
    m = WaveCostModel()
    for i in range(300):
        m.observe(1 + i % 4, 16 << (i % 5), 100.0 + i)
    eng = ReservoirEngine(tesn.dpg_params(cfg, device="cpu"), 2,
                          device="cpu", cost_model=m)
    st = eng.stats()
    assert len(st.wave_log) <= 256
    assert st.wave_costs == m.records()
    assert len(st.wave_costs) == m.n_observations > 256
