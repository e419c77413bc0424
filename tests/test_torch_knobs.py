"""The port's knob registry and tuned-manifest overlay against the JAX
package's: every knob's name, layer, kind, default, choices, bounds and
probe grid are equal; ``validate`` accepts and refuses the same values
with the same messages; ``search_space``, ``write_manifest`` and
``load_manifest`` agree; and a manifest the JAX ``write_manifest``
wrote gives the same overrides on both packages' configs, explicit
fields winning, through the trainers' own overlay."""

import json
import math

import pytest

from dgl_operator_tpu.autotune import knobs as JK
from dgl_operator_tpu.runtime import TrainConfig as JaxTrainConfig
from dgl_operator_tpu.runtime.kge import KGETrainConfig as JaxKGETrainConfig
from dgl_operator_tpu_torch.autotune import knobs as K
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.models.kge import KGEConfig
from dgl_operator_tpu_torch.models.sage import DistSAGE
from dgl_operator_tpu_torch.obs import get_obs
from dgl_operator_tpu_torch.runtime.kge import KGETrainConfig, KGETrainer
from dgl_operator_tpu_torch.runtime.loop import SampledTrainer, TrainConfig

pytestmark = pytest.mark.autotune

FIELDS = ("name", "kind", "layer", "default", "choices", "lo", "hi",
          "probe_values", "label", "choice_msg")


@pytest.fixture(autouse=True)
def no_manifest(monkeypatch):
    monkeypatch.delenv(K.TUNED_MANIFEST_ENV, raising=False)


def test_the_registries_hold_the_same_knobs():
    assert list(K.REGISTRY) == list(JK.REGISTRY)
    assert K.LAYERS == JK.LAYERS
    assert (K.TUNED_MANIFEST_ENV, K.MANIFEST_VERSION) == (
        JK.TUNED_MANIFEST_ENV, JK.MANIFEST_VERSION)


@pytest.mark.parametrize("name", sorted(JK.REGISTRY))
def test_knob_equals_the_jax_knob(name):
    want, got = JK.REGISTRY[name], K.REGISTRY[name]
    assert {f: getattr(got, f) for f in FIELDS} == {
        f: getattr(want, f) for f in FIELDS}


def _candidates(k):
    vals = [k.default, None, "x", True, False, 0, 1, -1, 0.5, 2, 3, 4,
            1e9, -1e9, float("nan")]
    vals += list(k.choices or ()) + list(k.probe_values)
    for b in (k.lo, k.hi):
        if b is not None:
            vals += [b, b - 1, b + 1, b - 0.05, b + 0.05]
    return vals


def _outcome(mod, name, value):
    try:
        v = mod.validate(name, value)
    except (ValueError, TypeError) as exc:
        return type(exc).__name__, str(exc)
    return ("ok", "nan" if isinstance(v, float) and math.isnan(v)
            else repr(v))


@pytest.mark.parametrize("name", sorted(JK.REGISTRY))
def test_validate_accepts_and_refuses_as_jax(name):
    for value in _candidates(JK.REGISTRY[name]):
        assert _outcome(K, name, value) == _outcome(JK, name, value), value


def test_search_space_and_unknown_knobs_as_jax():
    searchable = [n for n, k in JK.REGISTRY.items() if k.probe_values]
    assert K.search_space(searchable) == JK.search_space(searchable)
    for name in ("resume", "shard_rules"):
        with pytest.raises(ValueError, match="no probe grid"):
            K.search_space([name])
    with pytest.raises(KeyError, match="unknown knob"):
        K.validate("prefetch_depth", 1)


MANIFEST = {"prefetch": 4, "num_samplers": 2, "halo_cache_frac": 0.5,
            "pipeline_mode": "staged", "pipeline_depth": 2,
            "donate": False, "cap_policy": "worst", "sentry": False,
            "quality_window": 16, "quality_action": "warn",
            "gather_depth": 4, "part_method": "flat", "slo_p99_ms": 120.0}


@pytest.fixture
def manifest(tmp_path):
    path = str(tmp_path / "tuned.json")
    JK.write_manifest(path, MANIFEST, score=2.5, baseline_score=2.0,
                      search={"rounds": 3})
    return path


def test_manifests_round_trip_between_the_packages(manifest, tmp_path):
    assert K.load_manifest(manifest) == JK.load_manifest(manifest)
    mine = str(tmp_path / "port.json")
    K.write_manifest(mine, MANIFEST, score=2.5, baseline_score=2.0,
                     search={"rounds": 3})
    assert json.load(open(mine)) == json.load(open(manifest))
    for layer in K.LAYERS:
        assert K.overrides_for(K.load_manifest(manifest), layer) == \
            JK.overrides_for(JK.load_manifest(manifest), layer)
    bad = dict(json.load(open(manifest)), version=2)
    json.dump(bad, open(mine, "w"))
    with pytest.raises(ValueError, match="version"):
        K.load_manifest(mine)
    json.dump(dict(bad, version=1, knobs={"prefetch": -3}), open(mine, "w"))
    with pytest.raises(ValueError, match="prefetch must be >= 0"):
        K.load_manifest(mine)


def _fields(cfg, names):
    return {n: getattr(cfg, n) for n in names}


@pytest.mark.parametrize("layers", [("train",), ("train", "quality"),
                                    ("train", "quality", "shard")])
def test_the_overlay_gives_the_jax_overrides(manifest, layers):
    port, jax_cfg = TrainConfig(), JaxTrainConfig()
    for layer in layers:
        port = K.apply_tuned(port, layer=layer, manifest_path=manifest)
        jax_cfg = JK.apply_tuned(jax_cfg, layer=layer,
                                 manifest_path=manifest)
    names = [n for n in MANIFEST if hasattr(port, n)]
    assert _fields(port, names) == _fields(jax_cfg, names)
    assert port.prefetch == 4
    assert (port.sentry is False) == ("quality" in layers)
    assert (port.gather_depth == 4) == ("shard" in layers)


def test_explicit_fields_win(manifest):
    """A field set away from its default keeps its value; one left at
    the default (even when passed explicitly) takes the manifest's."""
    port = K.apply_tuned(TrainConfig(prefetch=1, pipeline_depth=3),
                         manifest_path=manifest)
    want = JK.apply_tuned(JaxTrainConfig(prefetch=1, pipeline_depth=3),
                          manifest_path=manifest)
    assert (port.prefetch, port.pipeline_depth) == (1, 3) == (
        want.prefetch, want.pipeline_depth)
    assert port.pipeline_mode == want.pipeline_mode == "staged"
    # without a manifest the config is returned as it is
    cfg = TrainConfig()
    assert K.apply_tuned(cfg) is cfg


def test_the_trainers_apply_the_manifest(manifest, monkeypatch):
    monkeypatch.setenv(K.TUNED_MANIFEST_ENV, manifest)
    g = datasets.synthetic_node_clf(200, 800, 8, 4, seed=1).graph
    tr = SampledTrainer(DistSAGE(8, 8, 4, device="cpu"), g,
                        TrainConfig(prefetch=1, eval_every=0, fanouts=(3, 3),
                                    batch_size=16), device="cpu")
    assert (tr.cfg.prefetch, tr.cfg.num_samplers, tr.cfg.sentry,
            tr.cfg.quality_window) == (1, 2, False, 16)
    assert tr.cfg.gather_depth == 2        # a shard knob: DistTrainer's
    kge = KGETrainer(KGEConfig(model_name="TransE_l2", n_entities=20,
                               n_relations=3, hidden_dim=8, gamma=12.0),
                     KGETrainConfig(quality_window=64), device="cpu")
    assert (kge.tcfg.sentry, kge.tcfg.quality_window,
            kge.tcfg.quality_action) == (False, 64, "warn")
    want = JK.apply_tuned(JK.apply_tuned(JaxKGETrainConfig(
        quality_window=64), layer="kge"), layer="quality")
    assert (want.sentry, want.quality_window, want.quality_action) == (
        False, 64, "warn")
    c = get_obs().metrics.counter("autotune_overrides_applied_total",
                                  labels=("knob",))
    assert c.value(knob="num_samplers") >= 1
