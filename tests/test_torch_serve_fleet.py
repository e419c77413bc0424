"""The port's HTTP serving plane and fleet router against the JAX
package's, on the CPU.

One 4-part book written by the JAX partitioner and one JAX-written
serving export feed every plane. The ring and the weights equal the
JAX router's; routing goes by owner partition and skips degraded
replicas; a replica killed mid-stream is drained with no request
dropped and regrows; a canary of a NaN-filled candidate rolls back and
a clean one promotes through the fence; one failover request is one
span tree; ``/healthz`` answers 503 before the engine is warm;
``/metrics`` is the JAX package's ``render_prometheus`` of the same
snapshot; the SLO monitors' edges agree; and the same ``/predict`` to a
JAX plane and a port plane returns the same predictions.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dgl_operator_tpu.graph import datasets as jax_datasets
from dgl_operator_tpu.graph.blocks import FanoutBlock as JaxFanoutBlock
from dgl_operator_tpu.graph.partition import partition_graph
from dgl_operator_tpu.models.sage import DistSAGE as JaxDistSAGE
from dgl_operator_tpu.obs import metrics as jax_metrics
from dgl_operator_tpu.obs import slo as jax_slo
from dgl_operator_tpu.runtime.checkpoint import \
    export_for_serving as jax_export
from dgl_operator_tpu.serve import router as jax_router
from dgl_operator_tpu.serve.engine import ServeConfig as JaxServeConfig
from dgl_operator_tpu.serve.engine import ServeEngine as JaxServeEngine
from dgl_operator_tpu.serve.server import ServingPlane as JaxServingPlane
from dgl_operator_tpu_torch.models.sage import DistSAGE
from dgl_operator_tpu_torch.obs import get_obs, tracectx
from dgl_operator_tpu_torch.obs.metrics import (render_prometheus,
                                                render_quantile_gauges)
from dgl_operator_tpu_torch.obs.slo import SLOMonitor
from dgl_operator_tpu_torch.runtime.checkpoint import (ServingPromotion,
                                                       export_for_serving,
                                                       load_params,
                                                       promotion_history,
                                                       read_fence)
from dgl_operator_tpu_torch.serve import (CanaryController, FleetRouter,
                                          HashRing, Replica, ServeConfig,
                                          ServeEngine, ServingPlane,
                                          infer_sage_dims, weight_of)
from dgl_operator_tpu_torch.serve.router import _http_json
from test_torch_native import use_jax_graphcore

pytestmark = pytest.mark.serve

FEAT, HIDDEN, CLASSES = 12, 16, 4
FANOUTS = (3, 4)
BATCH = 16
KW = dict(fanouts=FANOUTS, batch_size=BATCH, cap_policy="worst",
          halo_cache_frac=0.25, max_wait_ms=1.0)


@pytest.fixture(autouse=True)
def jax_library(monkeypatch, tmp_path_factory):
    use_jax_graphcore(monkeypatch, tmp_path_factory)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        use_jax_graphcore(mp, tmp_path_factory)
        ds = jax_datasets.synthetic_node_clf(num_nodes=500, num_edges=2500,
                                             feat_dim=FEAT,
                                             num_classes=CLASSES, seed=3)
        out = tmp_path_factory.mktemp("fleet")
        cfg_json = partition_graph(ds.graph, "synth", 4, str(out / "book"))
        model = JaxDistSAGE(hidden_feats=HIDDEN, out_feats=CLASSES,
                            dropout=0.0)
        blk = JaxFanoutBlock(jnp.zeros((2, 3), jnp.int32),
                             jnp.ones((2, 3), jnp.float32), 4)
        params = jax.device_get(model.init(jax.random.PRNGKey(0),
                                           [blk, blk], jnp.ones((4, FEAT))))
        rng = np.random.default_rng(0)
        params = jax.tree_util.tree_map(
            lambda x: np.asarray(x) + 0.1 * rng.normal(size=np.shape(x))
            .astype(np.float32), params)
        path = jax_export(str(out / "export") + "/", params)
        yield ds, cfg_json, path, model


def _engine(served, warm=True):
    _, cfg_json, path, _ = served
    return ServeEngine(DistSAGE(FEAT, HIDDEN, CLASSES, device="cpu"),
                       cfg_json, params_path=path, cfg=ServeConfig(**KW),
                       warm=warm, device="cpu")


class Fleet:
    """Port planes on ephemeral ports and a router over them."""

    def __init__(self, served, names, **router_kw):
        self.planes = {n: ServingPlane(_engine(served), port=0,
                                       slo_interval_s=0, name=n).start()
                       for n in names}
        self.node_map = np.asarray(self.planes[names[0]].engine.node_map)
        self.router = FleetRouter(
            [Replica(n, "127.0.0.1", p.port, plane=p)
             for n, p in self.planes.items()],
            node_map=self.node_map, probe_timeout_s=1.0, **router_kw)

    def close(self):
        for p in self.planes.values():
            p.stop()


@pytest.fixture
def fleet(served):
    made = []

    def make(names, **kw):
        made.append(Fleet(served, names, **kw))
        return made[-1]
    yield make
    for f in made:
        f.close()


# ---------------------------------------------------------------------
# the ring and the weights, as the JAX router's
# ---------------------------------------------------------------------
def test_hash_ring_and_weights_equal_jax():
    for names in (["r0", "r1", "r2"], ["a", "b"], ["solo"]):
        for vnodes in (8, 64):
            mine = HashRing(names, vnodes=vnodes)
            theirs = jax_router.HashRing(list(reversed(names)),
                                         vnodes=vnodes)
            for k in [f"part-{i}" for i in range(16)] + ["nodes-1,2,3"]:
                assert mine.candidates(k) == theirs.candidates(k)
    with pytest.raises(ValueError, match="at least one"):
        HashRing([])
    base = {"ready": True, "slo": {"ok": True, "targets": {"p99_ms": 50.0}}}
    for livez in (None, {"ready": False}, base, {**base, "shedding": True},
                  {**base, "slo": {"ok": False,
                                   "targets": {"p99_ms": 50.0}}},
                  {**base, "p99_ms": 100.0}, {**base, "p99_ms": 5000.0},
                  {**base, "p99_ms": 20.0}):
        assert weight_of(livez) == jax_router.weight_of(livez)


def test_router_routes_by_owner_partition_and_skips_degraded():
    node_map = np.array([0, 0, 1, 1, 2, 2, 3, 3])
    router = FleetRouter([Replica(f"r{i}", "127.0.0.1", 1)
                          for i in range(3)], node_map=node_map)
    healthy = {"ready": True, "p99_ms": 5.0,
               "slo": {"ok": True, "targets": {"p99_ms": 50.0}}}
    router.update_health({f"r{i}": dict(healthy) for i in range(3)})
    for part, seeds in ((0, [0, 1]), (1, [2, 3]), (2, [4]), (3, [6])):
        chain = [r.name for r in router.route(seeds)]
        assert chain == router.ring.candidates(f"part-{part}")
        assert chain == [r.name for r in router.route(seeds[:1])]
    head = router.route([0])[0].name
    failovers = router._m_failovers.value()
    router.update_health({head: {**healthy, "shedding": True}})
    chain = [r.name for r in router.route([0])]
    assert chain[0] != head and chain[-1] == head and len(chain) == 3
    router.mark_down(head, reason="test")
    assert router.replicas_up() == 2
    assert head not in [r.name for r in router.route([0])]
    router.mark_down(head)
    assert router._m_failovers.value() == failovers + 1
    router.readmit(head)
    state = router.fleet_state()
    assert state["replicas_up"] == 3 and state["replicas"][head]["state"] \
        == "up"


# ---------------------------------------------------------------------
# the planes
# ---------------------------------------------------------------------
def test_healthz_is_503_until_the_engine_is_warm(served):
    plane = ServingPlane(_engine(served, warm=False), port=0,
                         slo_interval_s=0, name="cold").start()
    try:
        code, hz = _http_json("GET", "127.0.0.1", plane.port, "/healthz")
        assert code == 503 and hz["ok"] is False and hz["replica"] == "cold"
        plane.engine.warmup()
        code, hz = _http_json("GET", "127.0.0.1", plane.port, "/healthz")
        assert code == 200 and hz["ok"] and hz["device"] == "cpu"
        code, lz = _http_json("GET", "127.0.0.1", plane.port, "/livez")
        assert code == 200 and lz["ready"] and lz["slo"]["ok"]
        code, err = _http_json("POST", "127.0.0.1", plane.port, "/predict",
                               {"seeds": [1]})
        assert code == 400 and "nodes" in err["error"]
    finally:
        plane.stop()


def test_metrics_text_is_the_jax_rendering(served):
    plane = ServingPlane(_engine(served), port=0, slo_interval_s=0).start()
    try:
        for ids in ([1, 2, 3], list(range(40, 70))):
            code, _ = _http_json("POST", "127.0.0.1", plane.port,
                                 "/predict", {"nodes": ids})
            assert code == 200
        import urllib.request
        with urllib.request.urlopen(
                f"http://127.0.0.1:{plane.port}/metrics") as r:
            text = r.read().decode()
        snap = get_obs().metrics.snapshot()
        assert render_prometheus(snap) == jax_metrics.render_prometheus(snap)
        assert render_quantile_gauges(snap) == \
            jax_metrics.render_quantile_gauges(snap)
        assert text == (jax_metrics.render_prometheus(snap)
                        + jax_metrics.render_quantile_gauges(snap))
        assert 'serve_quantile_seconds{family="serve_request_seconds"' in text
        h = get_obs().metrics.histogram("serve_request_seconds")
        fam = snap["serve_request_seconds"]
        assert h.quantile(0.5) == jax_metrics.quantile_from_counts(
            fam["buckets"], fam["samples"][0]["counts"], 0.5)
    finally:
        plane.stop()


def test_slo_monitor_edges_equal_jax():
    clock = [0.0]
    targets = {"p99_ms": 50.0, "min_heartbeat_hz": 1.0}
    mine = SLOMonitor(targets=targets, window_s=3.0, clock=lambda: clock[0])
    theirs = jax_slo.SLOMonitor(targets=targets, window_s=3.0,
                                clock=lambda: clock[0])
    stream = ([{"p99_ms": 10.0}] * 3 + [{"p99_ms": 90.0}] * 4
              + [{"p99_ms": 10.0, "heartbeat_hz": 0.5}] * 3
              + [{"p99_ms": 5.0, "heartbeat_hz": 2.0}] * 5
              + [{"heartbeat_hz": 0.1, "done": True}])
    n0 = len(get_obs().events)
    flips = 0
    for snap in stream:
        clock[0] += 1.0
        got, want = mine.evaluate(snap), theirs.evaluate(snap)
        assert got == want
        assert mine.state() == theirs.state()
        flips += bool(got)
    edges = [(e["kind"], e["target"]) for e in list(get_obs().events)[n0:]
             if e["kind"] in ("slo_breach", "slo_recovered")]
    assert ("slo_breach", "p99_ms") in edges
    assert ("slo_recovered", "p99_ms") in edges and flips


def test_port_and_jax_planes_answer_the_same_predictions(served):
    """One JAX-written export behind a JAX plane and a port plane, the
    same requests in the same order (one micro-batch each): the same
    predictions."""
    ds, cfg_json, path, model = served
    jeng = JaxServeEngine(model, cfg_json, params_path=path,
                          cfg=JaxServeConfig(**KW))
    jplane = JaxServingPlane(jeng, port=0, slo_interval_s=0,
                             name="jax").start()
    plane = ServingPlane(_engine(served), port=0, slo_interval_s=0,
                         name="port").start()
    assert infer_sage_dims(load_params(path)) == (2, HIDDEN, CLASSES)
    try:
        rng = np.random.default_rng(5)
        for size in (1, 7, BATCH, 3 * BATCH):
            ids = rng.choice(ds.graph.num_nodes, size=size, replace=False)
            body = {"nodes": ids.tolist()}
            cj, pj = _http_json("POST", "127.0.0.1", jplane.port,
                                "/predict", body)
            cp, pp = _http_json("POST", "127.0.0.1", plane.port,
                                "/predict", body)
            assert cj == cp == 200
            assert pp["predictions"] == pj["predictions"]
    finally:
        jplane.stop()
        plane.stop()


# ---------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------
def test_replica_death_is_drained_and_regrows(served, fleet):
    f = fleet(["r0", "r1", "r2"], request_timeout_s=60.0)
    router = f.router
    victim = router.ring.candidates("part-0")[0]
    part0 = np.flatnonzero(f.node_map == 0)
    assert router.route(part0[:1])[0].name == victim
    codes, lock = [], threading.Lock()
    retries, failovers = (router._m_retries.value(),
                          router._m_failovers.value())

    def client(c):
        for i in range(6):
            seeds = part0[(2 * i + c) % len(part0):][:3]
            code, payload = router.forward(seeds)
            with lock:
                codes.append((code, len(payload.get("predictions", []))
                              == len(seeds)))
            if c == 0 and i == 2:
                f.planes[victim].kill()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert codes == [(200, True)] * 18          # none dropped
    router.probe_once()
    assert router.replica(victim).state == "down"
    assert router.replicas_up() == 2
    assert get_obs().metrics.gauge("fleet_replicas_up").value() == 2
    assert router._m_failovers.value() == failovers + 1
    assert router._m_retries.value() >= retries
    # regrow: a new plane under the victim's ring name
    reborn = ServingPlane(_engine(served), port=0, slo_interval_s=0,
                          name=victim).start()
    f.planes[victim + "-reborn"] = reborn
    rep = router.replica(victim)
    rep.port, rep.plane = reborn.port, reborn
    router.probe_once()
    assert router.replica(victim).state == "up" and router.replicas_up() == 3
    fwd0 = rep.forwarded
    code, _ = router.forward(part0[:2])
    assert code == 200 and rep.forwarded == fwd0 + 1
    kinds = [e["kind"] for e in get_obs().events]
    assert "fleet_replica_down" in kinds and "fleet_replica_regrow" in kinds


def _poison_export(path):
    tree = load_params(path)

    def nan(t):
        return ({k: nan(v) for k, v in t.items()} if isinstance(t, dict)
                else np.full_like(t, np.nan))
    export_for_serving(path, nan(tree))


def test_canary_rollback_then_promote(served, fleet, tmp_path):
    _, _, path, _ = served
    f = fleet(["r0", "r1"])
    router = f.router
    owner = router.ring.candidates("part-0")[0]
    canary_name = "r1" if owner == "r0" else "r0"
    promo = ServingPromotion(str(tmp_path / "promo"))
    canary = CanaryController(router, promo, frac=0.5,
                              divergence_threshold=0.95, min_mirrors=4)
    part0 = np.flatnonzero(f.node_map == 0)
    probe = part0[:8]
    before = f.planes[canary_name].engine.predict(probe, sample_seed=9)
    # round 1: a candidate whose leaves the test filled with NaN
    cand = promo.stage(load_params(path))
    _poison_export(cand)
    canary.start(cand, replica=canary_name)
    sent = 0
    while canary.active and sent < 40:
        code, payload = router.forward(part0[:2])
        assert code == 200, payload
        sent += 1
    assert canary.verdict == "rollback" and canary.nonfinite > 0
    assert canary.mirrored >= 4
    assert read_fence(promo.directory) is None
    assert promotion_history(promo.directory)[-1]["action"] == "rolled_back"
    np.testing.assert_array_equal(
        f.planes[canary_name].engine.predict(probe, sample_seed=9), before)
    # round 2: the clean export promotes and rolls out to both replicas
    owner_params = f.planes[owner].engine.params
    canary.start(promo.stage(load_params(path)), replica=canary_name)
    sent = 0
    while canary.active and sent < 40:
        code, _ = router.forward(part0[:2])
        assert code == 200
        sent += 1
    assert canary.verdict == "promote"
    assert read_fence(promo.directory)["epoch"] == 1
    assert promotion_history(promo.directory)[-1]["action"] == "promoted"
    assert f.planes[owner].engine.params is not owner_params
    assert router.fleet_state()["canary"]["verdict"] == "promote"


def test_failover_request_yields_one_trace_tree(fleet):
    f = fleet(["r0", "r1", "r2"])
    router = f.router
    victim = router.ring.candidates("part-0")[0]
    f.planes[victim].kill()
    part0 = np.flatnonzero(f.node_map == 0)
    root = tracectx.new_root()
    retries = router._m_retries.value()
    with tracectx.use(root):
        code, payload = router.forward(part0[:2])
    assert code == 200, payload
    assert router._m_retries.value() == retries + 1
    deadline = time.monotonic() + 10
    tree = []
    while time.monotonic() < deadline:
        tree = [s for s in list(get_obs().spans)
                if s.get("trace_id") == root.trace_id]
        if any(s["name"] == "serve_request" for s in tree):
            break
        time.sleep(0.01)
    by_span = {s["span_id"]: s for s in tree}
    fwd = sorted((s for s in tree if s["name"] == "fleet_forward"),
                 key=lambda s: s["attempt"])
    assert [s["attempt"] for s in fwd] == [1, 2]
    assert fwd[0]["replica"] == victim and fwd[1]["replica"] != victim
    assert all(s["parent_id"] == root.span_id for s in fwd)
    serves = [s for s in tree if s["name"] == "serve_http"]
    assert len(serves) == 1
    assert serves[0]["parent_id"] == fwd[1]["span_id"]
    engine = [s for s in tree
              if s["name"] in ("engine_fanout", "forward_dispatch")]
    assert engine
    for s in engine:
        path, cur = set(), s.get("parent_id")
        while cur in by_span:
            path.add(cur)
            cur = by_span[cur].get("parent_id")
        assert serves[0]["span_id"] in path and cur == root.span_id
    for s in tree:
        assert s.get("parent_id") in by_span or \
            s.get("parent_id") == root.span_id, s
