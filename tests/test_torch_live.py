"""The port's live plane and serving-side chaos drills, on the CPU.

The trainer half of ``LiveFeed`` gives the JAX feed's snapshots for the
same ticks under an injected clock (step rate, heartbeat rate, exchange
MiB/s, stall share, critical-path split, the riders, ``done``);
``LiveServer`` answers ``/livez`` and ``/metrics`` over localhost; the
sidecar starts only with ``TPU_OPERATOR_LIVE_PORT`` set, once a
process, and never raises; a trainer under the sidecar shows its step
advancing and reads done after the run. ``replica:die`` kills a named
``ServingPlane`` after its n-th request with no request of the fleet
dropped, and ``promote:bad`` poisons a staged candidate behind a valid
checksum, which the canary rolls back, once.
"""

import json
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dgl_operator_tpu.obs import live as jax_live
from dgl_operator_tpu.runtime import timers as jax_timers
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.graph.partition import partition_graph
from dgl_operator_tpu_torch.launcher import chaos
from dgl_operator_tpu_torch.models.sage import DistSAGE, state_dict_to_flax
from dgl_operator_tpu_torch.obs import get_obs, live
from dgl_operator_tpu_torch.runtime import timers
from dgl_operator_tpu_torch.runtime.checkpoint import (ServingPromotion,
                                                       export_for_serving,
                                                       load_params,
                                                       promotion_history,
                                                       read_fence)
from dgl_operator_tpu_torch.runtime.loop import SampledTrainer, TrainConfig
from dgl_operator_tpu_torch.serve import (CanaryController, FleetRouter,
                                          Replica, ServeConfig, ServeEngine,
                                          ServingPlane)

pytestmark = pytest.mark.obslive

FEAT, HIDDEN, CLASSES = 8, 16, 4


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in ("TPU_OPERATOR_CHAOS", "TPU_OPERATOR_LIVE_PORT",
                 "TPU_OPERATOR_TUNED_MANIFEST", "TPU_OPERATOR_WORKSPACE"):
        monkeypatch.delenv(name, raising=False)
    yield
    live.stop_sidecar()
    live.reset_feed()


# ---------------------------------------------------------------------
# the feed
# ---------------------------------------------------------------------
class Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _ticks():
    """(ts, step, phase totals, exchange bytes, riders) per heartbeat."""
    rng = np.random.default_rng(0)
    out, tot, nbytes = [], {"stall": 0.0, "sample": 0.0, "dispatch": 0.0,
                            "exchange": 0.0}, 0
    for i in range(14):
        for k in tot:
            tot[k] += float(rng.uniform(0, 0.3))
        nbytes += int(rng.integers(1, 1 << 22))
        riders = {"overlap_ratio": float(rng.uniform()) if i % 3 else None,
                  "loss": float(rng.normal()) if i % 2 else None,
                  "grad_norm": float(rng.uniform(0, 9)) if i % 4 else None}
        out.append((0.7 * i + 0.1 * (i % 3), 4 * i, dict(tot), nbytes,
                    riders))
    return out


def _feed_snapshots(mod, timer_cls):
    clock = Clock()
    feed = mod.LiveFeed(window_s=3.0, clock=clock)
    snaps = []
    clock.now = 0.0
    snaps.append(feed.snapshot())               # idle: every key None
    for ts, step, tot, nbytes, riders in _ticks():
        t = timer_cls()
        t.total.update(tot)
        t.bytes["exchange"] = nbytes
        clock.now = ts
        feed.tick(step, timer=t, **riders)
        snaps.append(feed.snapshot())
    clock.now += 20.0                           # the window is empty
    snaps.append(feed.snapshot())
    feed.mark_done()
    snaps.append(feed.snapshot(window_s=100.0))
    feed.reset()
    snaps.append(feed.snapshot())
    return snaps


def test_feed_snapshots_equal_jax():
    got = _feed_snapshots(live, timers.PhaseTimer)
    want = _feed_snapshots(jax_live, jax_timers.PhaseTimer)
    assert got == want
    assert got[-2]["done"] and got[-2]["heartbeat_hz"] > 0
    assert got[5]["critpath_frac"] is not None


# ---------------------------------------------------------------------
# the sidecar
# ---------------------------------------------------------------------
def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.read().decode()


def test_live_server_answers_livez_and_metrics():
    feed = live.LiveFeed()
    server = live.LiveServer(feed=feed, port=0).start()
    try:
        feed.tick(3)
        feed.tick(5)
        get_obs().metrics.counter("live_test_total", "a test counter").inc()
        code, body = _get(server.port, "/livez")
        snap = json.loads(body)
        assert code == 200 and snap["step"] == 5
        assert (snap["role"], snap["port"]) == ("train", server.port)
        code, text = _get(server.port, "/metrics")
        assert code == 200 and "live_test_total 1" in text
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(server.port, "/nope")
        assert err.value.code == 404
    finally:
        server.stop()


def test_sidecar_is_env_gated_and_never_raises(monkeypatch, capsys):
    assert live.maybe_start_sidecar() is None
    monkeypatch.setenv(live.LIVE_PORT_ENV, "0")
    sc = live.maybe_start_sidecar()
    assert sc is not None and live.maybe_start_sidecar() is sc
    assert _get(sc.port, "/livez")[0] == 200
    live.stop_sidecar()
    monkeypatch.setenv(live.LIVE_PORT_ENV, "not-a-port")
    assert live.maybe_start_sidecar() is None
    with socket.socket() as busy:
        busy.bind(("127.0.0.1", 0))
        busy.listen()
        monkeypatch.setenv(live.LIVE_PORT_ENV, str(busy.getsockname()[1]))
        assert live.maybe_start_sidecar() is None
    assert "live sidecar failed to start" in capsys.readouterr().out


def test_trainer_heartbeats_reach_livez(monkeypatch):
    monkeypatch.setenv(live.LIVE_PORT_ENV, "0")
    g = datasets.synthetic_node_clf(300, 1200, FEAT, CLASSES, seed=2).graph
    cfg = TrainConfig(num_epochs=2, batch_size=16, fanouts=(3, 3),
                      eval_every=0, dropout=0.0)
    tr = SampledTrainer(DistSAGE(FEAT, HIDDEN, CLASSES, device="cpu"), g,
                        cfg, device="cpu")
    seen = []
    heartbeat = live.LiveFeed.tick

    def tick(self, step, *a, **kw):
        heartbeat(self, step, *a, **kw)
        if live._sidecar is not None:
            seen.append(json.loads(_get(live._sidecar.port,
                                        "/livez")[1])["step"])

    monkeypatch.setattr(live.LiveFeed, "tick", tick)
    out = tr.train()
    assert seen == list(range(1, out["step"] + 1))
    snap = json.loads(_get(live._sidecar.port, "/livez")[1])
    assert snap["done"] and snap["step"] == out["step"]
    assert snap["heartbeat_hz"] > 0 and snap["loss"] is not None


# ---------------------------------------------------------------------
# serving-side chaos
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def served(tmp_path_factory):
    out = tmp_path_factory.mktemp("live")
    g = datasets.synthetic_node_clf(400, 2000, FEAT, CLASSES, seed=3).graph
    book = partition_graph(g, "synth", 2, str(out / "book"))
    model = DistSAGE(FEAT, HIDDEN, CLASSES, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    params = state_dict_to_flax(model.state_dict())
    return book, export_for_serving(str(out / "export") + "/", params)


def _plane(served, name):
    book, path = served
    eng = ServeEngine(DistSAGE(FEAT, HIDDEN, CLASSES, device="cpu"), book,
                      params_path=path,
                      cfg=ServeConfig(fanouts=(3, 3), batch_size=16,
                                      cap_policy="worst", max_wait_ms=1.0),
                      device="cpu")
    return ServingPlane(eng, port=0, slo_interval_s=0, name=name).start()


def test_replica_die_kills_the_named_replica(served, monkeypatch):
    monkeypatch.setenv(chaos.CHAOS_ENV, "replica:die:3@host=r1")
    planes = {n: _plane(served, n) for n in ("r0", "r1")}
    try:
        router = FleetRouter([Replica(n, "127.0.0.1", p.port, plane=p)
                              for n, p in planes.items()],
                             node_map=np.asarray(planes["r0"].engine.node_map),
                             probe_timeout_s=1.0, request_timeout_s=60.0)
        node_map = np.asarray(planes["r0"].engine.node_map)
        part = next(p for p in (0, 1)
                    if router.ring.candidates(f"part-{p}")[0] == "r1")
        ids = np.flatnonzero(node_map == part)
        codes = []
        for i in range(8):
            code, payload = router.forward(ids[i:i + 2])
            codes.append(code == 200 and len(payload["predictions"]) == 2)
        assert all(codes)
        assert planes["r1"].dead and not planes["r0"].dead
        assert planes["r1"]._accepted == 3
        router.probe_once()
        assert router.replica("r1").state == "down"
        c = get_obs().metrics.counter("chaos_faults_injected_total",
                                      labels=("verb", "action"))
        assert c.value(verb="replica", action="die") >= 1
    finally:
        for p in planes.values():
            p.stop()


def test_promote_bad_is_rolled_back_once(served, monkeypatch, tmp_path):
    _, path = served
    monkeypatch.setenv(chaos.CHAOS_ENV, "promote:bad")
    planes = {n: _plane(served, n) for n in ("r0", "r1")}
    try:
        node_map = np.asarray(planes["r0"].engine.node_map)
        router = FleetRouter([Replica(n, "127.0.0.1", p.port, plane=p)
                              for n, p in planes.items()],
                             node_map=node_map, probe_timeout_s=1.0)
        promo = ServingPromotion(str(tmp_path / "promo"))
        canary = CanaryController(router, promo, frac=0.5,
                                  divergence_threshold=0.95, min_mirrors=4)
        owner = router.ring.candidates("part-0")[0]
        name = "r1" if owner == "r0" else "r0"
        ids = np.flatnonzero(node_map == 0)
        for round_ in ("bad", "clean"):
            cand = promo.stage(load_params(path))
            leaves = load_params(cand)["params"]["FanoutSAGEConv_0"]["self"]
            # load_params verified the sidecar: the poison is checksum-clean
            assert np.isnan(leaves["kernel"]).all() == (round_ == "bad")
            canary.start(cand, replica=name)
            sent = 0
            while canary.active and sent < 40:
                assert router.forward(ids[:2])[0] == 200
                sent += 1
            assert canary.verdict == ("rollback" if round_ == "bad"
                                      else "promote")
        assert [h["action"] for h in promotion_history(promo.directory)] \
            == ["rolled_back", "promoted"]
        assert read_fence(promo.directory)["epoch"] == 1
    finally:
        for p in planes.values():
            p.stop()


def test_kill_from_a_handler_thread_does_not_deadlock(served, monkeypatch):
    """The replica that dies on a request is killed from a side thread,
    so the request's handler returns (dropping its connection) and the
    plane's threads join."""
    monkeypatch.setenv(chaos.CHAOS_ENV, "replica:die:1")
    plane = _plane(served, "solo")
    try:
        done = threading.Event()

        def post():
            req = urllib.request.Request(
                f"http://127.0.0.1:{plane.port}/predict",
                data=json.dumps({"nodes": [1, 2]}).encode(),
                headers={"Content-Type": "application/json"})
            try:
                urllib.request.urlopen(req, timeout=20)
            except (urllib.error.URLError, ConnectionError, OSError):
                pass
            done.set()

        t = threading.Thread(target=post)
        t.start()
        t.join(timeout=30)
        assert done.is_set() and not t.is_alive()
        deadline = threading.Event()
        for _ in range(100):
            if plane.dead:
                break
            deadline.wait(0.05)
        assert plane.dead
    finally:
        plane.stop()
