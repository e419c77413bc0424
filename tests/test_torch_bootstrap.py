"""The port's hostfile rendezvous against the JAX package's.

``dgl_operator_tpu_torch/parallel/bootstrap.py`` copies the hostfile
contract of ``dgl_operator_tpu/parallel/bootstrap.py``: the same
operator-format files must parse, revise and rank alike in both, and
``initialize_from_hostfile`` keeps the JAX semantics around the
rendezvous (a single-entry job opens nothing; an unknown host raises).
"""

import socket

import pytest
import torch.distributed as dist

from dgl_operator_tpu.parallel import bootstrap as jax_bootstrap
from dgl_operator_tpu_torch.parallel import bootstrap

HOSTFILES = {
    "operator": ("10.0.0.1 30050 job-worker-0 slots=2\n"
                 "10.0.0.2 30050 job-worker-1 slots=2\n"),
    "launcher_and_comments": ("# rendered by the operator\n"
                              "10.0.0.9 30050 job-launcher slots=1\n"
                              "\n"
                              "10.0.0.1 30051 job-worker-0 slots=4\n"
                              "10.0.0.2 30052 job-worker-1\n"),
    "bare": "10.0.0.1\n10.0.0.2 40000\n10.0.0.3 40001 w3 slots=8 x=1\n",
    "empty": "# nothing\n\n",
}


def _write(tmp_path, text):
    path = tmp_path / "hostfile"
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("name", sorted(HOSTFILES))
def test_parse_hostfile_matches_jax(tmp_path, name):
    path = _write(tmp_path, HOSTFILES[name])
    got = bootstrap.parse_hostfile(path)
    want = jax_bootstrap.parse_hostfile(path)
    assert [(e.ip, e.port, e.name, e.slots, e.addr) for e in got] == \
        [(e.ip, e.port, e.name, e.slots, e.addr) for e in want]


@pytest.mark.parametrize("style", ["dgl", "dglke", "jax"])
@pytest.mark.parametrize("name", ["operator", "launcher_and_comments"])
def test_revise_hostfile_matches_jax(tmp_path, name, style):
    src = _write(tmp_path, HOSTFILES[name])
    got = bootstrap.revise_hostfile(src, str(tmp_path / "port"), style, 3)
    want = jax_bootstrap.revise_hostfile(src, str(tmp_path / "jax"), style, 3)
    with open(got) as g, open(want) as w:
        assert g.read() == w.read()


def test_revise_hostfile_rejects_unknown_style(tmp_path):
    src = _write(tmp_path, HOSTFILES["operator"])
    with pytest.raises(ValueError):
        bootstrap.revise_hostfile(src, str(tmp_path / "x"), "mpi")


def test_write_hostfile_round_trips(tmp_path):
    src = _write(tmp_path, HOSTFILES["launcher_and_comments"])
    entries = bootstrap.parse_hostfile(src)
    out = str(tmp_path / "written")
    bootstrap.write_hostfile(out, entries)
    jax_out = str(tmp_path / "jax_written")
    jax_bootstrap.write_hostfile(jax_out, jax_bootstrap.parse_hostfile(src))
    with open(out) as g, open(jax_out) as w:
        assert g.read() == w.read()
    assert bootstrap.parse_hostfile(out) == entries


@pytest.mark.parametrize("env,host,want", [
    ("1", "elsewhere", 1),
    (None, "job-worker-1", 1),
    (None, "10.0.0.1", 0),
    (None, "elsewhere", None)])
def test_my_rank_matches_jax(tmp_path, monkeypatch, env, host, want):
    path = _write(tmp_path, HOSTFILES["operator"])
    if env is None:
        monkeypatch.delenv(bootstrap.RANK_ENV, raising=False)
    else:
        monkeypatch.setenv(bootstrap.RANK_ENV, env)
    monkeypatch.setattr(socket, "gethostname", lambda: host)
    got = bootstrap.my_rank(bootstrap.parse_hostfile(path))
    assert got == jax_bootstrap.my_rank(jax_bootstrap.parse_hostfile(path)) \
        == want


def test_env_names_match_jax():
    for name in ("HOSTFILE_ENV", "RANK_ENV", "PHASE_ENV", "FENCE_EPOCH_ENV",
                 "DEFAULT_PORT"):
        assert getattr(bootstrap, name) == getattr(jax_bootstrap, name)


@pytest.mark.parametrize("text", [None, "", "10.0.0.1 30050 only-worker\n"])
def test_single_entry_job_opens_nothing(tmp_path, monkeypatch, text):
    """No hostfile, an empty one or one entry: rank 0, no group."""
    monkeypatch.delenv(bootstrap.HOSTFILE_ENV, raising=False)
    path = (str(tmp_path / "missing") if text is None
            else _write(tmp_path, text))
    assert bootstrap.initialize_from_hostfile(path, device="cpu") == 0
    assert not dist.is_initialized()


def test_hostfile_path_comes_from_the_env(tmp_path, monkeypatch):
    monkeypatch.setenv(bootstrap.HOSTFILE_ENV,
                       _write(tmp_path, "10.0.0.1 30050 w0\n"))
    assert bootstrap.initialize_from_hostfile(device="cpu") == 0
    assert not dist.is_initialized()


def test_unknown_host_raises(tmp_path, monkeypatch):
    path = _write(tmp_path, HOSTFILES["operator"])
    monkeypatch.delenv(bootstrap.RANK_ENV, raising=False)
    monkeypatch.setattr(socket, "gethostname", lambda: "not-a-worker")
    with pytest.raises(RuntimeError, match="cannot determine rank"):
        bootstrap.initialize_from_hostfile(path, device="cpu")
    assert not dist.is_initialized()


def test_rank_outside_the_hostfile_raises(tmp_path):
    path = _write(tmp_path, HOSTFILES["operator"])
    with pytest.raises(RuntimeError, match="outside"):
        bootstrap.initialize_from_hostfile(path, rank=2, device="cpu")


def test_backend_follows_the_device():
    assert bootstrap.default_backend("cpu") == "gloo"
    assert bootstrap.default_backend("cuda:0") == "nccl"
