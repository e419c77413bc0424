"""One rank of the port's two-rank sharding and ring tests.

``tests/test_torch_ring_attention.py``, ``tests/test_torch_ring.py`` and
``tests/test_torch_zero.py`` start two of these as
``python tests/torch_shard_worker.py <case> <rank> <port> <out> [arg]``.
A rank opens a gloo group of two on ``tcp://localhost:<port>``, runs the
case and writes what it got to ``<out>.<rank>`` (``torch.save``). The
test process runs the same case's one-process form itself. This module
imports nothing of JAX.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from dgl_operator_tpu_torch.graph.graph import Graph  # noqa: E402
from dgl_operator_tpu_torch.models.gat import gat_hub_attention  # noqa
from dgl_operator_tpu_torch.nn.conv import GATConv  # noqa: E402
from dgl_operator_tpu_torch.parallel import ring_attention as ra  # noqa
from dgl_operator_tpu_torch.parallel.embedding import (  # noqa: E402
    ShardedTableSpec, pad_rows)
from dgl_operator_tpu_torch.parallel.ring import (  # noqa: E402
    ring_lookup, ring_push_adagrad)

WORLD = 2
# ring attention: N queries, an axis of S over SHARDS shards
N, S, H, DK, DV, SHARDS = 12, 64, 2, 8, 16, 8
# the ring embedding: a table of ROWS rows over 4 shards, B ids a slot
ROWS, DIM, B, LR = 1001, 16, 64, 0.1


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def attention_inputs():
    m = np.random.default_rng(3).random((N, S)) < 0.7
    m[:, :8] = True
    return [torch.from_numpy(a) for a in (
        _rand((N, H, DK), 0), _rand((N, S, H, DK), 1),
        _rand((N, S, H, DV), 2), m.astype(np.float32))]


def hub_inputs():
    """A 60-node graph with a hub (node 7), its features and a GAT layer
    drawn from seed 0."""
    rng = np.random.default_rng(3)
    src = rng.integers(0, 60, 340).astype(np.int32)
    dst = np.concatenate([rng.integers(0, 60, 300),
                          np.full(40, 7)]).astype(np.int32)
    x = torch.from_numpy(rng.normal(size=(60, 8)).astype(np.float32))
    conv = GATConv(8, 6, num_heads=2, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    return Graph(src, dst, 60), x, conv


def embedding_inputs():
    """The table, its Adagrad sums, every slot's ids and gradient rows."""
    rng = np.random.default_rng(0)
    spec = ShardedTableSpec(ROWS, DIM, 4)
    table = torch.from_numpy(pad_rows(rng.normal(size=(ROWS, DIM)),
                                      spec.padded_rows))
    state = torch.from_numpy(np.abs(rng.normal(
        size=spec.padded_rows)).astype(np.float32))
    ids = rng.integers(0, ROWS, size=(4, B))
    ids[1, :5] = -1
    grads = torch.from_numpy(rng.normal(size=(4, B, DIM)).astype(
        np.float32))
    return spec, table, state, ids, grads


def ring_attention_case(rank: int, world: int) -> dict:
    q, k, v, mask = attention_inputs()
    cols = slice(rank * S // world, (rank + 1) * S // world)
    k = k[:, cols].clone().requires_grad_()
    out = ra.ring_dot_attention(q, k, v[:, cols], mask[:, cols], SHARDS,
                                rank, world)
    (out ** 2).sum().backward()
    g, x, conv = hub_inputs()
    hub = gat_hub_attention(conv, g, x, [7, 1, 2], SHARDS, rank=rank,
                            world=world)
    return {"out": out.detach(), "kgrad": k.grad, "hub": hub}


def ring_embedding_case(rank: int, world: int) -> dict:
    spec, table, state, ids, grads = embedding_inputs()
    rows = spec.padded_rows // world
    mine = slice(rank * rows, (rank + 1) * rows)
    L = spec.num_shards // world
    slots = slice(rank * L, (rank + 1) * L)
    t, s = table[mine].clone(), state[mine].clone()
    got = ring_lookup(t, ids, spec, rank, world)
    ring_push_adagrad(t, s, ids, grads[slots], spec, LR, rank=rank,
                      world=world)
    return {"lookup": got, "table": t, "state": s}


# the DistTrainer runs of tests/test_torch_zero.py
FEAT, HIDDEN, CLASSES = 16, 32, 4


# the fields both packages' TrainConfig share
DIST_FIELDS = dict(num_epochs=1, batch_size=32, lr=0.01, fanouts=(4, 4),
                   log_every=1000, eval_every=0)


def dist_config(**kw):
    from dgl_operator_tpu_torch.runtime.loop import TrainConfig
    return TrainConfig(**{**DIST_FIELDS, "dropout": 0.0, **kw})


def run_dist(book: str, init=None, mesh=None, **kw):
    """``DistTrainer`` SAGE over ``book`` on the CPU from the flax params
    ``init`` (or seed 0's weights): the trainer and its result."""
    from dgl_operator_tpu_torch.models.sage import DistSAGE
    from dgl_operator_tpu_torch.runtime.dist import DistTrainer
    model = DistSAGE(FEAT, HIDDEN, CLASSES, dropout=0.0, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    tr = DistTrainer(model, book, dist_config(**kw), device="cpu",
                     mesh=mesh)
    return tr, tr.train(init_params=init)


def run_two(case: str, out: str, *extra: str, timeout: int = 240) -> list:
    """Two ranks of ``case`` as subprocesses; what each wrote."""
    import socket
    import subprocess
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, str(r),
         str(port), out, *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [torch.load(f"{out}.{r}", weights_only=False)
            for r in range(WORLD)]


def opt_bytes(tr) -> int:
    """The bytes of a trainer's optimizer state tensors."""
    return sum(v.numel() * v.element_size()
               for st in tr.optimizer.state.values()
               for v in st.values() if isinstance(v, torch.Tensor))


def wus_case(rank: int, world: int, book: str) -> dict:
    repl, repl_out = run_dist(book)
    tr, out = run_dist(book, shard_update=True)
    try:
        run_dist(book, shard_update=True, ckpt_dir=book + ".ckpt")
        guard = ""
    except ValueError as exc:
        guard = str(exc)
    return {"losses": [r["losses"] for r in out["history"]],
            "params": out["params"], "opt_state": out["opt_state"],
            "opt_bytes": opt_bytes(tr), "repl_opt_bytes": opt_bytes(repl),
            "repl_losses": [r["losses"] for r in repl_out["history"]],
            "repl_params": repl_out["params"],
            "repl_opt_state": repl_out["opt_state"], "ckpt_guard": guard}


# the KGE grid's relation rows sharded over dp
KGE_RULES = (("relation", "dp"), (".*", None))


def kge_run(rules=None):
    """The KGE grid job of ``tests/torch_kge_grid_worker.py`` on a 2 x 2
    grid, with relation ``shard_rules`` or without: the trainer and its
    result."""
    import torch_kge_grid_worker as kw
    from dgl_operator_tpu_torch.graph.kge_sampler import TrainDataset
    from dgl_operator_tpu_torch.runtime.kge import DistKGETrainer
    ds = kw.dataset()
    cfg, tcfg = kw.configs(ds, shard_rules=rules)
    tr = DistKGETrainer(cfg, tcfg, device="cpu", mesh=kw.mesh_of((2, 2)))
    out = tr.train(TrainDataset(ds.train, ds.n_entities, ds.n_relations,
                                ranks=4))
    return tr, out


def kge_rel_case(rank: int, world: int) -> dict:
    tr, out = kge_run(KGE_RULES)
    return {"losses": out["losses"], "state": tr.state_dict(),
            "rel_rows": tuple(tr.relation.shape)}


def main(argv) -> None:
    case, rank, port, out = argv[:4]
    rank, world = int(rank), WORLD
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        if case == "ring_attention":
            got = ring_attention_case(rank, world)
        elif case == "ring_embedding":
            got = ring_embedding_case(rank, world)
        elif case == "wus":
            got = wus_case(rank, world, argv[4])
        elif case == "kge_rel":
            got = kge_rel_case(rank, world)
        else:
            raise ValueError(f"unknown case {case!r}")
        torch.save(got, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
