"""Which collectives ``torch.distributed``'s gloo backend takes on CUDA
tensors, with two ranks on one card (NCCL refuses two ranks on one
GPU), and whether NCCL runs the same calls at world size 1.

Run on a machine with a card: ``python -m
dgl_operator_tpu_torch.examples.gloo_cuda_probe``. Prints one JSON line
per rank and one for NCCL; a call that raises is reported with its
error, a call that returns a wrong result as ``"wrong"``.
"""

import datetime
import json
import socket
import subprocess
import sys

import torch
import torch.distributed as dist


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _calls(rank: int, world: int):
    dev = torch.device("cuda", 0)

    def all_reduce():
        t = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        return bool((t == world * (world + 1) / 2).all())

    def all_gather():
        out = [torch.empty(2, dtype=torch.int64, device=dev)
               for _ in range(world)]
        dist.all_gather(out, torch.full((2,), rank, dtype=torch.int64,
                                        device=dev))
        return all(bool((o == r).all()) for r, o in enumerate(out))

    def all_to_all_single():
        src = torch.arange(world * 3, dtype=torch.int32, device=dev) \
            + 100 * rank
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src)
        want = torch.cat([torch.arange(3, dtype=torch.int32) + 3 * rank
                          + 100 * r for r in range(world)]).to(dev)
        return bool(torch.equal(out, want))

    result = {}
    for fn in (all_reduce, all_gather, all_to_all_single):
        try:
            ok = fn()
            torch.cuda.synchronize()
            result[fn.__name__] = "ok" if ok else "wrong"
        except Exception as exc:    # the probe reports every refusal
            result[fn.__name__] = f"{type(exc).__name__}: {exc}"[:300]
    return result


def _rank_main(rank: int, port: int) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        print(json.dumps({"backend": "gloo", "rank": rank,
                          **_calls(rank, 2)}), flush=True)
    finally:
        dist.destroy_process_group()


def main() -> int:
    if len(sys.argv) == 3:
        _rank_main(int(sys.argv[1]), int(sys.argv[2]))
        return 0
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 1
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-m", __spec__.name,
                               str(r), str(port)]) for r in (0, 1)]
    try:
        rcs = [p.wait(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        print(json.dumps({"backend": "nccl", "world": 1,
                          **_calls(0, 1)}), flush=True)
    finally:
        dist.destroy_process_group()
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "card": torch.cuda.get_device_name(0),
                      "gloo_ranks_rc": rcs}), flush=True)
    return 0 if rcs == [0, 0] else 1


if __name__ == "__main__":
    sys.exit(main())
