"""Time gloo's collectives on host buffers: ``all_reduce`` against the
``reduce_scatter_tensor`` plus ``all_gather_into_tensor`` that
``Transport.reduce_bucket`` posts for a gradient bucket, on 2 ranks of
this host (a data group of 2 replicas), one f32 buffer of ``--mib`` MiB,
one torch thread a rank.  Prints one JSON line: each repeat's seconds
for each, and the bucket's bytes over the best time.

    python3 tools/gloo_collectives.py --mib 1024 --repeat 3
"""
import argparse
import json
import os
import sys
import time

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
from repro_torch.launch import mesh as MESH  # noqa: E402


def _time(fn) -> float:
    dist.barrier()
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def rank_times(mesh, mib: int, repeat: int) -> dict:
    torch.set_num_threads(1)
    n = mib * 2**20 // 4
    x = torch.ones(n)
    shard = torch.empty(n // mesh.world)
    out = dict(all_reduce=[], reduce_scatter=[], all_gather=[])
    for _ in range(repeat):
        out["all_reduce"].append(_time(lambda: dist.all_reduce(x)))
        out["reduce_scatter"].append(
            _time(lambda: dist.reduce_scatter_tensor(shard, x)))
        out["all_gather"].append(
            _time(lambda: dist.all_gather_into_tensor(x, shard)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", type=int, default=256)
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args()
    res = MESH.spawn_ranks(rank_times, 2, "gloo", args.mib, args.repeat)[0]
    nbytes = args.mib * 2**20
    rs_ag = [a + b for a, b in zip(res["reduce_scatter"], res["all_gather"])]
    print(json.dumps(dict(
        mib=args.mib, torch=torch.__version__, seconds=res,
        reduce_scatter_plus_all_gather=rs_ag,
        gb_s=dict(all_reduce=nbytes / min(res["all_reduce"]) / 1e9,
                  reduce_scatter_plus_all_gather=nbytes / min(rs_ag) / 1e9))))


if __name__ == "__main__":
    main()
