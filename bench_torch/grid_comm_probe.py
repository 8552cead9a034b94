#!/usr/bin/env python3
"""What the collectives of a process grid do on one card.

Run under torchrun, four ranks sharing one GPU over gloo, then one rank
over NCCL:

    python -m torch.distributed.run --standalone --nproc_per_node=4 \
        bench_torch/grid_comm_probe.py --backend=gloo
    python -m torch.distributed.run --standalone --nproc_per_node=1 \
        bench_torch/grid_comm_probe.py --backend=nccl

For each collective of the grid layer (``pydnmfk_tpu_torch/parallel/
mesh.py``: all-reduce SUM and MAX, all-gather, broadcast, over the world
and over row and column subgroups of a 2 x 2 grid) it checks that the
backend takes a CUDA tensor, that the result is right and bitwise equal on
every member of the group, and times it on CUDA tensors and staged through
host tensors, at a k x k Gram (32 x 32 f32) and at the AH^T of a
28800 x 19200 block at k = 32 (28800 x 32 f32). One JSON line per case.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist


def timed(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--backend", default="gloo")
    args = p.parse_args()
    dev = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                       % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    dist.init_process_group(args.backend, device_id=(dev if args.backend ==
                                                     "nccl" else None))
    rank, world = dist.get_rank(), dist.get_world_size()
    groups = {"world": None}
    if world == 4:
        groups["row"], _ = dist.new_subgroups_by_enumeration(
            [[0, 1], [2, 3]], backend=args.backend)
        groups["col"], _ = dist.new_subgroups_by_enumeration(
            [[0, 2], [1, 3]], backend=args.backend)
    for gname, group in groups.items():
        size = dist.get_world_size(group)
        for shape in ((32, 32), (28800, 32)):
            gen = torch.Generator(dev)
            gen.manual_seed(rank)
            x = torch.rand(shape, generator=gen, device=dev)
            case = {"backend": args.backend, "world": world, "group": gname,
                    "shape": list(shape), "rank": rank}
            try:
                y = x.clone()
                dist.all_reduce(y, group=group)
                want = torch.zeros_like(x)
                members = dist.get_process_group_ranks(group) if group \
                    else list(range(world))
                for r in members:
                    g = torch.Generator(dev)
                    g.manual_seed(r)
                    want += torch.rand(shape, generator=g, device=dev)
                case["sum_err"] = float((y - want).abs().max())
                outs = [torch.empty_like(y) for _ in range(size)]
                dist.all_gather(outs, y, group=group)
                case["sum_equal_on_members"] = all(torch.equal(outs[0], o)
                                                   for o in outs)
                xs = [torch.empty_like(x) for _ in range(size)]
                dist.all_gather(xs, x, group=group)
                z = x.clone()
                dist.all_reduce(z, op=dist.ReduceOp.MAX, group=group)
                case["max_ok"] = bool(torch.equal(z, torch.stack(xs).amax(0)))
                b = x.clone()
                dist.broadcast(b, src=members[0], group=group)
                case["broadcast"] = True
                case["cuda_ms"] = timed(lambda: dist.all_reduce(
                    x.clone(), group=group))

                def staged():
                    h = x.cpu()
                    dist.all_reduce(h, group=group)
                    x.copy_(h)

                if args.backend == "gloo":
                    case["staged_ms"] = timed(staged)
                case["ok"] = True
            except Exception as e:          # a probe: report and go on
                case["ok"] = False
                case["error"] = repr(e)[:300]
            print(json.dumps(case), flush=True)
            dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
