#!/usr/bin/env python3
"""Probe: which collectives a gloo group of processes sharing one card
runs on CUDA tensors (each in its own pair of processes, so that a crash
names its collective): ``all_reduce``, the list ``all_gather``,
``all_gather_into_tensor``, ``DTensor.full_tensor`` of a split DTensor,
and the same ``full_tensor`` of its CPU copy. On a machine with a CUDA
card::

    python3 probes/gloo_cuda.py
"""

import socket
import subprocess
import sys

WORKER = r"""
import sys, torch, torch.distributed as dist
rank, port, case = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=2)
device = "cpu" if case.endswith("-cpu") else "cuda"
x = torch.full((4, 3), float(rank + 1), device=device)
if case == "all_reduce":
    dist.all_reduce(x)
    out = x
elif case == "all_gather":
    parts = [torch.empty_like(x) for _ in range(2)]
    dist.all_gather(parts, x)
    out = torch.cat(parts)
elif case == "all_gather_into_tensor":
    out = torch.empty((8, 3), device=device)
    dist.all_gather_into_tensor(out, x)
else:
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    mesh = init_device_mesh(device, (2,))
    out = DTensor.from_local(x, mesh, [Shard(0)], run_check=False).full_tensor()
torch.cuda.synchronize()
print("ok", case, rank, out.sum().item(), flush=True)
dist.destroy_process_group()
"""

CASES = ("all_reduce", "all_gather", "all_gather_into_tensor", "full_tensor", "full_tensor-cpu")


def run(case: str) -> str:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(port), case],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    results = []
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
            results.append("timed out")
            continue
        tail = (err.strip().splitlines() or [""])[-1]
        results.append(out.strip() if proc.returncode == 0 else f"rc {proc.returncode}: {tail}")
    return f"{case}: {results}"


if __name__ == "__main__":
    for case in CASES:
        print(run(case), flush=True)
