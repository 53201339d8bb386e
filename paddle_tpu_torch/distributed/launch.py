"""Multi-process launcher: ``python -m paddle_tpu_torch.distributed.launch``.

Counterpart of ``paddle_tpu/distributed/launch.py`` (reference
python/paddle/distributed/launch.py:281: one trainer process per card with
PADDLE_* env vars; :147 start_procs, :141 terminate_procs). The CLI is the
JAX package's; ``--backend`` takes ``""``/``gpu`` (rank r on
``CUDAPlace(FLAGS_selected_gpus)``) or ``cpu`` (gloo ranks on the CPU).
Rank r of a node gets card ``--selected_gpus[r]``, by default r modulo
the cards visible, so ranks share a card when there are fewer cards than
ranks (the backend rule then picks gloo). ``--rendezvous_file`` puts the
store in a file instead of on a TCP port. One trainer failing kills the
rest, and the launcher returns its exit code.

Usage:
  python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
      --backend cpu train.py --my-flag ...
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

__all__ = ["launch", "find_free_ports"]


def _parse_args(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--cluster_node_ips", type=str, default="127.0.0.1",
                   help="comma-separated node ips (reference flag)")
    p.add_argument("--node_ip", type=str, default="127.0.0.1",
                   help="this node's ip")
    p.add_argument("--started_port", type=int, default=0,
                   help="first endpoint port; 0 picks free ports")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="trainer processes on this node")
    p.add_argument("--backend", type=str, default="",
                   choices=["", "gpu", "cpu"],
                   help="gpu (default): one card a rank; cpu: gloo ranks "
                        "on the CPU")
    p.add_argument("--local_devices", type=int, default=1,
                   help="devices per process (one: a process drives one "
                        "card)")
    p.add_argument("--selected_gpus", type=str, default="",
                   help="comma-separated card per local rank (default: "
                        "rank modulo the visible cards)")
    p.add_argument("--rendezvous_file", type=str, default="",
                   help="a file-store path for the rendezvous instead of "
                        "the TCP store at the first endpoint")
    p.add_argument("--log_dir", type=str, default=None,
                   help="redirect each rank's output to {log_dir}/workerlog.N")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def find_free_ports(n: int) -> list:
    """Bind-then-release to reserve n distinct free ports."""
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _visible_cards() -> int:
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return len([d for d in vis.split(",") if d.strip()])
    import torch

    return torch.cuda.device_count()


def _cards(args, nproc: int) -> list:
    if args.selected_gpus:
        cards = [int(c) for c in args.selected_gpus.split(",") if c.strip()]
        if len(cards) < nproc:
            raise ValueError(f"--selected_gpus names {len(cards)} card(s) "
                             f"for {nproc} ranks")
        return cards[:nproc]
    if args.backend == "cpu":
        return list(range(nproc))
    n = _visible_cards()
    if n < 1:
        raise RuntimeError("launch: no CUDA card visible; pass --backend "
                           "cpu to run the ranks on the CPU")
    return [r % n for r in range(nproc)]


def launch(args=None) -> int:
    args = args or _parse_args()
    if args.local_devices > 1:
        raise NotImplementedError(
            f"--local_devices {args.local_devices}: one process drives one "
            f"card in the port; launch one rank per card (--nproc_per_node)")
    node_ips = [ip for ip in args.cluster_node_ips.split(",") if ip]
    nproc = args.nproc_per_node
    if args.started_port:
        ports = [args.started_port + i for i in range(nproc)]
    else:
        if len(node_ips) > 1:
            # auto-discovered ports are LOCAL: other nodes would pick
            # different ones and the cross-node endpoint lists (and the
            # rank-0 store address) would disagree
            raise ValueError(
                "multi-node launch (cluster_node_ips has "
                f"{len(node_ips)} nodes) requires an explicit "
                "--started_port so every node builds the same endpoint "
                "list; port auto-discovery only works single-node")
        ports = find_free_ports(nproc)
    endpoints = []
    for ip in node_ips:
        endpoints += [f"{ip}:{p}" for p in ports]
    node_rank = node_ips.index(args.node_ip)
    cards = _cards(args, nproc)

    procs, log_files = [], []
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    for local_rank in range(nproc):
        rank = node_rank * nproc + local_rank
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(len(node_ips) * nproc),
            "PADDLE_CURRENT_ENDPOINT": f"{args.node_ip}:{ports[local_rank]}",
            "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
            "PADDLE_LOCAL_NPROC": str(nproc),
            "PADDLE_LOCAL_CARDS": ",".join(str(c) for c in cards),
            "FLAGS_selected_gpus": str(cards[local_rank]),
        })
        if args.backend:
            env["PADDLE_DIST_BACKEND"] = args.backend
        env["PADDLE_LOCAL_DEVICES"] = str(args.local_devices)
        if args.rendezvous_file:
            env["PADDLE_RENDEZVOUS_FILE"] = args.rendezvous_file
        if len(node_ips) == 1 and node_ips[0] == "127.0.0.1":
            # one node: gloo's pairs over the loopback interface
            env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        cmd = [sys.executable, "-u", args.training_script] \
            + args.training_script_args
        out = None
        if args.log_dir:
            out = open(os.path.join(args.log_dir, f"workerlog.{local_rank}"),
                       "w")
            log_files.append(out)
        procs.append(subprocess.Popen(cmd, env=env, stdout=out,
                                      stderr=subprocess.STDOUT if out else None))

    rc = 0
    try:
        alive = set(range(nproc))
        while alive:
            for i in list(alive):
                r = procs[i].poll()
                if r is None:
                    continue
                alive.discard(i)
                if r != 0:
                    rc = r
                    # one trainer died: kill the rest (reference
                    # terminate_procs — a hung collective never recovers)
                    for j in alive:
                        procs[j].send_signal(signal.SIGTERM)
                    for j in alive:
                        try:
                            procs[j].wait(timeout=10)
                        except subprocess.TimeoutExpired:
                            procs[j].kill()
                            procs[j].wait()
                    alive.clear()
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in log_files:
            f.close()
    return rc


def _terminated(signum, frame):
    # SIGTERM to the launcher: unwind through launch()'s finally, which
    # kills every rank it started
    raise SystemExit(128 + signum)


if __name__ == "__main__":
    signal.signal(signal.SIGTERM, _terminated)
    sys.exit(launch())
