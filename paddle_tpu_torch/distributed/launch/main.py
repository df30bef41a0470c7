"""The launch CLI, the counterpart of
``paddle_tpu/distributed/launch/main.py:23-91`` (the reference's
``launch/main.py:23``, its controllers and the elastic restart of
``fleet/elastic/manager.py:125``).

One process per node: it sets the world's environment (the master's
address, the number of nodes, this node's rank), runs the training script
with its output in ``<log_dir>/workerlog.<rank>.<restart>``, and
supervises it: with ``--elastic_level 1`` a failed worker is started
again, up to ``--max_restart`` times. The rendezvous itself is
``init_parallel_env`` in the script (a ``torch.distributed`` process
group over gloo met at the port's ``TCPStore`` on the master), fed by the
environment set here. Exit codes: 0 when the worker succeeds, the
worker's code when it fails for good, 130 on an interrupt.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time


def build_parser():
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--master", default=None,
                   help="host:port of node 0's store")
    p.add_argument("--nnodes", type=int,
                   default=int(os.environ.get("PADDLE_NNODES", "1")))
    p.add_argument("--rank", "--node_rank", type=int, dest="rank",
                   default=int(os.environ.get("PADDLE_NODE_RANK", "0")))
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="kept for CLI parity; one process per node")
    p.add_argument("--devices", "--gpus", dest="devices", default=None,
                   help="visible CUDA device ids (comma separated)")
    p.add_argument("--job_id", default="default")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--elastic_level", type=int,
                   default=int(os.environ.get("PADDLE_ELASTIC_LEVEL", "0")),
                   help="0: fail fast; 1: restart in place on failure")
    p.add_argument("--max_restart", type=int, default=3)
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p


def launch(args=None):
    args = args if args is not None else build_parser().parse_args()
    env = dict(os.environ)
    env["PADDLE_TRAINERS_NUM"] = str(args.nnodes)
    env["PADDLE_TRAINER_ID"] = str(args.rank)
    env["PADDLE_NNODES"] = str(args.nnodes)
    if args.master:
        env["PADDLE_MASTER"] = args.master
        host, _, port = args.master.partition(":")
        env["MASTER_ADDR"] = host
        env["MASTER_PORT"] = port or "8476"
    if args.devices:
        env["CUDA_VISIBLE_DEVICES"] = args.devices
    os.makedirs(args.log_dir, exist_ok=True)

    cmd = [sys.executable, args.training_script] + args.training_script_args
    restarts = 0
    while True:
        log_path = os.path.join(
            args.log_dir, f"workerlog.{args.rank}.{restarts}")
        with open(log_path, "wb") as logf:
            proc = subprocess.Popen(cmd, env=env, stdout=logf,
                                    stderr=subprocess.STDOUT)
            try:
                ret = proc.wait()
            except KeyboardInterrupt:
                proc.send_signal(signal.SIGTERM)
                proc.wait()
                return 130
        if ret == 0:
            return 0
        # failure detection and the elastic restart (elastic_level as in
        # the reference's launch/main.py:93-97)
        if args.elastic_level >= 1 and restarts < args.max_restart:
            restarts += 1
            print(f"[launch] worker exited {ret}; restart "
                  f"{restarts}/{args.max_restart}", file=sys.stderr)
            time.sleep(1)
            continue
        print(f"[launch] worker failed with code {ret} (log: {log_path})",
              file=sys.stderr)
        return ret


if __name__ == "__main__":
    sys.exit(launch())
