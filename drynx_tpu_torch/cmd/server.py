"""Server CLI: `gen` emits a node config (TOML, stdout); `run` boots the node.

The port's counterpart of drynx_tpu/cmd/server.py (the reference's
cmd/server main.go:42-126): `server gen` creates the keypair and address
config on stdout; `server run` reads the config from stdin and serves
until killed. One binary, the role decided by the roster
(cmd/README.md:13-18). A node runs on the CUDA card unless `--cpu` is
given; its `listening` line names its device.

Usage:
  python -m drynx_tpu_torch.cmd.server gen --address 127.0.0.1:7000 --name cn0
  python -m drynx_tpu_torch.cmd.server run < node.toml
  python -m drynx_tpu_torch.cmd.server run --cpu --data dp.txt < dp.toml
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..crypto import elgamal as eg
from . import toml_io


def cmd_gen(args) -> int:
    host, _, port = args.address.partition(":")
    rng = np.random.default_rng()
    secret, public = eg.keygen(rng)
    cfg = {"node": {
        "name": args.name,
        "host": host or "127.0.0.1",
        "port": int(port or 0),
        "secret": hex(secret),
        "public_x": hex(public[0]),
        "public_y": hex(public[1]),
    }}
    # the generated keypair as TOML is this command's whole purpose (a key
    # file for the operator)
    sys.stdout.write(toml_io.dumps(cfg))  # drynx: noqa[secret-flow-to-sink]
    return 0


def cmd_run(args) -> int:
    from ..service.node import DrynxNode

    # the overlay comes from the dialed roster, but the root that dispatches
    # a survey reads these: the flags land in the environment that
    # service/topology.py reads
    if args.topology:
        os.environ["DRYNX_TOPOLOGY"] = args.topology
    if args.tree_fanout:
        os.environ["DRYNX_TREE_FANOUT"] = str(args.tree_fanout)

    cfg = toml_io.loads(sys.stdin.read())["node"]
    data = None
    if args.lr_data:
        # (X, y) for log_reg surveys: CSV, label in column 0 (reference
        # LoadData, lib/encoding/logistic_regression.go:1275)
        from ..models import logreg as lr

        data = lr.load_csv(args.lr_data)
    elif args.data:
        data = np.loadtxt(args.data, dtype=np.int64, ndmin=1)
    pool = None
    if args.pool:
        from ..pool import CryptoPool

        # DrynxNode activates it before any table is built
        pool = CryptoPool(args.pool)
    node = DrynxNode(cfg["name"], int(cfg["secret"], 16),
                     (int(cfg["public_x"], 16), int(cfg["public_y"], 16)),
                     host=cfg.get("host", "127.0.0.1"),
                     port=int(cfg.get("port", 0)), data=data,
                     db_path=args.db, pool=pool,
                     device="cpu" if args.cpu else None)
    where = str(node.device)
    if node.device.type == "cuda":
        import torch

        where += f" ({torch.cuda.get_device_name(node.device)})"
    print(f"drynx node {cfg['name']} listening on "
          f"{node.address[0]}:{node.address[1]} device {where}",
          file=sys.stderr, flush=True)
    try:
        node.server.serve_forever()
    except KeyboardInterrupt:
        node.stop()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="drynx-server")
    sub = p.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("gen", help="generate node config TOML on stdout")
    g.add_argument("--address", default="127.0.0.1:0")
    g.add_argument("--name", default="node")
    g.set_defaults(fn=cmd_gen)
    r = sub.add_parser("run", help="run node from config TOML on stdin")
    r.add_argument("--data", default=None,
                   help="path to this DP's local data (one int per line)")
    r.add_argument("--lr-data", default=None,
                   help="path to this DP's (X, y) CSV for log_reg surveys "
                        "(label in column 0)")
    r.add_argument("--db", default=None,
                   help="proof/skipchain DB path (VN role)")
    r.add_argument("--pool", default=None,
                   help="crypto-pool directory (CryptoPool): DRO slabs "
                        "for shuffle contributions, persisted signature "
                        "and fixed-base tables")
    r.add_argument("--topology", default=None, choices=["tree", "star"],
                   help="survey dispatch overlay when this node roots a "
                        "survey: tree (default) relays contributions up a "
                        "roster-derived forest; star is the flat fan-out")
    r.add_argument("--tree-fanout", type=int, default=None,
                   help="tree branching factor (else ceil(sqrt(n)) "
                        "clamped to the policy's bounds)")
    r.add_argument("--cpu", action="store_true",
                   help="run the node on the CPU (the plain versions of "
                        "the kernels); without it the node runs on the "
                        "CUDA card")
    r.set_defaults(fn=cmd_run)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
