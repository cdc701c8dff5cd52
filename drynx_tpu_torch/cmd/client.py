"""Client CLI: composable TOML config pipeline over stdin/stdout.

The port's counterpart of drynx_tpu/cmd/client.py (the reference's
cmd/client main.go:33-69, network.go, survey.go):

  network new                      -> empty network config on stdout
  network add-node --role cn ...   -> appends a node (reads cfg on stdin)
  network set-client               -> attaches a fresh querier keypair
  survey new --operation sum ...   -> adds the survey section
  survey run                       -> runs the survey against the network

Two network modes:
  * remote  — nodes are running `server run` processes (TCP control plane)
  * local   — `survey run --local` spins an in-process LocalCluster with the
              configured role counts (the reference's 3-node demo wiring,
              cmd/client/survey.go:96-104)

`survey run` decrypts (and, locally, runs the cluster) on the CUDA card
unless `--cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..crypto import elgamal as eg
from . import toml_io


def _read_cfg() -> dict:
    text = sys.stdin.read()
    return toml_io.loads(text) if text.strip() else {}


def _emit(cfg: dict) -> int:
    sys.stdout.write(toml_io.dumps(cfg))
    return 0


def cmd_network_new(args) -> int:
    return _emit({"nodes": []})


def cmd_network_add_node(args) -> int:
    cfg = _read_cfg()
    nodes = cfg.setdefault("nodes", [])
    host, _, port = args.address.partition(":")
    node = {"name": args.name or f"{args.role}{len(nodes)}",
            "role": args.role, "host": host or "127.0.0.1",
            "port": int(port or 0)}
    if args.public:
        x, _, y = args.public.partition(",")
        node["public_x"], node["public_y"] = x, y
    nodes.append(node)
    return _emit(cfg)


def cmd_network_set_client(args) -> int:
    cfg = _read_cfg()
    rng = np.random.default_rng()
    secret, public = eg.keygen(rng)
    cfg["client"] = {"secret": hex(secret), "public_x": hex(public[0]),
                     "public_y": hex(public[1])}
    # writing the freshly generated keypair to the operator's config is
    # this command's whole purpose (key-store TOML, never logged)
    return _emit(cfg)  # drynx: noqa[secret-flow-to-sink]


def cmd_survey_new(args) -> int:
    cfg = _read_cfg()
    cfg["survey"] = {"operation": args.operation, "query_min": args.min,
                     "query_max": args.max, "proofs": bool(args.proofs),
                     "obfuscation": bool(args.obfuscation)}
    if args.operation == "log_reg":
        cfg["survey"]["lr"] = {
            "features": args.lr_features, "records": args.lr_records,
            "k": args.lr_k, "precision": args.lr_precision,
            "iterations": args.lr_iterations, "step": args.lr_step,
            "lambda": args.lr_lambda}
    return _emit(cfg)


def _lr_params_of(sv: dict):
    from ..models.logreg import LRParams

    lr_cfg = sv.get("lr", {})
    if not lr_cfg.get("features") or not lr_cfg.get("records"):
        raise SystemExit(
            "log_reg survey config is missing its lr section — re-run "
            "`survey new --operation log_reg --lr-features D --lr-records N`")
    return LRParams(
        k=int(lr_cfg.get("k", 2)),
        precision=float(lr_cfg.get("precision", 1e2)),
        lambda_=float(lr_cfg.get("lambda", 1.0)),
        step=float(lr_cfg.get("step", 0.1)),
        max_iterations=int(lr_cfg.get("iterations", 25)),
        n_features=int(lr_cfg["features"]),
        n_records=int(lr_cfg["records"]))


def cmd_survey_set_operation(args) -> int:
    cfg = _read_cfg()
    cfg.setdefault("survey", {})["operation"] = args.operation
    return _emit(cfg)


def cmd_survey_run(args) -> int:
    cfg = _read_cfg()
    sv = cfg.get("survey", {})
    op = sv.get("operation", "sum")
    qmin, qmax = int(sv.get("query_min", 0)), int(sv.get("query_max", 0))

    device = "cpu" if args.cpu else None
    if args.local:
        from ..service.api import DrynxClient
        from ..service.service import LocalCluster

        roles = [n.get("role") for n in cfg.get("nodes", [])]
        cluster = LocalCluster(
            n_cns=max(roles.count("cn"), 1),
            n_dps=max(roles.count("dp"), 1),
            n_vns=roles.count("vn") if sv.get("proofs") else 0,
            dlog_limit=int(sv.get("dlog_limit", 10000)), device=device)
        client = DrynxClient(cluster)
        if args.serve > 1:
            # standing-server mode: N copies of the survey through the
            # scheduler (SERVER.md) — equal shapes batch at the VNs
            from ..server import SurveyServer

            server = SurveyServer(cluster, max_batch=args.serve)
            admissions = {}
            for i in range(args.serve):
                sq = client.generate_survey_query(
                    op, query_min=qmin, query_max=qmax,
                    proofs=1 if sv.get("proofs") else 0,
                    obfuscation=bool(sv.get("obfuscation", False)),
                    survey_id=f"cli{i}")
                admissions[sq.survey_id] = server.submit(sq)
            results = server.drain()
            out = {"operation": op, "surveys": {}}
            ok = True
            for sid, a in admissions.items():
                res = results.get(sid)
                if isinstance(res, Exception):
                    out["surveys"][sid] = {"lane": a.lane,
                                           "error": str(res)}
                    ok = False
                    continue
                entry = {"lane": a.lane, "result": _jsonable(res.result)}
                if res.block is not None:
                    entry["bitmap_ok"] = all(
                        v == 1 for v in res.block.data.bitmap.values())
                    ok = ok and entry["bitmap_ok"]
                out["surveys"][sid] = entry
            print(json.dumps(out))
            return 0 if ok else 1
        sq = client.generate_survey_query(
            op, query_min=qmin, query_max=qmax,
            proofs=1 if sv.get("proofs") else 0,
            obfuscation=bool(sv.get("obfuscation", False)))
        res = client.send_survey_query(sq)
        out = {"survey_id": res.survey_id, "operation": op,
               "result": _jsonable(res.result)}
        if res.block is not None:
            out["block_hash"] = res.block.hash()
            out["bitmap_ok"] = all(v == 1
                                   for v in res.block.data.bitmap.values())
        print(json.dumps(out))
        return 0

    # remote mode: drive running server processes
    from ..service.node import RemoteClient, Roster, RosterEntry

    entries = []
    for n in cfg.get("nodes", []):
        pub = (int(n["public_x"], 16), int(n["public_y"], 16))
        entries.append(RosterEntry(name=n["name"], role=n["role"],
                                   host=n["host"], port=int(n["port"]),
                                   public=pub))
    roster = Roster(entries)
    client = RemoteClient(roster, device=device)
    client.broadcast_roster()
    lr_params = _lr_params_of(sv) if op == "log_reg" else None
    ranges = None
    if op == "log_reg" and sv.get("proofs"):
        # uniform spec; the signed-offset shift (u^l/2) keeps negative
        # fixed-point coefficients inside the proved range
        ranges = [(16, 5)] * lr_params.num_coeffs()
    if sv.get("proofs"):
        from ..resilience import policy as rp

        result, block = client.run_survey(
            op, query_min=qmin, query_max=qmax, proofs=True,
            obfuscation=bool(sv.get("obfuscation", False)),
            lr_params=lr_params, ranges=ranges,
            timeout=float(sv.get("proof_timeout",
                                 2 * rp.COLD_COMPILE_WAIT_S)))
        bitmap = block.get("bitmap", {})
        print(json.dumps({"operation": op, "result": _jsonable(result),
                          "block_hash": block.get("block_hash"),
                          "bitmap_ok": bool(bitmap) and
                          all(v == 1 for v in bitmap.values())}))
        return 0
    result = client.run_survey(op, query_min=qmin, query_max=qmax,
                               lr_params=lr_params)
    print(json.dumps({"operation": op, "result": _jsonable(result)}))
    return 0


def _jsonable(x):
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="drynx-client")
    sub = p.add_subparsers(dest="group", required=True)

    net = sub.add_parser("network").add_subparsers(dest="cmd", required=True)
    n_new = net.add_parser("new")
    n_new.set_defaults(fn=cmd_network_new)
    n_add = net.add_parser("add-node")
    n_add.add_argument("--role", required=True, choices=["cn", "dp", "vn"])
    n_add.add_argument("--name", default=None)
    n_add.add_argument("--address", default="127.0.0.1:0")
    n_add.add_argument("--public", default=None,
                       help="x,y affine ints (hex) for remote nodes")
    n_add.set_defaults(fn=cmd_network_add_node)
    n_set = net.add_parser("set-client")
    n_set.set_defaults(fn=cmd_network_set_client)

    srv = sub.add_parser("survey").add_subparsers(dest="cmd", required=True)
    s_new = srv.add_parser("new")
    s_new.add_argument("--operation", default="sum")
    s_new.add_argument("--min", type=int, default=0)
    s_new.add_argument("--max", type=int, default=0)
    s_new.add_argument("--proofs", action="store_true")
    s_new.add_argument("--obfuscation", action="store_true")
    s_new.add_argument("--lr-features", type=int, default=0,
                       help="log_reg: number of features d")
    s_new.add_argument("--lr-records", type=int, default=0,
                       help="log_reg: TOTAL records across all DPs (N)")
    s_new.add_argument("--lr-k", type=int, default=2)
    s_new.add_argument("--lr-precision", type=float, default=1e2)
    s_new.add_argument("--lr-iterations", type=int, default=25)
    s_new.add_argument("--lr-step", type=float, default=0.1)
    s_new.add_argument("--lr-lambda", type=float, default=1.0)
    s_new.set_defaults(fn=cmd_survey_new)
    s_op = srv.add_parser("set-operation")
    s_op.add_argument("--operation", required=True)
    s_op.set_defaults(fn=cmd_survey_set_operation)
    s_run = srv.add_parser("run")
    s_run.add_argument("--local", action="store_true")
    s_run.add_argument("--serve", type=int, default=1, metavar="N",
                       help="local only: submit N copies of the survey "
                            "through the standing SurveyServer scheduler "
                            "(batched verification; see SERVER.md)")
    s_run.add_argument("--cpu", action="store_true",
                       help="decrypt (and run a --local cluster) on the "
                            "CPU; without it on the CUDA card")
    s_run.set_defaults(fn=cmd_survey_run)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
