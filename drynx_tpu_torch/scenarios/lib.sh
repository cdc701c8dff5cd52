#!/bin/bash
# Shared helpers of the port's shell scenarios (a copy of test/lib.sh for
# drynx_tpu_torch; the reference Go system's test/lib.sh:36-57 boots N real
# server processes on random ports and the client pipes TOML configs
# between subcommands). Every node runs on the CUDA card; with
# DRYNX_SCENARIO_CPU=1 in the environment, `server run` and `survey run`
# get --cpu instead. With DRYNX_SCENARIO_GATE naming a file, a scenario
# that calls wait_gate boots its servers and then waits for that file
# before its survey (a driver that runs other work meanwhile opens it).
set -euo pipefail

REPO_ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="$REPO_ROOT${PYTHONPATH:+:$PYTHONPATH}"

# the interpreter: $PYTHON when the caller names one, else python
PYTHON="${PYTHON:-python}"
export PYTHON
SERVER="$PYTHON -m drynx_tpu_torch.cmd.server"
CLIENT="$PYTHON -m drynx_tpu_torch.cmd.client"
DEVICE_ARGS=""
if [ "${DRYNX_SCENARIO_CPU:-0}" = 1 ]; then
    DEVICE_ARGS="--cpu"
fi

WORKDIR="$(mktemp -d)"
declare -a SERVER_PIDS=()

cleanup() {
    for pid in "${SERVER_PIDS[@]:-}"; do
        kill "$pid" 2>/dev/null || true
    done
    wait 2>/dev/null || true
    rm -rf "$WORKDIR"
}
trap cleanup EXIT

random_port() {
    $PYTHON - <<'PY'
import socket
s = socket.socket()
s.bind(("127.0.0.1", 0))
print(s.getsockname()[1])
s.close()
PY
}

# gen_node <name> -> writes $WORKDIR/<name>.toml, echoes "host:port"
gen_node() {
    local name="$1" port
    port="$(random_port)"
    $SERVER gen --address "127.0.0.1:$port" --name "$name" \
        > "$WORKDIR/$name.toml"
    echo "127.0.0.1:$port"
}

# start_node <name> [--data <file>] -> boots `server run` on its config
start_node() {
    local name="$1"; shift
    $SERVER run $DEVICE_ARGS "$@" < "$WORKDIR/$name.toml" \
        2>"$WORKDIR/$name.log" &
    SERVER_PIDS+=("$!")
}

# survey_run -> the pipeline's last stage, on the nodes' device
survey_run() {
    $CLIENT survey run $DEVICE_ARGS
}

# node_public <name> -> "x,y" hex public key from the generated config
node_public() {
    $PYTHON - "$WORKDIR/$1.toml" <<'PY'
import sys
from drynx_tpu_torch.cmd import toml_io
cfg = toml_io.loads(open(sys.argv[1]).read())["node"]
print(f"{cfg['public_x']},{cfg['public_y']}")
PY
}

# wait_listening <name> -- block until the node logs its listen line (a
# node on the card makes its CUDA context first: up to 300 s)
wait_listening() {
    local name="$1" tries=0
    until grep -q "listening" "$WORKDIR/$name.log" 2>/dev/null; do
        tries=$((tries + 1))
        [ "$tries" -gt 1500 ] && { echo "server $name never came up" >&2;
                                   cat "$WORKDIR/$name.log" >&2; return 1; }
        sleep 0.2
    done
}

# wait_gate -- block until $DRYNX_SCENARIO_GATE exists, when it is set
wait_gate() {
    [ -z "${DRYNX_SCENARIO_GATE:-}" ] && return 0
    until [ -e "$DRYNX_SCENARIO_GATE" ]; do
        sleep 0.2
    done
}
