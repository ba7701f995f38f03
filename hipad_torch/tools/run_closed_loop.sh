#!/bin/bash
# Parallel Bench2Drive closed-loop evaluation of the PyTorch port.
#
# The same sharded-routes / resume scheme as tools/run_closed_loop.sh (and
# the reference's run_evaluation_multi_hipad.sh, 16 CARLA sims over 8 GPUs):
# each worker pairs one CARLA server with one agent process
# (hipad_torch/agent/carla_adapter.py), and worker i runs its agent on GPU
# i % GPU_NUM, so two workers a GPU when TASK_NUM = 2 * GPU_NUM. Requires
# CARLA 0.9.15 and the Bench2Drive leaderboard checkout.
#
# Usage: TASK_NUM=16 GPU_NUM=8 CARLA_ROOT=/path LEADERBOARD_ROOT=/path \
#        ROUTES_DIR=splits/ CKPT=work_dirs/hipad_torch \
#        ./hipad_torch/tools/run_closed_loop.sh out/

set -euo pipefail
OUT=${1:-eval_out}
TASK_NUM=${TASK_NUM:-8}
GPU_NUM=${GPU_NUM:-$(nvidia-smi -L 2>/dev/null | wc -l)}
if [ "$GPU_NUM" -lt 1 ]; then GPU_NUM=1; fi
BASE_PORT=${BASE_PORT:-20082}
BASE_TM_PORT=${BASE_TM_PORT:-50000}
CKPT=${CKPT:-work_dirs/hipad_torch}
# CARLA takes ~30 s to open its RPC port after launch
CARLA_BOOT_WAIT=${CARLA_BOOT_WAIT:-30}
REPO_ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
mkdir -p "$OUT"

for ((i = 0; i < TASK_NUM; i++)); do
  PORT=$((BASE_PORT + i * 150))
  TM_PORT=$((BASE_TM_PORT + i * 150))
  ROUTES="${ROUTES_DIR}/split_${i}.xml"
  (
    "${CARLA_ROOT}/CarlaUE4.sh" -RenderOffScreen -nosound \
        -carla-rpc-port=$PORT >"$OUT/carla_$i.log" 2>&1 &
    CARLA_PID=$!
    sleep "$CARLA_BOOT_WAIT"
    CUDA_VISIBLE_DEVICES=$((i % GPU_NUM)) \
    PYTHONPATH="${LEADERBOARD_ROOT}:${LEADERBOARD_ROOT}/leaderboard:${REPO_ROOT}" \
    SAVE_PATH="$OUT/agent_$i" \
    python "${LEADERBOARD_ROOT}/leaderboard/leaderboard_evaluator.py" \
        --routes="$ROUTES" \
        --repetitions=1 \
        --track=SENSORS \
        --checkpoint="$OUT/route_$i.json" \
        --agent="${REPO_ROOT}/hipad_torch/agent/carla_adapter.py" \
        --agent-config="${CKPT}+hipad_torch_$i" \
        --port=$PORT --traffic-manager-port=$TM_PORT \
        --resume=True >"$OUT/eval_$i.log" 2>&1
    kill $CARLA_PID 2>/dev/null || true
  ) &
done
wait
python "${REPO_ROOT}/tools/route_stats.py" --route-dir "$OUT" --out "$OUT/merged.json"
