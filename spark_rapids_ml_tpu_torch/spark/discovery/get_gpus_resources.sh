#!/usr/bin/env bash
# GPU resource discovery script for Spark executors, in the format of
# Spark's own getGpusResources.sh. Wire it as
#   spark.executor.resource.gpu.discoveryScript=<this file>
#   spark.executor.resource.gpu.amount=<cards per executor, normally 1>
#   spark.task.resource.gpu.amount=1
# One task owns one card; parallelism comes from the partition count.
#
# Prints the Spark ResourceInformation JSON: {"name": "gpu", "addresses": [...]}.
# The addresses come from CUDA_VISIBLE_DEVICES when it is set, else from
# nvidia-smi; with neither the list is empty.
set -euo pipefail

addresses=()

if [[ -n "${CUDA_VISIBLE_DEVICES:-}" ]]; then
  IFS=',' read -r -a addresses <<< "${CUDA_VISIBLE_DEVICES}"
elif command -v nvidia-smi > /dev/null; then
  while IFS= read -r line; do
    line="${line//[[:space:]]/}"
    [[ -n "${line}" ]] && addresses+=("${line}")
  done < <(nvidia-smi --query-gpu=index --format=csv,noheader 2> /dev/null || true)
fi

if [[ ${#addresses[@]} -eq 0 ]]; then
  echo '{"name": "gpu", "addresses": []}'
  exit 0
fi

printf '{"name": "gpu", "addresses": ['
for i in "${!addresses[@]}"; do
  [[ $i -gt 0 ]] && printf ','
  printf '"%s"' "${addresses[$i]}"
done
printf ']}\n'
