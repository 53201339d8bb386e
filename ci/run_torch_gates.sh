#!/usr/bin/env bash
# The PyTorch port's CI gates (paddle_tpu_torch), on the CPU:
#   ci/run_torch_gates.sh
#
# The static gates (program, concurrency and numerics lint, the registry
# audit) and the serving/fleet load gates of tools/torch_load_check.py
# with --device cpu, each negative control required to FAIL with the
# gate's own "-> FAIL" line (a crash is not a pass). JSON artifacts land
# in $CI_ARTIFACT_DIR (default: the current directory). The same legs run
# on the card at full width in chip_smoke.py's gates phase.
set -euo pipefail
cd "$(dirname "$0")/.."
ART="${CI_ARTIFACT_DIR:-.}"

# must_fail NAME LOG CMD...: the command exits non-zero AND its log
# carries the gate's "-> FAIL" verdict
must_fail() {
  local name="$1" log="$2"
  shift 2
  if "$@" > "$log" 2>&1; then
    echo "$name did NOT fail" >&2
    exit 1
  fi
  if ! grep -q -- "-> FAIL" "$log"; then
    echo "$name exited non-zero WITHOUT tripping the gate:" >&2
    tail -20 "$log" >&2
    exit 1
  fi
}

echo "== import check (the port imports neither jax nor paddle_tpu)"
python -c "
import sys
sys.modules['jax'] = None
sys.modules['paddle_tpu'] = None
import paddle_tpu_torch
print('ops registered:', len(paddle_tpu_torch.core.registry.all_ops()))"

echo "== static program lint over the port's zoo (verifier + PT700s/710s/"
echo "   720s/90x; errors and non-allowlisted dead code gate)"
python tools/torch_lint_program.py --zoo \
  --json "$ART/ci_torch_lint_report.json" | tail -5

echo "== concurrency lint gate (analysis/concurrency over paddle_tpu_torch:"
echo "   PT800 cycles, PT801 blocking under a lock, PT802 unguarded"
echo "   cross-thread attrs gate unless allowlisted with a reason)"
python tools/torch_lint_concurrency.py \
  --json "$ART/ci_torch_concurrency_report.json"
echo "== concurrency lint negative control (broken fixtures, allowlist off)"
must_fail "torch_lint_concurrency --negative-control" \
  "$ART/ci_torch_concurrency_negative.log" \
  python tools/torch_lint_concurrency.py --negative-control

echo "== numerics lint gate (the zoo + QAT variants) and the witness"
echo "   containment cross-check"
python tools/torch_lint_numerics.py --witness \
  --json "$ART/ci_torch_numerics_report.json" | tail -6
echo "== numerics lint negative control (broken fixtures, allowlist off)"
must_fail "torch_lint_numerics --negative-control" \
  "$ART/ci_torch_numerics_negative.log" \
  python tools/torch_lint_numerics.py --negative-control

echo "== op-registry audit (ops without a lower rule gate)"
python tools/torch_audit_registry.py --strict \
  --json-file "$ART/ci_torch_registry_audit.json" > /dev/null

echo "== serving load gate (--decode; under the lock witness)"
python tools/torch_load_check.py --ci --device cpu --decode --lock-witness \
  --json "$ART/ci_torch_serving_report.json" | tail -13
echo "== serving negative control (no shedding, prefix cache off,"
echo "   speculation off)"
must_fail "torch_load_check --decode --negative-control" \
  "$ART/ci_torch_serving_negative.log" \
  python tools/torch_load_check.py --ci --device cpu --decode \
  --negative-control

echo "== fleet gate (two replica processes, one SIGTERMed mid-burst; the"
echo "   telemetry plane)"
python tools/torch_load_check.py --ci --device cpu --fleet \
  --log-dir "$ART" --json "$ART/ci_torch_fleet_report.json" | tail -12
echo "== fleet negative control (drain honoring + unadmitted retry off)"
must_fail "torch_load_check --fleet --negative-control" \
  "$ART/ci_torch_fleet_negative.log" \
  python tools/torch_load_check.py --ci --device cpu --fleet \
  --negative-control --log-dir "$ART"

echo "== fleet self-healing gate under the lock witness (its runtime"
echo "   section merged into the concurrency report)"
python tools/torch_load_check.py --ci --device cpu --fleet-chaos \
  --lock-witness \
  --concurrency-json "$ART/ci_torch_concurrency_report.json" \
  --log-dir "$ART" --json "$ART/ci_torch_fleet_chaos_report.json" | tail -10
echo "== fleet self-healing negative control (restarts + bisection off)"
must_fail "torch_load_check --fleet-chaos --negative-control" \
  "$ART/ci_torch_fleet_chaos_negative.log" \
  python tools/torch_load_check.py --ci --device cpu --fleet-chaos \
  --negative-control --log-dir "$ART"

echo "== fleet control-loop gate (autoscaler + tenant fair share)"
python tools/torch_load_check.py --ci --device cpu --autoscale \
  --log-dir "$ART" --json "$ART/ci_torch_autoscale_report.json" | tail -14
echo "== fleet control-loop negative control (no autoscaler, no quotas)"
must_fail "torch_load_check --autoscale --negative-control" \
  "$ART/ci_torch_autoscale_negative.log" \
  python tools/torch_load_check.py --ci --device cpu --autoscale \
  --negative-control --log-dir "$ART"

echo "torch gates: OK"
