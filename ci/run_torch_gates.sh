#!/usr/bin/env bash
# The PyTorch port's CI gates (paddle_tpu_torch), on the CPU:
#   ci/run_torch_gates.sh
#
# The static gates (program, concurrency and numerics lint, the registry
# audit), the serving/fleet load gates of tools/torch_load_check.py and
# the memory plan, auto-remat, metrics, trace, chaos and option-sweep
# gates, with --device cpu, each negative control required to FAIL with
# the gate's own "-> FAIL" line (a crash is not a pass). JSON artifacts
# land in $CI_ARTIFACT_DIR (default: the current directory). The same
# legs run on the card at full width in chip_smoke.py's gates and
# ci_gates phases.
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

echo "== memory plan gate (the book programs and the lint builtin suite;"
echo "   error-severity PT5xx findings gate)"
python tools/torch_mem_report.py --check \
  --json "$ART/ci_torch_mem_report.json" | tail -2

echo "== auto-remat gate (BERT-base peak drop and budget fit, the flag-off"
echo "   tripwire as its negative control, bit-exact training)"
python tools/torch_remat_check.py --check --device cpu \
  --json "$ART/ci_torch_remat_report.json"

echo "== metrics gate (one compile and one hit a scenario, 0 recompiles)"
python tools/torch_metrics_report.py --check --device cpu \
  --json "$ART/ci_torch_metrics_report.json" | grep -v "^  "
echo "== metrics negative control (3 forced recompiles)"
must_fail "torch_metrics_report --force-recompile 3" \
  "$ART/ci_torch_forced_recompile.log" \
  python tools/torch_metrics_report.py --check --device cpu \
  --force-recompile 3

echo "== trace gate (complete traces, flight-recorder incidents, span"
echo "   overhead, the cost model; the burst's merged timeline)"
python tools/torch_trace_check.py --check --device cpu \
  --json "$ART/ci_torch_trace_report.json" \
  --timeline "$ART/ci_torch_timeline.json" | tail -8
echo "== trace negative control (flight recorder off)"
must_fail "torch_trace_check --negative-control" \
  "$ART/ci_torch_trace_negative.log" \
  python tools/torch_trace_check.py --check --device cpu --negative-control

echo "== chaos gate (a worker killed inside a checkpoint write resumes to"
echo "   the uninterrupted run's loss and digest)"
python tools/torch_chaos_check.py --check --device cpu \
  --json "$ART/ci_torch_chaos_report.json" | tail -3
echo "== chaos negative control (retries off)"
must_fail "torch_chaos_check --negative-control" \
  "$ART/ci_torch_chaos_negative.log" \
  python tools/torch_chaos_check.py --check --device cpu --negative-control

echo "== option sweep (K5 tilings, conv layout, epilogue fusion; must rank)"
python tools/torch_option_sweep.py --ci --device cpu \
  --json "$ART/ci_torch_option_sweep.json" | tail -3
echo "== option sweep negative control (sets that cannot run)"
must_fail "torch_option_sweep --negative-control" \
  "$ART/ci_torch_option_sweep_negative.log" \
  python tools/torch_option_sweep.py --ci --device cpu --negative-control

echo "torch gates: OK"
