#!/usr/bin/env python
"""Numerics static-analysis linter CLI of the PyTorch port (CI face of
paddle_tpu_torch.analysis.numerics; counterpart of tools/lint_numerics.py).

Runs the interval/precision-flow analysis over the port's model zoo —
including QAT-transformed (``contrib.slim`` ``quant_aware``)
resnet/bert/gpt variants — and reports the PT900 family:

  PT900  broken fake-quant/dequant pairing                ERROR
  PT901  dead / non-persistable moving-average scale      WARNING
  PT902  statically-proven overflowing cast               ERROR
  PT903  reduction accumulated in low precision           WARNING
  PT904  AMP loss-scale coverage gap                      WARNING
  PT905  nonfinite-producing op on a proven interval      WARNING
  PT906  quantizable GEMM/conv site (the int8 work-list)  INFO

ALL of PT900-PT905 gate regardless of severity; a finding is either
fixed or allowlisted below with the reason on record. PT906 never gates:
it is the int8 work-list, carried in the JSON artifact.

Usage:
  python tools/torch_lint_numerics.py
      Lint the zoo + QAT variants (the ci/run_torch_gates.sh gate).
  --witness            ALSO run a short train+infer of mnist_mlp /
                       resnet / bert / gpt under FLAGS_numerics_witness=1
                       on the CPU and cross-check every observed value
                       against its statically-proven interval,
                       tolerance-free (monitor.numwitness.
                       containment_violations — any escape is an
                       analysis soundness bug and fails CI). Observed
                       abs-max feeds back into the PT906 report as
                       calibration data.
  --json PATH          machine-readable report: findings, the PT906
                       quantizability work-list, bounded intervals,
                       witness observations + violations.
  --negative-control   analyze the intentionally-broken fixtures under
                       tests/fixtures/torch_numerics with an EMPTY
                       allowlist; the gate must trip on ALL of
                       PT900-PT905 (proves every detector can fail).

Exit status (stable, for CI):
  0  clean — no gating findings (and no containment violations)
  1  findings — PT900-PT905 not covered by the allowlist, or a witness
     containment violation
  2  internal error — the linter itself failed (never conflate a linter
     crash with a lint finding)
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch.analysis.numerics import analyze_numerics  # noqa: E402

# Findings the zoo gate accepts, with the reason on record. Matched on
# (code, key) where key is "<program>:<op_type>" — stable across line
# numbers and var renames.
ALLOWLIST: dict = {
}

# every PT900-PT905 finding gates unless allowlisted; PT906 is the
# info-level work-list and never gates
GATING_CODES = ("PT900", "PT901", "PT902", "PT903", "PT904", "PT905")

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "..",
                           "tests", "fixtures", "torch_numerics")

# (name, steps) of the zoo programs the --witness leg trains + infers;
# must stay a subset of _zoo_targets() names
WITNESS_RUNS = (("zoo/mnist_mlp", 3), ("zoo/resnet18", 2),
                ("zoo/bert_tiny", 2), ("zoo/gpt_tiny/prefill", 2))


def _zoo_targets():
    """(name, main, startup_or_None, fetch_names, feed_fn_or_None)
    tuples over the models the gate lints. feed_fn(rng) builds one batch
    for the witness leg (None = static-only target)."""
    import paddle_tpu_torch.unique_name as un
    from paddle_tpu_torch.contrib.slim.quantization import quant_aware
    from paddle_tpu_torch.models import (BertConfig, GptConfig,
                                   build_bert_pretrain,
                                   build_gpt_generative, build_mnist_mlp,
                                   build_resnet)

    out = []

    def mlp_feed(rng):
        x = rng.randn(16, 784).astype(np.float32)
        return {"img": x,
                "label": rng.randint(0, 10, (16, 1)).astype(np.int64)}

    with un.guard():
        m = build_mnist_mlp(hidden=(64,))
        out.append(("zoo/mnist_mlp", m["main"], m["startup"],
                    [m["loss"].name, m["acc"].name], mlp_feed))

    def resnet_feed(rng):
        return {"img": rng.randn(4, 3, 32, 32).astype(np.float32),
                "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}

    with un.guard():
        m = build_resnet(depth=18, class_num=10, image_shape=(3, 32, 32))
        out.append(("zoo/resnet18", m["main"], m["startup"],
                    [m["loss"].name, m["acc"].name], resnet_feed))

    def bert_feed(rng):
        B, S = 2, 32
        ids = rng.randint(0, 100, (B, S)).astype(np.int64)
        mask_label = np.full((B, S), -100, np.int64)
        mask_label[:, :4] = rng.randint(0, 100, (B, 4))
        return {"src_ids": ids,
                "pos_ids": np.tile(np.arange(S, dtype=np.int64), (B, 1)),
                "sent_ids": np.zeros((B, S), np.int64),
                "input_mask": np.ones((B, S), np.float32),
                "mask_label": mask_label,
                "next_sent_label": rng.randint(0, 2, (B, 1)).astype(
                    np.int64)}

    with un.guard():
        m = build_bert_pretrain(BertConfig.tiny(), seq_len=32)
        out.append(("zoo/bert_tiny", m["main"], m["startup"],
                    [m["loss"].name], bert_feed))

    def gpt_feed(rng):
        B, S = 2, 16
        ids = np.zeros((B, S), np.int64)
        ids[:, :5] = rng.randint(1, 50, (B, 5))
        mask = np.zeros((B, S), np.float32)
        mask[:, :5] = 1.0
        return {"prompt_ids": ids, "prompt_mask": mask,
                "prompt_pos": np.tile(np.arange(S, dtype=np.int64),
                                      (B, 1)),
                "prompt_len": np.full((B, 1), 5, np.int64),
                "slot_mask": np.ones((B, 1), np.float32)}

    with un.guard():
        g = build_gpt_generative(GptConfig.tiny(), batch_slots=2,
                                 max_seq=32, page_size=8,
                                 prompt_buckets=(16,))
        pf = g["prefill"][16]
        out.append(("zoo/gpt_tiny/prefill", pf["main"], g["startup"],
                    [pf["first_token"].name], gpt_feed))
        out[-1] = out[-1] + (g,)   # state_vars needed by the witness run
        out.append(("zoo/gpt_tiny/decode", g["decode"]["main"], None,
                    [g["decode"]["next_token"].name], None))

    # QAT-transformed variants: quant_aware over fresh builds — the gate
    # proves the PT900/PT901 contract holds on the slim pass's own output
    with un.guard():
        m = build_resnet(depth=18, class_num=10, image_shape=(3, 32, 32),
                         build_optimizer=False)
        quant_aware(m["main"], m["startup"])
        out.append(("zoo/resnet18+qat", m["main"], None,
                    [m["loss"].name, m["acc"].name], None))
    with un.guard():
        m = build_bert_pretrain(BertConfig.tiny(), seq_len=32,
                                build_optimizer=False)
        quant_aware(m["main"], m["startup"])
        out.append(("zoo/bert_tiny+qat", m["main"], None,
                    [m["loss"].name], None))
    with un.guard():
        g = build_gpt_generative(GptConfig.tiny(), batch_slots=2,
                                 max_seq=32, page_size=8,
                                 prompt_buckets=(16,))
        pf = g["prefill"][16]
        quant_aware(pf["main"], g["startup"])
        out.append(("zoo/gpt_tiny/prefill+qat", pf["main"], None,
                    [pf["first_token"].name], None))
    return out


def _diag_dict(d) -> dict:
    return {"code": d.code, "severity": d.severity, "op_type": d.op_type,
            "block": d.block_idx, "op_idx": d.op_idx,
            "message": d.message, "site": d.site}


def _lint(name, program, fetch_names, allowlist, json_report,
          calibration=None) -> bool:
    rep = analyze_numerics(program, fetch_names=fetch_names,
                           calibration=calibration)
    gating, allow_hits = [], []
    for d in rep.diagnostics:
        if d.code not in GATING_CODES:
            continue
        reason = allowlist.get((d.code, f"{name}:{d.op_type or ''}"), "")
        if reason:
            allow_hits.append((d, reason))
        else:
            gating.append(d)
    by_code: dict = {}
    for d in rep.diagnostics:
        by_code[d.code] = by_code.get(d.code, 0) + 1
    status = "FAIL" if gating else "ok"
    sites = len(rep.quant_sites)
    print(f"[{status}] {name}: "
          f"{sum(len(b.ops) for b in program.blocks)} ops, "
          f"{len(rep.bounded_intervals(proven_only=False))} bounded "
          f"interval(s), {sites} quantizable site(s), findings "
          f"{by_code or '{}'}, {len(allow_hits)} allowlisted")
    for d in gating:
        print(f"  {d.code} [{d.severity}] op '{d.op_type}' "
              f"(block {d.block_idx} op {d.op_idx}): {d.message}")
    json_report["targets"].append({
        "name": name, "status": "fail" if gating else "ok",
        "report": rep.to_dict(),
        "gating": [_diag_dict(d) for d in gating],
        "allowlisted": [dict(_diag_dict(d), reason=r)
                        for d, r in allow_hits],
    })
    if gating:
        print(f"numerics gate -> FAIL ({name}: {len(gating)} "
              f"non-allowlisted finding(s))")
    return not gating


def _negative_control(json_report: dict) -> int:
    """Fixtures must trip every PT900-PT905 with the allowlist OFF."""
    fixture_modules = sorted(
        f[:-3] for f in os.listdir(FIXTURE_DIR)
        if f.endswith(".py") and f != "__init__.py")

    tripped = set()
    ok_all = True
    for modname in fixture_modules:
        # loaded by path under a name of their own: the JAX package's
        # fixtures carry the same module names
        spec = importlib.util.spec_from_file_location(
            f"torch_numerics_{modname}",
            os.path.join(FIXTURE_DIR, modname + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        main, _startup, fetch = mod.build()
        ok = _lint(f"negative-control({modname})", main, fetch, {},
                   json_report)
        ok_all = ok_all and ok
        tripped |= set(json_report["targets"][-1]["report"]
                       .get("findings_by_code", {}))
    missing = [c for c in GATING_CODES if c not in tripped]
    if missing:
        # a control that cannot trip every family is a broken control,
        # not a gate failure — exit 2 so CI's "-> FAIL" grep flags it
        print(f"negative control did NOT produce {', '.join(missing)} "
              f"on the fixtures — the analysis lost coverage",
              file=sys.stderr)
        return 2
    if ok_all:
        print("negative control found nothing gating on intentionally "
              "broken fixtures", file=sys.stderr)
        return 0   # CI inverts the exit status: 0 here fails the build
    return 1


def _witness_run(name, main, startup, fetch_names, feed_fn, steps,
                 net=None):
    """Short train (or infer) loop under FLAGS_numerics_witness=1;
    returns the merged observed ranges {var: {...}}."""
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.monitor import numwitness

    numwitness.reset_numerics_witness()
    set_flags({"numerics_witness": True})
    try:
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        rng = np.random.RandomState(0)
        with fluid.scope_guard(scope):
            exe.run(startup)
            if net is not None:     # generative state (paged KV, slots)
                from paddle_tpu_torch.core.types import np_dtype

                for vn, (shape, dt) in net["state_vars"].items():
                    scope.set_var(vn, np.zeros(shape, np_dtype(dt)))
            for _ in range(steps):
                exe.run(main, feed=feed_fn(rng), fetch_list=fetch_names)
            # the infer leg: forward-only clone over the trained params
            # (same var names, same static intervals)
            if net is None:
                infer = main.clone(for_test=True)
                feed = feed_fn(rng)
                infer_fetch = [n for n in fetch_names
                               if infer.global_block.has_var(n)]
                exe.run(infer, feed=feed, fetch_list=infer_fetch)
        return numwitness.numerics_witness_vars()
    finally:
        set_flags({"numerics_witness": False})


def _witness_leg(targets, json_report: dict) -> bool:
    """The lock-witness idiom for numerics: every observed value must lie
    inside its statically-proven interval, tolerance-free."""
    from paddle_tpu_torch.monitor import numwitness

    by_name = {t[0]: t for t in targets}
    ok = True
    for name, steps in WITNESS_RUNS:
        t = by_name[name]
        net = t[5] if len(t) > 5 else None
        _, main, startup, fetch_names, feed_fn = t[:5]
        observed = _witness_run(name, main, startup, fetch_names,
                                feed_fn, steps, net=net)
        rep = analyze_numerics(main, fetch_names=fetch_names)
        static = rep.bounded_intervals(proven_only=True)
        checked = sorted(set(static) & set(observed))
        violations = numwitness.containment_violations(static, observed)
        status = "FAIL" if violations else "ok"
        print(f"[{status}] witness {name}: {steps} step(s), "
              f"{len(observed)} var(s) observed, {len(checked)} "
              f"interval(s) cross-checked, "
              f"{len(violations)} containment violation(s)")
        for v in violations:
            print(f"  ESCAPE {v['var']}: {v['detail']}")
        # feed observed abs-max back into PT906 as calibration
        calib = {n: o["absmax"] for n, o in observed.items()}
        calibrated = analyze_numerics(main, fetch_names=fetch_names,
                                      calibration=calib)
        json_report["witness"].append({
            "name": name, "steps": steps,
            "status": "fail" if violations else "ok",
            "observed": observed,
            "checked_vars": checked,
            "violations": violations,
            "quant_sites_calibrated": calibrated.quant_sites,
        })
        if violations:
            print(f"numerics gate -> FAIL (witness {name}: "
                  f"{len(violations)} observed value(s) escaped their "
                  f"static interval — analysis soundness bug)")
            ok = False
    return ok


def run(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the machine-readable report here")
    ap.add_argument("--witness", action="store_true",
                    help="also run the runtime-witness containment "
                         "cross-check over the zoo")
    ap.add_argument("--negative-control", action="store_true",
                    help="analyze the broken fixtures with an empty "
                         "allowlist; must FAIL")
    args = ap.parse_args(argv)

    json_report = {
        "targets": [], "witness": [],
        "allowlist": [{"code": c, "key": k, "reason": r}
                      for (c, k), r in sorted(ALLOWLIST.items())],
    }
    if args.negative_control:
        code = _negative_control(json_report)
        json_report["status"] = "negative-control"
    else:
        targets = _zoo_targets()
        ok = True
        for t in targets:
            name, main, _startup, fetch_names = t[0], t[1], t[2], t[3]
            ok = _lint(name, main, fetch_names, ALLOWLIST,
                       json_report) and ok
        if args.witness:
            ok = _witness_leg(targets, json_report) and ok
        json_report["status"] = "ok" if ok else "fail"
        code = 0 if ok else 1
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(json_report, f, indent=2, sort_keys=True)
        print(f"report -> {args.json}")
    return code


def main(argv=None) -> int:
    """Stable CI exit codes: 0 clean, 1 findings, 2 internal error."""
    try:
        return run(argv)
    except SystemExit as e:  # argparse error: also an internal error
        code = e.code if isinstance(e.code, int) else 2
        return code if code in (0, 1) else 2
    except Exception:
        traceback.print_exc()
        return 2


if __name__ == "__main__":
    sys.exit(main())
