#!/usr/bin/env python
"""Static program linter CLI of the PyTorch port (CI face of
paddle_tpu_torch.analysis; counterpart of tools/lint_program.py).

Drives the full pass-manager pipeline (the verifier passes plus the
PT700s dtype/shape-consistency, PT710s donation-race, PT720s dead-code
and PT90x numerics families) over serialized programs, the built-in
test_book suite, or the whole model zoo of ``paddle_tpu_torch.models``.
The JAX tool's sharding_check pass (PT730-PT744, under a dp=8 mesh) is
not in the port, which runs on one card.

Usage:
  python tools/torch_lint_program.py prog.json [prog2.json ...]
      Lint serialized programs (Program.to_json / save_inference_model's
      __model__ file).
  python tools/torch_lint_program.py --builtin
      The test_book.py programs (fit-a-line, recognize-digits MLP,
      word2vec) with backward + optimizer — main+startup of each.
  python tools/torch_lint_program.py --zoo
      --builtin plus every paddle_tpu_torch.models program (MLP, ResNet,
      BERT, DeepFM, seq2seq, GPT) linted against its full declared fetch
      surface — the ci/run_torch_gates.sh gate.
  --json PATH     machine-readable report: per-program findings,
                  allowlist hits, pass timings from the monitor registry.
  --passes a,b,c  restrict the pipeline (default: every analysis pass).
  --show-info     also print info-severity findings.

Exit status (stable, for CI):
  0  clean — no gating findings
  1  findings — error-severity diagnostics, or dead-code findings
     (PT720/PT721/PT722) not covered by the allowlist below
  2  internal error — the linter itself failed (never conflate a linter
     crash with a lint finding)
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch.analysis import (  # noqa: E402
    ALL_ANALYSIS_PASSES, Severity, default_pass_manager, format_diagnostics)

# Findings the zoo gate accepts, with the reason on record (the satellite
# contract: every dead-code finding is either fixed or allowlisted here).
# Matched on (code, op_type).
ALLOWLIST = {
    ("PT721", "accuracy"):
        "accuracy's Correct/Total outputs are reference-schema state "
        "slots; the layers.accuracy API surfaces only the Accuracy scalar",
    ("PT721", "reshape2"):
        "XShape is the grad-side shape echo the reference schema requires; "
        "inference/forward-only consumers never read it",
    ("PT721", "transpose2"):
        "XShape grad-side shape echo (see reshape2)",
    ("PT721", "squeeze2"):
        "XShape grad-side shape echo (see reshape2)",
    ("PT721", "unsqueeze2"):
        "XShape grad-side shape echo (see reshape2)",
    ("PT721", "flatten2"):
        "XShape grad-side shape echo (see reshape2)",
    ("PT721", "recurrent_grad"):
        "recurrent_grad emits an @GRAD slot for every forward input; the "
        "fill_constant_batch_size_like initial-state grad has no consumer "
        "by construction",
    ("PT721", "dropout"):
        "the Mask output is read only by dropout_grad; forward-only "
        "clones keep the slot per the reference schema",
    ("PT721", "softmax_with_cross_entropy"):
        "the Softmax output is read only by the grad op; forward-only "
        "clones keep the slot per the reference schema",
    ("PT721", "layer_norm"):
        "Mean/Variance are grad-side state slots read only by "
        "layer_norm_grad; inference-only programs (the GPT generative "
        "phases) never read them",
}

# dead-code findings gate the zoo unless allowlisted; everything else
# gates only at error severity
GATING_CODES = ("PT720", "PT721", "PT722")


def _builtin_programs():
    """(name, program, fetch_names) triples mirroring tests/test_book.py."""
    import paddle_tpu_torch.unique_name as un

    out = []
    with un.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[13], dtype="float32")
            y = fluid.layers.data("y", shape=[1], dtype="float32")
            pred = fluid.layers.fc(x, 1)
            loss = fluid.layers.mean(
                fluid.layers.square_error_cost(pred, y))
            fluid.optimizer.SGD(learning_rate=0.02).minimize(loss)
        out.append(("fit_a_line/main", main, [loss.name]))
        out.append(("fit_a_line/startup", startup, []))

    with un.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            img = fluid.layers.data("img", shape=[784], dtype="float32")
            label = fluid.layers.data("label", shape=[1], dtype="int64")
            h = fluid.layers.fc(img, 64, act="relu")
            logits = fluid.layers.fc(h, 10)
            loss = fluid.layers.mean(
                fluid.layers.softmax_with_cross_entropy(logits, label))
            acc = fluid.layers.accuracy(logits, label)
            test_prog = main.clone(for_test=True)
            fluid.optimizer.Adam(learning_rate=2e-3).minimize(loss)
        out.append(("recognize_digits/main", main, [loss.name, acc.name]))
        out.append(("recognize_digits/startup", startup, []))
        # the eval clone's full fetch surface includes the (un-optimized)
        # loss — fetching only acc would misreport the loss chain as dead
        out.append(("recognize_digits/test_clone", test_prog,
                    [loss.name, acc.name, logits.name]))

    with un.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            w1 = fluid.layers.data("w1", shape=[1], dtype="int64")
            w2 = fluid.layers.data("w2", shape=[1], dtype="int64")
            nxt = fluid.layers.data("next", shape=[1], dtype="int64")
            embs = [fluid.layers.embedding(
                w, size=[1000, 32],
                param_attr=fluid.ParamAttr(name="shared_emb"))
                for w in (w1, w2)]
            concat = fluid.layers.concat(embs, axis=1)
            hidden = fluid.layers.fc(concat, 64, act="sigmoid")
            logits = fluid.layers.fc(hidden, 1000)
            loss = fluid.layers.mean(
                fluid.layers.softmax_with_cross_entropy(logits, nxt))
            fluid.optimizer.Adam(learning_rate=5e-3).minimize(loss)
        out.append(("word2vec/main", main, [loss.name]))
        out.append(("word2vec/startup", startup, []))
    return out


def _zoo_programs():
    """The paddle_tpu_torch.models programs, each against its full declared
    fetch surface (loss + metrics/predictions) — fetching less would
    misreport the metric heads as dead code."""
    import paddle_tpu_torch.unique_name as un
    from paddle_tpu_torch.models import (BertConfig, build_bert_pretrain,
                                   build_deepfm, build_mnist_mlp,
                                   build_resnet, build_seq2seq_train)

    out = []
    with un.guard():
        m = build_mnist_mlp()
        out.append(("zoo/mnist_mlp/main", m["main"],
                    [m["loss"].name, m["acc"].name]))
        out.append(("zoo/mnist_mlp/startup", m["startup"], []))
    with un.guard():
        m = build_resnet(depth=18, class_num=10, image_shape=(3, 32, 32))
        out.append(("zoo/resnet18/main", m["main"],
                    [m["loss"].name, m["acc"].name]))
        out.append(("zoo/resnet18/startup", m["startup"], []))
    with un.guard():
        m = build_bert_pretrain(BertConfig.tiny(), seq_len=32)
        out.append(("zoo/bert_tiny/main", m["main"],
                    [m["loss"].name, m["mlm_loss"].name,
                     m["nsp_loss"].name]))
        out.append(("zoo/bert_tiny/startup", m["startup"], []))
    with un.guard():
        m = build_deepfm()
        out.append(("zoo/deepfm/main", m["main"],
                    [m["loss"].name, m["pred"].name]))
        out.append(("zoo/deepfm/startup", m["startup"], []))
    with un.guard():
        m = build_seq2seq_train(src_vocab=50, tgt_vocab=50)
        out.append(("zoo/seq2seq/main", m["main"], [m["loss"].name]))
        out.append(("zoo/seq2seq/startup", m["startup"], []))
    with un.guard():
        from paddle_tpu_torch.models import GptConfig, build_gpt_generative

        # both generative phases, incl. the PT710s donation-race pass
        # over the donated KV caches
        m = build_gpt_generative(GptConfig.tiny(), batch_slots=2,
                                 max_seq=32, page_size=8,
                                 prompt_buckets=(16,))
        pf = m["prefill"][16]
        out.append(("zoo/gpt_tiny/prefill", pf["main"],
                    [pf["first_token"].name]))
        out.append(("zoo/gpt_tiny/decode", m["decode"]["main"],
                    [m["decode"]["next_token"].name]))
        out.append(("zoo/gpt_tiny/startup", m["startup"], []))
    return out


def _allowlisted(d) -> str:
    """The allowlist reason covering diagnostic ``d``, or ''."""
    return ALLOWLIST.get((d.code, d.op_type or ""), "")


def _lint(name, program, fetch_names, passes, show_info: bool,
          report: dict, gate_dead_code: bool = True) -> bool:
    mgr = default_pass_manager()
    result = mgr.run_pipeline(program, passes, fetch_names=fetch_names,
                              verify="none")
    diags = result.diagnostics
    errors = [d for d in diags if d.severity == Severity.ERROR]
    gating = list(errors)
    allow_hits = []
    for d in diags:
        if (gate_dead_code and d.code in GATING_CODES
                and d.severity != Severity.ERROR):
            reason = _allowlisted(d)
            if reason:
                allow_hits.append((d, reason))
            else:
                gating.append(d)
    n_ops = sum(len(b.ops) for b in program.blocks)
    n_warn = sum(d.severity == Severity.WARNING for d in diags)
    n_info = sum(d.severity == Severity.INFO for d in diags)
    status = "FAIL" if gating else "ok"
    print(f"[{status}] {name}: {n_ops} ops, {len(errors)} error(s), "
          f"{n_warn} warning(s), {n_info} info(s), "
          f"{len(allow_hits)} allowlisted")
    shown = [d for d in diags
             if show_info or d.severity != Severity.INFO or d in gating]
    if shown:
        print(format_diagnostics(shown))
    report["programs"].append({
        "name": name,
        "ops": n_ops,
        "status": status.lower() if status == "FAIL" else "ok",
        "errors": len(errors),
        "warnings": n_warn,
        "infos": n_info,
        "gating": [_diag_dict(d) for d in gating],
        "allowlisted": [dict(_diag_dict(d), reason=r)
                        for d, r in allow_hits],
        "findings": [_diag_dict(d) for d in diags],
    })
    return not gating


def _diag_dict(d) -> dict:
    return {"code": d.code, "severity": d.severity, "message": d.message,
            "block": d.block_idx, "op": d.op_idx, "op_type": d.op_type,
            "site": d.site}


def _pass_timings() -> dict:
    """Per-pass run counts and wall time from the monitor registry."""
    from paddle_tpu_torch import monitor

    snap = monitor.get_registry().to_dict()
    out = {}
    for metric in ("pass_runs_total", "pass_duration_seconds"):
        fam = snap.get(metric)
        if fam:
            out[metric] = fam["values"]
    return out


def run(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("programs", nargs="*",
                    help="serialized Program JSON files")
    ap.add_argument("--builtin", action="store_true",
                    help="lint the built-in test_book model suite")
    ap.add_argument("--zoo", action="store_true",
                    help="lint --builtin plus every paddle_tpu_torch.models "
                         "program (the CI gate)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the machine-readable report here")
    ap.add_argument("--passes", default=None,
                    help="comma-separated pass names (default: the full "
                         "analysis pipeline)")
    ap.add_argument("--show-info", action="store_true",
                    help="also print info-severity findings")
    args = ap.parse_args(argv)
    if not args.builtin and not args.zoo and not args.programs:
        ap.error("pass program JSON files, --builtin or --zoo")

    passes = tuple(p.strip() for p in args.passes.split(",")
                   if p.strip()) if args.passes else ALL_ANALYSIS_PASSES
    report = {"passes": list(passes), "programs": [],
              "allowlist": [{"code": c, "op_type": t, "reason": r}
                            for (c, t), r in sorted(ALLOWLIST.items())]}
    ok = True
    suites = []
    if args.builtin or args.zoo:
        suites.append(_builtin_programs())
    if args.zoo:
        suites.append(_zoo_programs())
    for suite in suites:
        for name, prog, fetches in suite:
            ok = _lint(name, prog, fetches, passes, args.show_info,
                       report) and ok
    for path in args.programs:
        try:
            with open(path, "r", encoding="utf-8") as f:
                prog = fluid.Program.from_json(f.read())
        except Exception as e:  # malformed beyond parsing: still a lint fail
            print(f"[FAIL] {path}: cannot load program: "
                  f"{type(e).__name__}: {e}")
            report["programs"].append({"name": path, "status": "fail",
                                       "load_error": str(e)})
            ok = False
            continue
        # file inputs carry no fetch surface: a dead-code verdict would be
        # guesswork, so files gate on error severity only
        ok = _lint(path, prog, [], passes, args.show_info, report,
                   gate_dead_code=False) and ok

    report["status"] = "ok" if ok else "fail"
    report["pass_timings"] = _pass_timings()
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        print(f"report -> {args.json}")
    return 0 if ok else 1


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
