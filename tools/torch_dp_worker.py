#!/usr/bin/env python
"""Rank script of ``chip_smoke.py``'s ``data_parallel`` phase: BERT-base
f32 pretraining (seq 128, dropout 0, Adam 1e-4) data parallel over the
launched ranks, each on its slice of a global batch.

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        --selected_gpus 0,0 tools/torch_dp_worker.py --out DIR \\
        --legs allreduce,repeat,zero1,dygraph [--seed N] [--batch 32]

Legs, in the order given:

* ``allreduce`` — 4 steps of ``CompiledProgram.with_data_parallel`` from
  the startup's weights; per step the loss, the step ms, the
  collectives' ms and bytes and the K1/K3/K4 launches; step 1 also
  fetches every parameter gradient; then one more step under
  ``torch.profiler`` (device busy and idle share). Rank 0 writes the
  step-1 gradients to ``DIR/grads_allreduce.pt`` and the parameters after
  step 4 to ``DIR/params_allreduce.pt``.
* ``unscaled`` — a negative control: step 1 again with the plan's
  1/ranks scale of the mean's gradient dropped (a wrong gradient scale,
  which Adam's update would hide); rank 0 writes its gradients to
  ``DIR/grads_unscaled.pt``.
* ``repeat`` — the same 4 steps again from a fresh scope.
* ``zero1`` — the same under ``ReduceStrategy.Reduce``, a sharded
  checkpoint written to ``DIR/ckpt`` after step 2; the Adam moments'
  bytes on this rank and its peak memory.
* ``dygraph`` — 3 steps of dygraph BERT-base under ``DataParallel``; rank
  0 writes the averaged step-1 gradients to ``DIR/dy_grads.pt``.
* ``resume`` — fresh ranks: restore ``DIR/ckpt`` and run steps 3-4 under
  ZeRO-1.
* ``divergence`` — ``FLAGS_replica_check_interval=1``, policy raise: one
  clean step, then rank 1 perturbs one parameter; the next step must
  raise ``ReplicaDivergenceError`` naming it.

Each rank writes what it measured to ``DIR/rank<r>.<tag>.json``. A digest
is the sha256 of the parameters' bytes in name order.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch import distributed as dist  # noqa: E402
from paddle_tpu_torch import kernels as K  # noqa: E402
from paddle_tpu_torch.models.bert import (BertConfig,  # noqa: E402
                                          build_bert_pretrain)

SEQ, STEPS, DY_STEPS, SAVE_AFTER = 128, 4, 3, 2
ATTENTION = ("flash_attention_fwd", "flash_attention_dq",
             "flash_attention_dkv")
PERTURBED = "layer0_att_q_w"


def config():
    return dataclasses.replace(BertConfig.base(), hidden_dropout=0.0,
                               attention_dropout=0.0)


def build(seed, place):
    """The static program and the startup's weights (names from a fresh
    generator, so every process agrees)."""
    with fluid.unique_name.guard():
        net = build_bert_pretrain(config(), seq_len=SEQ)
    net["startup"].random_seed = seed
    scope = fluid.Scope()
    fluid.Executor(place).run(net["startup"], scope=scope)
    return net, dict(scope.vars)


def global_feed(seed, batch):
    import chip_smoke as cs

    return cs.bert_feed(seed, config().vocab_size, batch, SEQ)


def digest(scope, names):
    h = hashlib.sha256()
    for n in sorted(names):
        h.update(scope.find_var(n).detach().cpu().numpy().tobytes())
    return h.hexdigest()


def params_of(net):
    return [p.name for p in net["main"].all_parameters()]


def grads_of(net):
    """The trainable parameters' gradient names."""
    blk = net["main"].global_block
    return [n + "@GRAD" for n in params_of(net) if n + "@GRAD" in blk.vars]


class Rank:
    def __init__(self, args):
        self.env = dist.init_parallel_env()
        self.rank, self.world = self.env.rank, self.env.world_size
        self.place = self.env.place()
        self.out, self.seed = args.out, args.seed
        self.net, self.init = build(args.seed, self.place)
        feed = global_feed(args.seed, args.batch)
        k = args.batch // self.world
        sl = slice(self.rank * k, (self.rank + 1) * k)
        self.feed = {n: v[sl] for n, v in feed.items()}
        self.res = {"rank": self.rank, "world": self.world,
                    "backend": dist.backend_name(),
                    "card": torch.cuda.current_device(),
                    "masked": int((self.feed["mask_label"] != -100).sum()),
                    "init_digest": digest_dict(self.init,
                                               params_of(self.net))}

    def compiled(self, zero):
        bs = fluid.BuildStrategy()
        if zero:
            bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
        return fluid.CompiledProgram(self.net["main"]).with_data_parallel(
            loss_name=self.net["loss"].name, build_strategy=bs)

    def fresh(self):
        scope = fluid.Scope()
        for n, t in self.init.items():
            scope.set_var(n, t.clone())
        return fluid.Executor(self.place), scope

    def steps(self, exe, prog, scope, n, timed=False, grads=None):
        """``n`` steps: the losses, and with ``timed`` the step ms, the
        collectives' ms and bytes and the attention launches of each.
        ``grads``: a dict that takes step 1's parameter gradients (on the
        host, by name)."""
        losses, rows = [], []
        dist.set_collective_timing(timed)
        try:
            for _ in range(n):
                K.reset_launch_counts()
                dist.reset_collective_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                extra = grads_of(self.net) if grads is not None \
                    and not losses else []
                out = exe.run(prog, feed=self.feed,
                              fetch_list=[self.net["loss"]] + extra,
                              scope=scope, return_numpy=not extra)
                if extra:
                    grads.update((g, t.detach().cpu())
                                 for g, t in zip(extra, out[1:]))
                    out = [out[0].detach().cpu().numpy()]
                ms = (time.perf_counter() - t0) * 1e3
                losses.append(float(np.ravel(out[0])[0]))
                st = dist.collective_stats()
                launches = K.launch_counts()
                rows.append({"ms": ms, "collective_ms": st["seconds"] * 1e3,
                             "collective_bytes": st["bytes"],
                             "collective_calls": st["calls"],
                             "launches": {a: launches[a]
                                          for a in ATTENTION}})
        finally:
            dist.set_collective_timing(False)
        return losses, rows

    # -- legs ------------------------------------------------------------
    def allreduce(self):
        import chip_smoke as cs

        exe, scope = self.fresh()
        prog = self.compiled(False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        grads = {}
        losses, rows = self.steps(exe, prog, scope, STEPS, timed=True,
                                  grads=grads)
        names = params_of(self.net)
        self.res["allreduce"] = {"losses": losses, "steps": rows,
                                 "digest": digest(scope, names),
                                 "grad_digest": digest_dict(grads, grads),
                                 "peak_bytes":
                                     torch.cuda.max_memory_allocated()}
        if self.rank == 0:
            torch.save(grads, os.path.join(self.out, "grads_allreduce.pt"))
            torch.save({n: scope.find_var(n).detach().cpu() for n in names},
                       os.path.join(self.out, "params_allreduce.pt"))
        prof = cs.profile_run(lambda: exe.run(
            prog, feed=self.feed, fetch_list=[self.net["loss"]],
            scope=scope))
        self.res["allreduce"]["profiled"] = {
            k: prof[k] for k in ("wall_s", "device_busy_s", "idle_share",
                                 "device_kernels", "port_kernels")}

    def unscaled(self):
        from paddle_tpu_torch.parallel import compiled_program as cp

        init = cp._DPPlan.__init__

        def unscaled_init(plan, *a, **kw):
            init(plan, *a, **kw)
            plan.grad_scale.clear()

        cp._DPPlan.__init__ = unscaled_init
        try:
            exe, scope = self.fresh()
            grads = {}
            self.steps(exe, self.compiled(False), scope, 1, grads=grads)
        finally:
            cp._DPPlan.__init__ = init
        if self.rank == 0:
            torch.save(grads, os.path.join(self.out, "grads_unscaled.pt"))

    def repeat(self):
        exe, scope = self.fresh()
        losses, _ = self.steps(exe, self.compiled(False), scope, STEPS)
        self.res["repeat"] = {"losses": losses,
                              "digest": digest(scope, params_of(self.net))}

    def zero1(self):
        exe, scope = self.fresh()
        prog = self.compiled(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        first, rows = self.steps(exe, prog, scope, SAVE_AFTER, timed=True)
        fluid.io.save_checkpoint(exe, os.path.join(self.out, "ckpt"),
                                 self.net["main"], scope=scope,
                                 meta={"step": SAVE_AFTER},
                                 mesh={"dp": self.world})
        rest, rows2 = self.steps(exe, prog, scope, STEPS - SAVE_AFTER,
                                 timed=True)
        moments = sum(v.nelement() * v.element_size()
                      for n, v in scope.vars.items()
                      if n.startswith("moment"))
        self.res["zero1"] = {
            "losses": first + rest, "steps": rows + rows2,
            "digest": digest(scope, params_of(self.net)),
            "moment_bytes": moments,
            "sharded": len(getattr(scope, "_dp_shards", {})),
            "peak_bytes": torch.cuda.max_memory_allocated()}
        self.res.setdefault("allreduce", {})["moment_bytes"] = sum(
            t.nelement() * t.element_size() for n, t in self.init.items()
            if n.startswith("moment"))

    def resume(self):
        exe, scope = self.fresh()
        meta = fluid.io.load_checkpoint(exe, os.path.join(self.out, "ckpt"),
                                        self.net["main"], scope=scope)
        losses, _ = self.steps(exe, self.compiled(True), scope,
                               STEPS - meta["step"])
        self.res["resume"] = {"from_step": meta["step"], "losses": losses,
                              "digest": digest(scope, params_of(self.net))}

    def divergence(self):
        from paddle_tpu_torch.resilience import ReplicaDivergenceError

        exe, scope = self.fresh()
        prog = self.compiled(False)
        fluid.set_flags({"FLAGS_replica_check_interval": 1,
                         "FLAGS_replica_divergence_policy": "raise"})
        got = None
        try:
            self.steps(exe, prog, scope, 1)
            if self.rank == 1:
                scope.find_var(PERTURBED).view(-1)[7] += 1e-3
            try:
                self.steps(exe, prog, scope, 1)
            except ReplicaDivergenceError as e:
                got = e.param
        finally:
            fluid.set_flags({"FLAGS_replica_check_interval": 0})
        self.res["divergence"] = {"perturbed": PERTURBED, "named": got}

    def dygraph(self):
        from tools.torch_dygraph_bert import DygraphBert, load_static, to_feed

        with fluid.dygraph.guard(self.place, seed=self.seed):
            fluid.dygraph.prepare_context()
            model = DygraphBert(config())
            load_static(model, self.net["main"], self.init)
            dp = fluid.dygraph.DataParallel(model)
            opt = fluid.optimizer.Adam(learning_rate=1e-4)
            f = to_feed(self.feed)
            names = model.static_names(self.net["main"])
            losses, launches = [], []
            for step in range(DY_STEPS):
                K.reset_launch_counts()
                loss, _, _ = dp(f)
                losses.append(float(np.ravel(loss.numpy())[0]))
                loss.backward()
                dp.apply_collective_grads()
                launches.append({a: K.launch_counts()[a]
                                 for a in ATTENTION})
                if step == 0 and self.rank == 0:
                    torch.save({names[n]: p._grad.detach().cpu()
                                for n, p in model.named_parameters()
                                if p._grad is not None},
                               os.path.join(self.out, "dy_grads.pt"))
                opt.minimize(loss, parameter_list=dp.parameters())
                dp.clear_gradients()
            h = hashlib.sha256()
            for n, p in sorted(model.named_parameters()):
                h.update(p.value.detach().cpu().numpy().tobytes())
        self.res["dygraph"] = {"losses": losses, "launches": launches,
                               "digest": h.hexdigest()}


def digest_dict(values, names):
    h = hashlib.sha256()
    for n in sorted(names):
        h.update(values[n].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--legs", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=32,
                    help="the global batch (each rank feeds batch/world)")
    ap.add_argument("--tag", default="run",
                    help="names this launch's reports: DIR/rank<r>.<tag>.json")
    args = ap.parse_args(argv)
    # the settings chip_smoke.py's device phase makes: no TF32, no bf16
    # partial sums in cuBLAS's split-k reductions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    r = Rank(args)
    for leg in args.legs.split(","):
        t0 = time.perf_counter()
        getattr(r, leg)()
        r.res.setdefault("seconds", {})[leg] = time.perf_counter() - t0
    with open(os.path.join(args.out, f"rank{r.rank}.{args.tag}.json"),
              "w") as f:
        json.dump(r.res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
