#!/usr/bin/env python
"""Rank script of ``chip_smoke.py``'s ``model_parallel`` phase: tensor
parallel BERT-base and ring attention over the launched ranks.

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        --selected_gpus 0,0 tools/torch_mp_worker.py --out DIR \\
        --legs tp,tp_control,ring [--seed N]
    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 4 \\
        --selected_gpus 0,0,0,0 tools/torch_mp_worker.py --out DIR \\
        --legs dptp,dptp_badseed [--seed N]

Legs, in the order given (BERT-base f32, batch 32 x seq 128, Adam 1e-4,
from the startup's weights, which every rank makes whole and the parallel
step cuts to its shards):

* ``tp`` — ``{"tp": 2}`` with ``transformer_tp_rules``, dropout 0, 4
  steps through ``parallel.sharding.compile_sharded_step``: per step the
  loss, the step ms, the collectives' calls and bytes by kind and the
  K1/K3/K4 launches; step 1 fetches every parameter gradient (gathered
  from the shards) and step 4 every parameter. Rank 0 writes them to
  ``DIR/grads_tp.pt`` and ``DIR/params_tp.pt``. Also this rank's
  parameter + moment bytes.
* ``tp_control`` — a negative control: step 1 again with the plan's first
  row-parallel all-reduce dropped; its loss.
* ``ring`` — ``{"sp": 2}``: the Fluid-API program of
  ``__graft_entry__._dryrun_ring_attention_fluid_api`` at GPT-2 small's
  attention widths (B 8, H 12, S 1024, D 64, causal), SGD 0.1, 3 steps;
  step 1 fetches the loss, ``wq@GRAD`` and the attention output (rank 0
  writes them to ``DIR/ring.pt``); per step the launches and ms.
* ``dptp`` — ``{"dp": 2, "tp": 2}`` at ``DPTP_LAYERS`` layers, dropout
  0.1, ZeRO-1,
  ``FLAGS_replica_check_interval=1`` (policy raise), 4 steps: the losses,
  and digests of the replicated parameters and of this rank's shards.
* ``dptp_badseed`` — a negative control: the same with the whole rank
  folded into the step seed; the ``ReplicaDivergenceError`` it raises.
* ``pp`` — ``{"pp": 2}``: BERT-base's encoder widths as a
  ``PipelineRegion`` (``build_pipeline_encoder``: 12 blocks, 2 stages of
  6, ``PP_MICRO`` microbatches) with the embeddings and a classification
  head outside it, batch 32 x seq 128, f32, dropout 0, Adam 1e-4, 4
  steps: per step the loss, ms, the collectives by kind and the K1/K3/K4
  launches; step 1 fetches every stacked gradient and step 4 every
  parameter (gathered from the stage slices; rank 0 writes them to
  ``DIR/grads_pp.pt`` and ``DIR/params_pp.pt``); this rank's stacked
  parameter + moment bytes and its peak.
* ``dppp`` — ``{"dp": 2, "pp": 2}`` at ``DPPP_LAYERS`` blocks, dropout
  0.1, ZeRO-1, ``FLAGS_replica_check_interval=1`` (policy raise), 4
  steps: the losses and digests of the replicated parameters and of this
  rank's stage slices.
* ``dppp_nobcast`` — a negative control: the same with the input's
  cotangent left on stage 0 (no broadcast over ``pp``); the
  ``ReplicaDivergenceError`` it raises.

Each rank writes what it measured to ``DIR/rank<r>.<tag>.json``.
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
from paddle_tpu_torch.parallel import sharding as sh  # noqa: E402

SEQ, BATCH, STEPS = 128, 32, 4
# the dp x tp leg checks the replicas' bytes: BERT-base's widths at 4 of
# its 12 layers (the whole chip_smoke.py run keeps inside its time limit)
DPTP_LAYERS = 4
RING = dict(B=8, H=12, S=1024, D=64, steps=3, lr=0.1)
ATTENTION = ("flash_attention_fwd", "flash_attention_dq",
             "flash_attention_dkv")
# the pipeline legs: BERT-base's encoder widths in two stages, four
# microbatches (8 rows each on {"pp": 2}: K1/K3/K4 at [8 * 12, 128, 64])
PP_STAGES, PP_MICRO, PP_LAYERS, DPPP_LAYERS = 2, 4, 12, 4


def config(dropout=0.0, layers=12):
    return dataclasses.replace(BertConfig.base(), num_layers=layers,
                               hidden_dropout=dropout,
                               attention_dropout=dropout)


def build(seed, place, dropout=0.0, layers=12):
    """The static program and the startup's weights (names from a fresh
    generator, so every process agrees)."""
    with fluid.unique_name.guard():
        net = build_bert_pretrain(config(dropout, layers), seq_len=SEQ)
    net["startup"].random_seed = seed
    scope = fluid.Scope()
    fluid.Executor(place).run(net["startup"], scope=scope)
    return net, dict(scope.vars)


def build_ring(seq_par):
    """fc -> fused_multihead_attention(causal) -> square error -> SGD."""
    B, H, S, D = (RING[k] for k in "BHSD")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        xv = fluid.layers.data("x", shape=[H, S, D], dtype="float32")
        yv = fluid.layers.data("y", shape=[H, S, D], dtype="float32")
        q = fluid.layers.fc(xv, D, num_flatten_dims=3,
                            param_attr=fluid.ParamAttr(name="wq"),
                            bias_attr=False)
        o = fluid.layers.fused_multihead_attention(
            q, xv, xv, causal=True, sequence_parallel=seq_par)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(o, yv))
        fluid.optimizer.SGD(learning_rate=RING["lr"]).minimize(loss)
    return main, startup, loss, o


def build_pipeline_encoder(fluid, hidden, heads, ffn, layers, stages,
                           microbatches, seq, vocab, dropout=0.0,
                           classes=2, lr=1e-4):
    """BERT's encoder blocks (``models/bert.py``'s ``_encoder_layer``:
    attention through ``fused_multihead_attention``, post-residual
    ``layer_norm``, a gelu FFN) as a ``layers.PipelineRegion`` of
    ``stages`` stages of ``layers // stages`` blocks, every weight an
    ``s.param`` (``layer_norm(scale=False, shift=False)`` times a stacked
    gamma plus a stacked beta); the word and position embeddings and
    their ``layer_norm`` before the region, a mean-pooled classification
    head after it, softmax cross-entropy, Adam. ``fluid`` is either
    package. Feeds ``src_ids``/``pos_ids`` int64 ``[B, seq]``, ``label``
    int64 ``[B, 1]``."""
    nh, hd = heads, hidden // heads
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = L.data("src_ids", shape=[seq], dtype="int64")
        pos = L.data("pos_ids", shape=[seq], dtype="int64")
        label = L.data("label", shape=[1], dtype="int64")
        x = L.elementwise_add(
            L.embedding(ids, size=[vocab, hidden],
                        param_attr=fluid.ParamAttr(name="word_embedding")),
            L.embedding(pos, size=[seq, hidden],
                        param_attr=fluid.ParamAttr(name="pos_embedding")))
        x = L.layer_norm(x, begin_norm_axis=2)
        pipe = L.PipelineRegion(num_stages=stages,
                                num_microbatches=microbatches)
        one = fluid.initializer.Constant(1.0)
        with pipe.stage(x) as s:
            h = s.input

            def dense(t, name, n_in, n_out):
                w = s.param(f"{name}_w", [n_in, n_out])
                b = s.param(f"{name}_b", [n_out], is_bias=True)
                return L.elementwise_add(L.matmul(t, w), b)

            def norm(t, name):
                t = L.layer_norm(t, scale=False, shift=False,
                                 begin_norm_axis=2)
                g = s.param(f"{name}_gamma", [hidden], initializer=one)
                b = s.param(f"{name}_beta", [hidden], is_bias=True)
                return L.elementwise_add(L.elementwise_mul(t, g), b)

            def drop(t):
                return L.dropout(t, dropout,
                                 dropout_implementation="upscale_in_train")

            def heads_of(t):
                return L.transpose(L.reshape(t, [0, seq, nh, hd]),
                                   [0, 2, 1, 3])

            for i in range(layers // stages):
                q, k, v = (heads_of(dense(h, f"l{i}_{n}", hidden, hidden))
                           for n in ("q", "k", "v"))
                a = L.fused_multihead_attention(q, k, v,
                                                attn_dropout=dropout)
                a = L.reshape(L.transpose(a, [0, 2, 1, 3]), [0, seq, hidden])
                a = drop(dense(a, f"l{i}_out", hidden, hidden))
                h = norm(L.elementwise_add(h, a), f"l{i}_att_ln")
                f = L.gelu(dense(h, f"l{i}_ffn1", hidden, ffn))
                f = drop(dense(f, f"l{i}_ffn2", ffn, hidden))
                h = norm(L.elementwise_add(h, f), f"l{i}_ffn_ln")
            s.set_output(h)
        pooled = L.reduce_mean(pipe.output, dim=[1])
        logits = L.fc(pooled, classes, param_attr=fluid.ParamAttr(
            name="cls_w"), bias_attr=fluid.ParamAttr(name="cls_b"))
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss


def pipeline_feed(seed, batch, seq, vocab, classes=2):
    rng = np.random.RandomState(seed)
    return {"src_ids": rng.randint(0, vocab, (batch, seq)).astype(np.int64),
            "pos_ids": np.tile(np.arange(seq), (batch, 1)).astype(np.int64),
            "label": rng.randint(0, classes, (batch, 1)).astype(np.int64)}


def pipeline_net(seed, place, layers, dropout=0.0):
    """``build_pipeline_encoder`` at BERT-base's widths and its startup's
    state."""
    cfg = BertConfig.base()
    main, startup, loss = build_pipeline_encoder(
        fluid, cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
        layers, PP_STAGES, PP_MICRO, SEQ, cfg.vocab_size, dropout=dropout)
    startup.random_seed = seed
    scope = fluid.Scope()
    fluid.Executor(place).run(startup, scope=scope)
    return main, loss, dict(scope.vars)


def stage_stacked(init):
    """The names of the vars stacked over the stages (the parameters and
    their same-height optimizer state; a beta power stays whole)."""
    return sorted(n for n, v in init.items() if ".pp_stacked" in n
                  and "@" not in n and v.dim() and v.shape[0] == PP_STAGES)


def stacked_bytes(values, names):
    return sum(values[n].nelement() * values[n].element_size()
               for n in names)


def ring_feed(seed):
    B, H, S, D = (RING[k] for k in "BHSD")
    rng = np.random.RandomState(seed)
    return {"x": (rng.randn(B, H, S, D) * 0.3).astype(np.float32),
            "y": (rng.randn(B, H, S, D) * 0.3).astype(np.float32)}


def global_feed(seed, batch):
    import chip_smoke as cs

    return cs.bert_feed(seed, config().vocab_size, batch, SEQ)


def digest(values, names):
    h = hashlib.sha256()
    for n in sorted(names):
        h.update(values[n].detach().cpu().numpy().tobytes())
    return h.hexdigest()


class Rank:
    def __init__(self, args):
        self.env = dist.init_parallel_env()
        self.rank, self.world = self.env.rank, self.env.world_size
        self.place = self.env.place()
        self.out, self.seed = args.out, args.seed
        self.res = {"rank": self.rank, "world": self.world,
                    "backend": dist.backend_name(),
                    "card": torch.cuda.current_device()}

    def bert_step(self, mesh, dropout=0.0, zero=False, layers=12):
        """A scope with the startup's weights, the compiled step over
        ``mesh`` and this rank's rows of the global batch."""
        net, init = build(self.seed, self.place, dropout, layers)
        names = [p.name for p in net["main"].all_parameters()]
        grads = [n + "@GRAD" for n in names
                 if n + "@GRAD" in net["main"].global_block.vars]
        run, io = sh.compile_sharded_step(
            net["main"], mesh, net["feeds"], [net["loss"].name] + grads,
            sh.transformer_tp_rules())
        if zero:
            io["compiled"]._build_strategy.reduce_strategy = \
                fluid.BuildStrategy.ReduceStrategy.Reduce
        scope = fluid.Scope()
        for n, t in init.items():
            scope.set_var(n, t.clone())
        dp, c = mesh.shape.get("dp", 1), mesh.coord("dp")
        feed = global_feed(self.seed, BATCH)
        k = BATCH // dp
        feed = {n: v[c * k:(c + 1) * k] for n, v in feed.items()}
        return dict(net=net, names=names, grads=grads, run=run,
                    compiled=io["compiled"], scope=scope, feed=feed,
                    exe=fluid.Executor(self.place))

    def steps(self, s, n, grads=None, params=None):
        """``n`` steps; per step the loss, ms, collectives by kind and the
        attention launches. ``grads``/``params``: dicts that take step
        1's gradients / the last step's parameters (host, by name)."""
        losses, rows = [], []
        for i in range(n):
            K.reset_launch_counts()
            dist.reset_collective_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fetch = [s["net"]["loss"].name]
            if grads is not None and i == 0:
                fetch += s["grads"]
            if params is not None and i == n - 1:
                fetch += s["names"]
            out = s["exe"].run(s["compiled"], feed=s["feed"],
                               fetch_list=fetch, scope=s["scope"],
                               return_numpy=False)
            ms = (time.perf_counter() - t0) * 1e3
            host = dict(zip(fetch[1:], (t.detach().cpu() for t in out[1:])))
            if grads is not None and i == 0:
                grads.update((g, host[g]) for g in s["grads"])
            if params is not None and i == n - 1:
                params.update((p, host[p]) for p in s["names"])
            losses.append(float(out[0].detach().cpu().reshape(-1)[0]))
            st = dist.collective_stats()
            launches = K.launch_counts()
            rows.append({"ms": ms, "collective_bytes": st["bytes"],
                         "collective_calls": st["calls"],
                         "by_kind": st["by_kind"],
                         "launches": {a: launches[a] for a in ATTENTION}})
        return losses, rows

    def state_bytes(self, s):
        names = set(s["names"])
        return sum(v.nelement() * v.element_size()
                   for n, v in s["scope"].vars.items()
                   if isinstance(v, torch.Tensor) and (
                       n in names or n.startswith(("moment1_",
                                                   "moment2_"))))

    # -- legs ------------------------------------------------------------
    def tp(self):
        s = self.bert_step(sh.Mesh({"tp": self.world}))
        whole = self.state_bytes(s)
        torch.cuda.reset_peak_memory_stats()
        grads, params = {}, {}
        losses, rows = self.steps(s, STEPS, grads, params)
        self.res["tp"] = {"losses": losses, "steps": rows,
                          "state_bytes": self.state_bytes(s),
                          "whole_state_bytes": whole,
                          "peak_bytes": torch.cuda.max_memory_allocated(),
                          "digest": digest(params, params)}
        if self.rank == 0:
            torch.save(grads, os.path.join(self.out, "grads_tp.pt"))
            torch.save(params, os.path.join(self.out, "params_tp.pt"))

    def tp_control(self):
        from paddle_tpu_torch.parallel import compiled_program as cp

        init = cp._DPPlan.__init__

        def dropped(plan, program, *a, **kw):
            init(plan, program, *a, **kw)
            ops = program.global_block.ops
            del plan.partial[min(i for i in plan.partial
                                 if ops[i].type == "mul")]

        cp._DPPlan.__init__ = dropped
        try:
            s = self.bert_step(sh.Mesh({"tp": self.world}))
            losses, _ = self.steps(s, 1)
        finally:
            cp._DPPlan.__init__ = init
        self.res["tp_control"] = {"losses": losses}

    def ring(self):
        main, startup, loss, o = build_ring(True)
        exe, scope = fluid.Executor(self.place), fluid.Scope()
        exe.run(startup, scope=scope)
        D = RING["D"]
        scope.set_var("wq", torch.eye(D, device=self.place.torch_device()))
        prog = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, places=sh.Mesh({"sp": self.world}))
        feed = ring_feed(self.seed)
        losses, rows = [], []
        for i in range(RING["steps"]):
            K.reset_launch_counts()
            dist.reset_collective_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fetch = [loss.name] + (["wq@GRAD", o.name] if i == 0 else [])
            out = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope,
                          return_numpy=False)
            ms = (time.perf_counter() - t0) * 1e3
            losses.append(float(out[0].detach().cpu().reshape(-1)[0]))
            if i == 0 and self.rank == 0:
                torch.save({"wq_grad": out[1].detach().cpu(),
                            "out": out[2].detach().cpu()},
                           os.path.join(self.out, "ring.pt"))
            st = dist.collective_stats()
            launches = K.launch_counts()
            rows.append({"ms": ms, "collective_bytes": st["bytes"],
                         "by_kind": st["by_kind"],
                         "launches": {a: launches[a] for a in ATTENTION}})
        self.res["ring"] = {"losses": losses, "steps": rows}

    def dptp(self):
        mesh = sh.Mesh({"dp": 2, "tp": self.world // 2})
        s = self.bert_step(mesh, dropout=0.1, zero=True,
                           layers=DPTP_LAYERS)
        fluid.set_flags({"FLAGS_replica_check_interval": 1,
                         "FLAGS_replica_divergence_policy": "raise"})
        try:
            losses, rows = self.steps(s, STEPS)
        finally:
            fluid.set_flags({"FLAGS_replica_check_interval": 0})
        shards = getattr(s["scope"], "_mesh_shards", {})
        scope = s["scope"]
        replicated = [n for n in s["names"] if n not in shards]
        sharded = [n for n in s["names"] if n in shards]
        self.res["dptp"] = {
            "losses": losses, "steps": rows,
            "coords": mesh.coords(self.rank),
            "replicated_digest": digest(scope.vars, replicated),
            "shard_digest": digest(scope.vars, sharded),
            "sharded": len(sharded),
            "zero_sharded": len(getattr(scope, "_dp_shards", {}))}

    def dptp_badseed(self):
        from paddle_tpu_torch.parallel import compiled_program as cp
        from paddle_tpu_torch.resilience import ReplicaDivergenceError

        fold = cp._DPPlan.fold_seed
        cp._DPPlan.fold_seed = \
            lambda plan, seed: (seed + plan.rank * 0x9E3779B1) & 0x7FFFFFFF
        mesh = sh.Mesh({"dp": 2, "tp": self.world // 2})
        named, count = None, 0
        fluid.set_flags({"FLAGS_replica_check_interval": 1,
                         "FLAGS_replica_divergence_policy": "raise"})
        try:
            s = self.bert_step(mesh, dropout=0.1, zero=True,
                               layers=DPTP_LAYERS)
            self.steps(s, 1)
        except ReplicaDivergenceError as e:
            named = e.param
            count = len(getattr(e, "diverged", []) or [])
        finally:
            cp._DPPlan.fold_seed = fold
            fluid.set_flags({"FLAGS_replica_check_interval": 0})
        self.res["dptp_badseed"] = {"named": named, "count": count}

    def pp_steps(self, loss, scope, prog, feed, n, first=(), last=()):
        """``n`` steps of ``prog``: per step the loss, ms, the collectives by
        kind and the attention launches; step 1 also fetches ``first``, step
        ``n`` ``last`` (host tensors, by name)."""
        exe = fluid.Executor(self.place)
        losses, rows, got = [], [], {}
        for i in range(n):
            K.reset_launch_counts()
            dist.reset_collective_stats()
            fetch = [loss.name] + (list(first) if i == 0 else []) + (
                list(last) if i == n - 1 else [])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope,
                          return_numpy=False)
            ms = (time.perf_counter() - t0) * 1e3
            got.update((f, t.detach().cpu()) for f, t in zip(fetch[1:],
                                                             out[1:]))
            losses.append(float(out[0].detach().cpu().reshape(-1)[0]))
            st = dist.collective_stats()
            launches = K.launch_counts()
            rows.append({"ms": ms, "collective_bytes": st["bytes"],
                         "by_kind": st["by_kind"],
                         "launches": {a: launches[a] for a in ATTENTION}})
        return losses, rows, got

    def pp(self):
        main, loss, init = pipeline_net(self.seed, self.place, PP_LAYERS)
        scope = fluid.Scope()
        for n, t in init.items():
            scope.set_var(n, t.clone())
        prog = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, places=sh.Mesh({"pp": self.world}))
        names = [p.name for p in main.all_parameters()]
        grads = [n + "@GRAD" for n in names if n.endswith(".pp_stacked")]
        feed = pipeline_feed(self.seed, BATCH, SEQ,
                             BertConfig.base().vocab_size)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, rows, got = self.pp_steps(loss, scope, prog, feed, STEPS,
                                          grads, names)
        held = stage_stacked(init)
        self.res["pp"] = {"losses": losses, "steps": rows,
                          "stacked_bytes": stacked_bytes(scope.vars, held),
                          "whole_stacked_bytes": stacked_bytes(init, held),
                          "peak_bytes": torch.cuda.max_memory_allocated(),
                          "digest": digest(got, names)}
        if self.rank == 0:
            torch.save({g: got[g] for g in grads},
                       os.path.join(self.out, "grads_pp.pt"))
            torch.save({n: got[n] for n in names},
                       os.path.join(self.out, "params_pp.pt"))

    def dppp_leg(self, tag):
        from paddle_tpu_torch.resilience import ReplicaDivergenceError

        main, loss, init = pipeline_net(self.seed, self.place, DPPP_LAYERS,
                                        dropout=0.1)
        scope = fluid.Scope()
        for n, t in init.items():
            scope.set_var(n, t.clone())
        mesh = sh.Mesh({"dp": 2, "pp": self.world // 2})
        bs = fluid.BuildStrategy()
        bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
        prog = fluid.CompiledProgram(main, bs).with_data_parallel(
            loss_name=loss.name, places=mesh)
        k, c = BATCH // 2, mesh.coord("dp")
        feed = {n: v[c * k:(c + 1) * k] for n, v in pipeline_feed(
            self.seed, BATCH, SEQ, BertConfig.base().vocab_size).items()}
        names = [p.name for p in main.all_parameters()]
        fluid.set_flags({"FLAGS_replica_check_interval": 1,
                         "FLAGS_replica_divergence_policy": "raise"})
        named, losses, rows = None, [], []
        try:
            losses, rows, _ = self.pp_steps(loss, scope, prog, feed, STEPS)
        except ReplicaDivergenceError as e:
            named = e.param
        finally:
            fluid.set_flags({"FLAGS_replica_check_interval": 0})
        stacked = [n for n in names if n.endswith(".pp_stacked")]
        replicated = [n for n in names if n not in stacked]
        self.res[tag] = {
            "losses": losses, "steps": rows, "named": named,
            "coords": mesh.coords(self.rank),
            "replicated_digest": digest(scope.vars, replicated),
            "stage_digest": digest(scope.vars, stacked),
            "zero_sharded": len(getattr(scope, "_dp_shards", {}))}

    def dppp(self):
        self.dppp_leg("dppp")

    def dppp_nobcast(self):
        from paddle_tpu_torch.parallel import pipeline as pl

        keep = pl._replicate_input_grad
        pl._replicate_input_grad = \
            lambda buf, mine, group: buf if mine else torch.zeros_like(buf)
        try:
            self.dppp_leg("dppp_nobcast")
        finally:
            pl._replicate_input_grad = keep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--legs", required=True)
    ap.add_argument("--seed", type=int, default=0)
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
