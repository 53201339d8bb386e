"""Device selection and the full-width probes shared by the port's gate
tools (``tools/torch_{remat_check,metrics_report,trace_check,
chaos_check,option_sweep}.py``).

Every tool runs on ``CUDAPlace(0)`` unless ``--device cpu`` asks for the
CPU (the CPU tests do); a missing card is an error, never a fall-back.
The probes here are the card legs' models at their published widths:
BERT-base (12 layers, hidden 768) f32 training and bf16 fused inference
at batch 8 x seq 128, and ResNet-50 bf16 inference. ``tiny=True`` gives
the same programs at BERT-tiny / ResNet-18 widths for a CPU rehearsal.
"""
from __future__ import annotations

import numpy as np

import paddle_tpu_torch as fluid
import paddle_tpu_torch.unique_name as un

# where the tools run: "cuda" (CUDAPlace(0)) unless --device cpu
_DEVICE = "cuda"

BERT_BATCH, BERT_SEQ = 8, 128
RESNET_BATCH, RESNET_HW = 32, 224


def set_device(device: str) -> None:
    """Run every tool's executors on ``"cuda"`` or ``"cpu"``."""
    global _DEVICE
    if device not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {device!r} (cuda or cpu)")
    _DEVICE = device


def device() -> str:
    return _DEVICE


def place():
    return fluid.CPUPlace() if _DEVICE == "cpu" else fluid.CUDAPlace(0)


def executor():
    return fluid.Executor(place())


def synchronize() -> None:
    """Wait for the card (a no-op on the CPU)."""
    if _DEVICE == "cuda":
        import torch

        torch.cuda.synchronize()


def refuse_multi_device(mode: str):
    """The JAX tools' modes that reshape or validate a mesh live wait for
    the port's model-parallel slice: raise, naming it."""
    raise NotImplementedError(
        f"{mode} validates or re-forms a mesh live, which waits for "
        f"ROADMAP Queue A item 6 (slice 25); the port's gates run on one "
        f"card")


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="CUDAPlace(0) (default) or the CPU")


def bert_config(tiny: bool = False):
    """BERT-base (BERT-tiny) at dropout 0: the executor keys each step's
    random draws on a step counter no checkpoint holds, so a resumed run
    could not repeat dropout masks; every gate leg runs without them."""
    from paddle_tpu_torch.models.bert import BertConfig

    cfg = BertConfig.tiny() if tiny else BertConfig.base()
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    return cfg


def bert_feed(seed: int, vocab: int, batch: int, seq: int) -> dict:
    """A synthetic pretraining batch: random tokens, two segments, padded
    lengths in [seq/2, seq], 15 % of the real tokens masked."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(seq // 2, seq + 1, (batch, 1))
    lens[0] = seq
    real = np.arange(seq)[None] < lens
    masked = real & (rng.rand(batch, seq) < 0.15)
    return {"src_ids": rng.randint(0, vocab, (batch, seq)).astype(np.int64),
            "pos_ids": np.tile(np.arange(seq, dtype=np.int64), (batch, 1)),
            "sent_ids": (np.arange(seq)[None] >= lens // 2).astype(np.int64),
            "input_mask": real.astype(np.float32),
            "mask_label": np.where(masked,
                                   rng.randint(0, vocab, (batch, seq)),
                                   -100).astype(np.int64),
            "next_sent_label": rng.randint(0, 2, (batch, 1))
            .astype(np.int64)}


def bert_train(seed: int = 0, tiny: bool = False, batch: int = BERT_BATCH,
               seq: int = BERT_SEQ):
    """BERT-base f32 pretraining (Adam, dropout 0), its feed and config:
    ``(net, feed, cfg)`` with ``net`` the ``build_bert_pretrain`` dict."""
    from paddle_tpu_torch.models.bert import build_bert_pretrain

    cfg = bert_config(tiny)
    with un.guard():
        net = build_bert_pretrain(cfg, seq_len=seq)
    net["main"].random_seed = net["startup"].random_seed = seed
    return net, bert_feed(seed, cfg.vocab_size, batch, seq), cfg


def bert_infer(seed: int = 0, tiny: bool = False, batch: int = BERT_BATCH,
               seq: int = BERT_SEQ):
    """BERT-base bf16 inference (the is_test clone under
    ``decorate_program``; fused under ``FLAGS_epilogue_fusion``) fetching
    the encoder output: ``(program, startup, feed_names, fetch, feed)``."""
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models.bert import build_bert_pretrain

    cfg = bert_config(tiny)
    with un.guard():
        net = build_bert_pretrain(cfg, seq_len=seq, build_optimizer=False)
    net["startup"].random_seed = seed
    prog = mixed_precision.decorate_program(net["main"].clone(for_test=True))
    enc = next(op.input("X")[0] for op in prog.global_block.ops
               if op.type == "mul" and op.input("Y")[0] == "mlm_trans_w")
    names = list(net["feeds"])
    feed = bert_feed(seed, cfg.vocab_size, batch, seq)
    return prog, net["startup"], names, enc, {n: feed[n] for n in names}


def resnet_infer(seed: int = 0, tiny: bool = False,
                 batch: int = RESNET_BATCH):
    """ResNet-50 bf16 inference (the is_test clone under
    ``decorate_program``): ``(program, startup, fetch, feed)``."""
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models.resnet import build_resnet

    depth, hw, classes = (18, 64, 10) if tiny else (50, RESNET_HW, 1000)
    with un.guard():
        net = build_resnet(depth=depth, class_num=classes,
                           image_shape=(3, hw, hw), build_optimizer=False)
    net["startup"].random_seed = seed
    prog = mixed_precision.decorate_program(net["main"].clone(for_test=True))
    rng = np.random.RandomState(seed)
    feed = {"img": rng.rand(batch, 3, hw, hw).astype(np.float32),
            "label": rng.randint(0, classes, (batch, 1)).astype(np.int64)}
    return prog, net["startup"], net["logits"].name, feed
