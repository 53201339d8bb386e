"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

It mirrors the JAX package's module names (``framework``, ``layers``,
``executor``, ``ops``, ``kernels``, ``models``, ``serving``, ``analysis``)
and runs its programs eagerly on torch tensors; the attention and
fused-GEMM kernels are written by hand in CUDA for Hopper (``csrc/``).
It imports neither ``jax`` nor ``paddle_tpu``.

Slices ported so far: generative serving of the GPT models
(``models.gpt.build_gpt_generative`` + ``serving.GenerativeEngine``),
BERT pretraining (``models.bert.build_bert_pretrain``: ``append_backward``,
the generic ``<type>_grad``, Adam) and inference with GEMM-epilogue fusion
(``FLAGS_epilogue_fusion``: ``analysis.epilogue_fusion`` rewrites matmul
chains into ``fused_gemm_epilogue``, the fused-GEMM kernel K5 on the
card), bf16 mixed precision (``contrib.mixed_precision``: ``decorate``
for training, ``decorate_program`` for inference) and the MLP train step
(``models.mlp.build_mnist_mlp``, SGD), and ResNet training and inference
(``models.resnet.build_resnet``: conv2d, batch_norm, pool2d, Momentum,
weight decay through ``regularizer``), and the serving services
(``serving.ServingEngine`` batching with admission control, speculative
decoding in ``serving.GenerativeEngine``, ``monitor``, ``trace`` and
``resilience``). ``Executor()`` runs on ``CUDAPlace(0)``; pass
``CPUPlace()`` for the CPU.
"""
from . import ops  # noqa: F401  (registers the op rules)
from . import (contrib, layers, monitor, optimizer,  # noqa: F401
               regularizer, resilience, serving, trace, unique_name)
from .backward import append_backward
from .executor import CPUPlace, CUDAPlace, Executor, Scope, global_scope
from .flags import flag, get_flags, set_flags
from .framework import (Program, default_main_program,
                        default_startup_program, program_guard)
from .initializer import Constant, Normal, TruncatedNormal, Uniform, Xavier
from .param_attr import ParamAttr

__all__ = ["CPUPlace", "CUDAPlace", "Executor", "Scope", "global_scope",
           "append_backward", "optimizer", "regularizer",
           "flag", "get_flags", "set_flags", "Program", "default_main_program",
           "default_startup_program", "program_guard", "Constant",
           "Normal", "TruncatedNormal", "Uniform", "Xavier", "ParamAttr",
           "layers", "unique_name", "contrib", "monitor", "trace",
           "resilience", "serving"]
