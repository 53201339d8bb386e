"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

It mirrors the JAX package's module names (``framework``, ``layers``,
``executor``, ``ops``, ``kernels``, ``models``, ``serving``) and runs its
programs eagerly on torch tensors; the attention kernels are written by
hand in CUDA for Hopper (``csrc/``). It imports neither ``jax`` nor
``paddle_tpu``.

Slices ported so far: generative serving of the GPT models
(``models.gpt.build_gpt_generative`` + ``serving.GenerativeEngine``) and
BERT pretraining (``models.bert.build_bert_pretrain``: ``append_backward``,
the generic ``<type>_grad``, Adam). ``Executor()`` runs on
``CUDAPlace(0)``; pass ``CPUPlace()`` for the CPU.
"""
from . import ops  # noqa: F401  (registers the op rules)
from . import layers, optimizer, unique_name  # noqa: F401
from .backward import append_backward
from .executor import CPUPlace, CUDAPlace, Executor, Scope, global_scope
from .flags import flag, set_flags
from .framework import (Program, default_main_program,
                        default_startup_program, program_guard)
from .initializer import Constant, TruncatedNormal
from .param_attr import ParamAttr

__all__ = ["CPUPlace", "CUDAPlace", "Executor", "Scope", "global_scope",
           "append_backward", "optimizer",
           "flag", "set_flags", "Program", "default_main_program",
           "default_startup_program", "program_guard", "Constant",
           "TruncatedNormal", "ParamAttr", "layers", "unique_name"]
