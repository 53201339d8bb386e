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
``resilience``), and the training safety net (``FLAGS_check_nan_inf``
with ``FLAGS_nan_inf_policy`` rollback, ``monitor.numwitness``, gradient
clipping through ``set_gradient_clip``, ``gradients``/``calc_gradient``,
``io`` with crash-safe checkpoints, graceful preemption in
``resilience.graceful``), and every optimizer, the learning-rate
schedules (``layers.learning_rate_scheduler``) and gradient merge
(``optimizer.GradientMergeOptimizer``: the executor's microbatch loop),
program verification and the autotuner (``FLAGS_check_program``,
``FLAGS_autotune``), and control flow with seq2seq (``layers.While``,
``StaticRNN``, the tensor arrays, beam search;
``models.seq2seq.build_seq2seq_train``/``build_seq2seq_infer``), and
LoD inputs (``layers.data(lod_level=1)``: a padded var with its
``<name>@LOD`` lengths, fed by ``DataFeeder``) with the sequence ops,
the recurrent ops (``dynamic_gru``, ``dynamic_lstm``, ``DynamicRNN``,
``warpctc``), the structured losses (``linear_chain_crf``,
``crf_decoding``, ``nce``, ``hsigmoid``, ``edit_distance``,
``ctc_greedy_decoder``, ``chunk_eval``) and
``models.seq2seq.build_seq2seq_train_varlen``, and SelectedRows
gradients of ``is_sparse`` tables (``core.selected_rows``: the sparse
branches of the lookup grad, the math, clip and update ops) with
``models.deepfm.build_deepfm``, and the ``nn`` ops ``conv2d_transpose``,
``group_norm``, ``instance_norm``, ``l2_normalize``, ``prelu`` and the
two interpolations, and the misc and image op groups, and the detection
ops (``layers.detection``: priors, anchors, box coding, ``yolo_box``,
``multiclass_nms``, RoI align and pooling, the RPN/FPN proposal ops)
with the deformable and position-sensitive RoI ops, sampled softmax and
``py_func``, ``layers.distributions`` and ``metrics``, and the data
path (``reader``: ``DataLoader``/``PyReader`` staging each batch on the
card from pinned memory on a side stream, the reader decorators;
``dataset``; ``dataset_feed`` over the native MultiSlot parser in
``native``; ``incubate.data_generator``), ``profiler`` over
``torch.profiler``, ``resilience.elastic`` and ``contrib.Trainer``/
``Inferencer``, and dygraph mode (``dygraph``: the eager tape over the
op rules under autograd, ``Layer`` and its layers, the eager optimizer
updates, ``save_dygraph``), the predictor API with its export over
``torch.export`` (``inference``), and ``contrib.slim`` with the
fake-quant ops.
``Executor()`` runs on ``CUDAPlace(0)``; pass
``CPUPlace()`` for the CPU.
"""
from . import ops  # noqa: F401  (registers the op rules)
from . import (analysis, clip, contrib, initializer, io,  # noqa: F401
               layers, metrics, monitor, optimizer, regularizer, resilience,
               serving, trace, tuning, unique_name)
from . import dataset, incubate, profiler, reader  # noqa: F401
from . import dygraph, inference, kernels  # noqa: F401
from .dataset_feed import DatasetFactory
from .reader import DataLoader, PyReader, batch
from .backward import append_backward, calc_gradient, gradients
from .data_feeder import DataFeeder
from .clip import (ErrorClipByValue, GradientClipByGlobalNorm,
                   GradientClipByNorm, GradientClipByValue,
                   set_gradient_clip)
from .core import registry as op_registry
from .executor import (CPUPlace, CUDAPlace, Executor, Scope, global_scope,
                       scope_guard)
from .flags import flag, get_flags, set_flags
from .framework import (Block, Operator, Parameter, Program, Variable,
                        default_main_program, default_startup_program,
                        in_dygraph_mode, name_scope, program_guard)
from .initializer import Constant, Normal, TruncatedNormal, Uniform, Xavier
from .layers import learning_rate_scheduler  # noqa: F401
from .param_attr import ParamAttr, WeightNormParamAttr
from .transpiler import memory_optimize, release_memory

__version__ = "0.1.0"

data = layers.data

__all__ = ["CPUPlace", "CUDAPlace", "DataFeeder", "Executor", "Scope",
           "global_scope",
           "append_backward", "calc_gradient", "gradients", "optimizer",
           "regularizer", "clip", "io", "set_gradient_clip",
           "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "ErrorClipByValue",
           "flag", "get_flags", "set_flags", "Program", "default_main_program",
           "default_startup_program", "program_guard", "Constant",
           "Normal", "TruncatedNormal", "Uniform", "Xavier", "ParamAttr",
           "layers", "unique_name", "contrib", "monitor", "trace",
           "resilience", "serving", "Block", "Operator", "Parameter",
           "Variable", "in_dygraph_mode", "name_scope", "scope_guard",
           "WeightNormParamAttr", "data", "initializer", "analysis",
           "tuning", "op_registry", "learning_rate_scheduler",
           "memory_optimize", "release_memory", "DataLoader", "PyReader",
           "batch", "reader", "dataset", "dataset_feed", "DatasetFactory",
           "profiler", "incubate", "dygraph", "inference"]
