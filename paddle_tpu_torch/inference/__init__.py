"""Inference stack: predictor API and program export (counterpart of
``paddle_tpu/inference``).

Reference: paddle/fluid/inference/api/analysis_predictor.h:47
AnalysisPredictor (Run/ZeroCopyRun over an analysed program),
paddle_analysis_config.h AnalysisConfig, ZeroCopyTensor, and the engine
bridges (tensorrt/anakin subgraph engines).

The predictor loads a saved inference model (``io.load_inference_model``)
into a scope of its own and runs it through an ``Executor``, so the
executor's flags act as they do in ``Executor.run``
(``FLAGS_epilogue_fusion`` fuses the GEMM chains onto K5). ``use_gpu()``,
the default, means ``CUDAPlace(device_id)``; ``disable_gpu()`` the CPU.

The portable serving artifact (the TensorRT/Anakin role; the JAX package
writes StableHLO through ``jax.export``) is a ``torch.export`` archive
here: :func:`export_stablehlo` keeps the JAX package's name and
signature. It traces the program's interpreter once in non-strict mode
over example feeds of the fixed ``feed_specs``, with the scope's state as
buffers of a wrapper module, so the weights are embedded; the port's
kernels enter the graph as the ``paddle_tpu_torch::flash_attention_fwd``
and ``paddle_tpu_torch::fused_gemm`` operators (the wrappers call them
while ``torch.export`` traces), which still launch and count the kernels
when the artifact runs.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import io as io_mod
from .. import kernels  # noqa: F401  (registers the kernels' operators)
from ..core.types import torch_dtype
from ..executor import CPUPlace, CUDAPlace, Executor, Scope, scope_guard
from ..ops.common import _exact_cudnn

__all__ = ["AnalysisConfig", "AnalysisPredictor", "ZeroCopyTensor",
           "create_paddle_predictor", "export_stablehlo", "load_stablehlo",
           "StableHLOPredictor"]


class AnalysisConfig:
    """reference paddle_analysis_config.h — the knobs that mean something
    here, plus switches accepted for parity."""

    def __init__(self, model_dir: Optional[str] = None,
                 prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        self._model_dir = model_dir
        self._prog_file = prog_file
        self._params_file = params_file
        self._use_accelerator = True
        self._device_id = 0
        self._memory_optim = True  # inert: the executor frees as it goes

    def set_model(self, model_dir: str):
        self._model_dir = model_dir

    def model_dir(self) -> str:
        return self._model_dir

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._use_accelerator = True
        self._device_id = int(device_id)

    def disable_gpu(self):
        self._use_accelerator = False

    def use_gpu(self) -> bool:
        return self._use_accelerator

    def enable_memory_optim(self):
        self._memory_optim = True

    def switch_use_feed_fetch_ops(self, flag: bool):
        pass  # feed/fetch are executor-spliced, never ops

    def switch_ir_optim(self, flag: bool = True):
        pass  # the executor's passes run under their own flags

    def enable_tensorrt_engine(self, **kw):
        raise NotImplementedError(
            "TensorRT is not part of the port — use export_stablehlo() for "
            "a portable compiled-serving artifact")


class ZeroCopyTensor:
    """reference api/paddle_api.h ZeroCopyTensor: named input/output handle
    with copy_from_cpu/copy_to_cpu."""

    def __init__(self, name: str, owner: "AnalysisPredictor", is_input: bool):
        self.name = name
        self._owner = owner
        self._is_input = is_input

    def copy_from_cpu(self, arr: np.ndarray) -> None:
        if not self._is_input:
            raise RuntimeError(f"'{self.name}' is an output tensor")
        self._owner._feeds[self.name] = np.asarray(arr)

    def copy_to_cpu(self) -> np.ndarray:
        if self._is_input:
            return np.asarray(self._owner._feeds[self.name])
        return np.asarray(self._owner._outputs[self.name])

    def shape(self):
        return list(self.copy_to_cpu().shape)


class AnalysisPredictor:
    """reference analysis_predictor.h:47. One predictor = one loaded
    inference program + its own scope + an executor on the config's
    place."""

    def __init__(self, config: AnalysisConfig):
        self._config = config
        place = CUDAPlace(config._device_id) if config.use_gpu() \
            else CPUPlace()
        self._exe = Executor(place)
        self._scope = Scope()
        model_dir = config.model_dir()
        model_fn = params_fn = None
        if model_dir is None:
            # combined-file form: AnalysisConfig(prog_file, params_file)
            if not (config._prog_file and config._params_file):
                raise ValueError(
                    "AnalysisConfig needs model_dir or both prog_file and "
                    "params_file")
            model_dir = os.path.dirname(config._prog_file) or "."
            model_fn = os.path.basename(config._prog_file)
            params_fn = os.path.basename(config._params_file)
        with scope_guard(self._scope):
            self._program, self._feed_names, fetch_vars = \
                io_mod.load_inference_model(model_dir, self._exe,
                                            model_filename=model_fn,
                                            params_filename=params_fn)
        self._fetch_names = [v.name for v in fetch_vars]
        self._feeds: Dict[str, np.ndarray] = {}
        self._outputs: Dict[str, np.ndarray] = {}

    # -- names & handles --------------------------------------------------
    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_output_names(self) -> List[str]:
        return list(self._fetch_names)

    def get_input_handle(self, name: str) -> ZeroCopyTensor:
        if name not in self._feed_names:
            raise KeyError(f"unknown input '{name}'; have {self._feed_names}")
        return ZeroCopyTensor(name, self, is_input=True)

    def get_output_handle(self, name: str) -> ZeroCopyTensor:
        if name not in self._fetch_names:
            raise KeyError(f"unknown output '{name}'")
        return ZeroCopyTensor(name, self, is_input=False)

    get_input_tensor = get_input_handle
    get_output_tensor = get_output_handle

    # -- execution --------------------------------------------------------
    def run(self, inputs: Optional[Sequence[np.ndarray]] = None):
        """With ``inputs``: positional arrays aligned with input names
        (reference Run(inputs, &outputs)); without: ZeroCopyRun over the
        handles filled via copy_from_cpu."""
        if inputs is not None:
            if len(inputs) != len(self._feed_names):
                raise ValueError(
                    f"expected {len(self._feed_names)} inputs "
                    f"({self._feed_names}), got {len(inputs)}")
            self._feeds = dict(zip(self._feed_names,
                                   (np.asarray(a) for a in inputs)))
        missing = [n for n in self._feed_names if n not in self._feeds]
        if missing:
            raise RuntimeError(f"inputs not set: {missing}")
        outs = self._exe.run(self._program, feed=dict(self._feeds),
                             fetch_list=self._fetch_names, scope=self._scope)
        self._outputs = dict(zip(self._fetch_names, outs))
        return [self._outputs[n] for n in self._fetch_names]

    zero_copy_run = run


def create_paddle_predictor(config: AnalysisConfig) -> AnalysisPredictor:
    """reference CreatePaddlePredictor<AnalysisConfig>."""
    return AnalysisPredictor(config)


# ---------------------------------------------------------------------------
# Program export (the TRT/Anakin replacement), over torch.export
# ---------------------------------------------------------------------------

def _block_io(block, feed_names, fetch_names):
    """The sorted feed order and the state a run of ``block`` reads (scope
    vars read before any op writes them), as the JAX package's
    ``analyze_block_io`` orders them."""
    produced, state = set(), []
    for op in block.ops:
        for n in op.input_arg_names:
            if n not in produced and n not in feed_names \
                    and n not in state and n != "@EMPTY@":
                state.append(n)
        produced.update(n for n in op.output_arg_names if n != "@EMPTY@")
    for n in fetch_names:
        if n not in produced and n not in feed_names and n not in state:
            state.append(n)
    return sorted(feed_names), state


class _Interpreter(torch.nn.Module):
    """The program's interpreter as a module: the state the program reads
    is its buffers (``s0``, ``s1``, ...: the export embeds them), the
    feeds its arguments in ``feed_order``, the fetches its outputs."""

    def __init__(self, program, feed_order, state, fetch_names, device,
                 gemm_blocks):
        super().__init__()
        self._program = program
        self._feed_order = list(feed_order)
        self._state_names = [n for n, _ in state]
        self._fetch_names = list(fetch_names)
        self._device = device
        self._gemm_blocks = gemm_blocks
        for i, (_, t) in enumerate(state):
            self.register_buffer(f"s{i}", t)

    def forward(self, *feeds):
        from ..lowering import LowerCtx, lower_block

        env = dict(zip(self._feed_order, feeds))
        env.update((n, self.get_buffer(f"s{i}"))
                   for i, n in enumerate(self._state_names))
        ctx = LowerCtx(self._device, seed=0, gemm_blocks=self._gemm_blocks,
                       program=self._program)
        lower_block(self._program.global_block, env, ctx)
        return tuple(env[n] for n in self._fetch_names)


def _state_tensor(v, var, device):
    if isinstance(v, torch.Tensor):
        return v.detach().to(device)
    arr = np.asarray(v)
    dt = torch_dtype(var.dtype) if var is not None else None
    return torch.from_numpy(np.array(arr, copy=True)).to(device, dt)


def export_stablehlo(program, feed_specs: Dict[str, tuple], fetch_list,
                     path: str, scope=None):
    """Serialize an inference program as a portable artifact.

    ``feed_specs``: ``{name: (shape, dtype)}`` fixing the signature. Writes
    ``<path>``, a ``torch.export`` archive (``torch.export.save``) of the
    program as the executor would run it under the current flags (the
    epilogue fusion included), with the scope's weights embedded as
    buffers, and ``<path>.txt``, the printed graph (the role of the JAX
    package's ``.mlir``). :func:`load_stablehlo` runs it with no Program;
    loading needs the port's kernel operators registered
    (``import paddle_tpu_torch``). The state's device is the export's:
    the artifact runs there. Returns ``{"feed_order", "fetch_names"}``."""
    from ..executor import global_scope

    scope = scope or global_scope()
    fetch_names = [f if isinstance(f, str) else f.name for f in fetch_list]
    block = program.global_block
    state = []
    feed_order, state_names = _block_io(block, set(feed_specs), fetch_names)
    for n in state_names:
        v = scope.find_var(n)
        if v is None:
            raise RuntimeError(f"var '{n}' not in scope — run startup/load "
                               f"params before exporting")
        state.append((n, v))
    devices = [v.device for _, v in state if isinstance(v, torch.Tensor)]
    device = devices[0] if devices else CUDAPlace(0).torch_device()
    state = [(n, _state_tensor(v, block.vars.get(n), device))
             for n, v in state]
    feeds = {n: np.zeros(tuple(s), np.dtype(d))
             for n, (s, d) in feed_specs.items()}
    # the executor's preparation under the current flags: the block
    # triple, the fusion rewrite and the verification of what will run
    exe = Executor(CPUPlace()) if device.type == "cpu" else \
        Executor(CUDAPlace(device.index or 0))
    run_prog, blocks, _ = exe._prepare(program, feeds, fetch_names)
    module = _Interpreter(run_prog, feed_order, state, fetch_names, device,
                          blocks)
    args = tuple(torch.zeros(tuple(feed_specs[n][0]),
                             dtype=torch_dtype(feed_specs[n][1]),
                             device=device) for n in feed_order)
    with torch.no_grad():
        exported = torch.export.export(module, args, strict=False)
    torch.export.save(exported, path)
    with open(path + ".txt", "w") as f:
        f.write(str(exported.graph_module.code))
    return {"feed_order": feed_order, "fetch_names": fetch_names}


class StableHLOPredictor:
    """Run an artifact of :func:`export_stablehlo` (no Program machinery):
    positional inputs in its ``feed_order``, numpy outputs."""

    def __init__(self, path: str):
        self._exported = torch.export.load(path)
        self._module = self._exported.module()
        user = torch.export.graph_signature.InputKind.USER_INPUT
        specs = [s for s in self._exported.graph_signature.input_specs
                 if s.kind == user]
        nodes = {n.name: n for n in self._exported.graph.nodes
                 if n.op == "placeholder"}
        self._inputs = [nodes[s.arg.name].meta["val"] for s in specs]

    def run(self, *inputs):
        args = [torch.as_tensor(np.asarray(a)).to(v.device, v.dtype)
                for a, v in zip(inputs, self._inputs)]
        # the program's convolutions set cuDNN's float32 and deterministic
        # settings around each call (``ops.common.convolution``), which
        # the exported graph does not carry: set them for the whole run
        with torch.no_grad(), _exact_cudnn():
            outs = self._module(*args)
        return [o.detach().cpu().numpy() for o in outs]


def load_stablehlo(path: str) -> StableHLOPredictor:
    return StableHLOPredictor(path)
