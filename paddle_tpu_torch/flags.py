"""FLAGS_* config (counterpart of ``paddle_tpu/flags.py``), the flags this
slice of the port reads. Flags resolve, in order: explicit ``set_flags``
> ``FLAGS_<name>`` env var > default."""
from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["flag", "set_flags", "get_flags"]

# name -> (type, default, meaning)
_DEFS: Dict[str, tuple] = {
    "use_flash_attention": (str, "auto",
                            "attention path: auto (the hand-written CUDA "
                            "kernel on a CUDA tensor, the plain PyTorch "
                            "version on a CPU tensor) or never (the plain "
                            "version everywhere)"),
    "serving_queue_depth": (int, 256,
                            "serving admission control: queued requests "
                            "above this are rejected with typed Overloaded"),
    "serving_deadline_s": (float, 0.0,
                           "default per-request deadline in seconds (0: "
                           "none); an expired request settles typed "
                           "DeadlineExceeded"),
    "epilogue_fusion": (bool, False,
                        "GEMM-epilogue fusion (analysis/epilogue_fusion.py, "
                        "a registered transform pass): Executor.run and "
                        "run_chained rewrite mul/matmul -> bias-add -> "
                        "activation -> residual -> layer_norm chains of a "
                        "forward-only program into fused_gemm_epilogue ops, "
                        "gated by a fidelity witness (a program it cannot "
                        "prove runs untransformed)"),
    "use_fused_gemm": (str, "auto",
                       "fused_gemm_epilogue path: auto (the hand-written "
                       "CUDA kernel on a CUDA tensor when classify_gemm "
                       "takes the shape, the dense replay of the original "
                       "op rules elsewhere), always (the kernel, or its "
                       "plain version on a CPU tensor; a shape the kernel "
                       "does not take raises), never (the dense replay)"),
    "fused_gemm_blocks": (str, "",
                          "fused_gemm_epilogue block sizes as 'm,n,k'; "
                          "empty means the port's compiled default "
                          "(kernels.fused_gemm.DEFAULT_BLOCKS)"),
    "conv_use_nhwc": (str, "auto",
                      "memory format of conv and pool inputs (shapes stay "
                      "logical NCHW): auto (torch.channels_last on a CUDA "
                      "tensor, contiguous NCHW on a CPU tensor), always "
                      "(channels_last), never (contiguous NCHW)"),
}

# flags that take one of a few words
_CHOICES: Dict[str, tuple] = {"use_flash_attention": ("auto", "never"),
                              "use_fused_gemm": ("auto", "always", "never"),
                              "conv_use_nhwc": ("auto", "always", "never")}

_overrides: Dict[str, Any] = {}


def _value(name: str, raw):
    val = _coerce(_DEFS[name][0], raw)
    if name in _CHOICES and val not in _CHOICES[name]:
        raise ValueError(f"FLAGS_{name}={val!r}: takes one of "
                         f"{_CHOICES[name]}")
    return val


def _coerce(typ, raw):
    if typ is bool:
        if isinstance(raw, (int, float, bool)):
            return bool(raw)
        s = str(raw).strip().lower()
        if s in ("1", "true", "yes", "on"):
            return True
        if s in ("0", "false", "no", "off", ""):
            return False
        raise ValueError(f"not a boolean flag value: {raw!r}")
    return typ(raw)


def flag(name: str):
    """Current value of one flag."""
    if name not in _DEFS:
        raise KeyError(f"unknown flag '{name}' — known: {sorted(_DEFS)}")
    if name in _overrides:
        return _overrides[name]
    typ, default, _ = _DEFS[name]
    raw = os.environ.get(f"FLAGS_{name}")
    return default if raw is None else _value(name, raw)


def get_flags(names=None) -> Dict[str, Any]:
    """``{'FLAGS_<name>': value}`` for ``names`` (one name, a list, or
    None for every flag)."""
    if names is None:
        names = list(_DEFS)
    if isinstance(names, str):
        names = [names]
    return {f"FLAGS_{n}": flag(n) for n in (x.replace("FLAGS_", "")
                                            for x in names)}


def set_flags(flags_dict: Dict[str, Any]) -> None:
    """``set_flags({'FLAGS_use_flash_attention': 'never'})``."""
    for k, v in flags_dict.items():
        name = k.replace("FLAGS_", "")
        if name not in _DEFS:
            raise KeyError(f"unknown flag '{k}' — known: "
                           f"{sorted('FLAGS_' + n for n in _DEFS)}")
        _overrides[name] = _value(name, v)
