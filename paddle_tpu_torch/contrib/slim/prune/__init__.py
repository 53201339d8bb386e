"""Model pruning (counterpart of ``paddle_tpu/contrib/slim/prune``;
reference contrib/slim/prune/pruner.py).

Zeroed channels save no work in a dense kernel, so pruning has two modes
with different artifacts:

- **mask pruning** (`prune_parameters`): zero the selected channel groups
  in the scope, shapes unchanged. This is what the reference's iterative
  sensitive-pruning loop actually needs during training (prune -> finetune
  -> re-prune), and the only mode that composes with a compiled program
  mid-training.
- **shape shrinking** (`shrink_model`): numpy surgery on the scope + var
  metadata that REMOVES the pruned channels of matched conv/fc chains for
  deployment — the reference's final export semantics, where the FLOP
  savings become real.

The scope holds torch tensors, on the card or the CPU: the surgery reads
each one back to the host (``_host``) and plants numpy arrays, which the
executor moves to its device at the next run.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

__all__ = ["Pruner", "StructurePruner", "prune_parameters", "apply_masks",
           "shrink_model"]


def _host(v) -> np.ndarray:
    """A scope value as a numpy array (a tensor read back from its
    device)."""
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class Pruner:
    """Base class (reference pruner.py:22)."""

    def prune(self, param):
        pass


class StructurePruner(Pruner):
    """Group (channel) pruning by l1/l2 norm (reference pruner.py:34)."""

    def __init__(self, pruning_axis: Dict[str, int],
                 criterions: Dict[str, str]):
        self.pruning_axis = pruning_axis
        self.criterions = criterions

    def cal_pruned_idx(self, name: str, param: np.ndarray, ratio: float,
                       axis: Optional[int] = None) -> List[int]:
        criterion = self.criterions.get(name, self.criterions.get("*"))
        if axis is None:
            axis = self.pruning_axis.get(name, self.pruning_axis.get("*"))
        prune_num = int(round(param.shape[axis] * ratio))
        reduce_dims = tuple(i for i in range(param.ndim) if i != axis)
        if criterion == "l1_norm":
            scores = np.sum(np.abs(param), axis=reduce_dims)
        elif criterion == "l2_norm":
            scores = np.sqrt(np.sum(np.square(param), axis=reduce_dims))
        else:
            raise ValueError(f"unknown criterion {criterion!r}")
        return list(scores.argsort()[:prune_num])

    def prune_tensor(self, tensor: np.ndarray, pruned_idx, pruned_axis: int,
                     lazy: bool = False) -> np.ndarray:
        """lazy=True zeroes the groups (mask mode); lazy=False removes them
        (shrink mode) — reference pruner.py prune_tensor contract."""
        if lazy:
            out = np.array(tensor)
            idx = [slice(None)] * tensor.ndim
            idx[pruned_axis] = list(pruned_idx)
            out[tuple(idx)] = 0
            return out
        return np.delete(tensor, list(pruned_idx), axis=pruned_axis)


def prune_parameters(scope, ratios: Dict[str, float], criterion="l1_norm",
                     axis=0, tied: Optional[Dict[str, List[str]]] = None):
    """Mask-prune named parameters in ``scope`` by channel-group norm:
    zero the lowest-norm ``ratio`` of groups along ``axis``. ``tied`` maps
    a pruned param to vars sharing its channel axis (its bias, BN stats):
    a masked channel must read as FULLY dead — weight AND bias — or the
    downstream layers finetune against a constant the final shrink then
    removes. Returns {param: pruned channel indices}; re-apply with
    ``apply_masks`` after each finetune step to keep the zeros pinned."""
    pruner = StructurePruner({"*": axis}, {"*": criterion})
    pruned = {}
    for name, ratio in ratios.items():
        val = _host(scope.find_var(name))
        idx = pruner.cal_pruned_idx(name, val, ratio)
        scope.set_var(name, pruner.prune_tensor(val, idx, axis, lazy=True))
        pruned[name] = idx
        for tied_name in (tied or {}).get(name, []):
            tv = _host(scope.find_var(tied_name)).copy()
            tv[idx] = 0
            scope.set_var(tied_name, tv)
    return pruned


def apply_masks(scope, pruned: Dict[str, List[int]], axis=0,
                tied: Optional[Dict[str, List[str]]] = None):
    """Re-pin the pruned groups to zero (call after each finetune step —
    the optimizer update revives them otherwise)."""
    for name, idx in pruned.items():
        w = _host(scope.find_var(name)).copy()
        sl = [slice(None)] * w.ndim
        sl[axis] = list(idx)
        w[tuple(sl)] = 0
        scope.set_var(name, w)
        for tied_name in (tied or {}).get(name, []):
            tv = _host(scope.find_var(tied_name)).copy()
            tv[list(idx)] = 0
            scope.set_var(tied_name, tv)


def shrink_model(program, startup_program, scope,
                 ratios: Dict[str, float], criterion="l1_norm",
                 pruned_idx: Optional[Dict[str, List[int]]] = None):
    """Deployment-time channel removal for fc/conv chains: shrink param
    OUT-channels (axis 0 for conv [O,I,kh,kw], axis 1 for fc [in, out]) and
    the DOWNSTREAM consumer's IN-channels to match. Only straight-line
    producer->consumer chains are rewritten; anything else raises rather
    than silently corrupting shapes. Returns the pruned index map.

    After a mask-prune + finetune cycle, pass ``pruned_idx`` (the map
    ``prune_parameters`` returned): finetuning changes channel norms, so
    recomputing indices here would remove channels the finetune made
    important while keeping the zeroed ones."""
    block = program.global_block
    pruner = StructurePruner({}, {"*": criterion})

    # ops through which the channel dim flows unchanged: the walk continues
    # past these until it hits the next parametered op; anything else stops
    # the walk loudly rather than silently corrupting shapes
    _CHANNEL_PRESERVING = {
        "elementwise_add", "elementwise_sub", "elementwise_mul", "relu",
        "relu6", "leaky_relu", "sigmoid", "tanh", "batch_norm", "dropout",
        "pool2d", "scale", "prelu", "swish", "hard_swish",
    }

    def consumers_of(var_name):
        return [op for op in block.ops if var_name in op.input_arg_names]

    def shrink_param(var_name, idx, axis):
        w = _host(scope.find_var(var_name))
        scope.set_var(var_name, pruner.prune_tensor(w, idx, axis))
        block.var(var_name).shape = tuple(
            _host(scope.find_var(var_name)).shape)

    pruned = {}
    for name, ratio in ratios.items():
        val = _host(scope.find_var(name))
        # conv weights are [O, I, kh, kw]; fc weights [in, out]
        out_axis = 0 if val.ndim == 4 else 1
        n_out = val.shape[out_axis]
        idx = (list(pruned_idx[name]) if pruned_idx and name in pruned_idx
               else pruner.cal_pruned_idx(name, val, ratio, axis=out_axis))
        if not idx:
            continue
        shrink_param(name, idx, out_axis)
        pruned[name] = idx

        # BFS from the producer's output through channel-preserving ops;
        # shrink side-input params (biases, bn stats) along their channel
        # axis and downstream weights along their IN-channel axis
        producer = next(op for op in block.ops
                        if name in op.input_arg_names)
        frontier = list(producer.output_arg_names)
        seen_vars = set(frontier)
        while frontier:
            var_name = frontier.pop()
            for op in consumers_of(var_name):
                # deployment transform: backward/optimizer ops re-derive
                # from the (shrunk) forward — never walk into them. NOTE:
                # after shrinking a TRAINING program, optimizer
                # accumulators keep their old shapes; rebuild the
                # optimizer (re-run minimize + startup) before continuing
                # to train, exactly as the reference slim rebuilds its
                # graph between prune rounds.
                if op.type.endswith("_grad") or \
                        op.attrs.get("__op_role__") in ("backward",
                                                        "optimize",
                                                        "lr_sched"):
                    continue
                param_ins = [n for n in op.input_arg_names
                             if n != name and block.has_var(n)
                             and type(block.var(n)).__name__ == "Parameter"]
                hit_weight = False
                for in_name in param_ins:
                    w = _host(scope.find_var(in_name))
                    if w.ndim >= 2:
                        in_axis = 1 if w.ndim == 4 else 0
                        if w.shape[in_axis] == n_out:
                            shrink_param(in_name, idx, in_axis)
                            hit_weight = True
                    elif w.ndim == 1 and w.shape[0] == n_out:
                        shrink_param(in_name, idx, 0)  # bias / bn stats
                if hit_weight:
                    continue  # channel identity ends here
                if op.type in _CHANNEL_PRESERVING:
                    for out_name in op.output_arg_names:
                        if out_name not in seen_vars:
                            seen_vars.add(out_name)
                            frontier.append(out_name)
                elif not param_ins:
                    raise ValueError(
                        f"shrink_model: op '{op.type}' consumes pruned "
                        f"channels of '{name}' but is not channel-"
                        f"preserving; prune a layer with a straight "
                        f"conv/fc chain or use mask pruning")
    program._bump_version()
    return pruned
