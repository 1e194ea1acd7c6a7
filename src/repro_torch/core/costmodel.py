"""Analytical per-op cost model over aten calls.

The port of ``repro.core.costmodel``: the reference prices jaxpr
equations, this module prices the aten calls a
``TorchDispatchMode`` sees (:class:`repro_torch.core.trace.OperationTracker`)
with the same per-primitive formulas:

  * matmul-like ops (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``,
    ``dot``): ``2·b·m·n·k``;
  * convolution: ``2 · output size · reduction per output element /
    groups`` (the reference's ``_conv_cost``, groups counted as it counts
    them); each gradient ``aten.convolution_backward`` computes is priced
    as the convolution that computes it (:func:`conv_grad_costs`), as the
    reference prices JAX's transposed convolutions, zeros of a stride's
    dilation included, so equal functions give equal FLOPs;
  * movement ops (views, copies, ``cat``, indexing, creation): bytes only;
  * reductions and cumulative ops: one FLOP per input element;
  * other elementwise ops: ``_ELEMENTWISE_WEIGHT`` FLOPs per output
    element (1 by default);
  * the port's kernel ops (:data:`KERNEL_OPS`, ``torch.library`` custom
    ops named ``repro_torch::<kernel>``): what the kernel's function
    needs, counted as chip_smoke.py's bounds count it
    (:func:`flash_attention_cost`, :func:`ssd_cost`).

Each op is named with the reference's primitive name where one exists
(:func:`prim_name`), so a port trace reads like a reference trace and the
calibration tables key the same way.  Bytes count every tensor operand
read once and every output written once (no fusion), as the reference
does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence, Tuple

import torch


@dataclasses.dataclass
class OpCost:
    flops: float = 0.0
    bytes_read: float = 0.0
    bytes_written: float = 0.0

    @property
    def bytes_accessed(self) -> float:
        return self.bytes_read + self.bytes_written

    @property
    def intensity(self) -> float:
        """Arithmetic intensity (FLOPs/byte); paper Fig. 2's x-axis."""
        return self.flops / max(self.bytes_accessed, 1.0)

    def __add__(self, other: "OpCost") -> "OpCost":
        return OpCost(self.flops + other.flops,
                      self.bytes_read + other.bytes_read,
                      self.bytes_written + other.bytes_written)

    def scaled(self, k: float) -> "OpCost":
        return OpCost(self.flops * k, self.bytes_read * k,
                      self.bytes_written * k)


# FLOPs per element of the reference's elementwise primitives that cost
# more than one op (``repro.core.costmodel._ELEMENTWISE_WEIGHT``).
_ELEMENTWISE_WEIGHT = {
    "exp": 4, "log": 4, "log1p": 4, "expm1": 4,
    "sin": 4, "cos": 4, "tan": 6, "tanh": 6, "logistic": 6,
    "erf": 8, "erf_inv": 8, "erfc": 8,
    "rsqrt": 2, "sqrt": 2, "cbrt": 4,
    "div": 2, "rem": 2, "pow": 8, "integer_pow": 2,
    "atan2": 10, "sigmoid": 6,
}

#: aten overload packets -> the reference's primitive names
_PRIM_NAMES = {
    # matmul-like and convolution
    "mm": "dot_general", "addmm": "dot_general", "bmm": "dot_general",
    "baddbmm": "dot_general", "mv": "dot_general", "addmv": "dot_general",
    "dot": "dot_general", "convolution": "conv_general_dilated",
    # elementwise
    "add": "add", "sub": "sub", "rsub": "sub", "mul": "mul", "div": "div",
    "exp": "exp", "log": "log", "log1p": "log1p", "expm1": "expm1",
    "sin": "sin", "cos": "cos", "tan": "tan", "tanh": "tanh",
    "sigmoid": "logistic", "erf": "erf", "erfinv": "erf_inv",
    "erfc": "erfc", "rsqrt": "rsqrt", "sqrt": "sqrt", "neg": "neg",
    "abs": "abs", "sign": "sign", "maximum": "max", "minimum": "min",
    "clamp_min": "max", "clamp_max": "min", "remainder": "rem",
    "fmod": "rem", "atan2": "atan2", "eq": "eq", "ne": "ne", "lt": "lt",
    "le": "le", "gt": "gt", "ge": "ge", "logical_and": "and",
    "bitwise_and": "and", "logical_or": "or", "bitwise_or": "or",
    "logical_not": "not", "bitwise_not": "not", "floor": "floor",
    "ceil": "ceil", "round": "round", "square": "square",
    "reciprocal": "div",
    # reductions
    "sum": "reduce_sum", "amax": "reduce_max", "amin": "reduce_min",
    "prod": "reduce_prod", "argmax": "argmax", "argmin": "argmin",
    "any": "reduce_or", "all": "reduce_and",
    # movement
    "view": "reshape", "_unsafe_view": "reshape", "reshape": "reshape",
    "t": "transpose", "transpose": "transpose", "permute": "transpose",
    "expand": "broadcast_in_dim", "squeeze": "squeeze",
    "unsqueeze": "expand_dims", "cat": "concatenate",
    "stack": "concatenate", "slice": "slice", "narrow": "slice",
    "select": "slice", "split": "split", "split_with_sizes": "split",
    "unbind": "split", "chunk": "split", "index": "gather",
    "index_select": "gather", "gather": "gather", "embedding": "gather",
    "take_along_dim": "gather", "constant_pad_nd": "pad", "flip": "rev",
    "clone": "copy", "copy": "copy", "_to_copy": "convert_element_type",
    "where": "select_n", "arange": "iota", "scatter": "scatter",
    "index_put": "scatter", "slice_scatter": "scatter",
    "select_scatter": "scatter",
}

#: reference-named ops priced as pure data movement (bytes only), beside
#: the creation ops below
_MOVEMENT = {
    "reshape", "transpose", "broadcast_in_dim", "squeeze", "rev",
    "concatenate", "slice", "dynamic_slice", "dynamic_update_slice",
    "pad", "gather", "scatter", "convert_element_type", "copy", "split",
    "expand_dims", "iota", "select_n", "as_strided", "contiguous",
    "zeros", "ones", "full", "empty", "zeros_like", "ones_like",
    "full_like", "empty_like", "empty_strided", "new_zeros", "new_ones",
    "new_full", "new_empty", "new_empty_strided", "fill", "zero",
    "scalar_tensor", "lift_fresh_copy", "embedding_dense_backward",
    "one_hot", "masked_fill", "index_add", "scatter_add",
}

#: ops priced as reductions (one FLOP per input element)
_REDUCTIONS = {
    "reduce_sum", "reduce_max", "reduce_min", "reduce_prod", "reduce_or",
    "reduce_and", "argmax", "argmin", "mean", "var", "std", "var_mean",
    "std_mean", "logsumexp", "norm", "linalg_vector_norm", "max", "min",
    "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "cumsum", "cumprod", "cummax", "cummin",
    "logcumsumexp", "native_batch_norm", "native_layer_norm",
    "nll_loss_forward", "nll_loss_backward",
}

_MATMUL = {"mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot"}

#: the port's kernels as dispatcher ops, each one tracked op a call
KERNEL_OPS = ("repro_torch::flash_attention", "repro_torch::ssd")


def packet_name(func) -> str:
    """The aten overload packet's name: ``aten.add_.Tensor`` -> ``add_``."""
    return func.overloadpacket.__name__


def prim_name(func) -> str:
    """The reference's primitive name for an aten op where one exists
    (``aten.add`` -> ``add``, ``aten.sum`` -> ``reduce_sum``, ``aten.mm``
    -> ``dot_general``), else the aten name; in-place ops price as their
    out-of-place forms.  ``max``/``min`` are reductions with one operand
    and elementwise with two, as in the reference."""
    name = packet_name(func)
    if getattr(func, "namespace", None) == "repro_torch":
        return f"repro_torch::{name}"
    if name.endswith("_") and not name.startswith("_"):
        name = name[:-1]
    return _PRIM_NAMES.get(name, name)


def tensors_of(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in tensors_of(v)]
    return []


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _in_out_bytes(args, out) -> Tuple[float, float]:
    return (float(sum(tensor_bytes(t) for t in tensors_of(args))),
            float(sum(tensor_bytes(t) for t in tensors_of(out))))


def _matmul_dims(name: str, args) -> Tuple[int, int, int, int]:
    """(b, m, n, k) of a matmul-like aten call."""
    if name in ("addmm", "baddbmm", "addmv"):
        args = args[1:]
    a, b = args[0], args[1]
    if name in ("bmm", "baddbmm"):
        return a.shape[0], a.shape[1], b.shape[2], a.shape[2]
    if name in ("mv", "addmv"):
        return 1, a.shape[0], 1, a.shape[1]
    if name == "dot":
        return 1, 1, 1, a.shape[0]
    return 1, a.shape[0], b.shape[1], a.shape[1]


def conv_reduction(weight: torch.Tensor, transposed: bool,
                   groups: int) -> int:
    """Reduction per output element of a convolution, counted as the
    reference counts it: the kernel's size over its output channels (a
    transposed convolution's kernel is the forward kernel of the
    convolution it transposes, so its output channels are
    ``weight.shape[1] * groups``)."""
    out_ch = weight.shape[1] * groups if transposed else weight.shape[0]
    return weight.numel() // max(out_ch, 1)


def _conv_cost(args, out) -> Tuple[OpCost, Dict[str, int]]:
    x, w = args[0], args[1]
    transposed, groups = bool(args[6]), int(args[8])
    red = conv_reduction(w, transposed, groups)
    flops = 2.0 * out.numel() * red / max(groups, 1)
    rd, wr = _in_out_bytes(args[:3], out)
    return OpCost(flops, rd, wr), {"out_size": out.numel(), "red": red}


def conv_grad_costs(args, out) -> List[Tuple[str, OpCost, Dict[str, int]]]:
    """``[(which, cost, cparams)]`` for each gradient an
    ``aten.convolution_backward(grad_out, input, weight, bias_sizes,
    stride, padding, dilation, transposed, output_padding, groups,
    output_mask)`` call computes, ``which`` in ``input``, ``weight``,
    ``bias``.  Each is priced as the convolution the reference runs for
    it: the grad input as ``2 · its size · weight size / its channels /
    groups``, the grad weight as ``2 · its size · batch·H'·W'`` (H', W'
    the grad output's), the grad bias as a sum over the grad output."""
    go, x, w = args[0], args[1], args[2]
    groups, mask = int(args[9]), list(args[10])
    grad_in, grad_w, grad_b = out
    costs = []
    if mask[0] and grad_in is not None:
        red = w.numel() // max(x.shape[1], 1)
        costs.append(("input", OpCost(
            2.0 * grad_in.numel() * red / max(groups, 1),
            float(tensor_bytes(go) + tensor_bytes(w)),
            float(tensor_bytes(grad_in))), {"out_size": grad_in.numel(),
                                            "red": red}))
    if mask[1] and grad_w is not None:
        red = go.numel() // max(go.shape[1], 1)
        costs.append(("weight", OpCost(
            2.0 * grad_w.numel() * red,
            float(tensor_bytes(x) + tensor_bytes(go)),
            float(tensor_bytes(grad_w))), {"out_size": grad_w.numel(),
                                           "red": red}))
    if len(mask) > 2 and mask[2] and grad_b is not None:
        costs.append(("bias", OpCost(
            float(go.numel()), float(tensor_bytes(go)),
            float(tensor_bytes(grad_b))), {}))
    return costs


def flash_attention_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: int,
                         q_offset: int = 0) -> OpCost:
    """One flash-attention call: 4 D FLOPs per allowed (query, key) pair
    per head (q.k and p.v), counted under the causal mask and the window
    with query row r at position ``q_offset + r`` (so a query chunk counts
    the work its shard does); q, k, v read once and o (q's shape and
    dtype) written once."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    i = q_offset + torch.arange(sq, dtype=torch.float64)
    hi = torch.clamp(i, max=skv - 1) if causal else \
        torch.full((sq,), skv - 1.0, dtype=torch.float64)
    lo = torch.clamp(i - window + 1, min=0) if window > 0 else \
        torch.zeros(sq, dtype=torch.float64)
    pairs = float(torch.clamp(hi - lo + 1, min=0).sum())
    return OpCost(4.0 * b * h * d * pairs,
                  float(tensor_bytes(q) + tensor_bytes(k) + tensor_bytes(v)),
                  float(tensor_bytes(q)))


def ssd_flop_terms(l: int, n: int, p: int, chunk: int
                   ) -> Tuple[float, float, float]:
    """FLOPs of one (batch, head) of an SSD scan in chunks of ``chunk``
    rows, in three parts: over chunks of r rows, r(r+1) N for the causal
    scores c b^T; r(r+1) P for their product with x plus 4 L N P for the
    readout and rank-1 update against the carried state; N P for the
    state's decay once a chunk."""
    rows = [chunk] * (l // chunk) + ([l % chunk] if l % chunk else [])
    pairs = float(sum(r * (r + 1) for r in rows))
    return pairs * n, pairs * p + 4.0 * l * n * p, float(len(rows) * n * p)


def ssd_cost(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, chunk: int) -> OpCost:
    """One SSD scan at the kernel's ``chunk``: the FLOPs of
    :func:`ssd_flop_terms` for every (batch, head); x, dt, a, b and c read
    once (b and c once for all heads where they are a head-broadcast
    view), y and the final state (fp32) written once."""
    b, h, l, p = x.shape
    n = bmat.shape[-1]
    flops = b * h * sum(ssd_flop_terms(l, n, p, chunk))
    heads = 1 if bmat.stride(1) == 0 else h
    read = (tensor_bytes(x) + dt.numel() * 4 + a.numel() * 4
            + 2 * b * heads * l * n * bmat.element_size())
    return OpCost(flops, float(read), float(b * h * (l + n) * p * 4))


_KERNEL_COSTS = {
    "repro_torch::flash_attention": lambda args: flash_attention_cost(
        *args[:3], bool(args[3]), int(args[4]),
        int(args[5]) if len(args) > 5 else 0),   # q_offset, default 0
    "repro_torch::ssd": lambda args: ssd_cost(*args[:5], int(args[5])),
}


def op_cost(func, args: Sequence[Any], out) -> Tuple[OpCost, Dict[str, Any]]:
    """Cost of one aten call (``convolution_backward`` goes through
    :func:`conv_grad_costs`, one entry per gradient).  Returns the cost
    and the reference's raw cost params: ``b``, ``m``, ``n``, ``k`` for a
    matmul, ``out_size`` and ``red`` for a convolution, else none."""
    pkt = packet_name(func)
    name = prim_name(func)
    if name in _KERNEL_COSTS:
        return _KERNEL_COSTS[name](args), {}
    if pkt in _MATMUL or pkt.rstrip("_") in _MATMUL:
        b, m, n, k = _matmul_dims(pkt.rstrip("_"), args)
        rd, wr = _in_out_bytes(args, out)
        return (OpCost(2.0 * b * m * n * k, rd, wr),
                {"b": b, "m": m, "n": n, "k": k})
    if pkt == "convolution":
        return _conv_cost(args, out)
    rd, wr = _in_out_bytes(args, out)
    if name in _MOVEMENT:
        return OpCost(0.0, rd, wr), {}
    ins = tensors_of(args)
    if name in _REDUCTIONS and not (name in ("max", "min") and
                                    len(ins) > 1):
        return OpCost(float(sum(t.numel() for t in ins)), rd, wr), {}
    if name == "sort":
        n = max((t.numel() for t in ins), default=1)
        return OpCost(float(n) * max(math.log2(max(n, 2)), 1.0), rd, wr), {}
    if name == "pow" and len(ins) == 1 and isinstance(args[1], int):
        name = "square" if args[1] == 2 else "integer_pow"
    weight = _ELEMENTWISE_WEIGHT.get(name, 1)
    return (OpCost(float(weight * sum(t.numel() for t in tensors_of(out))),
                   rd, wr), {})
