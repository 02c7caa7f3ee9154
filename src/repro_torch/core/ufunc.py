"""Universal-function registry (paper §5.3) — the single dispatch table.

A ufunc is a vectorized scalar function applied independently to every
element of the involved array-views; the engine translates a ufunc
application into per-sub-view-block operations.  ``cost`` is the relative
per-element compute weight used by the timeline model (memory-bound ufuncs
≈ 1, transcendentals higher — calibrated against NumPy throughput ratios).

Every primitive is registered once here and every consumer derives from
this table:

* the NumPy array protocol on :class:`~repro_torch.core.darray.DistArray`
  resolves ``np.add`` → :data:`NP_TO_UFUNC` → :class:`UFunc`;
* ``repro_torch.core.darray`` generates its module-level functions from
  :data:`UFUNCS`;
* block payloads run on tensors: :func:`apply_ufunc` evaluates a
  primitive (or, via :func:`eval_tree`, a fused expression tree) with
  the torch implementation in :data:`TORCH_IMPLS`, and
  :func:`torch_reduce` runs the reductions of :data:`_REDUCE_NP`.

The user-facing model stays NumPy, so every payload computes in the
dtype NumPy would choose for the same operands: each primitive's loop
dtypes come from the NumPy ufunc's own type resolution
(``np.ufunc.resolve_dtypes``, NEP 50 scalar rules), the tensor operands
are cast to them, and the torch op runs in that dtype.  Torch's own
promotion differs on scalars (``float32 * np.float64(c)`` is float64 in
NumPy, float32 in torch), so it is never relied on.  Every primitive has
a torch form; an unknown name raises.

``out_dtype`` carries a fixed result dtype for primitives whose output
dtype is not the promoted input dtype — the comparisons return
``bool``, exactly as NumPy's do.  The timeline cost model is untouched
by dtype routing (costs stay per-element).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

__all__ = [
    "UFunc",
    "UFUNCS",
    "NP_TO_UFUNC",
    "TORCH_IMPLS",
    "get_ufunc",
    "result_dtype",
    "eval_tree",
    "apply_ufunc",
    "torch_reduce",
    "to_torch_dtype",
    "to_numpy_dtype",
    "loop_dtypes",
    "operand_key",
]


@dataclass(frozen=True)
class UFunc:
    name: str
    fn: Callable
    nin: int
    cost: float = 1.0  # relative per-element cost vs. a copy
    reduceable: bool = False
    # fused ufuncs carry their expression tree (see eval_tree) so that
    # block payloads re-trace the expression with the torch primitives
    # instead of calling the opaque NumPy closure.
    tree: object = None
    # fixed result dtype (e.g. bool for comparisons); None means NumPy
    # promotion of the input dtypes
    out_dtype: object = None

    def __call__(self, *args):
        return self.fn(*args)


def result_dtype(ufunc: "UFunc", dtypes) -> np.dtype:
    """Result dtype of applying ``ufunc`` to operands of ``dtypes`` —
    the ufunc's fixed ``out_dtype`` if it has one, NumPy promotion
    otherwise."""
    if ufunc.out_dtype is not None:
        return np.dtype(ufunc.out_dtype)
    return np.result_type(*dtypes)


def eval_tree(spec, arrays, impl: Callable[["UFunc"], Callable]):
    """Evaluate a fused-expression spec tree.

    ``spec`` nodes are ``("leaf", i)`` (the i-th input array),
    ``("const", v)`` (a scalar), or ``(UFunc, (subspec, ...))``.  ``impl``
    maps each primitive :class:`UFunc` to a callable — ``lambda u: u.fn``
    reproduces the NumPy semantics on ndarrays; ``lambda u:
    functools.partial(apply_ufunc, u)`` runs the same tree on tensors."""
    tag = spec[0]
    if tag == "leaf":
        return arrays[spec[1]]
    if tag == "const":
        return spec[1]
    f, subs = spec
    return impl(f)(*[eval_tree(s, arrays, impl) for s in subs])


UFUNCS: dict[str, UFunc] = {}

# NumPy ufunc object -> our UFunc: the table behind DistArray's
# ``__array_ufunc__`` (np.add(a, b) records uf.add lazily)
NP_TO_UFUNC: dict[np.ufunc, UFunc] = {}

# our UFunc name -> the NumPy ufunc whose type resolution decides the
# payload's compute dtype (identity and where are not np.ufuncs)
_NP_UFUNC: dict[str, np.ufunc] = {}


def _reg(
    name,
    fn,
    nin,
    cost=1.0,
    reduceable=False,
    np_ufunc: Optional[np.ufunc] = None,
    out_dtype=None,
):
    uf = UFunc(name, fn, nin, cost, reduceable, out_dtype=out_dtype)
    UFUNCS[name] = uf
    if np_ufunc is not None:
        NP_TO_UFUNC[np_ufunc] = uf
        _NP_UFUNC[name] = np_ufunc
    return uf


identity = _reg("identity", lambda x: x, 1, 1.0)
add = _reg("add", np.add, 2, 1.0, reduceable=True, np_ufunc=np.add)
subtract = _reg("subtract", np.subtract, 2, 1.0, np_ufunc=np.subtract)
multiply = _reg("multiply", np.multiply, 2, 1.0, reduceable=True, np_ufunc=np.multiply)
divide = _reg("divide", np.divide, 2, 2.0, np_ufunc=np.divide)
power = _reg("power", np.power, 2, 8.0, np_ufunc=np.power)
negative = _reg("negative", np.negative, 1, 1.0, np_ufunc=np.negative)
absolute = _reg("absolute", np.absolute, 1, 1.0, np_ufunc=np.absolute)
exp = _reg("exp", np.exp, 1, 4.0, np_ufunc=np.exp)
log = _reg("log", np.log, 1, 4.0, np_ufunc=np.log)
sqrt = _reg("sqrt", np.sqrt, 1, 2.0, np_ufunc=np.sqrt)
square = _reg("square", np.square, 1, 1.0, np_ufunc=np.square)
maximum = _reg("maximum", np.maximum, 2, 1.0, reduceable=True, np_ufunc=np.maximum)
minimum = _reg("minimum", np.minimum, 2, 1.0, reduceable=True, np_ufunc=np.minimum)
greater = _reg("greater", np.greater, 2, 1.0, np_ufunc=np.greater, out_dtype=np.bool_)
less = _reg("less", np.less, 2, 1.0, np_ufunc=np.less, out_dtype=np.bool_)
where = _reg("where", np.where, 3, 1.0)  # np.where is not a np.ufunc

_REDUCE_INIT = {"add": 0.0, "multiply": 1.0, "maximum": -np.inf, "minimum": np.inf}
_REDUCE_NP = {
    "add": np.add.reduce,
    "multiply": np.multiply.reduce,
    "maximum": np.maximum.reduce,
    "minimum": np.minimum.reduce,
}


def get_ufunc(name: str) -> UFunc:
    return UFUNCS[name]


def reduce_fn(name: str):
    return _REDUCE_NP[name]


# ---------------------------------------------------------------------------
# torch implementations of the primitives
# ---------------------------------------------------------------------------

# every primitive registered above has exactly one entry; operands arrive
# already cast to NumPy's loop dtype (see apply_ufunc)
TORCH_IMPLS: dict[str, Callable] = {
    "identity": lambda x: x,
    "add": torch.add,
    "subtract": torch.sub,
    "multiply": torch.mul,
    "divide": torch.div,
    "power": torch.pow,
    "negative": torch.neg,
    "absolute": torch.abs,
    "exp": torch.exp,
    "log": torch.log,
    "sqrt": torch.sqrt,
    "square": torch.square,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "greater": torch.gt,
    "less": torch.lt,
    "where": torch.where,
}

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}
_TORCH_TO_NP = {t: n for n, t in _NP_TO_TORCH.items()}


def to_torch_dtype(dtype) -> torch.dtype:
    """The torch dtype holding blocks of NumPy dtype ``dtype``."""
    try:
        return _NP_TO_TORCH[np.dtype(dtype)]
    except KeyError:
        raise TypeError(f"dtype {np.dtype(dtype)} has no torch counterpart") from None


def to_numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The NumPy dtype of a block tensor's torch ``dtype``."""
    return _TORCH_TO_NP[dtype]


def operand_key(x):
    """What NumPy's type resolution sees of one operand: a tensor's
    dtype, a NumPy scalar's dtype (strong), or a Python int/float/complex
    type (weak, NEP 50).  Python bools resolve as ``np.bool_``."""
    if isinstance(x, torch.Tensor):
        return _TORCH_TO_NP[x.dtype]
    if isinstance(x, np.generic):
        return x.dtype
    if isinstance(x, bool):
        return np.dtype(np.bool_)
    if isinstance(x, (int, float, complex)):
        return type(x)
    raise TypeError(f"unsupported payload operand {type(x).__name__}")


@functools.lru_cache(maxsize=4096)
def loop_dtypes(name: str, keys: tuple) -> tuple:
    """NumPy's (input dtypes, output dtype) for primitive ``name`` on
    operands described by ``keys``."""
    if name == "where":
        # np.where(c, x, y): c as bool, x and y promoted together
        common = np.result_type(*keys[1:])
        return (np.dtype(np.bool_), common, common), common
    if name == "identity":
        k = keys[0]
        dt = k if isinstance(k, np.dtype) else np.result_type(k)
        return (dt,), dt
    npu = _NP_UFUNC.get(name)
    if npu is None:
        raise KeyError(f"ufunc {name!r} has no torch implementation")
    dts = npu.resolve_dtypes(tuple(keys) + (None,) * npu.nout)
    return tuple(dts[: npu.nin]), dts[npu.nin]


def _operand(x, np_dtype: np.dtype) -> torch.Tensor:
    td = _NP_TO_TORCH[np_dtype]
    if isinstance(x, torch.Tensor):
        return x if x.dtype == td else x.to(td)
    # a scalar becomes a 0-d CPU tensor of the loop dtype: torch hands
    # such a tensor to a kernel on any device as a plain value (no
    # host-to-device copy), and with every operand in the loop dtype the
    # op computes in exactly that dtype
    return torch.tensor(x, dtype=td)


def apply_ufunc(ufunc: UFunc, *args):
    """Apply primitive ``ufunc`` to tensors and scalars in NumPy's loop
    dtype.  Returns a tensor when any operand is one, else the NumPy
    scalar NumPy itself would return."""
    try:
        impl = TORCH_IMPLS[ufunc.name]
    except KeyError:
        raise KeyError(f"ufunc {ufunc.name!r} has no torch implementation") from None
    if not any(isinstance(a, torch.Tensor) for a in args):
        return ufunc.fn(*args)  # scalars only: a folded constant expression
    in_dts, out_dt = loop_dtypes(ufunc.name, tuple(operand_key(a) for a in args))
    res = impl(*[_operand(a, d) for a, d in zip(args, in_dts)])
    return _operand(res, out_dt)


def _torch_impl(u: UFunc):
    return functools.partial(apply_ufunc, u)


def eval_ufunc(ufunc: UFunc, args):
    """Evaluate a primitive or fused ufunc on tensors/scalars."""
    if ufunc.tree is not None:
        return eval_tree(ufunc.tree, args, _torch_impl)
    return apply_ufunc(ufunc, *args)


def torch_reduce(name: str, x: torch.Tensor, axes: Optional[tuple], keepdims: bool):
    """``np.<name>.reduce(x, axis=axes, keepdims=keepdims)`` on a tensor
    (``axes=None`` reduces every axis).  Sums and products of bools and
    small integers accumulate in int64, as NumPy's do."""
    if name not in _REDUCE_NP:
        raise KeyError(f"reduction {name!r} has no torch implementation")
    dims = tuple(range(x.ndim)) if axes is None else tuple(axes)
    if not dims:
        return x.clone()
    if name == "add":
        return torch.sum(x, dim=dims, keepdim=keepdims)
    if name == "maximum":
        return torch.amax(x, dim=dims, keepdim=keepdims)
    if name == "minimum":
        return torch.amin(x, dim=dims, keepdim=keepdims)
    # multiply: torch.prod takes one dim at a time (highest first, so the
    # remaining dim indices stay valid)
    for d in sorted(dims, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdims)
    return x
