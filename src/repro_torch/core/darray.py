"""User-facing distributed arrays — the DistNumPy API surface (paper §5).

``array(..., dist=True)`` etc. mirror the paper's only API difference from
NumPy.  All operations on :class:`DistArray` are recorded lazily into the
active :class:`~repro_torch.core.engine.Runtime`; reading data back (``__array__``,
``item``, comparisons) triggers an operation flush (§5.6) — under
``sync="demand"`` a *partial* one, draining only the reader's dependency
cone, with :meth:`DistArray.evaluate` / :meth:`DistArray.block_until_ready`
as the explicit JAX-style spellings.

The paper's central promise — *no user-visible change to the NumPy
programming model* — is carried by the NumPy array protocols:
:class:`DistArray` (and :class:`Expr`) implement ``__array_ufunc__``,
``__array_function__`` and ``__array_priority__``, so plain
``np.add(a, b)``, ``np.exp(a)``, ``np.sum(a, axis=0)``, ``np.matmul``,
``np.where`` and ``np.roll`` record lazily into the active runtime.  The
ufunc registry in :mod:`repro_torch.core.ufunc` is the single dispatch table
(NumPy ufunc → :class:`UFunc` → backend impl); the module-level
functions here (``add``, ``exp``, …) are generated from it.

When the runtime is created with ``fusion=True``, elementwise expressions
build :class:`Expr` trees that are merged into a single joint operation at
materialization — the paper's §7 "merge calls to ufuncs" future work,
implemented here as a beyond-paper optimization.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from . import ufunc as uf
from .blocks import ViewSpec
from .engine import ArrayBase, Runtime, current_runtime
from .ufunc import UFunc

Scalar = (int, float, complex, bool, np.integer, np.floating, np.complexfloating, np.bool_)


def _coerce_operand(x):
    """Normalize one user-supplied operand: DistArray/Expr/scalar pass
    through, host ndarrays are scattered into a DistArray, 0-d arrays
    become scalars.  Returns None for unsupported types."""
    if isinstance(x, (DistArray, Expr)) or isinstance(x, Scalar):
        return x
    if isinstance(x, np.ndarray):
        if x.ndim == 0:
            return x[()]
        return array(x)
    if isinstance(x, (list, tuple)):
        return array(np.asarray(x))
    return None


def _as_operand(x):
    """DistArray -> (base, view); Expr -> materialized temp; scalar -> tag."""
    if isinstance(x, DistArray):
        return (x._base, x._view)
    if isinstance(x, Expr):
        return _as_operand(x.materialize())
    if isinstance(x, Scalar):
        return ("c", x)
    raise TypeError(f"unsupported operand {type(x)}")


def _result_meta(ufn: Optional[UFunc], args) -> tuple[tuple[int, ...], np.dtype]:
    """(broadcast shape, result dtype) of applying ``ufn`` to ``args``;
    the ufunc's fixed ``out_dtype`` (comparisons -> bool) overrides NumPy
    promotion."""
    shapes, dtypes = [], []
    for a in args:
        if isinstance(a, (DistArray, Expr)):
            shapes.append(a.shape)
            dtypes.append(a.dtype)
        else:
            dtypes.append(np.dtype(type(a)) if not isinstance(a, complex) else np.dtype(complex))
    shape = np.broadcast_shapes(*shapes) if shapes else ()
    if ufn is not None and ufn.out_dtype is not None:
        dtype = np.dtype(ufn.out_dtype)
    else:
        dtype = np.result_type(*dtypes)
    return tuple(shape), dtype


# ---------------------------------------------------------------------------
# NumPy protocol dispatch (shared by DistArray and Expr)
# ---------------------------------------------------------------------------

# np functions that are not np.ufuncs dispatch through
# ``__array_function__``; handlers registered below with @_implements
_HANDLED_FUNCTIONS: dict = {}


def _implements(*np_funcs):
    def deco(fn):
        for f in np_funcs:
            _HANDLED_FUNCTIONS[f] = fn
        return fn

    return deco


# ufunc.reduce method -> the engine's reduceable ufunc name
_REDUCE_UFUNCS = {np.add: "add", np.minimum: "minimum", np.maximum: "maximum"}


def _array_ufunc(self, ufunc, method, *inputs, **kwargs):
    """Shared ``__array_ufunc__``: resolve the NumPy ufunc through the
    registry (ufunc.py is the single dispatch table) and record lazily."""
    out = kwargs.pop("out", None)
    if method == "__call__":
        if ufunc is np.matmul:
            if kwargs or out is not None:
                return NotImplemented
            a, b = (_coerce_operand(x) for x in inputs)
            if a is None or b is None:
                return NotImplemented
            return matmul(a, b)
        u = uf.NP_TO_UFUNC.get(ufunc)
        if u is None or kwargs:
            return NotImplemented
        args = [_coerce_operand(x) for x in inputs]
        if any(a is None for a in args):
            return NotImplemented
        if out is not None:
            target = out[0] if isinstance(out, tuple) else out
            if not isinstance(target, DistArray) or (
                isinstance(out, tuple) and len(out) != 1
            ):
                return NotImplemented
            rt = current_runtime()
            if rt.fusion:
                Expr(u, tuple(args)).materialize(out=target)
            else:
                rt.record_map(
                    u, (target._base, target._view), [_as_operand(a) for a in args]
                )
            return target
        return _apply(u, *args)
    if method == "reduce":
        name = _REDUCE_UFUNCS.get(ufunc)
        axis = kwargs.pop("axis", 0)
        keepdims = kwargs.pop("keepdims", False)
        if name is None or out is not None or kwargs.pop("dtype", None) is not None:
            return NotImplemented
        if kwargs:
            return NotImplemented
        (a,) = inputs
        a = a.materialize() if isinstance(a, Expr) else a
        return a._reduce(name, axis, keepdims)
    return NotImplemented


def _array_function(self, func, types, args, kwargs):
    impl = _HANDLED_FUNCTIONS.get(func)
    if impl is None:
        return NotImplemented
    return impl(*args, **kwargs)


class Expr:
    """Unevaluated elementwise expression (fusion mode)."""

    __slots__ = ("ufunc", "args", "shape", "dtype")

    __array_priority__ = 1000.0
    __array_ufunc__ = _array_ufunc
    __array_function__ = _array_function

    def __init__(self, ufunc: UFunc, args: tuple):
        self.ufunc = ufunc
        self.args = args
        self.shape, self.dtype = _result_meta(ufunc, args)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    # -- fusion ---------------------------------------------------------
    def _collect(self, leaves: list) -> object:
        """Return a spec tree of ('leaf', idx) / ('const', v) / (ufunc, specs)."""
        specs = []
        for a in self.args:
            if isinstance(a, Expr):
                specs.append(a._collect(leaves))
            elif isinstance(a, DistArray):
                leaves.append(a)
                specs.append(("leaf", len(leaves) - 1))
            else:
                specs.append(("const", a))
        return (self.ufunc, tuple(specs))

    def _cost_parts(self) -> tuple[int, float]:
        """(#ops, heavy-compute surplus) of the tree."""
        n, heavy = 1, max(0.0, self.ufunc.cost - 1.0)
        for a in self.args:
            if isinstance(a, Expr):
                sn, sh = a._cost_parts()
                n += sn
                heavy += sh
        return n, heavy

    def fused_cost(self, n_leaves: int) -> float:
        """Per-element cost of the fused op.  Plain ufunc chains are
        memory-bound: a chain of k binary ufuncs moves ~3k·N bytes
        (2 reads + 1 write each), the fused version (L+1)·N — that ratio is
        the fusion win (HBM round-trip avoidance on TPU).  Heavy
        (transcendental) compute stays additive."""
        _, heavy = self._cost_parts()
        return max(1.0, (n_leaves + 1) / 3.0) + heavy

    def materialize(self, out: Optional["DistArray"] = None) -> "DistArray":
        """Record ONE joint operation for the whole tree (§7 fusion)."""
        rt = current_runtime()
        leaves: list[DistArray] = []
        spec = self._collect(leaves)
        if out is not None and any(l._base is out._base for l in leaves):
            # output aliases an input base: a single joint operation would
            # let one fragment's write race another fragment's read.  Go
            # through a fresh temporary (same rule NumPy's ufuncs need).
            tmp = self.materialize(None)
            rt.record_map(
                uf.identity, (out._base, out._view), [(tmp._base, tmp._view)]
            )
            return out

        def run(*arrays):
            return uf.eval_tree(spec, arrays, lambda u: u.fn)

        fused = UFunc(
            name=f"fused[{self.ufunc.name}x{len(leaves)}]",
            fn=run,
            nin=len(leaves),
            cost=self.fused_cost(len(leaves)),
            tree=spec,
        )
        if out is None:
            out = empty(self.shape, dtype=self.dtype)
        rt.record_map(fused, (out._base, out._view), [(l._base, l._view) for l in leaves])
        return out

    # -- readback (materialize + gather) ----------------------------------
    def __array__(self, dtype=None, copy=None):
        return self.materialize().__array__(dtype)

    def evaluate(self):
        """Materialize the tree and start draining its cone without
        blocking (see :meth:`DistArray.evaluate`)."""
        from repro_torch.api.futures import evaluate as _evaluate

        return _evaluate(self)

    # -- reductions (np.sum(expr) etc. land here via the protocols) --------
    def _reduce(self, name: str, axis, keepdims: bool) -> "DistArray":
        return self.materialize()._reduce(name, axis, keepdims)

    def sum(self, axis=None, keepdims=False):
        return self._reduce("add", axis, keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce("minimum", axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self._reduce("maximum", axis, keepdims)

    # -- operator sugar (mirrors DistArray) -------------------------------
    def __add__(self, o):
        return _apply(uf.add, self, o)

    def __radd__(self, o):
        return _apply(uf.add, o, self)

    def __sub__(self, o):
        return _apply(uf.subtract, self, o)

    def __rsub__(self, o):
        return _apply(uf.subtract, o, self)

    def __mul__(self, o):
        return _apply(uf.multiply, self, o)

    def __rmul__(self, o):
        return _apply(uf.multiply, o, self)

    def __truediv__(self, o):
        return _apply(uf.divide, self, o)

    def __rtruediv__(self, o):
        return _apply(uf.divide, o, self)

    def __neg__(self):
        return _apply(uf.negative, self)

    def __pow__(self, o):
        return _apply(uf.power, self, o)


def _apply(ufn: UFunc, *args) -> Union["DistArray", Expr]:
    """Apply a ufunc: build an Expr in fusion mode, else record immediately
    into a fresh temporary (DistNumPy behaviour)."""
    coerced = []
    for a in args:
        c = _coerce_operand(a)
        if c is None:
            raise TypeError(f"unsupported operand {type(a)} for {ufn.name}")
        coerced.append(c)
    args = tuple(coerced)
    rt = current_runtime()
    if rt.fusion:
        return Expr(ufn, args)
    shape, dtype = _result_meta(ufn, args)
    out = empty(shape, dtype=dtype)
    rt.record_map(ufn, (out._base, out._view), [_as_operand(a) for a in args])
    return out


class DistArray:
    """An array-view over an array-base (paper §5.1)."""

    __slots__ = ("_base", "_view", "_rt")

    # NumPy defers to us for mixed ndarray/DistArray expressions, and
    # np.<ufunc>/np.<function> calls dispatch through the protocols.
    __array_priority__ = 1000.0
    __array_ufunc__ = _array_ufunc
    __array_function__ = _array_function

    def __init__(self, base: ArrayBase, view: ViewSpec, rt: Runtime):
        self._base = base
        self._view = view
        self._rt = rt

    # -- metadata ----------------------------------------------------------
    @property
    def shape(self) -> tuple[int, ...]:
        return self._view.vshape

    @property
    def ndim(self) -> int:
        return self._view.ndim

    @property
    def dtype(self) -> np.dtype:
        return self._base.dtype

    @property
    def size(self) -> int:
        return self._view.size

    def __repr__(self):
        return f"DistArray(shape={self.shape}, dtype={self.dtype}, base={self._base.id})"

    # -- views (§5.1: flat two-level hierarchy) ------------------------------
    def _normalize_key(self, key) -> tuple[slice, ...]:
        if not isinstance(key, tuple):
            key = (key,)
        out = []
        it = iter(key)
        for k in it:
            if k is Ellipsis:
                n_rest = sum(1 for x in key if x is not Ellipsis and x is not None)
                out.extend([slice(None)] * (self.ndim - n_rest - len(out)))
                continue
            if isinstance(k, int):
                L = self._view.vshape[len(out)]
                if k < 0:
                    k += L
                out.append(slice(k, k + 1))
            elif isinstance(k, slice):
                out.append(k)
            else:
                raise TypeError(f"unsupported index {k!r}")
        while len(out) < self.ndim:
            out.append(slice(None))
        return tuple(out)

    def __getitem__(self, key) -> "DistArray":
        view = self._view.compose_slice(self._normalize_key(key))
        return DistArray(self._base, view, self._rt)

    def __setitem__(self, key, value) -> None:
        target = self[key]
        tgt = (target._base, target._view)
        if isinstance(value, Expr):
            value.materialize(out=target)
        elif isinstance(value, DistArray):
            if value._base is target._base and value._view != target._view:
                value = value.copy()  # overlapping self-assignment: snapshot
            self._rt.record_map(uf.identity, tgt, [(value._base, value._view)])
        elif isinstance(value, Scalar):
            self._rt.record_fill(tgt, value)
        elif isinstance(value, np.ndarray):
            tmp = array(value)
            self._rt.record_map(uf.identity, tgt, [(tmp._base, tmp._view)])
        else:
            raise TypeError(f"unsupported assignment {type(value)}")

    def copy(self) -> "DistArray":
        out = empty(self.shape, dtype=self.dtype)
        self._rt.record_map(uf.identity, (out._base, out._view), [_as_operand(self)])
        return out

    # -- arithmetic -----------------------------------------------------------
    def __add__(self, o):
        return _apply(uf.add, self, o)

    def __radd__(self, o):
        return _apply(uf.add, o, self)

    def __sub__(self, o):
        return _apply(uf.subtract, self, o)

    def __rsub__(self, o):
        return _apply(uf.subtract, o, self)

    def __mul__(self, o):
        return _apply(uf.multiply, self, o)

    def __rmul__(self, o):
        return _apply(uf.multiply, o, self)

    def __truediv__(self, o):
        return _apply(uf.divide, self, o)

    def __rtruediv__(self, o):
        return _apply(uf.divide, o, self)

    def __pow__(self, o):
        return _apply(uf.power, self, o)

    def __neg__(self):
        return _apply(uf.negative, self)

    def __matmul__(self, o):
        return matmul(self, o)

    def __iadd__(self, o):
        self._rt.record_map(
            uf.add, (self._base, self._view), [_as_operand(self), _as_operand(o)]
        )
        return self

    def __isub__(self, o):
        self._rt.record_map(
            uf.subtract, (self._base, self._view), [_as_operand(self), _as_operand(o)]
        )
        return self

    def __imul__(self, o):
        self._rt.record_map(
            uf.multiply, (self._base, self._view), [_as_operand(self), _as_operand(o)]
        )
        return self

    # -- reductions --------------------------------------------------------
    def _reduce(self, name: str, axis, keepdims: bool) -> "DistArray":
        nd = self.ndim
        if axis is None:
            axes = tuple(range(nd))
        elif isinstance(axis, int):
            axes = (axis % nd,)
        else:
            axes = tuple(a % nd for a in axis)
        if keepdims:
            oshape = tuple(1 if d in axes else s for d, s in enumerate(self.shape))
        else:
            oshape = tuple(s for d, s in enumerate(self.shape) if d not in axes)
        # NumPy promotes bool sums to integer counts (np.sum(a > x) is the
        # counting idiom); min/max of bools stay bool
        rdtype = self.dtype
        if rdtype == np.bool_ and name == "add":
            rdtype = np.dtype(np.int64)
        out = empty(oshape, dtype=rdtype)
        self._rt.record_reduce(
            name, (out._base, out._view), (self._base, self._view), axes, keepdims
        )
        return out

    def sum(self, axis=None, keepdims=False):
        return self._reduce("add", axis, keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce("minimum", axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self._reduce("maximum", axis, keepdims)

    # -- demand-driven evaluation (futures surface) ---------------------------
    def evaluate(self) -> "object":
        """Start draining this array's dependency cone without blocking;
        returns a :class:`repro_torch.api.futures.ArrayFuture` (JAX-style
        async dispatch — recording continues while workers drain)."""
        from repro_torch.api.futures import evaluate as _evaluate

        return _evaluate(self)

    def block_until_ready(self) -> "DistArray":
        """Block until every pending operation this array depends on has
        executed (its dependency cone under ``sync="demand"``, the whole
        graph under ``sync="barrier"``); returns self, JAX-style."""
        return self.evaluate().block_until_ready()

    # -- readback (flush triggers, §5.6) -------------------------------------
    def __array__(self, dtype=None, copy=None):
        arr = self._rt.gather(self._base, self._view)
        return arr.astype(dtype) if dtype is not None else arr

    def to_numpy(self) -> np.ndarray:
        return self.__array__()

    def item(self) -> float:
        return self.__array__().reshape(-1)[0].item()

    def __float__(self):
        return float(self.item())

    def __bool__(self):
        return bool(self.__array__().all())

    def _cmp_scalar(self, other, op):
        return op(float(self), float(other))

    def __lt__(self, other):
        if self.size == 1 and isinstance(other, Scalar + (DistArray,)):
            return self._cmp_scalar(other, lambda a, b: a < b)
        return _apply(uf.less, self, other)

    def __gt__(self, other):
        if self.size == 1 and isinstance(other, Scalar + (DistArray,)):
            return self._cmp_scalar(other, lambda a, b: a > b)
        return _apply(uf.greater, self, other)


# ---------------------------------------------------------------------------
# creation routines (the paper's only API delta: ``dist=`` flag)
# ---------------------------------------------------------------------------

def array(data, dtype=None, dist: bool = True, block_shape=None) -> DistArray:
    rt = current_runtime()
    np_data = np.asarray(data, dtype=dtype)
    base = rt.new_base(np_data.shape, np_data.dtype, block_shape)
    rt.scatter(base, np_data)
    return DistArray(base, ViewSpec.full(np_data.shape), rt)


def empty(shape, dtype=np.float64, dist: bool = True, block_shape=None) -> DistArray:
    rt = current_runtime()
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    base = rt.new_base(shape, dtype, block_shape)
    rt.fill_base(base, 0)  # deterministic contents; blocks must exist
    return DistArray(base, ViewSpec.full(shape), rt)


def zeros(shape, dtype=np.float64, dist: bool = True, block_shape=None) -> DistArray:
    return full(shape, 0, dtype, dist, block_shape)


def ones(shape, dtype=np.float64, dist: bool = True, block_shape=None) -> DistArray:
    return full(shape, 1, dtype, dist, block_shape)


def full(shape, value, dtype=np.float64, dist=True, block_shape=None) -> DistArray:
    rt = current_runtime()
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    base = rt.new_base(shape, dtype, block_shape)
    rt.fill_base(base, value)
    return DistArray(base, ViewSpec.full(shape), rt)


def arange(n, dtype=np.float64, block_shape=None) -> DistArray:
    return array(np.arange(n, dtype=dtype), block_shape=block_shape)


def random(shape, seed=0, dtype=np.float64, block_shape=None) -> DistArray:
    rng = np.random.default_rng(seed)
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return array(rng.random(shape).astype(dtype), block_shape=block_shape)


# ---------------------------------------------------------------------------
# module-level ufuncs — generated from the registry (single dispatch
# table: adding a primitive to ufunc.py adds it here and to np.<ufunc>
# dispatch in one step)
# ---------------------------------------------------------------------------

def _module_ufunc(u: UFunc):
    def f(*args):
        if len(args) != u.nin:
            raise TypeError(f"{u.name} expects {u.nin} operand(s), got {len(args)}")
        return _apply(u, *args)

    f.__name__ = u.name
    f.__qualname__ = u.name
    f.__doc__ = (
        f"Record ``{u.name}`` lazily on DistArrays (generated from the "
        f"ufunc registry; ``np.{u.name}`` on DistArray operands is the "
        f"canonical spelling)."
    )
    return f


_GENERATED_UFUNCS = [n for n in uf.UFUNCS if n != "identity"]
for _name in _GENERATED_UFUNCS:
    globals()[_name] = _module_ufunc(uf.UFUNCS[_name])


# ---------------------------------------------------------------------------
# linalg / data movement
# ---------------------------------------------------------------------------

def matmul(a, b, trans_a=False, trans_b=False) -> DistArray:
    rt = current_runtime()
    a, b = _coerce_operand(a), _coerce_operand(b)
    a = a.materialize() if isinstance(a, Expr) else a
    b = b.materialize() if isinstance(b, Expr) else b
    M = a.shape[1] if trans_a else a.shape[0]
    Ka = a.shape[0] if trans_a else a.shape[1]
    Kb = b.shape[1] if trans_b else b.shape[0]
    N = b.shape[0] if trans_b else b.shape[1]
    if Ka != Kb:
        raise ValueError(f"matmul shape mismatch {a.shape} @ {b.shape}")
    out = empty((M, N), dtype=np.result_type(a.dtype, b.dtype))
    rt.record_matmul(
        (out._base, out._view),
        (a._base, a._view),
        (b._base, b._view),
        trans_a,
        trans_b,
    )
    return out


def roll(a, shift: int, axis: int = 0) -> DistArray:
    """np.roll equivalent: two strided copies (used by the LBM streaming
    step).  C[..., s:, ...] = A[..., :-s, ...]; C[..., :s, ...] = A[..., n-s:, ...]."""
    a = _coerce_operand(a)
    a = a.materialize() if isinstance(a, Expr) else a
    n = a.shape[axis]
    s = shift % n
    out = empty(a.shape, dtype=a.dtype)
    if s == 0:
        out[...] = a
        return out

    def sl(lo, hi):
        key = [slice(None)] * a.ndim
        key[axis] = slice(lo, hi)
        return tuple(key)

    out[sl(s, n)] = a[sl(0, n - s)]
    out[sl(0, s)] = a[sl(n - s, n)]
    return out


# ---------------------------------------------------------------------------
# __array_function__ handlers: the np-namespace spellings of the
# reductions / data movement above
# ---------------------------------------------------------------------------

def _as_lazy(x):
    c = _coerce_operand(x)
    if c is None:
        raise TypeError(f"unsupported operand {type(x)}")
    return c.materialize() if isinstance(c, Expr) else c


@_implements(np.sum)
def _np_sum(a, axis=None, dtype=None, out=None, keepdims=False, **kw):
    if dtype is not None or out is not None or kw:
        raise TypeError("np.sum on DistArray supports only axis= and keepdims=")
    return _as_lazy(a)._reduce("add", axis, keepdims)


@_implements(np.min, np.amin)
def _np_min(a, axis=None, out=None, keepdims=False, **kw):
    if out is not None or kw:
        raise TypeError("np.min on DistArray supports only axis= and keepdims=")
    return _as_lazy(a)._reduce("minimum", axis, keepdims)


@_implements(np.max, np.amax)
def _np_max(a, axis=None, out=None, keepdims=False, **kw):
    if out is not None or kw:
        raise TypeError("np.max on DistArray supports only axis= and keepdims=")
    return _as_lazy(a)._reduce("maximum", axis, keepdims)


@_implements(np.where)
def _np_where(condition, x=None, y=None):
    if x is None or y is None:
        raise TypeError("np.where(cond) without x/y is eager; unsupported on DistArray")
    return _apply(uf.where, condition, x, y)


@_implements(np.roll)
def _np_roll(a, shift, axis=None):
    if axis is None:
        raise TypeError("np.roll on DistArray requires an explicit axis")
    return roll(a, shift, axis)


@_implements(np.matmul)
def _np_matmul(a, b, **kw):
    if kw:
        raise TypeError("np.matmul on DistArray supports no keyword arguments")
    return matmul(a, b)


__all__ = [
    "DistArray",
    "array",
    "empty",
    "zeros",
    "ones",
    "full",
    "arange",
    "random",
    "matmul",
    "roll",
    *_GENERATED_UFUNCS,
]
