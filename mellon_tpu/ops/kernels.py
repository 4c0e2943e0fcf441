"""Covariance kernels: ABC, operator algebra, six concrete kernels.

Behavioural parity target: ``mellon/base_cov.py`` and ``mellon/cov.py``.

Device notes: every kernel evaluation is a single fused XLA graph of
(matmul for pairwise distances) -> (elementwise math); no intermediate
materialization beyond the (n, m) tile.  The serialization format is kept
byte-compatible with the reference (type tag ``"mellon.Covariance"``,
``mellon/base_cov.py:110-224``) so kernels round-trip between frameworks.
"""

import json
import logging
import sys
from abc import ABC, abstractmethod
from datetime import datetime
from importlib import import_module

import jax
import jax.numpy as jnp

from ..utils.util import (
    distance,
    distance_grad,
    expand_to_inactive,
    make_serializable,
    deserialize,
    select_active_dims,
)

logger = logging.getLogger("mellon_tpu")

PACKAGE_NAME = __name__.split(".")[0]
# serialization type tag shared with the reference for interchange
COV_TYPE_TAG = "mellon.Covariance"


# ---------------------------------------------------------------------------
# jitted elementwise cores: one stable program per kernel family, with the
# length scale as a runtime operand (eager op-by-op dispatch would cost one
# program load per op on remote-compiled backends)
# ---------------------------------------------------------------------------

@jax.jit
def _matern32_vals(x, y, ls):
    from ..utils.util import distance

    r = jnp.sqrt(3.0) * distance(x, y) / ls
    return (r + 1) * jnp.exp(-r)


@jax.jit
def _matern52_vals(x, y, ls):
    from ..utils.util import distance

    r = jnp.sqrt(5.0) * distance(x, y) / ls
    return (r + jnp.square(r) / 3 + 1) * jnp.exp(-r)


@jax.jit
def _expquad_vals(x, y, ls):
    from ..utils.util import distance

    r = distance(x, y) / ls
    return jnp.exp(-jnp.square(r) / 2)


@jax.jit
def _exponential_vals(x, y, ls):
    from ..utils.util import distance

    r = distance(x, y) / ls
    return jnp.exp(-r / 2)


@jax.jit
def _ratquad_vals(x, y, ls, alpha):
    from ..utils.util import distance

    r = distance(x, y) / ls
    return (jnp.square(r) / (2 * alpha) + 1) ** -alpha


@jax.jit
def _linear_vals(x, y, ls):
    return jnp.einsum("ij,kj->ik", x, y) / ls


# ---------------------------------------------------------------------------
# operand specs: a hashable static description of a kernel's *structure*
# plus a flat tuple of its numeric parameters.  Fused programs jit the
# static spec and thread the parameters as runtime operands, so one
# executable serves every fit regardless of length-scale values (a baked
# float would force a fresh trace/compile/load per fit).
# ---------------------------------------------------------------------------

def _hashable_active_dims(active_dims):
    """Encode active_dims (None/int/slice/sequence/bool mask) hashably."""
    import numpy as np

    if active_dims is None or isinstance(active_dims, (int, np.integer)):
        return int(active_dims) if active_dims is not None else None
    if isinstance(active_dims, slice):
        return ("__slice__", active_dims.start, active_dims.stop, active_dims.step)
    arr = np.asarray(active_dims)
    if arr.ndim == 0:
        return int(arr)
    if arr.dtype == bool:
        return ("__mask__", tuple(bool(b) for b in arr.tolist()))
    return ("__seq__", tuple(int(i) for i in arr.tolist()))


def _restore_active_dims(encoded):
    if isinstance(encoded, tuple) and encoded:
        import numpy as np

        if encoded[0] == "__slice__":
            return slice(encoded[1], encoded[2], encoded[3])
        if encoded[0] == "__mask__":
            return np.asarray(encoded[1], dtype=bool)
        if encoded[0] == "__seq__":
            return np.asarray(encoded[1], dtype=int)
    return encoded


_SPEC_CORES = {
    "matern32": _matern32_vals,
    "matern52": _matern52_vals,
    "expquad": _expquad_vals,
    "exponential": _exponential_vals,
    "ratquad": _ratquad_vals,
    "linear": _linear_vals,
}

_SPEC_OPS = {
    "add": lambda a, b: a + b,
    "mul": lambda a, b: a * b,
    "pow": lambda a, b: a**b,
}


def eval_operand_spec(spec, params, x, y):
    """Evaluate a kernel structure ``spec`` with parameter operands
    ``params`` at (x, y).  Equals ``cov_func(x, y)`` for the kernel that
    produced the spec via :meth:`Covariance.operand_spec`."""
    params = tuple(jnp.asarray(p).astype(x.dtype) for p in params)
    val, used = _eval_spec(spec, params, 0, x, y)
    if used != len(params):
        raise ValueError("operand spec consumed wrong number of parameters")
    return val


def _eval_spec(spec, params, i, x, y):
    tag = spec[0]
    active_dims = _restore_active_dims(spec[1])
    x = select_active_dims(x, active_dims)
    y = select_active_dims(y, active_dims)
    if tag in _SPEC_OPS:
        left, i = _eval_branch(spec[2], params, i, x, y)
        right, i = _eval_branch(spec[3], params, i, x, y)
        return _SPEC_OPS[tag](left, right), i
    n = spec[2]
    core = _SPEC_CORES[tag]
    return core(x, y, *params[i : i + n]), i + n


def _eval_branch(spec, params, i, x, y):
    if spec == "__const__":
        return params[i], i + 1
    return _eval_spec(spec, params, i, x, y)


class Covariance(ABC):
    """Base covariance function (parity: ``mellon/base_cov.py:17-224``)."""

    # operand-spec metadata: core registry tag + ordered parameter attrs.
    # User-defined kernels leave these unset and fused callers fall back to
    # the static-closure path.
    _spec_tag = None
    _spec_params = ()

    def __init__(self, active_dims=None):
        self.active_dims = active_dims

    def operand_spec(self):
        """(static, params): a hashable structure describing this kernel and
        the flat tuple of its numeric parameters as runtime operands (see
        :func:`eval_operand_spec`)."""
        if self._spec_tag is None:
            raise NotImplementedError(
                f"{self.__class__.__name__} does not define an operand spec."
            )
        static = (
            self._spec_tag,
            _hashable_active_dims(self.active_dims),
            len(self._spec_params),
        )
        params = tuple(jnp.asarray(getattr(self, p)) for p in self._spec_params)
        return static, params

    def __str__(self):
        return self.__repr__()

    def __repr__(self):
        clsname = self.__class__.__name__
        arguments = [
            f"{key}={val}"
            for key, val in self.__dict__.items()
            if key != "active_dims" or val is not None
        ]
        return clsname + "(" + ", ".join(arguments) + ")"

    @abstractmethod
    def k(self, x, y):
        ...

    def k_grad(self, x):
        """Default autodiff gradient of k(x, .) w.r.t. y
        (parity: ``mellon/base_cov.py:42-66``)."""
        k_func = lambda y: self.k(x, y[None, :])[..., 0]
        k_grad_pre = jax.vmap(jax.jacfwd(k_func), in_axes=(0,), out_axes=1)

        def k_grad(y):
            return k_grad_pre(y)

        return k_grad

    def __call__(self, x, y):
        return self.k(x, y)

    def diag(self, x):
        """Diagonal of k(x, x) via vmap (parity: ``mellon/base_cov.py:71-93``)."""
        x = jnp.expand_dims(x, 1)
        res = jax.vmap(self.k)(x, x)
        return jnp.reshape(res, res.shape[:-2])

    def __add__(self, other):
        return Add(self, other)

    def __radd__(self, other):
        return Add(self, other)

    def __mul__(self, other):
        return Mul(self, other)

    def __rmul__(self, other):
        return Mul(self, other)

    def __pow__(self, other):
        return Pow(self, other)

    # -- serialization ------------------------------------------------------

    def _data_dict(self):
        return {key: make_serializable(val) for key, val in self.__dict__.items()}

    def __getstate__(self):
        module_name = self.__class__.__module__
        clsname = self.__class__.__name__
        if module_name == "__main__":
            logger.warning(
                f'The covariance function "{clsname}" is not part of '
                f"{PACKAGE_NAME} and seems to be user defined. Make sure the "
                "implementation is available for deserialization."
            )
        try:
            metamodule = import_module(module_name.split(".")[0])
            version = getattr(metamodule, "__version__", "NA")
        except ImportError:
            version = "NA"
        return {
            "type": COV_TYPE_TAG,
            "data": self._data_dict(),
            "metadata": {
                "classname": clsname,
                "module_name": module_name,
                "module_version": version,
                "serialization_date": datetime.now().isoformat(),
                "python_version": sys.version,
            },
        }

    def __setstate__(self, state):
        for name, value in state["data"].items():
            setattr(self, name, deserialize(value))

    def to_json(self):
        return json.dumps(self.__getstate__())

    def to_dict(self):
        return self.__getstate__()

    @classmethod
    def from_json(cls, json_str):
        return cls.from_dict(json.loads(json_str))

    @classmethod
    def from_dict(cls, state):
        if not isinstance(state, dict) or state.get("type") != COV_TYPE_TAG:
            raise ValueError(
                "The passed dict does not seem to define a covariance kernel."
            )
        clsname = state["metadata"]["classname"]
        module_name = state["metadata"]["module_name"]
        Subclass = _resolve_covariance_class(clsname, module_name)
        instance = Subclass.__new__(Subclass)
        instance.__setstate__(state)
        return instance


def _resolve_covariance_class(clsname, module_name):
    """Resolve a kernel class by name.

    Kernels serialized by the reference carry ``module_name="mellon.cov"``;
    we map any known class name to our implementation first and only then
    fall back to importing the stated module.
    """
    if clsname in globals():
        return globals()[clsname]
    try:
        module = import_module(module_name)
        return getattr(module, clsname)
    except (ImportError, AttributeError):
        pass
    raise ValueError(
        f"Cannot resolve covariance class {clsname} from module {module_name}."
    )


class CovariancePair(Covariance):
    """Composite of two covariance functions
    (parity: ``mellon/base_cov.py:227-298``)."""

    def __init__(self, left, right, active_dims=None):
        super().__init__()
        self.left = left
        self.right = right
        self.active_dims = active_dims

    @abstractmethod
    def k(self, x, y):
        ...

    def operand_spec(self):
        left_static, left_params = self.left.operand_spec()
        if callable(self.right):
            right_static, right_params = self.right.operand_spec()
        else:
            right_static, right_params = "__const__", (jnp.asarray(self.right),)
        static = (
            self._spec_tag,
            _hashable_active_dims(self.active_dims),
            left_static,
            right_static,
        )
        if self._spec_tag is None:
            raise NotImplementedError(
                f"{self.__class__.__name__} does not define an operand spec."
            )
        return static, left_params + right_params

    def __getstate__(self):
        module_name = self.__class__.__module__.split(".")[0]
        try:
            module = import_module(module_name)
            version = getattr(module, "__version__", "NA")
        except ImportError:
            version = "NA"
        if callable(self.right):
            right_data = self.right.__getstate__()
        else:
            right_data = make_serializable(self.right)
        return {
            "type": COV_TYPE_TAG,
            "left_data": self.left.__getstate__(),
            "right_data": right_data,
            "active_dims": make_serializable(self.active_dims),
            "metadata": {
                "classname": self.__class__.__name__,
                "module_name": module_name,
                "module_version": version,
                "serialization_date": datetime.now().isoformat(),
                "python_version": sys.version,
            },
        }

    def __setstate__(self, state):
        if not isinstance(state, dict) or state.get("type") != COV_TYPE_TAG:
            raise ValueError(
                "The passed dict does not seem to define a covariance kernel."
            )
        self.left = Covariance.from_dict(state["left_data"])
        if (
            isinstance(state["right_data"], dict)
            and state["right_data"].get("type") == COV_TYPE_TAG
        ):
            self.right = Covariance.from_dict(state["right_data"])
        else:
            self.right = deserialize(state["right_data"])
        self.active_dims = deserialize(state.get("active_dims", None))


class Add(CovariancePair):
    """Sum kernel (parity: ``mellon/base_cov.py:301-364``)."""

    _spec_tag = "add"

    def __repr__(self):
        return "(" + repr(self.left) + " + " + repr(self.right) + ")"

    def k(self, x, y):
        x = select_active_dims(x, self.active_dims)
        y = select_active_dims(y, self.active_dims)
        if callable(self.right):
            return self.left(x, y) + self.right(x, y)
        return self.left(x, y) + self.right

    def k_grad(self, x):
        x_shape = x.shape
        active_dims = self.active_dims
        x = select_active_dims(x, active_dims)
        left_grad = self.left.k_grad(x)
        right_grad = self.right.k_grad(x) if callable(self.right) else None

        def k_grad(y):
            y_shape = y.shape
            y_act = select_active_dims(y, active_dims)
            grad = left_grad(y_act)
            if right_grad is not None:
                grad = grad + right_grad(y_act)
            target_shape = x_shape[:-1] + y_shape
            return expand_to_inactive(grad, target_shape, active_dims)

        return k_grad


class Mul(CovariancePair):
    """Product kernel with product-rule gradient
    (parity: ``mellon/base_cov.py:367-438``)."""

    _spec_tag = "mul"

    def __repr__(self):
        return "(" + repr(self.left) + " * " + repr(self.right) + ")"

    def k(self, x, y):
        x = select_active_dims(x, self.active_dims)
        y = select_active_dims(y, self.active_dims)
        if callable(self.right):
            return self.left(x, y) * self.right(x, y)
        return self.left(x, y) * self.right

    def k_grad(self, x):
        x_shape = x.shape
        active_dims = self.active_dims
        x_act = select_active_dims(x, active_dims)
        left_grad_func = self.left.k_grad(x_act)
        right_grad_func = self.right.k_grad(x_act) if callable(self.right) else None

        def k_grad(y):
            y_shape = y.shape
            y_act = select_active_dims(y, active_dims)
            left_grad = left_grad_func(y_act)
            if right_grad_func is not None:
                left_k = self.left.k(x_act, y_act)[..., None]
                right_k = self.right.k(x_act, y_act)[..., None]
                right_grad = right_grad_func(y_act)
                grad = left_grad * right_k + left_k * right_grad
            else:
                grad = left_grad * self.right
            target_shape = x_shape[:-1] + y_shape
            return expand_to_inactive(grad, target_shape, active_dims)

        return k_grad


class Pow(CovariancePair):
    """Power kernel with chain-rule gradient
    (parity: ``mellon/base_cov.py:441-497``)."""

    _spec_tag = "pow"

    def __repr__(self):
        return "(" + repr(self.left) + " ** " + repr(self.right) + ")"

    def k(self, x, y):
        x = select_active_dims(x, self.active_dims)
        y = select_active_dims(y, self.active_dims)
        return self.left(x, y) ** self.right

    def k_grad(self, x):
        x_shape = x.shape
        active_dims = self.active_dims
        x_act = select_active_dims(x, active_dims)
        base_grad_func = self.left.k_grad(x_act)

        def k_grad(y):
            y_shape = y.shape
            y_act = select_active_dims(y, active_dims)
            base_k = self.left.k(x_act, y_act)[..., None]
            base_grad = base_grad_func(y_act)
            power_grad = self.right * (base_k ** (self.right - 1)) * base_grad
            target_shape = x_shape[:-1] + y_shape
            return expand_to_inactive(power_grad, target_shape, active_dims)

        return k_grad


class _RadialKernel(Covariance):
    """Shared machinery for isotropic kernels k(x, y) = g(c·‖x−y‖/ls).

    Every radial kernel is fully described by its distance prefactor
    ``_r_scale`` (e.g. √5 for Matern-5/2) and the scalar derivative
    ``_dk_dr(r)`` of its profile g with respect to the scaled distance
    r = ``_r_scale``·‖x−y‖/ls.  The analytic pairwise gradient
    ∂k(x,y)/∂y is then the chain rule g'(r)·∂r/∂y, assembled once here
    instead of per kernel (re-derivation of ``mellon/cov.py:163-202`` in
    scalar-profile form; behavior pinned by tests/test_ops.py against
    autodiff).
    """

    _r_scale = 1.0
    _spec_params = ("ls",)

    def __init__(self, ls=1.0, active_dims=None):
        super().__init__()
        self.ls = ls
        self.active_dims = active_dims

    def _dk_dr(self, r):
        """d g / d r of the radial profile at scaled distance r."""
        raise NotImplementedError

    def k_grad(self, x):
        """Analytic ∂k(x, ·)/∂y, vectorized over row blocks of y."""
        full_x_shape = x.shape
        dims = self.active_dims
        x_act = select_active_dims(x, dims)
        pairwise = distance_grad(x_act)
        scale = self._r_scale / self.ls

        def grad_fn(y):
            y_act = select_active_dims(y, dims)
            dist, ddist_dy = pairwise(y_act)
            chain = self._dk_dr(scale * dist[..., None]) * (scale * ddist_dy)
            full = full_x_shape[:-1] + y.shape
            return expand_to_inactive(chain, full, dims)

        return grad_fn


class Matern32(_RadialKernel):
    R"""Matern-3/2: :math:`(1 + \sqrt{3} r / l) e^{-\sqrt{3} r / l}`
    (parity: ``mellon/cov.py:6-100``)."""

    _spec_tag = "matern32"
    _r_scale = 3.0**0.5

    def k(self, x, y):
        x = select_active_dims(x, self.active_dims)
        y = select_active_dims(y, self.active_dims)
        return _matern32_vals(x, y, self.ls)

    def _dk_dr(self, r):
        # g(r) = (1 + r)·e^{-r}  ⇒  g'(r) = -r·e^{-r}
        return -r * jnp.exp(-r)


class Matern52(_RadialKernel):
    R"""Matern-5/2 (the default kernel):
    :math:`(1 + \sqrt{5} r / l + 5 r^2 / (3 l^2)) e^{-\sqrt{5} r / l}`
    (parity: ``mellon/cov.py:103-202``)."""

    _spec_tag = "matern52"
    _r_scale = 5.0**0.5

    def k(self, x, y):
        x = select_active_dims(x, self.active_dims)
        y = select_active_dims(y, self.active_dims)
        return _matern52_vals(x, y, self.ls)

    def _dk_dr(self, r):
        # g(r) = (1 + r + r²/3)·e^{-r}  ⇒  g'(r) = -(r + r²)/3·e^{-r}
        return -(r + jnp.square(r)) / 3 * jnp.exp(-r)


class ExpQuad(_RadialKernel):
    R"""Squared-exponential: :math:`e^{-r^2 / (2 l^2)}`
    (parity: ``mellon/cov.py:205-299``)."""

    _spec_tag = "expquad"

    def k(self, x, y):
        x = select_active_dims(x, self.active_dims)
        y = select_active_dims(y, self.active_dims)
        return _expquad_vals(x, y, self.ls)

    def _dk_dr(self, r):
        # g(r) = e^{-r²/2}  ⇒  g'(r) = -r·e^{-r²/2}
        return -r * jnp.exp(-jnp.square(r) / 2)


class Exponential(_RadialKernel):
    R"""Exponential: :math:`e^{-r / (2 l)}` (parity: ``mellon/cov.py:302-396``)."""

    _spec_tag = "exponential"

    def k(self, x, y):
        x = select_active_dims(x, self.active_dims)
        y = select_active_dims(y, self.active_dims)
        return _exponential_vals(x, y, self.ls)

    def _dk_dr(self, r):
        # g(r) = e^{-r/2}  ⇒  g'(r) = -e^{-r/2}/2
        return -jnp.exp(-r / 2) / 2


class RatQuad(_RadialKernel):
    R"""Rational quadratic: :math:`(1 + r^2/(2\alpha l^2))^{-\alpha}`
    (parity: ``mellon/cov.py:399-499``)."""

    _spec_tag = "ratquad"
    _spec_params = ("ls", "alpha")

    def __init__(self, alpha=1.0, ls=1.0, active_dims=None):
        super().__init__(ls=ls, active_dims=active_dims)
        self.alpha = alpha

    def k(self, x, y):
        x = select_active_dims(x, self.active_dims)
        y = select_active_dims(y, self.active_dims)
        return _ratquad_vals(x, y, self.ls, self.alpha)

    def _dk_dr(self, r):
        # g(r) = (1 + r²/2α)^{-α}  ⇒  g'(r) = -r·(1 + r²/2α)^{-α-1}
        return -r * (jnp.square(r) / (2 * self.alpha) + 1) ** (-self.alpha - 1)


class Linear(Covariance):
    R"""Linear: :math:`x \cdot y / l` (parity: ``mellon/cov.py:502-592``).

    Not radial — k depends on the inner product, so ∂k(x,y)/∂y = x/ls
    independently of y.
    """

    _spec_tag = "linear"
    _spec_params = ("ls",)

    def __init__(self, ls=1.0, active_dims=None):
        super().__init__()
        self.ls = ls
        self.active_dims = active_dims

    def k(self, x, y):
        x = select_active_dims(x, self.active_dims)
        y = select_active_dims(y, self.active_dims)
        return _linear_vals(x, y, self.ls)

    def k_grad(self, x):
        full_x_shape = x.shape
        dims = self.active_dims
        x_act = select_active_dims(x, dims)

        def grad_fn(y):
            y_act = select_active_dims(y, dims)
            n_y = y_act.shape[0]
            rows = jnp.broadcast_to(
                x_act[:, None, :],
                (x_act.shape[0], n_y, x_act.shape[-1]),
            )
            full = full_x_shape[:-1] + y.shape
            return expand_to_inactive(rows / self.ls, full, dims)

        return grad_fn
