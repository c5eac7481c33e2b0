"""A low-precision complex number as a pair of real tensors.

Counterpart of the JAX package's ``cadence_gemma_tpu/complex_lib.py``. torch
has no bfloat16 complex dtype (its smallest is ``complex64``, two float32),
so :class:`Complex` holds separate real and imaginary tensors of one shape
and one dtype, bfloat16 or float32, and carries the operations the
complex-valued RG-LRU scan needs. Every operator keeps the JAX module's
order of operations (the product is ``(ar*br - ai*bi, ar*bi + ai*br)``), so
both packages round alike.

The helpers (``zeros_like``, ``ones_like``, ``exp``, ``log``, ``conjugate``,
``abs_squared``, ``real_part``, ``concatenate``, ``where``, ``einsum``,
``lift``) also accept plain real tensors, so a caller is written once for
the real and the complex paths.

Left out: the JAX module's pytree registration (``flax.struct.dataclass``)
and its ``_is_placeholder`` guard exist for JAX's tracing machinery
(``shard_map``, ``eval_shape``, Pallas block specs), which the port does not
have. A ``torch.autograd.Function`` takes tensors, so the port's kernel
paths pass the components and rewrap them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Sequence, Union

import torch

Numeric = Union[int, float, torch.Tensor]


@dataclasses.dataclass(eq=False)
class Complex:
  """A complex number as a pair of equally shaped real tensors."""

  real: torch.Tensor
  imag: torch.Tensor

  def __post_init__(self):
    if self.real.shape != self.imag.shape:
      raise ValueError(
          f"Components differ in shape: {tuple(self.real.shape)} vs "
          f"{tuple(self.imag.shape)}."
      )
    if self.real.dtype != self.imag.dtype:
      raise ValueError(
          f"Components differ in dtype: {self.real.dtype} vs "
          f"{self.imag.dtype}."
      )

  # -- tensor protocol ------------------------------------------------------

  @property
  def dtype(self) -> torch.dtype:
    return self.real.dtype

  @property
  def shape(self) -> torch.Size:
    return self.real.shape

  @property
  def ndim(self) -> int:
    return self.real.ndim

  @property
  def device(self) -> torch.device:
    return self.real.device

  def to(self, *args, **kwargs) -> "Complex":
    """``Tensor.to`` on both components: a dtype (``astype``), a device, or
    both."""
    return Complex(self.real.to(*args, **kwargs),
                   self.imag.to(*args, **kwargs))

  def astype(self, dtype: torch.dtype | None) -> "Complex":
    if dtype is None:
      return self
    return self.to(dtype)

  def reshape(self, *shape) -> "Complex":
    if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)):
      shape = tuple(shape[0])
    return Complex(self.real.reshape(shape), self.imag.reshape(shape))

  def contiguous(self) -> "Complex":
    return Complex(self.real.contiguous(), self.imag.contiguous())

  def to_complex64(self) -> torch.Tensor:
    """A native ``complex64`` tensor (the JAX module's ``to_numpy``)."""
    return torch.complex(self.real.float(), self.imag.float())

  # -- arithmetic -----------------------------------------------------------

  def __add__(self, other: "Complex" | Numeric) -> "Complex":
    if isinstance(other, Complex):
      return Complex(self.real + other.real, self.imag + other.imag)
    return Complex(self.real + other, self.imag)

  __radd__ = __add__

  def __neg__(self) -> "Complex":
    return Complex(-self.real, -self.imag)

  def __sub__(self, other: "Complex" | Numeric) -> "Complex":
    return self + (-other if isinstance(other, Complex) else -1 * other)

  def __rsub__(self, other: Numeric) -> "Complex":
    return (-self) + other

  def __mul__(self, other: "Complex" | Numeric) -> "Complex":
    if isinstance(other, Complex):
      return Complex(
          self.real * other.real - self.imag * other.imag,
          self.real * other.imag + self.imag * other.real,
      )
    return Complex(self.real * other, self.imag * other)

  __rmul__ = __mul__

  def __truediv__(self, other: "Complex" | Numeric) -> "Complex":
    if isinstance(other, Complex):
      denom = other.real * other.real + other.imag * other.imag
      return Complex(
          (self.real * other.real + self.imag * other.imag) / denom,
          (self.imag * other.real - self.real * other.imag) / denom,
      )
    return Complex(self.real / other, self.imag / other)

  def __matmul__(self, other: "Complex" | torch.Tensor) -> "Complex":
    if isinstance(other, Complex):
      return Complex(
          self.real @ other.real - self.imag @ other.imag,
          self.real @ other.imag + self.imag @ other.real,
      )
    return Complex(self.real @ other, self.imag @ other)

  def __getitem__(self, key: Any) -> "Complex":
    return Complex(self.real[key], self.imag[key])

  def __eq__(self, other: Any) -> torch.Tensor:  # type: ignore[override]
    if isinstance(other, Complex):
      return (self.real == other.real) & (self.imag == other.imag)
    return (self.real == other) & (self.imag == 0)

  def __hash__(self):
    return id(self)


# ---------------------------------------------------------------------------
# Helpers over real-or-complex values.
# ---------------------------------------------------------------------------


def is_complex(x: Any) -> bool:
  return isinstance(x, Complex)


def to_custom_complex(x: torch.Tensor | Complex) -> Complex:
  """Wraps a real or a native complex tensor (``complex64``) into a
  ``Complex``; a real tensor takes a zero imaginary part."""
  if isinstance(x, Complex):
    return x
  if x.is_complex():
    return Complex(x.real.contiguous(), x.imag.contiguous())
  return Complex(x, torch.zeros_like(x))


def from_numpy(real, imag, dtype: torch.dtype | None = None,
               device: torch.device | str | None = None) -> Complex:
  """A ``Complex`` from two numpy arrays (or anything ``torch.as_tensor``
  takes), e.g. the components of an operand made for the JAX package."""
  return Complex(torch.as_tensor(real, dtype=dtype, device=device),
                 torch.as_tensor(imag, dtype=dtype, device=device))


def zeros_like(x: torch.Tensor | Complex, dtype: torch.dtype | None = None):
  if isinstance(x, Complex):
    return Complex(torch.zeros_like(x.real, dtype=dtype),
                   torch.zeros_like(x.imag, dtype=dtype))
  return torch.zeros_like(x, dtype=dtype)


def ones_like(x: torch.Tensor | Complex, dtype: torch.dtype | None = None):
  if isinstance(x, Complex):
    return Complex(torch.ones_like(x.real, dtype=dtype),
                   torch.zeros_like(x.imag, dtype=dtype))
  return torch.ones_like(x, dtype=dtype)


def exp(x: torch.Tensor | Complex):
  """exp for real tensors; exp(a+bi) = e^a (cos b + i sin b) for Complex."""
  if isinstance(x, Complex):
    mag = torch.exp(x.real)
    return Complex(mag * torch.cos(x.imag), mag * torch.sin(x.imag))
  return torch.exp(x)


def log(x: torch.Tensor | Complex):
  """log for real tensors; the principal branch for Complex."""
  if isinstance(x, Complex):
    return Complex(0.5 * torch.log(x.real**2 + x.imag**2),
                   torch.atan2(x.imag, x.real))
  return torch.log(x)


def conjugate(x: torch.Tensor | Complex):
  if isinstance(x, Complex):
    return Complex(x.real, -x.imag)
  return torch.conj(x)


def abs_squared(x: torch.Tensor | Complex) -> torch.Tensor:
  if isinstance(x, Complex):
    return x.real**2 + x.imag**2
  return torch.square(torch.abs(x))


def real_part(x: torch.Tensor | Complex) -> torch.Tensor:
  return x.real if isinstance(x, Complex) else x


def concatenate(xs: Sequence[torch.Tensor | Complex], axis: int = 0):
  if any(isinstance(x, Complex) for x in xs):
    xs = [to_custom_complex(x) for x in xs]
    return Complex(torch.cat([x.real for x in xs], dim=axis),
                   torch.cat([x.imag for x in xs], dim=axis))
  return torch.cat(list(xs), dim=axis)


def where(cond: torch.Tensor, x: torch.Tensor | Complex,
          y: torch.Tensor | Complex):
  if isinstance(x, Complex) or isinstance(y, Complex):
    x, y = to_custom_complex(x), to_custom_complex(y)
    return Complex(torch.where(cond, x.real, y.real),
                   torch.where(cond, x.imag, y.imag))
  return torch.where(cond, x, y)


def einsum(eqn: str, *args: torch.Tensor | Complex):
  """einsum over real-or-complex operands.

    * no ``Complex`` operand: plain ``torch.einsum`` (any arity);
    * exactly one ``Complex`` among any number of real operands: the
      contraction is linear, so it runs on each component;
    * exactly two operands, at least one ``Complex``: the full complex
      product (rr - ii, ri + ir).
  """
  n_complex = sum(isinstance(a, Complex) for a in args)
  if n_complex == 0:
    return torch.einsum(eqn, *args)
  if n_complex == 1 and len(args) != 2:
    reals = [a.real if isinstance(a, Complex) else a for a in args]
    imags = [a.imag if isinstance(a, Complex) else a for a in args]
    return Complex(torch.einsum(eqn, *reals), torch.einsum(eqn, *imags))
  if len(args) != 2:
    raise NotImplementedError(
        "Complex einsum supports two operands, or one Complex among reals."
    )
  a, b = (to_custom_complex(x) for x in args)
  return Complex(
      torch.einsum(eqn, a.real, b.real) - torch.einsum(eqn, a.imag, b.imag),
      torch.einsum(eqn, a.real, b.imag) + torch.einsum(eqn, a.imag, b.real),
  )


# ---------------------------------------------------------------------------
# Componentwise lifting of structural functions.
# ---------------------------------------------------------------------------


def _has_complex(x: Any) -> bool:
  return isinstance(x, Complex) or (
      isinstance(x, (list, tuple)) and any(isinstance(e, Complex) for e in x)
  )


def _component(x: Any, part: str) -> Any:
  """One component of a Complex value or of a sequence holding one; a
  sequence with no Complex entry (split sizes, pad widths) passes as it is.
  """
  if isinstance(x, Complex):
    return getattr(x, part)
  if _has_complex(x):
    return type(x)(getattr(to_custom_complex(e), part) for e in x)
  return x


def _rebuild(real_out: Any, imag_out: Any) -> Any:
  """Zips componentwise outputs back into Complex (lists stay lists)."""
  if isinstance(real_out, (list, tuple)):
    return type(real_out)(_rebuild(r, i) for r, i in zip(real_out, imag_out))
  return Complex(real_out, imag_out)


def lift(fn: Callable[..., Any]) -> Callable[..., Any]:
  """Lifts a structural function to accept ``Complex`` operands.

  The lifted function applies ``fn`` to the real and to the imaginary
  components of every ``Complex`` argument (or sequence holding one). A bare
  real tensor or float among them takes a zero imaginary part; ints, shapes
  and axes pass to both calls unchanged (pass data as floats or tensors).
  Valid only where ``fn(a + bi) == fn(a) + fn(b) i``: shape manipulation and
  other real-linear maps, not products. With no ``Complex`` anywhere the call
  passes straight through.
  """

  @functools.wraps(fn)
  def wrapped(*args: Any, **kwargs: Any) -> Any:
    if not any(_has_complex(a) for a in args) and not any(
        _has_complex(v) for v in kwargs.values()
    ):
      return fn(*args, **kwargs)

    def operand(x, part):
      if isinstance(x, Complex) or _has_complex(x):
        return _component(x, part)
      if part == "imag":
        if isinstance(x, torch.Tensor):
          return torch.zeros_like(x)
        if isinstance(x, float):
          return 0.0
      return x

    real_out = fn(*(operand(a, "real") for a in args),
                  **{k: operand(v, "real") for k, v in kwargs.items()})
    imag_out = fn(*(operand(a, "imag") for a in args),
                  **{k: operand(v, "imag") for k, v in kwargs.items()})
    return _rebuild(real_out, imag_out)

  return wrapped


# The JAX module's table of lifted functions, under torch's names where
# torch's function differs (``flip`` takes ``dims``, ``split`` sizes).
broadcast_to = lift(torch.broadcast_to)
expand_dims = lift(torch.unsqueeze)
flip = lift(torch.flip)
reshape = lift(torch.reshape)
split = lift(torch.split)
squeeze = lift(torch.squeeze)
stack = lift(torch.stack)
tile = lift(torch.tile)
transpose = lift(torch.transpose)
add = lift(torch.add)  # addition is componentwise, so lift() is exact
pad = lift(torch.nn.functional.pad)
narrow = lift(torch.narrow)
