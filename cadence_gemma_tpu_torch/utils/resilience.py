"""Failure detection and recovery for long training runs.

Counterpart of the JAX package's ``cadence_gemma_tpu/utils/resilience.py``
in plain Python:

  * :class:`PreemptionHandler` turns SIGTERM (or any signals given) into a
    flag that ``train_loop(preemption=...)`` polls after each step: the loop
    then saves a resumable train state (``checkpoint/io.py``) under
    ``config.checkpoint_dir`` as ``preempted_step_{k}`` and returns, so a
    rescheduled job resumes with ``TrainingConfig.resume_from``;
  * :func:`with_retries` retries host-side IO (data loading, image decode,
    checkpoint writes) with exponential backoff.

The skip of non-finite updates is ``TrainingConfig.skip_nonfinite_updates``
(``train_loop.py``), as optax's ``apply_if_finite`` is in JAX.
"""

from __future__ import annotations

import functools
import signal
import threading
import time
from typing import Any, Callable, Iterable, Type


class PreemptionHandler:
  """Cooperative SIGTERM / SIGINT watcher (JAX ``resilience.py:34``).

  Use as a context manager around a training run: inside it, ``triggered``
  turns True when one of ``signals`` arrives, instead of the process dying
  mid-step. The handlers installed before are restored on exit and called
  on delivery, so nesting is safe. :meth:`trigger` sets the flag by hand
  (tests, schedulers with their own notice).
  """

  def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
    self._signals = tuple(signals)
    self._event = threading.Event()
    self._previous: dict[int, Any] = {}

  @property
  def triggered(self) -> bool:
    return self._event.is_set()

  def trigger(self) -> None:
    self._event.set()

  def _handle(self, signum, frame) -> None:
    self._event.set()
    prev = self._previous.get(signum)
    if callable(prev):
      prev(signum, frame)

  def __enter__(self) -> "PreemptionHandler":
    for s in self._signals:
      self._previous[s] = signal.getsignal(s)
      signal.signal(s, self._handle)
    return self

  def __exit__(self, *exc) -> None:
    for s, prev in self._previous.items():
      signal.signal(s, prev)
    self._previous.clear()


def with_retries(
    fn: Callable | None = None,
    *,
    retries: int = 3,
    exceptions: tuple[Type[BaseException], ...] = (OSError, IOError),
    backoff_s: float = 0.1,
    on_retry: Callable[[int, BaseException], None] | None = None,
):
  """Retries ``fn`` up to ``retries`` extra times with exponential backoff
  (JAX ``resilience.py:75``).

  Usable as ``@with_retries``, ``@with_retries(retries=5)`` or inline:
  ``with_retries(load, retries=5)(path)``. ``on_retry(attempt, error)`` runs
  before each wait of ``backoff_s * 2**attempt`` seconds; the last failure
  re-raises the original exception.
  """

  def decorate(f):
    @functools.wraps(f)
    def wrapped(*args, **kwargs):
      for attempt in range(retries + 1):
        try:
          return f(*args, **kwargs)
        except exceptions as e:
          if attempt == retries:
            raise
          if on_retry is not None:
            on_retry(attempt, e)
          time.sleep(backoff_s * (2**attempt))

    return wrapped

  return decorate if fn is None else decorate(fn)
