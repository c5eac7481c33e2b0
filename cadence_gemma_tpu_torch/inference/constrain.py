"""Grammar-constrained decoding: a regex compiled to token-level logit masks.

Counterpart of the JAX package's ``cadence_gemma_tpu/inference/constrain.py``;
the host side (the regex parser, the NFA, the minimized character DFA, the
token closure, persistence and the grammar builders) is the same numpy code,
so a grammar compiles to the same bits in both packages:

  * Build time (host, once per (grammar, vocabulary)): compile a regular
    expression to a character NFA (Thompson construction), determinize it
    over an *atom* alphabet (classes of characters the grammar cannot tell
    apart), then close the DFA over whole vocabulary tokens -- walking every
    token's characters from every DFA state, with ``native/constrain.cc``
    (``utils/constrain_cpp``) or in vectorized numpy passes chunked over
    states.

  * Run time (the card, inside the decode step that a CUDA graph captures):
        allowed_bits[S, ceil(V/32)] : int32  bit-packed token mask a state
                                             (the EOS bit set at accepting
                                             states); JAX's uint32 words
                                             viewed as int32
        trans[S, A]                 : int32  character-DFA transitions
        token_atoms[V, L] / token_lengths[V]  each token's atom string
    Masking is one row gather and a bit unpack; advancing replays the
    sampled token's <= L atoms through ``trans`` (L gathers a row). Memory
    is O(S*V/32 + S*A + V*L): a dense int32 ``next_state[S, V]`` would be
    ~1 GB at a 256k vocabulary and a few thousand states, so it is never
    built. Every shape is fixed and nothing is read back to the host, so
    the mask and the advance are captured with the rest of a decode step.

Torch has no shifts on ``uint32`` on every backend, so the tables keep the
same 32 bits in ``int32``: the arithmetic shift of a negative word fills
with ones from the top, and ``& 1`` keeps only bit 0, which is the bit JAX's
logical shift gives -- bit 31 of a word included.

JSON mode is a grammar built by :func:`json_regex`: JSON nesting is not
regular, so depth is bounded (default 3), the usual regex-constraint
tradeoff.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Sequence

import numpy as np
import torch

# -- regular expression AST ---------------------------------------------------
#
# Supported syntax: literals, escapes (\d \w \s \D \W \S \n \t \r \\ and
# escaped metacharacters), character classes [a-z_] / [^...], '.', grouping
# (...) (and non-capturing (?:...)), alternation '|', quantifiers * + ?
# {m} {m,} {m,n}. Anchored fullmatch semantics (the whole generation must
# match), which is what constrained decoding needs.


@dataclasses.dataclass(frozen=True)
class CharSet:
  """A set of characters, possibly complemented ('everything but')."""

  chars: frozenset
  negated: bool = False

  def __contains__(self, ch: str) -> bool:
    return (ch in self.chars) != self.negated


_DIGITS = frozenset("0123456789")
_WORD = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"
)
_SPACE = frozenset(" \t\n\r\f\v")
_ESCAPES = {
    "d": CharSet(_DIGITS),
    "D": CharSet(_DIGITS, negated=True),
    "w": CharSet(_WORD),
    "W": CharSet(_WORD, negated=True),
    "s": CharSet(_SPACE),
    "S": CharSet(_SPACE, negated=True),
    "n": CharSet(frozenset("\n")),
    "t": CharSet(frozenset("\t")),
    "r": CharSet(frozenset("\r")),
    "f": CharSet(frozenset("\f")),
    "v": CharSet(frozenset("\v")),
    "0": CharSet(frozenset("\0")),
}
_DOT = CharSet(frozenset("\n"), negated=True)


@dataclasses.dataclass(frozen=True)
class _Lit:
  charset: CharSet


@dataclasses.dataclass(frozen=True)
class _Cat:
  parts: tuple


@dataclasses.dataclass(frozen=True)
class _Alt:
  options: tuple


@dataclasses.dataclass(frozen=True)
class _Rep:
  node: Any
  min: int
  max: int | None  # None = unbounded


class RegexError(ValueError):
  """Malformed pattern."""


class _Parser:
  """Recursive-descent parser for the supported regex subset."""

  def __init__(self, pattern: str):
    self.p = pattern
    self.i = 0

  def parse(self):
    node = self._alt()
    if self.i != len(self.p):
      raise RegexError(
          f"unexpected {self.p[self.i]!r} at {self.i} in {self.p!r}"
      )
    return node

  def _peek(self) -> str | None:
    return self.p[self.i] if self.i < len(self.p) else None

  def _alt(self):
    options = [self._concat()]
    while self._peek() == "|":
      self.i += 1
      options.append(self._concat())
    return options[0] if len(options) == 1 else _Alt(tuple(options))

  def _concat(self):
    parts = []
    while self._peek() not in (None, "|", ")"):
      parts.append(self._repeat())
    if len(parts) == 1:
      return parts[0]
    return _Cat(tuple(parts))

  def _repeat(self):
    node = self._atom()
    while True:
      ch = self._peek()
      if ch == "*":
        self.i += 1
        node = _Rep(node, 0, None)
      elif ch == "+":
        self.i += 1
        node = _Rep(node, 1, None)
      elif ch == "?":
        self.i += 1
        node = _Rep(node, 0, 1)
      elif ch == "{":
        node = _Rep(node, *self._braces())
      else:
        return node

  def _braces(self) -> tuple:
    start = self.i
    self.i += 1  # '{'
    spec = ""
    while self._peek() not in (None, "}"):
      spec += self.p[self.i]
      self.i += 1
    if self._peek() != "}":
      raise RegexError(f"unterminated {{...}} at {start} in {self.p!r}")
    self.i += 1
    try:
      if "," not in spec:
        lo = hi = int(spec)
      else:
        lo_s, hi_s = spec.split(",", 1)
        lo = int(lo_s) if lo_s else 0
        hi = int(hi_s) if hi_s else None
    except ValueError as e:
      raise RegexError(f"bad quantifier {{{spec}}} in {self.p!r}") from e
    if hi is not None and hi < lo:
      raise RegexError(f"bad quantifier {{{spec}}}: max < min")
    return lo, hi

  def _atom(self):
    ch = self._peek()
    if ch is None:
      raise RegexError(f"pattern ends unexpectedly: {self.p!r}")
    if ch == "(":
      self.i += 1
      if self.p[self.i : self.i + 2] == "?:":  # non-capturing: same thing
        self.i += 2
      node = self._alt()
      if self._peek() != ")":
        raise RegexError(f"unbalanced '(' in {self.p!r}")
      self.i += 1
      return node
    if ch == "[":
      return _Lit(self._char_class())
    if ch == ".":
      self.i += 1
      return _Lit(_DOT)
    if ch == "\\":
      return _Lit(self._escape())
    if ch in "*+?{":
      raise RegexError(f"quantifier {ch!r} with nothing to repeat")
    if ch in ")|":
      raise RegexError(f"unexpected {ch!r} at {self.i}")
    self.i += 1
    return _Lit(CharSet(frozenset(ch)))

  def _escape(self) -> CharSet:
    self.i += 1  # backslash
    ch = self._peek()
    if ch is None:
      raise RegexError(f"dangling backslash in {self.p!r}")
    self.i += 1
    if ch in _ESCAPES:
      return _ESCAPES[ch]
    return CharSet(frozenset(ch))  # escaped metacharacter / literal

  def _char_class(self) -> CharSet:
    start = self.i
    self.i += 1  # '['
    negated = self._peek() == "^"
    if negated:
      self.i += 1
    chars: set = set()
    first = True
    while True:
      ch = self._peek()
      if ch is None:
        raise RegexError(f"unterminated '[' at {start} in {self.p!r}")
      if ch == "]" and not first:
        self.i += 1
        return CharSet(frozenset(chars), negated=negated)
      first = False
      if ch == "\\":
        cs = self._escape()
        if cs.negated:
          raise RegexError(
              f"negated escape class inside [...] in {self.p!r}"
          )
        chars |= cs.chars
        continue
      self.i += 1
      if self._peek() == "-" and self.i + 1 < len(self.p) and (
          self.p[self.i + 1] != "]"
      ):
        self.i += 1  # '-'
        hi = self.p[self.i]
        if hi == "\\":
          hi_set = self._escape()
          if len(hi_set.chars) != 1 or hi_set.negated:
            raise RegexError(f"bad range end in {self.p!r}")
          (hi,) = hi_set.chars
        else:
          self.i += 1
        if ord(hi) < ord(ch):
          raise RegexError(f"reversed range {ch}-{hi} in {self.p!r}")
        chars |= {chr(c) for c in range(ord(ch), ord(hi) + 1)}
      else:
        chars.add(ch)


# -- Thompson NFA -------------------------------------------------------------


class _NFA:
  """Character-class-labeled NFA with epsilon edges."""

  def __init__(self):
    self.n = 0
    self.edges: list = []  # (src, CharSet, dst)
    self.eps: list = []  # (src, dst)

  def state(self) -> int:
    self.n += 1
    return self.n - 1

  def build(self, node) -> tuple:
    """Returns (start, accept) for the sub-automaton of ``node``."""
    if isinstance(node, _Lit):
      s, a = self.state(), self.state()
      self.edges.append((s, node.charset, a))
      return s, a
    if isinstance(node, _Cat):
      if not node.parts:
        s = self.state()
        return s, s
      start, acc = self.build(node.parts[0])
      for part in node.parts[1:]:
        s2, a2 = self.build(part)
        self.eps.append((acc, s2))
        acc = a2
      return start, acc
    if isinstance(node, _Alt):
      s, a = self.state(), self.state()
      for option in node.options:
        so, ao = self.build(option)
        self.eps.append((s, so))
        self.eps.append((ao, a))
      return s, a
    if isinstance(node, _Rep):
      # Expand by duplication: {m,n} = m copies + (n-m) optionals;
      # {m,} = m copies + a Kleene star.
      start = prev = self.state()
      for _ in range(node.min):
        so, ao = self.build(node.node)
        self.eps.append((prev, so))
        prev = ao
      if node.max is None:
        so, ao = self.build(node.node)
        self.eps.append((prev, so))
        self.eps.append((ao, prev))
        return start, prev
      acc = self.state()
      self.eps.append((prev, acc))
      for _ in range(node.max - node.min):
        so, ao = self.build(node.node)
        self.eps.append((prev, so))
        prev = ao
        self.eps.append((prev, acc))
      return start, acc
    raise AssertionError(f"unknown node {node!r}")


def _eps_closure(by_src: dict, states) -> frozenset:
  """Epsilon closure over a prebuilt adjacency dict (hot path: called
  once per (DFA state, atom) during subset construction — rebuilding the
  adjacency per call made a 5k-state JSON grammar take minutes)."""
  stack, seen = list(states), set(states)
  while stack:
    s = stack.pop()
    for d in by_src.get(s, ()):
      if d not in seen:
        seen.add(d)
        stack.append(d)
  return frozenset(seen)


@dataclasses.dataclass
class CharDFA:
  """A determinized grammar over an explicit finite alphabet.

  ``trans[s, a]`` maps state s on atom a; ``dead`` is the absorbing
  reject state. ``atom_of`` maps a character to its atom id (characters
  outside the build alphabet are rejecting).
  """

  trans: np.ndarray  # [S, A] int32
  accepting: np.ndarray  # [S] bool
  start: int
  dead: int
  atom_of: dict

  def accepts(self, text: str) -> bool:
    """Host-side char walk (tests / debugging)."""
    s = self.start
    for ch in text:
      a = self.atom_of.get(ch)
      if a is None:
        return False
      s = int(self.trans[s, a])
      if s == self.dead:
        return False
    return bool(self.accepting[s])


def _minimize(
    trans: np.ndarray, accepting: np.ndarray, start: int, dead: int
) -> tuple[np.ndarray, np.ndarray, int, int]:
  """Moore partition refinement, vectorized over states.

  Subset construction leaves many equivalent states (the JSON grammar's
  duplicated per-depth value sub-automata collapse ~10x); minimizing
  before the token closure shrinks both the [S, V/32] device tables and
  the S-proportional walk. Labels start as (accepting?) and refine by
  the labels of each state's A successors until stable — O(S*A*log S).
  """
  labels = accepting.astype(np.int64)
  n_classes = 2
  while True:
    sig = np.concatenate(
        [labels[:, None], labels[trans]], axis=1
    )
    _, new_labels = np.unique(sig, axis=0, return_inverse=True)
    new_n = int(new_labels.max()) + 1
    if new_n == n_classes:
      break
    labels, n_classes = new_labels, new_n
  # Representative-ordered rebuild (first occurrence keeps determinism).
  first = np.full(n_classes, -1, dtype=np.int64)
  for s, lbl in enumerate(labels):
    if first[lbl] < 0:
      first[lbl] = s
  new_trans = labels[trans[first]].astype(np.int32)
  new_accepting = accepting[first]
  return (
      new_trans, new_accepting, int(labels[start]), int(labels[dead])
  )


def compile_regex(
    pattern: str, alphabet: Sequence[str], minimize: bool = True
) -> CharDFA:
  """Regex → minimal DFA over ``alphabet`` (the characters tokens emit).

  Characters never produced by any vocabulary token are irrelevant to
  token masking, so the DFA is built over exactly the vocabulary's
  character set — this keeps subset construction over a handful of
  *atoms* (grammar-equivalence classes of characters) rather than
  unicode. The result is Moore-minimized by default (the dead state
  stays a distinguished absorbing state: it is never accepting and no
  live state shares its all-dead row unless truly equivalent).
  """
  ast = _Parser(pattern).parse()
  nfa = _NFA()
  start, accept = nfa.build(ast)

  # Atom partition: characters with identical membership across every
  # CharSet the grammar mentions are interchangeable.
  charsets = [cs for _, cs, _ in nfa.edges]
  sig_to_atom: dict = {}
  atom_of: dict = {}
  atom_repr: list = []
  for ch in sorted(set(alphabet)):
    sig = tuple(ch in cs for cs in charsets)
    if sig not in sig_to_atom:
      sig_to_atom[sig] = len(atom_repr)
      atom_repr.append(ch)
    atom_of[ch] = sig_to_atom[sig]
  n_atoms = max(len(atom_repr), 1)

  # Subset construction. All per-NFA adjacency is prebuilt ONCE (edge →
  # atom-id list, eps adjacency) and each DFA state computes its moves
  # for every atom in a single sweep over its member states; epsilon
  # closures of repeated move sets are memoized. This keeps the JSON
  # serving grammar (5.5k DFA states over a 13.8k-state NFA) at ~a
  # second instead of minutes.
  eps_by_src: dict = {}
  for s, d in nfa.eps:
    eps_by_src.setdefault(s, []).append(d)
  edges_by_src: dict = {}
  for s, cs, d in nfa.edges:
    atom_ids = tuple(
        a for a, ch in enumerate(atom_repr) if ch in cs
    )
    if atom_ids:
      edges_by_src.setdefault(s, []).append((atom_ids, d))
  start_set = _eps_closure(eps_by_src, (start,))
  sets: dict = {start_set: 0}
  order = [start_set]
  rows: list = []
  closure_memo: dict = {}
  i = 0
  while i < len(order):
    cur = order[i]
    i += 1
    move: list = [None] * len(atom_repr)
    for s in cur:
      for atom_ids, d in edges_by_src.get(s, ()):
        for a in atom_ids:
          if move[a] is None:
            move[a] = {d}
          else:
            move[a].add(d)
    row = []
    for a in range(len(atom_repr)):
      nxt = move[a]
      if not nxt:
        row.append(-1)
        continue
      key = frozenset(nxt)
      closed = closure_memo.get(key)
      if closed is None:
        closed = _eps_closure(eps_by_src, key)
        closure_memo[key] = closed
      if closed not in sets:
        sets[closed] = len(order)
        order.append(closed)
      row.append(sets[closed])
    rows.append(row)

  dead = len(order)
  trans = np.full((dead + 1, n_atoms), dead, dtype=np.int32)
  for s, row in enumerate(rows):
    for a, d in enumerate(row):
      trans[s, a] = dead if d == -1 else d
  accepting = np.zeros(dead + 1, dtype=bool)
  for state_set, idx in sets.items():
    accepting[idx] = accept in state_set
  start_idx = 0
  if minimize:
    trans, accepting, start_idx, dead = _minimize(
        trans, accepting, start_idx, dead
    )
  return CharDFA(
      trans=trans, accepting=accepting, start=start_idx, dead=dead,
      atom_of=atom_of,
  )


# -- device tables -------------------------------------------------------------


def _forbid(rows: torch.Tensor, state_shape, logits: torch.Tensor):
  """``logits`` with -inf where the bit-packed ``rows`` ([..., W] int32, bit
  ``v % 32`` of word ``v // 32``) clear token ``v``."""
  shifts = torch.arange(32, dtype=torch.int32, device=rows.device)
  bits = (rows[..., None] >> shifts) & 1  # [..., W, 32]
  forbidden = bits.reshape(*state_shape, -1)[..., :logits.shape[-1]] == 0
  return logits.masked_fill(forbidden, float("-inf"))


def _walk(trans_at, atoms: torch.Tensor, lengths: torch.Tensor,
          state: torch.Tensor) -> torch.Tensor:
  """Replays each row's atom string (``atoms`` [b, L], ``lengths`` [b])
  through ``trans_at(state, atom)``: L gathers, unrolled (JAX's
  ``fori_loop``), with which rows still move at each step compared once."""
  moving = (torch.arange(atoms.shape[-1], device=atoms.device)
            < lengths[:, None])
  for j in range(atoms.shape[-1]):
    state = torch.where(moving[:, j], trans_at(state, atoms[:, j]), state)
  return state


@dataclasses.dataclass
class ConstraintTables:
  """One grammar's tables on the device: gather-only evaluation inside the
  decode step (JAX ``constrain.py:511-548``).

  A captured decode step reads the tables at their addresses: the samplers'
  graphs keep their own copies (:meth:`clone`) and copy a call's tables in
  (:meth:`copy_`).
  """

  allowed_bits: torch.Tensor  # [S, ceil(V/32)] int32, bit v%32 of word v//32
  trans: torch.Tensor  # [S, A] int32 character-DFA transitions
  token_atoms: torch.Tensor  # [V, L] int32 (pad slots hold 0)
  token_lengths: torch.Tensor  # [V] int32
  start: torch.Tensor  # 0-dim int32

  def mask(self, state: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """-inf out the tokens the grammar forbids in ``state`` (int32, any
    shape ``[...]``; ``logits`` is ``[..., V]``)."""
    return _forbid(self.allowed_bits[state], state.shape, logits)

  def advance(self, state: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """The DFA state after each row emitted ``token`` ([b] each).

    Replays the token's atom string through the character DFA: L gathers a
    row instead of a dense [S, V] next-state table.
    """
    return _walk(lambda s, a: self.trans[s, a], self.token_atoms[token],
                 self.token_lengths[token], state)

  def tensors(self) -> list[torch.Tensor]:
    return [getattr(self, f.name) for f in dataclasses.fields(self)]

  def clone(self) -> "ConstraintTables":
    return type(self)(*(t.clone() for t in self.tensors()))

  def copy_(self, other: "ConstraintTables") -> None:
    """Copies ``other``'s tables (of the same shapes) into these."""
    for dst, src in zip(self.tensors(), other.tensors()):
      dst.copy_(src)

  @property
  def shapes(self) -> tuple:
    return tuple(tuple(t.shape) for t in self.tensors())

class TokenDFA:
  """A compiled (grammar, vocabulary) constraint.

  Args:
    pattern: Regex the *generated* text (excluding stop tokens) must
      fullmatch.
    token_strings: ``token_strings[i]`` is the text token id ``i`` appends
      to the output. Empty strings mark non-text ids (pad/bos/control),
      which the constraint forbids (they make no progress). Use
      :func:`token_strings_from_vocab` for a Vocabulary.
    eos_id: Allowed exactly in accepting DFA states (generation may only
      stop when the output matches).
    extra_stop_ids: Further ids treated like EOS (e.g. ``<end_of_turn>``
      for IT chat serving) — allowed exactly at accepting states, no
      state advance.
  """

  def __init__(
      self,
      pattern: str,
      token_strings: Sequence[str],
      eos_id: int,
      extra_stop_ids: Sequence[int] = (),
      _state_chunk: int = 256,
      _use_native: bool | None = None,
      _minimize: bool = True,
  ):
    self.pattern = pattern
    self.eos_id = int(eos_id)
    self.stop_ids = sorted({int(eos_id)} | {int(i) for i in extra_stop_ids})
    alphabet = sorted({ch for t in token_strings for ch in t})
    dfa = compile_regex(pattern, alphabet, minimize=_minimize)
    self.char_dfa = dfa
    n_states = dfa.trans.shape[0]  # includes the dead state
    vocab = len(token_strings)

    max_len = max((len(t) for t in token_strings), default=1) or 1
    atoms = np.full((vocab, max_len), -1, dtype=np.int64)
    lengths = np.zeros(vocab, dtype=np.int64)
    for v, t in enumerate(token_strings):
      lengths[v] = len(t)
      for j, ch in enumerate(t):
        # Characters outside the alphabet cannot occur (the alphabet is
        # the union of token characters), but -1 guards stay for safety.
        atoms[v, j] = dfa.atom_of.get(ch, -1)
    for s in self.stop_ids:
      lengths[s] = 0  # stop tokens never advance the DFA

    # Vectorized token walk. Two scale tricks make a 256k vocabulary
    # build in seconds instead of minutes:
    #   1. Tokens are deduplicated by ATOM string — the grammar cannot
    #      tell "hem" from "gem" if h and g share an atom, so only
    #      unique (length, atoms...) rows walk; the result scatters back
    #      to all tokens with one gather. Real vocabularies collapse
    #      hard (most text chars share a handful of atoms, and every
    #      token containing an out-of-alphabet character folds into one
    #      dead row).
    #   2. The walk is chunked over states, keeping the peak allocation
    #      at O(_state_chunk * unique) — a full [S, V] int32 would be
    #      gigabytes for thousand-state grammars over a 256k vocab.
    key = np.concatenate([lengths[:, None], atoms], axis=1)
    # Any out-of-alphabet character kills the token regardless of the
    # rest: canonicalize those rows so they dedupe into one.
    tok_dead = ((atoms < 0) & (np.arange(max_len)[None] < lengths[:, None])
                ).any(axis=1)
    key[tok_dead] = -1
    uniq, uid = np.unique(key, axis=0, return_inverse=True)
    # Ascending length order: at walk step j, columns [off[j]:] are the
    # only ones still moving (np.unique sorts rows lexicographically, so
    # the length column is already ascending — asserted, not re-sorted).
    u_len = np.maximum(uniq[:, 0], 0)  # the dead row's -1 → length 0
    assert (np.diff(u_len) >= 0).all()
    u_atoms = uniq[:, 1:]
    n_uniq = uniq.shape[0]
    self.n_unique_tokens = int(n_uniq)

    allowed_bits = None
    if _use_native is not False:
      # Threaded C++ walk (native/constrain.cc): early-exits on the
      # absorbing dead state and parallelizes over DFA states — the
      # dominant cost of compiling against a 256k vocabulary.
      from cadence_gemma_tpu_torch.utils import constrain_cpp  # pylint: disable=import-outside-toplevel

      allowed_bits = constrain_cpp.walk_pack(
          dfa.trans, np.maximum(u_atoms, 0), u_len, uid, vocab, dfa.dead
      )
      if allowed_bits is None and _use_native:
        raise RuntimeError(
            "native constrain walker requested but unavailable "
            "(make -C native libconstrain.so failed?)"
        )
    if allowed_bits is None:
      allowed_bits = self._walk_pack_numpy(
          dfa, u_atoms, u_len, uid, vocab, max_len, _state_chunk
      )

    # Stop tokens: allowed exactly at accepting states (clear the walk's
    # bit first — stop ids are length-0 rows, never set, but keep this
    # robust to a text token doubling as a stop id).
    for stop in self.stop_ids:
      w, b = stop // 32, stop % 32
      allowed_bits[:, w] &= np.uint32(~np.uint32(1 << b))
      allowed_bits[:, w] |= dfa.accepting.astype(np.uint32) << np.uint32(b)
    # The dead state allows only EOS (never an all--inf logits row);
    # likewise fail-open any live-but-stuck state (no token and no stop
    # available — e.g. the grammar needs a character no token emits).
    stuck = ~(allowed_bits != 0).any(axis=1)
    self._stuck_states = [
        int(i) for i in np.nonzero(stuck)[0] if int(i) != dfa.dead
    ]
    w, b = self.eos_id // 32, self.eos_id % 32
    allowed_bits[stuck, w] |= np.uint32(1 << b)

    self._allowed_bits = allowed_bits
    self._token_atoms = np.maximum(atoms, 0).astype(np.int32)
    # Forever-forbidden tokens (an out-of-alphabet character) never
    # advance on device either — their clamped atom slots are garbage.
    self._token_lengths = np.where(tok_dead, 0, lengths).astype(np.int32)
    self.n_states = n_states
    self.vocab_size = vocab

  @staticmethod
  def _walk_pack_numpy(
      dfa: CharDFA, u_atoms, u_len, uid, vocab, max_len, state_chunk
  ) -> np.ndarray:
    """Numpy fallback for the native walk (identical bits, tested so).

    Two tricks keep it vectorizable: an identity "pad atom" makes
    positions past a token's length map a state to itself, so the inner
    walk is ONE gather per step (no live/dead where passes); and the
    length-ascending unique ordering lets step ``j`` touch only the
    still-moving suffix. Chunking over states bounds the peak allocation
    at O(state_chunk * unique) — a full [S, V] int32 would be gigabytes
    for thousand-state grammars over a 256k vocab.
    """
    n_states = dfa.trans.shape[0]
    n_atoms_t = dfa.trans.shape[1]
    n_uniq = u_atoms.shape[0]
    state_dtype = np.int16 if n_states < 2**15 - 1 else np.int32
    trans_ext = np.concatenate(
        [dfa.trans, np.arange(n_states, dtype=np.int32)[:, None]], axis=1
    ).astype(state_dtype)
    u_cols = np.where(
        np.arange(max_len)[None] < u_len[:, None], u_atoms, n_atoms_t
    ).astype(np.int64)
    step_off = np.searchsorted(u_len, np.arange(max_len), side="right")
    n_words = (vocab + 31) // 32
    pad = (-vocab) % 32
    allowed_bits = np.zeros((n_states, n_words), dtype=np.uint32)
    for s0 in range(0, n_states, state_chunk):
      s1 = min(s0 + state_chunk, n_states)
      cur = np.broadcast_to(
          np.arange(s0, s1, dtype=state_dtype)[:, None], (s1 - s0, n_uniq)
      ).copy()
      for j in range(max_len):
        off = step_off[j]
        if off >= n_uniq:
          break
        cur[:, off:] = trans_ext[cur[:, off:], u_cols[None, off:, j]]
      allowed_u = (cur != dfa.dead) & (u_len > 0)[None, :]
      allowed = allowed_u[:, uid]  # scatter back to token ids
      # Bitpack: bit v%32 of word v//32 in row s (LSB-first = the device
      # unpack order). packbits(little) gives LSB-first uint8s; viewing
      # 4 of them as one uint32 keeps bit positions on little-endian
      # hosts.
      if pad:
        allowed = np.pad(allowed, ((0, 0), (0, pad)))
      packed8 = np.ascontiguousarray(
          np.packbits(allowed, axis=1, bitorder="little")
      )
      allowed_bits[s0:s1] = packed8.view(np.uint32)
    return allowed_bits


  def tables(self, device=None) -> ConstraintTables:
    """The device tables, built once a device. ``None`` means CUDA and
    raises without a card; pass ``device="cpu"`` on the CPU."""
    from cadence_gemma_tpu_torch.models import griffin  # pylint: disable=import-outside-toplevel

    device = griffin.resolve_device(device)
    built = self.__dict__.setdefault("_device_tables", {})
    if str(device) not in built:
      as_dev = functools.partial(torch.as_tensor, device=device)
      built[str(device)] = ConstraintTables(
          allowed_bits=as_dev(self._allowed_bits.view(np.int32)),
          trans=as_dev(np.asarray(self.char_dfa.trans, np.int32)),
          token_atoms=as_dev(np.asarray(self._token_atoms, np.int32)),
          token_lengths=as_dev(np.asarray(self._token_lengths, np.int32)),
          start=as_dev(np.int32(self.char_dfa.start)),
      )
    return built[str(device)]

  # -- persistence -------------------------------------------------------------

  def save(self, path: str) -> None:
    """Serializes the compiled constraint (build once, serve many).

    A (grammar, tokenizer) compile is a pure function of its inputs, so
    servers cache it next to the checkpoint: ``TokenDFA.load(path)``
    restores tables and host mirrors without re-walking the vocabulary.
    """
    atom_chars = np.array(
        [ord(ch) for ch in self.char_dfa.atom_of], dtype=np.int64
    )
    atom_ids = np.array(
        list(self.char_dfa.atom_of.values()), dtype=np.int64
    )
    np.savez_compressed(
        path,
        pattern=np.array(self.pattern),
        eos_id=np.int64(self.eos_id),
        stop_ids=np.array(self.stop_ids, dtype=np.int64),
        allowed_bits=self._allowed_bits,
        token_atoms=self._token_atoms,
        token_lengths=self._token_lengths,
        trans=self.char_dfa.trans,
        accepting=self.char_dfa.accepting,
        start=np.int64(self.char_dfa.start),
        dead=np.int64(self.char_dfa.dead),
        atom_chars=atom_chars,
        atom_ids=atom_ids,
        stuck_states=np.array(self._stuck_states, dtype=np.int64),
        n_unique_tokens=np.int64(self.n_unique_tokens),
    )

  @classmethod
  def load(cls, path: str) -> "TokenDFA":
    """Restores a :meth:`save`d constraint without recompiling."""
    data = np.load(path, allow_pickle=False)
    self = cls.__new__(cls)
    self.pattern = str(data["pattern"])
    self.eos_id = int(data["eos_id"])
    self.stop_ids = [int(i) for i in data["stop_ids"]]
    self.char_dfa = CharDFA(
        trans=data["trans"],
        accepting=data["accepting"],
        start=int(data["start"]),
        dead=int(data["dead"]),
        atom_of={
            chr(int(c)): int(a)
            for c, a in zip(data["atom_chars"], data["atom_ids"])
        },
    )
    self._allowed_bits = data["allowed_bits"]
    self._token_atoms = data["token_atoms"]
    self._token_lengths = data["token_lengths"]
    self._stuck_states = [int(s) for s in data["stuck_states"]]
    self.n_unique_tokens = int(data["n_unique_tokens"])
    self.n_states = int(self._allowed_bits.shape[0])
    self.vocab_size = int(self._token_lengths.shape[0])
    return self

  # -- host-side mirrors (tests / debugging) ---------------------------------

  def token_allowed(self, state: int, token: int) -> bool:
    """Host mirror of the device mask for one (state, token)."""
    word = self._allowed_bits[state, token // 32]
    return bool((int(word) >> (token % 32)) & 1)

  def token_advance(self, state: int, token: int) -> int:
    """Host mirror of the device advance for one (state, token)."""
    s = state
    for j in range(int(self._token_lengths[token])):
      s = int(self.char_dfa.trans[s, self._token_atoms[token, j]])
    return s

  def allows_text(self, text: str) -> bool:
    """Whether a finished generation would have satisfied the grammar."""
    return self.char_dfa.accepts(text)

  def is_live_prefix(self, text: str) -> bool:
    """Whether ``text`` can still be extended into a grammar match."""
    s = self.char_dfa.start
    for ch in text:
      a = self.char_dfa.atom_of.get(ch)
      if a is None:
        return False
      s = int(self.char_dfa.trans[s, a])
      if s == self.char_dfa.dead:
        return False
    return True


@dataclasses.dataclass
class StackedConstraintTables:
  """A grammar registry for batched serving: one table set, G grammars
  (JAX ``constrain.py:826-881``).

  Grammar id 0 is always the allow-all grammar (one state, every token
  legal, nothing advances), so unconstrained requests share the decode step
  of constrained ones: their mask is the identity. Each grammar's tables
  are padded to the registry's largest state, atom and token-length counts;
  padding rows are unreachable.

  Built by :func:`stack_constraints`; read by the continuous batcher (a
  ``gid`` and a DFA state a slot).
  """

  allowed_bits: torch.Tensor  # [G, Smax, ceil(V/32)] int32
  trans: torch.Tensor  # [G, Smax, Amax] int32
  token_atoms: torch.Tensor  # [G, V, Lmax] int32
  token_lengths: torch.Tensor  # [G, V] int32
  start: torch.Tensor  # [G] int32

  def mask(self, gid: torch.Tensor, state: torch.Tensor,
           logits: torch.Tensor) -> torch.Tensor:
    """-inf out the tokens grammar ``gid[i]`` forbids in ``state[i, ...]``
    (``gid`` [b]; ``state`` [b] or [b, n])."""
    gid = gid.reshape(gid.shape + (1,) * (state.dim() - gid.dim()))
    return _forbid(self.allowed_bits[gid, state], state.shape, logits)

  def advance(self, gid: torch.Tensor, state: torch.Tensor,
              token: torch.Tensor) -> torch.Tensor:
    """Each row's DFA state after emitting ``token`` under grammar
    ``gid``."""
    return _walk(lambda s, a: self.trans[gid, s, a],
                 self.token_atoms[gid, token],
                 self.token_lengths[gid, token], state)

  def single(self, gid: int) -> ConstraintTables:
    """Grammar ``gid``'s tables as a :class:`ConstraintTables` (views of
    the registry, so a write into its slot shows through)."""
    return ConstraintTables(
        allowed_bits=self.allowed_bits[gid], trans=self.trans[gid],
        token_atoms=self.token_atoms[gid],
        token_lengths=self.token_lengths[gid], start=self.start[gid])

  def write(self, gid: int, dfa: "TokenDFA") -> None:
    """Overwrites registry slot ``gid`` with ``dfa`` (shapes unchanged; JAX
    ``serving.py:577-587``), on the current stream."""
    s_max, a_max = self.trans.shape[1:]
    l_max = self.token_atoms.shape[2]
    allowed, trans, atoms, lengths, start = pad_grammar(dfa, s_max, a_max,
                                                        l_max)
    for dst, src in ((self.allowed_bits, allowed.view(np.int32)),
                     (self.trans, trans), (self.token_atoms, atoms),
                     (self.token_lengths, lengths.astype(np.int32))):
      dst[gid].copy_(torch.as_tensor(src, device=dst.device))
    self.start[gid] = start

  tensors = ConstraintTables.tensors
  clone = ConstraintTables.clone
  copy_ = ConstraintTables.copy_
  shapes = ConstraintTables.shapes

  @property
  def num_grammars(self) -> int:
    return self.allowed_bits.shape[0]


@dataclasses.dataclass
class BoundConstraint:
  """A :class:`StackedConstraintTables` bound to per-row grammar ids.

  Presents the single-grammar ``mask(state, logits)`` / ``advance(state,
  token)`` interface over a registry and a [b] ``gid`` vector: what lets
  the grammar-agnostic speculative verify serve a mixed-grammar batch.
  """

  tables: StackedConstraintTables
  gid: torch.Tensor  # [b] int32

  def mask(self, state, logits):
    return self.tables.mask(self.gid, state, logits)

  def advance(self, state, token):
    return self.tables.advance(self.gid, state, token)

def pad_grammar(
    dfa: TokenDFA, s_max: int, a_max: int, l_max: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
  """Pads one grammar's tables to registry dims (padding is unreachable).

  Returns ``(allowed_bits, trans, token_atoms, token_lengths, start)``
  host arrays shaped exactly like one registry slot — the building block
  of :func:`stack_constraints` and of runtime slot replacement
  (``ContinuousBatcher.register_grammar``).
  """
  s, a = dfa.char_dfa.trans.shape
  l = dfa._token_atoms.shape[1]
  if s > s_max or a > a_max or l > l_max:
    raise ValueError(
        f"grammar needs (states={s}, atoms={a}, token_len={l}) but the "
        f"registry budget is ({s_max}, {a_max}, {l_max}); raise "
        "dynamic_grammar_budget or simplify the grammar."
    )
  allowed = np.zeros((s_max, dfa._allowed_bits.shape[1]), np.uint32)
  allowed[:s] = dfa._allowed_bits
  trans = np.zeros((s_max, a_max), np.int32)
  trans[:s, :a] = dfa.char_dfa.trans
  atoms = np.zeros((dfa.vocab_size, l_max), np.int32)
  atoms[:, :l] = dfa._token_atoms
  return allowed, trans, atoms, dfa._token_lengths, dfa.char_dfa.start


def stack_constraints(
    dfas: Sequence[TokenDFA],
    vocab_size: int,
    extra_slots: int = 0,
    min_dims: tuple[int, int, int] = (1, 1, 1),
    device=None,
) -> StackedConstraintTables:
  """Builds a serving grammar registry: [allow-all] + ``dfas`` (JAX
  ``constrain.py:931-982``).

  Registered grammar ``k`` of ``dfas`` becomes id ``k + 1``; id 0 is the
  allow-all grammar. Every DFA must have been compiled for the same
  ``vocab_size`` vocabulary. ``extra_slots`` reserves trailing allow-all
  slots for runtime registration (``ContinuousBatcher.register_grammar``
  overwrites them in place, so table shapes, and the captured steps that
  read them, never change); ``min_dims = (states, atoms, token_len)``
  floors the padded dims so those grammars fit. ``device``: ``None`` means
  CUDA and raises without a card.
  """
  from cadence_gemma_tpu_torch.models import griffin  # pylint: disable=import-outside-toplevel

  device = griffin.resolve_device(device)
  for i, dfa in enumerate(dfas):
    if dfa.vocab_size != vocab_size:
      raise ValueError(
          f"constraints[{i}] was compiled for a {dfa.vocab_size}-token "
          f"vocabulary; the serving vocabulary has {vocab_size}."
      )
  n_words = (vocab_size + 31) // 32
  s_max = max([min_dims[0], 1] + [d.n_states for d in dfas])
  a_max = max([min_dims[1], 1] + [d.char_dfa.trans.shape[1] for d in dfas])
  l_max = max([min_dims[2], 1] + [d._token_atoms.shape[1] for d in dfas])
  g = len(dfas) + 1 + extra_slots

  allowed = np.zeros((g, s_max, n_words), dtype=np.uint32)
  trans = np.zeros((g, s_max, a_max), dtype=np.int32)
  atoms = np.zeros((g, vocab_size, l_max), dtype=np.int32)
  lengths = np.zeros((g, vocab_size), dtype=np.int32)
  start = np.zeros((g,), dtype=np.int32)

  # Grammar 0 -- and every reserved dynamic slot until registered -- is
  # allow-all (the mask is the identity, zero lengths never advance). Bits
  # beyond vocab_size are set but harmless: the mask slices to the logits'
  # width.
  allowed[0] = np.uint32(0xFFFFFFFF)
  allowed[len(dfas) + 1:] = np.uint32(0xFFFFFFFF)
  for k, dfa in enumerate(dfas, start=1):
    (allowed[k], trans[k], atoms[k], lengths[k],
     start[k]) = pad_grammar(dfa, s_max, a_max, l_max)

  as_dev = functools.partial(torch.as_tensor, device=device)
  return StackedConstraintTables(
      allowed_bits=as_dev(allowed.view(np.int32)),
      trans=as_dev(trans),
      token_atoms=as_dev(atoms),
      token_lengths=as_dev(lengths),
      start=as_dev(start),
  )

_BYTE_PIECE = None  # compiled lazily (regex import kept out of hot paths)


def token_strings_from_vocab(vocab: Any, vocab_size: int) -> list:
  """Per-id emitted text for a Vocabulary.

  Prefers SentencePiece's ``IdToPiece`` (mapping the ``▁`` word-boundary
  marker to a space — the text a piece contributes to ``DecodeIds``),
  with the real tokenizer's two edge classes handled:

    * byte-fallback pieces (``<0x0A>`` etc.) map to their actual byte —
      the literal 6-character string would make the grammar treat a
      newline token as the text "<0x0A>";
    * control pieces (``IsControl``, e.g. ``<start_of_turn>``) come back
      empty — they make no text progress, so :class:`TokenDFA` forbids
      them (stop ids get their own columns).

  Falls back to single-id ``DecodeIds``. Pad/bos/eos and anything
  decoding to '' are empty/forbidden likewise.
  """
  global _BYTE_PIECE
  if _BYTE_PIECE is None:
    import re as _re

    _BYTE_PIECE = _re.compile(r"^<0x([0-9A-Fa-f]{2})>$")
  out = []
  specials = {int(vocab.pad_id()), int(vocab.bos_id()), int(vocab.eos_id())}
  has_piece = hasattr(vocab, "IdToPiece")
  is_control = getattr(vocab, "IsControl", None)
  is_byte = getattr(vocab, "IsByte", None)
  for i in range(vocab_size):
    if i in specials:
      out.append("")
      continue
    try:
      if has_piece:
        if is_control is not None and is_control(i):
          out.append("")
          continue
        piece = vocab.IdToPiece(i)
        m = _BYTE_PIECE.match(piece)
        if m and (is_byte is None or is_byte(i)):
          # Byte-fallback token: contributes one raw byte. Non-ASCII
          # bytes are utf-8 FRAGMENTS; chr() here treats them as
          # latin-1 stand-ins, which is exact for ASCII (the bytes any
          # ASCII grammar can mention) and safely dead otherwise.
          out.append(chr(int(m.group(1), 16)))
        else:
          out.append(piece.replace("▁", " "))
      else:
        out.append(vocab.DecodeIds([i]))
    except (IndexError, ValueError):
      out.append("")
  return out


# -- grammars -----------------------------------------------------------------


def escape_literal(text: str) -> str:
  """Escapes ``text`` so it matches itself under :func:`compile_regex`."""
  return "".join(
      "\\" + ch if ch in r"\.[](){}|*+?^-" or ch in "\n\t\r" else ch
      for ch in text
  )


def choice_regex(options: Sequence[str]) -> str:
  """A grammar accepting exactly one of ``options`` (classifier mode)."""
  if not options:
    raise ValueError("choice_regex needs at least one option")
  return "|".join(f"({escape_literal(o)})" for o in options)


def json_mode_dfa(
    vocab: Any,
    vocab_size: int,
    max_depth: int = 3,
    compact: bool = False,
    extra_stop_ids: Sequence[int] = (),
) -> TokenDFA:
  """The serving "JSON mode" grammar, compiled for ``vocab``.

  Register it on a batcher (``ContinuousBatcher(constraints=[dfa])``) and
  name it for the HTTP front end (``ServingFrontend(constraint_names=
  {"json_object": 0})``) to serve OpenAI ``response_format:
  {"type": "json_object"}`` requests.
  """
  return TokenDFA(
      json_regex(max_depth=max_depth, compact=compact),
      token_strings_from_vocab(vocab, vocab_size),
      eos_id=int(vocab.eos_id()),
      extra_stop_ids=extra_stop_ids,
  )


# JSON lexical grammars (RFC 8259), shared by json_regex / schema_regex.
_JSON_STRING = '"([^"\\\\\\n\\t]|\\\\(["\\\\/bfnrt]|u[0-9a-fA-F]{4}))*"'
_JSON_NUMBER = "-?(0|[1-9][0-9]*)(\\.[0-9]+)?([eE][+-]?[0-9]+)?"


def schema_regex(
    schema: dict,
    compact: bool = True,
    max_array_items: int = 8,
) -> str:
  """A grammar for JSON documents matching a JSON-Schema subset.

  The OpenAI "strict structured outputs" subset: objects must list every
  property in ``required`` (fixed emission order = declaration order),
  ``additionalProperties`` must not be truthy, and the supported types
  are ``object``, ``array`` (``items`` + ``minItems``/``maxItems``,
  default 0..``max_array_items``), ``string`` (+ ``enum``/``const``),
  ``integer``, ``number``, ``boolean``, ``null``, plus ``anyOf``.
  Numeric ranges (``minimum``/``maximum``) and string ``pattern`` are
  NOT enforced (regular languages can't count) — validate post-hoc if
  needed. Nesting depth is the schema's own depth; nothing is bounded
  artificially.

  ``compact``: forbid whitespace between structural characters (smaller
  DFA, canonical output). The result feeds :class:`TokenDFA` /
  :func:`schema_dfa`.
  """
  import json as _json

  ws = "" if compact else "[ \\n\\t]{0,8}"
  string_rx = _JSON_STRING
  number_rx = _JSON_NUMBER
  integer_rx = "-?(0|[1-9][0-9]*)"

  def literal(value) -> str:
    return escape_literal(_json.dumps(value))

  def value_rx(s: dict, path: str) -> str:
    if not isinstance(s, dict):
      raise ValueError(f"schema at {path} must be an object, got {s!r}")
    if "anyOf" in s:
      return "(" + "|".join(
          value_rx(opt, f"{path}.anyOf[{i}]")
          for i, opt in enumerate(s["anyOf"])
      ) + ")"
    if "const" in s:
      return literal(s["const"])
    if "enum" in s:
      if not s["enum"]:
        raise ValueError(f"empty enum at {path}")
      return "(" + "|".join(literal(v) for v in s["enum"]) + ")"
    t = s.get("type")
    if isinstance(t, list):
      return "(" + "|".join(
          value_rx({**s, "type": one}, path) for one in t
      ) + ")"
    if t == "string":
      return string_rx
    if t == "integer":
      return integer_rx
    if t == "number":
      return number_rx
    if t == "boolean":
      return "(true|false)"
    if t == "null":
      return "null"
    if t == "array":
      item = value_rx(s.get("items", {"type": "number"}), f"{path}.items")
      lo = int(s.get("minItems", 0))
      hi = int(s.get("maxItems", max_array_items))
      if hi < lo:
        raise ValueError(f"maxItems < minItems at {path}")
      if hi == 0:
        return f"\\[{ws}\\]"
      more = f"({ws},{ws}{item}){{{max(lo - 1, 0)},{hi - 1}}}"
      body = f"{item}{more}"
      if lo == 0:
        body = f"({body})?"
      return f"\\[{ws}{body}{ws}\\]"
    if t == "object":
      props = s.get("properties", {})
      required = list(s.get("required", []))
      if set(required) != set(props):
        raise ValueError(
            f"object at {path} must require every property (strict "
            f"structured outputs); properties={sorted(props)} "
            f"required={sorted(required)}"
        )
      if s.get("additionalProperties", False):
        raise ValueError(
            f"additionalProperties must be false/absent at {path}"
        )
      if not props:
        return f"\\{{{ws}\\}}"
      pairs = [
          f"{literal(name)}{ws}:{ws}"
          + value_rx(sub, f"{path}.{name}")
          for name, sub in props.items()
      ]
      inner = f"{ws},{ws}".join(pairs)
      return f"\\{{{ws}{inner}{ws}\\}}"
    raise ValueError(f"unsupported schema type {t!r} at {path}")

  return value_rx(schema, "$")


def tool_call_schema(
    tools: Sequence[dict],
    tool_name: str | None = None,
) -> dict:
  """A JSON-Schema (strict subset) for an OpenAI-style tool-call envelope.

  The constrained completion is forced to be exactly one call,
  ``{"name": <tool>, "arguments": <args>}``, where ``<tool>`` ranges over
  the declared function names and ``<args>`` matches that tool's
  ``parameters`` schema (strict structured-outputs subset — the same
  rules as ``response_format: json_schema``). Feed the result to
  :func:`schema_regex`/:func:`schema_dfa` or pass it as a per-request
  constraint; the serving layer uses it for ``tool_choice: "required"``
  and named-function ``tool_choice``.

  Args:
    tools: OpenAI ``tools`` entries: ``{"type": "function", "function":
      {"name": ..., "parameters": <json-schema>}}`` (a missing
      ``parameters`` means no arguments — an empty object).
    tool_name: Restrict the envelope to this one function
      (``tool_choice: {"type": "function", "function": {"name": ...}}``).

  Raises:
    ValueError: malformed tools, duplicate/unknown names. (Parameter
      schemas outside the strict subset raise later, in
      :func:`schema_regex`.)
  """
  branches = []
  seen: set[str] = set()
  for i, tool in enumerate(tools):
    if not isinstance(tool, dict) or tool.get("type") != "function":
      raise ValueError(f"tools[{i}] must be {{'type': 'function', ...}}")
    fn = tool.get("function")
    if not isinstance(fn, dict) or not isinstance(fn.get("name"), str):
      raise ValueError(f"tools[{i}].function needs a string 'name'")
    name = fn["name"]
    if name in seen:
      raise ValueError(f"duplicate tool name {name!r}")
    seen.add(name)
    if tool_name is not None and name != tool_name:
      continue
    params = fn.get("parameters")
    if params is None:
      params = {"type": "object", "properties": {}, "required": []}
    branches.append({
        "type": "object",
        "properties": {"name": {"const": name}, "arguments": params},
        "required": ["name", "arguments"],
    })
  if not branches:
    raise ValueError(
        f"tool_choice names {tool_name!r}, which is not in tools"
        if tool_name is not None else "tools must be non-empty"
    )
  return branches[0] if len(branches) == 1 else {"anyOf": branches}


def schema_dfa(
    schema: dict,
    vocab: Any,
    vocab_size: int,
    compact: bool = True,
    extra_stop_ids: Sequence[int] = (),
) -> TokenDFA:
  """Compiles a JSON-Schema (strict subset) constraint for ``vocab``.

  The per-request form behind OpenAI ``response_format:
  {"type": "json_schema", ...}`` serving.
  """
  return TokenDFA(
      schema_regex(schema, compact=compact),
      token_strings_from_vocab(vocab, vocab_size),
      eos_id=int(vocab.eos_id()),
      extra_stop_ids=extra_stop_ids,
  )


def json_regex(max_depth: int = 3, compact: bool = False) -> str:
  """A grammar for JSON values with nesting bounded at ``max_depth``.

  JSON is not regular; bounding depth is the standard regex-constraint
  tradeoff (beyond it, arrays/objects may only hold scalars). Depth grows
  the DFA ~4x per level — 3 keeps table build sub-second on a real vocab.

  ``compact``: forbid whitespace between structural characters (fewer
  states, canonical output).
  """
  ws = "" if compact else "[ \\n\\t]{0,8}"
  string = _JSON_STRING
  number = _JSON_NUMBER
  scalar = f"({string}|{number}|true|false|null)"

  def value(d: int) -> str:
    if d <= 0:
      return scalar
    inner = value(d - 1)
    pair = f"{string}{ws}:{ws}{inner}"
    obj = f"\\{{{ws}({pair}({ws},{ws}{pair})*)?{ws}\\}}"
    arr = f"\\[{ws}({inner}({ws},{ws}{inner})*)?{ws}\\]"
    return f"({scalar}|{obj}|{arr})"

  return value(max_depth)
