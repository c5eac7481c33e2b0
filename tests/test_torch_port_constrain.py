"""The port's grammar-constrained decoding against the JAX package's, on the CPU.

``inference/constrain.py`` in both packages runs the same numpy code (and the
same native walker, ``native/constrain.cc``), so the host side is held to
JAX's bit for bit: ``compile_regex`` over JAX's ``PATTERNS``, ``TokenDFA``'s
packed bits, atoms, lengths and stuck states (native and numpy walks), and
``.npz`` files saved by one package and loaded by the other. The device
tables' ``mask`` / ``advance`` (single, stacked, bound to per-row grammar
ids) equal JAX's jitted ones exactly, a token in bit 31 of its word
included: the port keeps JAX's ``uint32`` words as ``int32``.

End to end, on ``tests/test_torch_port_serving.py``'s tiny Griffin (an R
and an A block, width 16, window 8, float32, seeded std-0.5 normal weights)
over ``tests/test_constrain.py``'s character vocabulary: JAX's
``TestConstrainedSampling``, ``TestSpeculativeConstraints``,
``TestBatcherConstraints`` and ``TestDynamicGrammarSlots`` cases and
``test_constraint_composes_with_min_tokens``, each greedy case held to JAX's
tokens exactly (float32 on both sides; an argmax flips only on a near tie,
which these prompts do not hit); categorical outputs stay in the grammar;
the returned logits are the unmasked ones (JAX's within 1e-5). The
``ModalSampler`` with a grammar on the golden fixture's tiny model and
towers gives JAX's tokens.

Card tests (they skip here): captured against eager for a constrained decode
step and a constrained tick, and for the constrained verify step.
"""

import itertools
import os
import re

import numpy as np
import pytest
import torch

from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch import convert
from cadence_gemma_tpu_torch.inference import constrain
from cadence_gemma_tpu_torch.inference import sampler as sampler_lib
from cadence_gemma_tpu_torch.inference import serving
from cadence_gemma_tpu_torch.inference import speculative
from cadence_gemma_tpu_torch.utils import constrain_cpp

requires_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA device"
)

LOGITS_ATOL = 1e-5  # float32 on both sides, summed in other orders


class CharVocab:
  """``tests/test_constrain.py``'s character vocabulary: 0 pad, 1 bos, 2 eos,
  3 unk, then one id a piece (pieces may be multi-character)."""

  def __init__(self, pieces):
    self.pieces = list(pieces)
    self._ids = {p: i + 4 for i, p in enumerate(self.pieces)}

  def pad_id(self):
    return 0

  def bos_id(self):
    return 1

  def eos_id(self):
    return 2

  def GetPieceSize(self):  # noqa: N802
    return len(self.pieces) + 4

  def EncodeAsIds(self, text):  # noqa: N802
    ids, i = [], 0
    while i < len(text):
      for length in range(min(4, len(text) - i), 0, -1):
        piece = text[i:i + length]
        if piece in self._ids:
          ids.append(self._ids[piece])
          i += length
          break
      else:
        ids.append(3)
        i += 1
    return ids

  def DecodeIds(self, ids):  # noqa: N802
    return "".join(self.pieces[i - 4] for i in ids
                   if 4 <= i < len(self.pieces) + 4)

  def token_strings(self):
    return ["", "", "", ""] + self.pieces


# JAX's test_constrain.py PATTERNS, over its ALPHABET.
ALPHABET = "abcd1 "
PATTERNS = [
    "a*b", "(ab|cd)+", "[a-c]{2,4}", "a?b{2}c*", "(a|bc)*d", "[^a]b.",
    "\\d+", "a{2}", "a{2,}", "(?:ab)?c", "[ab][^cd]", "a|", "a b",
    "(a|b)(c|d)*", "[a-c1]+d?",
]
PIECES = ["a", "b", "c", "d", "ab", "cd", "cat", "dog", "t", "g", "o"]
WIDE = ([f"{a}{b}" for a in "abcd" for b in "abcd"] + list("abcd1 ")
        + [f"{a}1" for a in "abcd"] + [f"1{a}" for a in "abcd"])
JSON_PIECES = list('{}[]:,"0123456789-.eEtruefalsn ab') + [
    '{"', '":', '",', "true", "null", "12", '"a', 'b"', "false"]
SCHEMA = {"type": "object",
          "properties": {"a": {"type": "boolean"},
                         "b": {"type": "array", "items": {"type": "integer"},
                               "maxItems": 2}},
          "required": ["a", "b"]}


def _jax():
  """The JAX modules, imported here so the card tests run without JAX."""
  import jax  # pylint: disable=import-outside-toplevel
  import jax.numpy as jnp  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu.inference import constrain as jconstrain  # pylint: disable=import-outside-toplevel
  return jax, jnp, jconstrain


def _port_config(config):
  fields = config._asdict()
  fields["block_types"] = tuple(
      common.TemporalBlockType[b.name] for b in config.block_types)
  fields["scan_type"] = common.ScanType[config.scan_type.name]
  return common.GriffinConfig(**fields)


class Setup:
  """The tiny model in both packages over the character vocabulary."""

  def __init__(self):
    jax, jnp, _ = _jax()
    from cadence_gemma_tpu import common as jcommon  # pylint: disable=import-outside-toplevel
    from cadence_gemma_tpu.models import griffin as jgriffin  # pylint: disable=import-outside-toplevel

    self.vocab = CharVocab(PIECES)
    config = jcommon.GriffinConfig(
        vocab_size=self.vocab.GetPieceSize(), width=16,
        mlp_expanded_width=32, num_heads=2,
        block_types=(jcommon.TemporalBlockType.RECURRENT,
                     jcommon.TemporalBlockType.ATTENTION),
        embeddings_scale_by_sqrt_dim=True, attention_window_size=8,
        logits_soft_cap=30.0, lru_width=16,
        scan_type=jcommon.ScanType.LINEAR_NATIVE,
    )
    self.jmodel = jgriffin.Griffin(config, dtype=jnp.float32,
                                   param_dtype=jnp.float32,
                                   gradient_checkpointing=False)
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(self.jmodel.init, jax.random.PRNGKey(0),
                            jnp.ones((1, 4), jnp.int32),
                            jnp.arange(4)[None])["params"]
    params = jax.tree_util.tree_map(
        lambda x: (0.5 * rng.standard_normal(x.shape)).astype(np.float32),
        shapes)
    self.jparams = jax.tree_util.tree_map(jnp.asarray, params)
    self.model = convert.griffin_from_flax_params(
        params, _port_config(config), device="cpu", dtype=torch.float32)
    self._jax = {}
    self._dfas = {}

  def port(self, **kwargs):
    return sampler_lib.Sampler(self.model, self.vocab, device="cpu", **kwargs)

  def jax_sampler(self, **kwargs):
    from cadence_gemma_tpu.inference import sampler as jsampler  # pylint: disable=import-outside-toplevel

    key = tuple(sorted(kwargs.items()))
    if key not in self._jax:
      self._jax[key] = jsampler.Sampler(
          self.jmodel, self.vocab, self.jparams,
          bucket_prompt_lengths=False, **kwargs)
    return self._jax[key]

  def dfa(self, pattern, **kw):
    """(port TokenDFA, JAX TokenDFA) of ``pattern`` over the vocabulary."""
    key = (pattern, tuple(sorted(kw.items())))
    if key not in self._dfas:
      strings = self.vocab.token_strings()
      self._dfas[key] = (
          constrain.TokenDFA(pattern, strings, eos_id=2, **kw),
          _jax()[2].TokenDFA(pattern, strings, eos_id=2, **kw))
    return self._dfas[key]


@pytest.fixture(scope="module")
def setup():
  return Setup()


def _ids(tokens):
  return [int(t) for t in np.asarray(tokens)]


def _text(vocab, tokens):
  """The decoded generation before the first stop (or pad), and whether a
  stop ended it."""
  ids = []
  for t in _ids(tokens):
    if t in (vocab.eos_id(), vocab.pad_id()):
      return vocab.DecodeIds(ids), t == vocab.eos_id()
    ids.append(t)
  return vocab.DecodeIds(ids), False


def _assert_in_grammar(dfa, vocab, tokens):
  text, stopped = _text(vocab, tokens)
  assert (dfa.allows_text(text) if stopped
          else dfa.is_live_prefix(text)), (text, stopped)
  return text


# -- the host side, bit for bit ---------------------------------------------------


@pytest.mark.parametrize("pattern", PATTERNS)
def test_compile_regex_matches_jax(pattern):
  jconstrain = _jax()[2]
  for minimize in (True, False):
    got = constrain.compile_regex(pattern, ALPHABET, minimize=minimize)
    want = jconstrain.compile_regex(pattern, ALPHABET, minimize=minimize)
    np.testing.assert_array_equal(got.trans, want.trans)
    np.testing.assert_array_equal(got.accepting, want.accepting)
    assert (got.start, got.dead) == (want.start, want.dead)
    assert got.atom_of == want.atom_of
    for n in range(4):
      for chars in itertools.product(ALPHABET, repeat=n):
        text = "".join(chars)
        assert got.accepts(text) == bool(re.fullmatch(pattern, text))


GRAMMARS = {
    "pairs": ("(ab|cd)+", WIDE + ["cat", "dog", "catd", "é"]),
    "words": ("(cat|dog)( (cat|dog))*", WIDE + ["cat", "dog", "catd"]),
    "counted": ("[a-c]{2,5}d?", WIDE),
    "stuck": ("ab", ["a", "c"]),
    "json": (None, JSON_PIECES),
    "schema": (None, JSON_PIECES),
}


@pytest.mark.parametrize("name", list(GRAMMARS))
@pytest.mark.parametrize("native", [True, False])
def test_token_dfa_matches_jax(name, native):
  jconstrain = _jax()[2]
  pattern, pieces = GRAMMARS[name]
  if name == "json":
    pattern = constrain.json_regex(max_depth=1, compact=True)
    assert pattern == jconstrain.json_regex(max_depth=1, compact=True)
  elif name == "schema":
    pattern = constrain.schema_regex(SCHEMA)
    assert pattern == jconstrain.schema_regex(SCHEMA)
  if native:
    assert constrain_cpp.available()
  vocab = CharVocab(pieces)
  kw = dict(token_strings=vocab.token_strings(), eos_id=2,
            extra_stop_ids=[3], _use_native=native)
  got = constrain.TokenDFA(pattern, **kw)
  want = jconstrain.TokenDFA(pattern, **kw)
  for attr in ("_allowed_bits", "_token_atoms", "_token_lengths"):
    np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))
    assert getattr(got, attr).dtype == getattr(want, attr).dtype
  np.testing.assert_array_equal(got.char_dfa.trans, want.char_dfa.trans)
  assert got._stuck_states == want._stuck_states
  assert (got.n_states, got.n_unique_tokens, got.stop_ids) == (
      want.n_states, want.n_unique_tokens, want.stop_ids)


def test_npz_round_trip_between_packages(tmp_path):
  jconstrain = _jax()[2]
  vocab = CharVocab(["a", "b", "c", "d", "ab", "cd", "x"])
  args = ("(ab|cd)+x?", vocab.token_strings())
  for saver, loader in ((jconstrain.TokenDFA, constrain.TokenDFA),
                        (constrain.TokenDFA, jconstrain.TokenDFA)):
    dfa = saver(*args, eos_id=2)
    path = str(tmp_path / f"{saver.__module__.split('.')[0]}.npz")
    dfa.save(path)
    back = loader.load(path)
    for attr in ("_allowed_bits", "_token_atoms", "_token_lengths"):
      np.testing.assert_array_equal(getattr(back, attr), getattr(dfa, attr))
    np.testing.assert_array_equal(back.char_dfa.trans, dfa.char_dfa.trans)
    assert back.char_dfa.atom_of == dfa.char_dfa.atom_of
    assert (back.pattern, back.stop_ids, back._stuck_states) == (
        dfa.pattern, dfa.stop_ids, dfa._stuck_states)
    assert back.allows_text("abcd") and not back.allows_text("ac")


# -- the device tables against JAX's jitted ones ---------------------------------


def _bit31_dfa():
  """A vocabulary of 64 ids where id 31 (bit 31 of word 0) and id 63 are
  allowed in some states and forbidden in others."""
  pieces = WIDE + ["x"] * (64 - 4 - len(WIDE))
  pieces[31 - 4], pieces[63 - 4] = "c1", "1c"
  vocab = CharVocab(pieces)
  pattern = "([ab]c|d1)*[ab]?1?c?"
  strings = vocab.token_strings()
  return (vocab, constrain.TokenDFA(pattern, strings, eos_id=2),
          _jax()[2].TokenDFA(pattern, strings, eos_id=2))


def test_mask_and_advance_match_jax():
  jax, jnp, jconstrain = _jax()
  vocab, dfa, jdfa = _bit31_dfa()
  assert dfa._allowed_bits[:, 0].max() >= 2**31  # a set bit 31
  rng = np.random.default_rng(1)
  n = 4096
  states = rng.integers(0, dfa.n_states, n).astype(np.int32)
  states[:2 * dfa.n_states] = np.repeat(np.arange(dfa.n_states), 2)
  tokens = rng.integers(0, vocab.GetPieceSize(), n).astype(np.int32)
  tokens[:2 * dfa.n_states] = np.tile([31, 63], dfa.n_states)
  logits = rng.standard_normal((n, vocab.GetPieceSize())).astype(np.float32)
  tables = dfa.tables(device="cpu")
  assert tables.allowed_bits.dtype == torch.int32

  @jax.jit
  def jstep(t, s, lg, tok):
    return t.mask(s, lg), t.advance(s, tok)

  want_m, want_a = jstep(jdfa.tables, jnp.asarray(states),
                         jnp.asarray(logits), jnp.asarray(tokens))
  got_m = tables.mask(torch.tensor(states), torch.tensor(logits))
  got_a = tables.advance(torch.tensor(states), torch.tensor(tokens))
  np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
  np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
  assert got_a.dtype == torch.int32
  allowed31 = [dfa.token_allowed(s, 31) for s in range(dfa.n_states)]
  assert any(allowed31) and not all(allowed31)
  for s in range(dfa.n_states):  # the host mirrors
    for v in (31, 63):
      assert np.isfinite(got_m[2 * s + (v == 63), v].item()) == (
          dfa.token_allowed(s, v))

  # The registry: allow-all, the grammar, and a reserved slot written later.
  other = constrain.TokenDFA("(1a|b)+", vocab.token_strings(), eos_id=2)
  jother = jconstrain.TokenDFA("(1a|b)+", vocab.token_strings(), eos_id=2)
  reg = constrain.stack_constraints([dfa], vocab.GetPieceSize(),
                                    extra_slots=1, min_dims=(16, 8, 2),
                                    device="cpu")
  reg.write(2, other)
  jreg = jconstrain.stack_constraints([jdfa, jother], vocab.GetPieceSize(),
                                      min_dims=(16, 8, 2))
  np.testing.assert_array_equal(reg.allowed_bits.numpy().view(np.uint32),
                                np.asarray(jreg.allowed_bits))
  gid = rng.integers(0, 3, n).astype(np.int32)
  st = np.where(gid == 2, states % other.n_states,
                np.where(gid == 0, 0, states)).astype(np.int32)

  @jax.jit
  def jstacked(t, g, s, lg, tok):
    bound = jconstrain.BoundConstraint(tables=t, gid=g)
    return (t.mask(g, s, lg), t.advance(g, s, tok),
            bound.mask(s, lg), bound.advance(s, tok))

  want = jstacked(jreg, jnp.asarray(gid), jnp.asarray(st),
                  jnp.asarray(logits), jnp.asarray(tokens))
  g_t, s_t = torch.tensor(gid), torch.tensor(st)
  lg_t, tok_t = torch.tensor(logits), torch.tensor(tokens)
  bound = constrain.BoundConstraint(tables=reg, gid=g_t)
  got = (reg.mask(g_t, s_t, lg_t), reg.advance(g_t, s_t, tok_t),
         bound.mask(s_t, lg_t), bound.advance(s_t, tok_t))
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
  # A [b, n] state block (the verify's positions) masks as n [b] calls.
  block = torch.stack([s_t, s_t.flip(0)], dim=1)
  lg2 = torch.stack([lg_t, lg_t], dim=1)
  both = bound.mask(block, lg2)
  torch.testing.assert_close(both[:, 0], got[2], rtol=0, atol=0)
  torch.testing.assert_close(both[:, 1], reg.mask(g_t, s_t.flip(0), lg_t),
                             rtol=0, atol=0)
  s_other = torch.tensor(states % other.n_states)
  torch.testing.assert_close(
      reg.single(2).mask(s_other, lg_t),
      other.tables(device="cpu").mask(s_other, lg_t), rtol=0, atol=0)


def test_tables_need_a_card_unless_asked(monkeypatch):
  _, dfa, _ = _bit31_dfa()
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    dfa.tables()
  with pytest.raises(RuntimeError, match="device='cpu'"):
    constrain.stack_constraints([dfa], 64)


# -- the Sampler: JAX's TestConstrainedSampling ----------------------------------


def _both(setup, prompts, steps, pattern, sampler_kw=None, **kw):
  """The port's and JAX's outputs of one constrained call."""
  dfa, jdfa = setup.dfa(pattern)
  got = setup.port(**(sampler_kw or {}))(prompts, steps, constraint=dfa,
                                         **kw)
  want = setup.jax_sampler(**(sampler_kw or {}))(
      prompts, total_generation_steps=steps, constraint=jdfa, **kw)
  for g, w in zip(got.tokens, want.tokens):
    assert _ids(g) == _ids(w), (pattern, _ids(g), _ids(w))
  return got, dfa


@pytest.mark.parametrize("case", [
    ("greedy", ["ab cd"], 10, "[ab]{2,4}", {}, {}),
    ("choice", ["a", "d"], 8, "(cat)|(dog)", {}, {}),
    ("echo", ["ab ab"], 6, "[cd]{2}", {}, dict(echo=True)),
    ("chunked", ["ab cd ab cd ab cd"], 10, "[ab]{2,4}",
     dict(prefill_chunk_size=4), {}),
    ("penalty", ["ab"], 10, "[abcd]{3,6}", dict(repetition_penalty=1.3), {}),
    ("no_stop", ["ab cd"], 5, "[abcd]+", {},
     dict(end_sampling_at_eos_token=False)),
], ids=lambda c: c[0])
def test_constrained_sampler_matches_jax(setup, case):
  _, prompts, steps, pattern, sampler_kw, kw = case
  got, dfa = _both(setup, prompts, steps, pattern, sampler_kw, **kw)
  for row, tokens in enumerate(got.tokens):
    if kw.get("echo"):
      tokens = tokens[len(setup.vocab.EncodeAsIds(prompts[row])) + 1:]
    text = _assert_in_grammar(dfa, setup.vocab, tokens)
    if case[0] in ("greedy", "choice", "echo", "chunked", "penalty"):
      assert dfa.allows_text(text), text  # these stop inside the budget


def test_unconstrained_output_would_violate(setup):
  """The constraint changes the output: the free generation leaves the
  grammar (otherwise the cases above prove nothing)."""
  dfa, _ = setup.dfa("(cat)|(dog)")
  free = setup.port()(["a", "d"], 8)
  texts = [_text(setup.vocab, t)[0] for t in free.tokens]
  assert any(t not in ("cat", "dog") for t in texts), texts


def test_prefix_and_conversation_restart_the_grammar(setup):
  """A prefix continuation and a second conversation turn each start at the
  grammar's start state (JAX ``sampler.py:1228-1266``)."""
  dfa, jdfa = setup.dfa("[ab]{2,4}")
  s, js = setup.port(), setup.jax_sampler()
  for prefix, jprefix in ((s.prefill_prefix("ab cd"),
                           js.prefill_prefix("ab cd")),):
    got = s(["cd"], 10, prefix_state=prefix, constraint=dfa)
    want = js(["cd"], total_generation_steps=10, prefix_state=jprefix,
              constraint=jdfa)
    assert _ids(got.tokens[0]) == _ids(want.tokens[0])
    assert dfa.allows_text(_text(setup.vocab, got.tokens[0])[0])
  got = s(["ab"], 6, constraint=dfa, return_state=True)
  want = js(["ab"], total_generation_steps=6, constraint=jdfa,
            return_state=True)
  turn2 = s(["cd"], 6, prefix_state=got.state, constraint=dfa)
  jturn2 = js(["cd"], total_generation_steps=6, prefix_state=want.state,
              constraint=jdfa)
  assert _ids(turn2.tokens[0]) == _ids(jturn2.tokens[0])
  assert dfa.allows_text(_text(setup.vocab, turn2.tokens[0])[0])


def test_categorical_stays_in_grammar(setup):
  dfa, _ = setup.dfa("(cat|dog)( (cat|dog)){0,2}")
  s = setup.port(deterministic_sampling=False, temperature=1.5, top_k=8)
  for seed in range(4):
    out = s(["ab"], 16, generator=torch.Generator().manual_seed(seed),
            constraint=dfa)
    _assert_in_grammar(dfa, setup.vocab, out.tokens[0])


def test_state_and_logits(setup):
  """The prefill returns int32 DFA states, the mask keeps the returned logits
  unmasked (JAX's within 1e-5), and a vocabulary mismatch raises."""
  dfa, jdfa = setup.dfa("[ab]{2,4}")
  s = setup.port()
  got = s(["ab cd"], 4, constraint=dfa, return_logits=True,
          end_sampling_at_eos_token=False)
  want = setup.jax_sampler()(["ab cd"], total_generation_steps=4,
                             constraint=jdfa, return_logits=True,
                             end_sampling_at_eos_token=False)
  assert torch.isfinite(got.logits[0]).all()
  np.testing.assert_allclose(got.logits[0].numpy(), np.asarray(want.logits[0]),
                             rtol=0, atol=LOGITS_ATOL)
  free = s(["ab cd"], 1, return_logits=True)
  torch.testing.assert_close(got.logits[0][0], free.logits[0][0])
  tables = dfa.tables(device="cpu")
  state = s._prefill(torch.tensor([[1, 4, 5]]), torch.tensor([3]), 2, False,
                     False, None, constraint_tables=tables)
  assert state.constraint_state.dtype == torch.int32
  assert int(state.constraint_state[0]) == dfa.token_advance(
      dfa.char_dfa.start, int(state.tokens_buffer[0, 0]))
  wrong = constrain.TokenDFA("[ab]+", ["", "", "", "a", "b"], eos_id=2)
  with pytest.raises(ValueError, match="vocabulary"):
    s(["ab"], 4, constraint=wrong)
  # The tables themselves are accepted, as JAX accepts ``.tables``.
  out = s(["ab cd"], 10, constraint=tables)
  assert _ids(out.tokens[0]) == _ids(s(["ab cd"], 10,
                                       constraint=dfa).tokens[0])


# -- the ModalSampler on the golden fixture --------------------------------------


def test_modal_sampler_with_a_grammar_matches_jax():
  jax, jnp, jconstrain = _jax()
  from cadence_gemma_tpu.inference import modal_sampler as jmodal  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu.models import griffin as jgriffin  # pylint: disable=import-outside-toplevel
  import cadence_gemma_tpu_torch as port  # pylint: disable=import-outside-toplevel
  from cadence_gemma_tpu_torch.inference import modal_sampler  # pylint: disable=import-outside-toplevel
  from tests import make_golden_fixture as gold  # pylint: disable=import-outside-toplevel

  jvocab, tower, enc, jconfig, _ = gold.build()
  params = convert.read_npz_params(gold.FIXTURE, "p")
  vparams = convert.read_npz_params(gold.FIXTURE, "v")
  jmodel = jgriffin.Griffin(jconfig, dtype=jnp.float32,
                            param_dtype=jnp.float32,
                            gradient_checkpointing=False)
  tmodel = convert.griffin_from_flax_params(
      params, _port_config(jconfig), device="cpu", dtype=torch.float32)
  ptower = port.ViTConfig(**{f: getattr(tower, f)
                             for f in port.ViTConfig.__dataclass_fields__})
  tenc = convert.encoder_from_flax_params(vparams, ptower, ptower,
                                          device="cpu", dtype=torch.float32)
  vocab = port.SimpleVocab(gold.WORDS)
  ts = modal_sampler.ModalSampler(tmodel, vocab, tenc, device="cpu")
  js = jmodal.ModalSampler(
      jmodel, jvocab, jax.tree_util.tree_map(jnp.asarray, params),
      vision_encoder=enc,
      vision_params=jax.tree_util.tree_map(jnp.asarray, vparams),
      bucket_prompt_lengths=False)
  pattern = "(red|car)(dog|cart){1,3}"
  size = tmodel.config.vocab_size
  dfa = constrain.TokenDFA(
      pattern, constrain.token_strings_from_vocab(vocab, size),
      eos_id=vocab.eos_id())
  jdfa = jconstrain.TokenDFA(
      pattern, jconstrain.token_strings_from_vocab(jvocab, size),
      eos_id=jvocab.eos_id())
  pixels = np.asarray(tenc.preprocess_path(
      os.path.join(os.path.dirname(gold.FIXTURE), "dog.jpg")))
  features = ts.encode(torch.tensor(pixels))
  kw = dict(total_generation_steps=6, return_logits=True)
  for image in ("pixels", "img_embed"):
    got = ts([gold.MM_PROMPT], constraint=dfa, **kw,
             **{image: torch.tensor(pixels) if image == "pixels"
                else features})
    want = js([gold.MM_PROMPT], constraint=jdfa, **kw,
              **{image: jnp.asarray(pixels) if image == "pixels"
                 else jnp.asarray(features.float().numpy(), jnp.bfloat16)})
    assert _ids(got.tokens[0]) == _ids(want.tokens[0]), image
    np.testing.assert_allclose(got.logits[0].numpy(),
                               np.asarray(want.logits[0]), rtol=0,
                               atol=2e-4)  # the golden's tolerance
    ids = _ids(got.tokens[0])
    ids = ids[:ids.index(vocab.eos_id())] if vocab.eos_id() in ids else ids
    text = "".join(vocab.DecodeIds([t]) for t in ids)
    assert dfa.is_live_prefix(text), text


# -- speculation: JAX's TestSpeculativeConstraints -------------------------------


def test_speculative_matches_constrained_plain_greedy(setup):
  from cadence_gemma_tpu.inference import speculative as jspec  # pylint: disable=import-outside-toplevel

  dfa, jdfa = setup.dfa("[abcd]{3,6}")
  s = setup.port()
  plain = s(["ab cd"], 10, constraint=dfa)
  for k, n in ((3, 2), (1, 1)):
    out = speculative.SpeculativeSampler(s, draft_len=k, ngram=n)(
        ["ab cd"], 10, constraint=dfa)
    want = jspec.SpeculativeSampler(setup.jax_sampler(), draft_len=k,
                                    ngram=n)(["ab cd"], 10, constraint=jdfa)
    assert _ids(out.tokens[0]) == _ids(want.tokens[0])
    assert _text(setup.vocab, out.tokens[0]) == _text(setup.vocab,
                                                      plain.tokens[0])
    assert re.fullmatch("[abcd]{3,6}", _text(setup.vocab, out.tokens[0])[0])


def test_speculative_verify_step_matches_jax(setup):
  """One constrained ``prompt_lookup_spec_step`` from the same state: the
  DFA states after the emitted tokens and the emitted tokens equal JAX's."""
  jax, jnp, _ = _jax()
  from cadence_gemma_tpu.inference import speculative as jspec  # pylint: disable=import-outside-toplevel

  dfa, jdfa = setup.dfa("(ab|cd|a)+")
  tokens = torch.tensor([[1, 8, 4, 5], [1, 4, 9, 8]])
  with torch.no_grad():
    _, cache = setup.model(tokens, torch.arange(4).expand(2, -1))
  hist = torch.nn.functional.pad(tokens, (0, 8))
  cstate = torch.tensor([dfa.char_dfa.start, dfa.token_advance(0, 8)],
                        dtype=torch.int32)
  state = dict(hist=hist, valid_from=torch.zeros(2, dtype=torch.long),
               cur_len=torch.full((2,), 4), cache=cache,
               positions=torch.full((2, 1), 3), live=torch.tensor([True, True]),
               out=torch.zeros(2, 6, dtype=torch.long),
               write_idx=torch.zeros(2, dtype=torch.long),
               budget=torch.tensor([6, 2]), cstate=cstate)
  with torch.no_grad():
    got = speculative.prompt_lookup_spec_step(
        setup.model, state, draft_len=3, ngram=2,
        stop_ids=torch.tensor([2]), constraint=dfa.tables(device="cpu"))
  from tests.test_torch_port_speculative import _to_jax_cache  # pylint: disable=import-outside-toplevel
  jcache = _to_jax_cache(cache)
  jstate = {k: (jnp.asarray(v.numpy()).astype(jnp.int32)
                if k not in ("cache", "live") else v)
            for k, v in state.items()}
  jstate["cache"] = jcache
  jstate["live"] = jnp.asarray([True, True])
  want = jax.jit(lambda st: jspec.prompt_lookup_spec_step(
      setup.jmodel, setup.jparams, st, draft_len=3, ngram=2,
      stop_ids=jnp.asarray([2]), constraint=jdfa.tables))(jstate)
  for key in ("out", "hist", "cur_len", "write_idx", "cstate", "eos_hit"):
    np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                  err_msg=key)


def test_categorical_speculation_stays_in_grammar(setup):
  dfa, _ = setup.dfa("(cat|dog)(cat|dog)?")
  spec = speculative.SpeculativeSampler(
      setup.port(deterministic_sampling=False, temperature=1.3), draft_len=3,
      ngram=2)
  for seed in range(3):
    out = spec(["ab"], 14, generator=torch.Generator().manual_seed(seed),
               constraint=dfa)
    _assert_in_grammar(dfa, setup.vocab, out.tokens[0])


# -- the batcher: JAX's TestBatcherConstraints and TestDynamicGrammarSlots -------


def _run(batcher, schedule):
  """Runs a join schedule of ("add", name, prompt, kwargs) / ("step", n) /
  ("drain", n); returns {name: tokens}."""
  names, results = {}, {}
  for op in schedule:
    if op[0] == "add":
      names[batcher.add_request(op[2], **op[3])] = op[1]
    elif op[0] == "step":
      batcher.step(op[1])
    else:
      for rid, tokens, _ in batcher.run_until_drained(op[1]):
        results[names[rid]] = _ids(tokens)
  return results


def _against_jax(setup, patterns, schedule, batcher_kw, dynamic=()):
  """The port's and JAX's batchers over the same grammars and schedule."""
  from cadence_gemma_tpu.inference import serving as jserving  # pylint: disable=import-outside-toplevel

  pairs = [setup.dfa(p) for p in patterns]
  runs = []
  for pick, sampler, build in (
      (0, setup.port(), lambda s, **kw: serving.ContinuousBatcher(
          s, device="cpu", **kw)),
      (1, setup.jax_sampler(), jserving.ContinuousBatcher)):
    def fix(kw, pick=pick):
      if isinstance(kw.get("constraint"), str):  # a dynamic grammar
        kw = dict(kw, constraint=setup.dfa(kw["constraint"])[pick])
      return kw
    b = build(sampler, num_slots=3, max_steps_default=10,
              constraints=[d[pick] for d in pairs] or None, **batcher_kw)
    runs.append(_run(b, [op if op[0] != "add" else op[:3] + (fix(op[3]),)
                         for op in schedule]))
  assert runs[0] == runs[1]
  return runs[0]


def test_mixed_grammars_and_free_requests_match_jax(setup):
  res = _against_jax(
      setup, ["[ab]{2,4}", "(cat)|(dog)"],
      [("add", "ab", "ab cd", dict(max_steps=10, constraint=0)),
       ("add", "free", "ab cd", dict(max_steps=10)),
       ("step", 2),
       ("add", "choice", "d a", dict(max_steps=10, constraint=1)),
       ("drain", 4)], {})
  vocab = setup.vocab
  assert re.fullmatch("[ab]{2,4}", _text(vocab, res["ab"])[0])
  assert _text(vocab, res["choice"])[0] in ("cat", "dog")
  solo = _ids(setup.port()(["ab cd"], 10).tokens[0])
  assert res["free"] == solo[:len(res["free"])]
  dfa, _ = setup.dfa("[ab]{2,4}")
  alone = _ids(setup.port()(["ab cd"], 10, constraint=dfa).tokens[0])
  assert res["ab"] == alone[:len(res["ab"])]


def test_slot_reuse_resets_the_grammar(setup):
  res = _against_jax(
      setup, ["(cat)|(dog)"],
      [("add", "first", "a", dict(max_steps=8, constraint=0)),
       ("drain", 4),
       ("add", "free", "ab cd", dict(max_steps=6)),
       ("drain", 4)], {})
  solo = _ids(setup.port()(["ab cd"], 6).tokens[0])
  assert res["free"] == solo[:len(res["free"])]


def test_dynamic_grammars_match_jax(setup):
  """Three grammars through two dynamic slots (LRU), a shared slot, a free
  request: JAX's tokens and JAX's slot bookkeeping."""
  res = _against_jax(
      setup, [],
      [("add", "c1", "ab cd", dict(max_steps=10, constraint="[ab]{2,4}")),
       ("add", "free", "ab cd", dict(max_steps=10)),
       ("add", "c1b", "cd", dict(max_steps=8, constraint="[ab]{2,4}")),
       ("drain", 4),
       ("add", "c2", "ab", dict(max_steps=10, constraint="(cat)|(dog)")),
       ("step", 3),
       ("add", "c3", "ab", dict(max_steps=10, constraint="[cd]{1,3}")),
       ("drain", 4)],
      dict(dynamic_grammar_slots=2, dynamic_grammar_budget=(64, 16, 4)))
  for name, pattern in (("c1", "[ab]{2,4}"), ("c1b", "[ab]{2,4}"),
                        ("c2", "(cat)|(dog)"), ("c3", "[cd]{1,3}")):
    assert setup.dfa(pattern)[0].allows_text(
        _text(setup.vocab, res[name])[0]), name
  solo = _ids(setup.port()(["ab cd"], 10).tokens[0])
  assert res["free"] == solo[:len(res["free"])]


def test_dynamic_slot_bookkeeping(setup):
  vocab = setup.vocab
  b = serving.ContinuousBatcher(setup.port(), num_slots=3,
                                max_steps_default=10, device="cpu",
                                dynamic_grammar_slots=1,
                                dynamic_grammar_budget=(64, 16, 4))
  dfa, _ = setup.dfa("[ab]{2,4}")
  same = constrain.TokenDFA("[ab]{2,4}", vocab.token_strings(), eos_id=2)
  r1 = b.add_request("ab", max_steps=8, constraint=dfa)
  r2 = b.add_request("cd", max_steps=8, constraint=same)
  assert len(b._dynamic_by_key) == 1 and b._gid_refs[1] == 2
  with pytest.raises(RuntimeError, match="dynamic grammar slots"):
    b.add_request("cd", max_steps=10, constraint=setup.dfa("[cd]{1,2}")[0])
  res = {r: t for r, t, _ in b.run_until_drained(4)}
  for rid in (r1, r2):
    assert re.fullmatch("[ab]{2,4}", _text(vocab, res[rid])[0])
  assert b._gid_refs[1] == 0
  # Evictable now; a cancel releases its hold.
  rid = b.add_request("ab", max_steps=10,
                      constraint=setup.dfa("[cd]{1,2}")[0])
  assert b.cancel(rid) and b._gid_refs[1] == 0
  rid = b.add_request("cd", max_steps=10,
                      constraint=setup.dfa("[cd]{1,3}")[0])
  res = {r: t for r, t, _ in b.run_until_drained(4)}
  assert re.fullmatch("[cd]{1,3}", _text(vocab, res[rid])[0])
  big = constrain.TokenDFA("(cat|dog){1,41}", vocab.token_strings(),
                           eos_id=2)
  assert big.n_states > 64
  with pytest.raises(ValueError, match="budget"):
    b.add_request("ab", max_steps=4, constraint=big)


def test_batcher_validation(setup):
  s = setup.port()
  dfa, _ = setup.dfa("[ab]+")
  serving.ContinuousBatcher(s, num_slots=2, constraints=[dfa], draft_len=2,
                            device="cpu")
  plain = serving.ContinuousBatcher(s, num_slots=2, device="cpu")
  with pytest.raises(ValueError, match="constraints"):
    plain.add_request("ab", constraint=0)
  with pytest.raises(ValueError, match="dynamic_grammar_slots"):
    plain.register_grammar(dfa)
  with pytest.raises(ValueError, match="registered"):
    serving.ContinuousBatcher(s, num_slots=2, constraints=[dfa],
                              device="cpu").add_request("ab", constraint=1)
  with pytest.raises(ValueError, match="dynamic_grammar_budget"):
    serving.ContinuousBatcher(s, num_slots=2, dynamic_grammar_slots=1,
                              device="cpu")
  wrong = constrain.TokenDFA("[ab]+", ["", "", "", "a", "b"], eos_id=2)
  with pytest.raises(ValueError, match="vocabulary"):
    serving.ContinuousBatcher(s, num_slots=2, constraints=[wrong],
                              device="cpu")


def test_constraint_composes_with_min_tokens_and_bias(setup):
  """JAX's test_constraint_composes_with_min_tokens, and a logit bias that
  cannot bring back a banned token, against JAX's batcher."""
  res = _against_jax(
      setup, ["[ab]{1,4}"],
      [("add", "min", "ab cd", dict(max_steps=10, constraint=0,
                                    min_tokens=3)),
       ("add", "bias", "ab cd", dict(max_steps=10, constraint=0,
                                     logit_bias={7: 100.0, 4: 5.0})),
       ("drain", 4)], dict(per_request_sampling=True))
  for name in ("min", "bias"):
    text = "".join(setup.vocab.DecodeIds([t]) for t in res[name] if t != 2)
    assert re.fullmatch("[ab]{3,4}" if name == "min" else "[ab]{1,4}",
                        text), (name, res[name])


def test_speculative_batcher_with_grammars_matches_jax(setup):
  res = _against_jax(
      setup, ["[ab]{2,4}"],
      [("add", "c", "ab cd", dict(max_steps=10, constraint=0)),
       ("add", "f", "cd ab", dict(max_steps=10)),
       ("add", "d", "ab", dict(max_steps=10, constraint="[cd]{1,3}")),
       ("drain", 4)],
      dict(draft_len=2, ngram=2, dynamic_grammar_slots=1))
  dfa, _ = setup.dfa("[ab]{2,4}")
  want_c = setup.port()(["ab cd"], 10, constraint=dfa)
  assert _text(setup.vocab, res["c"]) == _text(setup.vocab,
                                               want_c.tokens[0])
  want_f = _ids(setup.port()(["cd ab"], 10).tokens[0])
  assert res["f"] == want_f[:len(res["f"])]


# -- card tests: captured against eager ------------------------------------------


def _card_model():
  torch.manual_seed(0)
  config = common.GriffinConfig(
      vocab_size=len(PIECES) + 4, width=128, mlp_expanded_width=256,
      num_heads=2,
      block_types=(common.TemporalBlockType.RECURRENT,
                   common.TemporalBlockType.ATTENTION),
      embeddings_scale_by_sqrt_dim=True, attention_window_size=16,
      logits_soft_cap=30.0, lru_width=128)
  from cadence_gemma_tpu_torch.models import griffin  # pylint: disable=import-outside-toplevel
  model = griffin.Griffin(config, device="cuda", dtype=torch.float32)
  with torch.no_grad():
    for p in model.parameters():
      p.normal_(0, 0.5)
  return model


@requires_cuda
@pytest.mark.parametrize("greedy", [True, False])
def test_cuda_captured_constrained_decode_matches_eager(greedy):
  model, vocab = _card_model(), CharVocab(PIECES)
  dfa = constrain.TokenDFA("(cat|dog|ab)( (cat|dog|ab)){0,4}",
                           vocab.token_strings(), eos_id=2)
  outs = []
  for jit in (True, False):
    s = sampler_lib.Sampler(model, vocab, deterministic_sampling=greedy,
                            jit_compile=jit, repetition_penalty=1.2)
    gen = None if greedy else torch.Generator("cuda").manual_seed(5)
    out = s(["ab cd", "d"], 16, generator=gen, constraint=dfa)
    assert (len(s._graphs) == 1) == jit
    outs.append([_ids(t.cpu()) for t in out.tokens])
    for t in out.tokens:
      _assert_in_grammar(dfa, vocab, t.cpu())
  assert outs[0] == outs[1]


@requires_cuda
def test_cuda_captured_constrained_tick_and_verify_match_eager():
  model, vocab = _card_model(), CharVocab(PIECES)
  strings = vocab.token_strings()
  dfas = [constrain.TokenDFA(p, strings, eos_id=2)
          for p in ("[ab]{2,6}", "(cat|dog)+")]
  results = []
  for jit in (True, False):
    s = sampler_lib.Sampler(model, vocab, jit_compile=jit)
    run = {}
    for draft in (0, 3):
      b = serving.ContinuousBatcher(s, num_slots=3, max_steps_default=12,
                                    constraints=dfas, draft_len=draft,
                                    dynamic_grammar_slots=1,
                                    reuse_programs=False)
      rids = [b.add_request("ab cd", constraint=0),
              b.add_request("d", constraint=1),
              b.add_request("cd ab")]
      b.step(2)
      run[draft] = {r: t for r, t, _ in b.run_until_drained(3)}
      rid = b.add_request("a", constraint=constrain.TokenDFA(
          "[cd]{1,3}", strings, eos_id=2))
      run[draft][rid] = dict((r, t) for r, t, _ in
                             b.run_until_drained(3))[rid]
      assert set(rids) < set(run[draft])
    spec = speculative.SpeculativeSampler(s, draft_len=3)
    run["solo"] = _ids(spec(["ab cd"], 10, constraint=dfas[0]).tokens[0]
                       .cpu())
    results.append(run)
  assert results[0] == results[1]
