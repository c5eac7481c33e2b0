"""The port's HTTP / OpenAI front end over its ContinuousBatcher.

On the CPU, with ``tests/test_torch_port_serving.py``'s tiny Griffin: the
front-end tests of ``tests/test_server.py`` over the port's batcher
(servers bind 127.0.0.1 on port 0), whose invariant is the batcher's: a
request's tokens match a solo ``Sampler`` run whatever path it takes
(queue, HTTP, streaming, neighbors joining or cancelling). The host helpers
(chat rendering, the tool preamble, tool-call parsing, the stop-string and
tool-stream gates) take the same inputs as the JAX package's and must give
equal outputs. The grammar-constrained surfaces are JAX's
``TestConstrainedServing`` and the forced cases of ``TestToolCalling``:
named grammars, ``response_format`` ``json_object`` / ``json_schema`` and a
forced ``tool_choice`` (streamed too) answer with output that stays in the
grammar, and answer 400 naming what a server without grammars lacks
(per-request adapters are ``test_torch_port_multi_lora.py``'s). One card
test holds the captured tick against the eager tick at the same width.
"""

import json
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch.inference import constrain
from cadence_gemma_tpu_torch.inference import sampler as sampler_lib
from cadence_gemma_tpu_torch.inference import server as server_lib
from cadence_gemma_tpu_torch.inference import serving
from cadence_gemma_tpu_torch.models import griffin
from cadence_gemma_tpu_torch.tokenizers import SimpleVocab

requires_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()", reason="needs a CUDA device"
)

TOOLS = [
    {"type": "function", "function": {
        "name": "f",
        "description": "eff",
        "parameters": {"type": "object",
                       "properties": {"x": {"type": "integer"}},
                       "required": ["x"]}}},
    {"type": "function", "function": {"name": "g"}},  # no arguments
]


# The JAX package is imported inside fixtures, so the card test below runs
# where only torch is installed.


@pytest.fixture(scope="module")
def setup():
  from tests.test_torch_port_serving import Pair

  pair = Pair()
  return pair.sampler, pair.vocab


@pytest.fixture(scope="module")
def jserver():
  from cadence_gemma_tpu.inference import server

  return server


def _batcher(sampler, num_slots=2, steps=8, **kwargs):
  return serving.ContinuousBatcher(sampler, num_slots=num_slots,
                                   max_steps_default=steps, device="cpu",
                                   **kwargs)


def _frontend(batcher, **kwargs):
  kwargs.setdefault("step_size", 2)
  return server_lib.ServingFrontend(batcher, device="cpu", **kwargs)


def _server(sampler, model_name="cadence-gemma-tpu", frontend_kw=None,
            **batcher_kw):
  fe = _frontend(_batcher(sampler, **batcher_kw), **(frontend_kw or {}))
  return server_lib.ServingHTTPServer(fe, port=0, model_name=model_name)


def _solo(sampler, prompt, steps, **kwargs):
  return sampler([prompt], total_generation_steps=steps,
                 **kwargs).tokens[0].tolist()


def _check(got, solo_tokens, steps, eos_id):
  assert got == solo_tokens[:len(got)], (got, solo_tokens)
  assert len(got) == steps or got[-1] == eos_id, (got, steps)


def _post(port, path, obj, timeout=120):
  req = urllib.request.Request(
      f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
      headers={"Content-Type": "application/json"},
  )
  with urllib.request.urlopen(req, timeout=timeout) as resp:
    return resp.status, json.loads(resp.read())


def _post_error(port, path, obj, code=400):
  with pytest.raises(urllib.error.HTTPError) as e:
    _post(port, path, obj)
  assert e.value.code == code
  return json.loads(e.value.read())["error"]


def _sse_events(port, path, obj):
  req = urllib.request.Request(
      f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
      headers={"Content-Type": "application/json"},
  )
  events, done = [], False
  with urllib.request.urlopen(req, timeout=120) as resp:
    assert resp.headers["Content-Type"] == "text/event-stream"
    for line in resp:
      line = line.decode().strip()
      if not line.startswith("data: "):
        continue
      payload = line[len("data: "):]
      if payload == "[DONE]":
        done = True
        break
      events.append(json.loads(payload))
  assert done, "stream must terminate with data: [DONE]"
  return events


class TestCancel:

  def test_cancel_running_leaves_neighbor_exact(self, setup):
    s, vocab = setup
    b = _batcher(s, steps=10)
    victim = b.add_request("alpha beta")
    keeper = b.add_request("gamma delta eps")
    b.step(3)
    assert b.cancel(victim)
    assert not b.cancel(victim)       # already gone
    assert not b.cancel(12345)        # unknown id
    res = {r: t for r, t, _ in b.run_until_drained(2)}
    assert victim not in res
    _check(res[keeper], _solo(s, "gamma delta eps", 10), 10, vocab.eos_id())

  def test_cancel_pending_and_slot_reuse(self, setup):
    s, vocab = setup
    b = _batcher(s, num_slots=1, steps=6)
    assert b.cancel(b.add_request("alpha beta"))  # never prefills
    rid = b.add_request("gamma delta")
    res = {r: t for r, t, _ in b.run_until_drained(2)}
    _check(res[rid], _solo(s, "gamma delta", 6), 6, vocab.eos_id())


class TestFrontend:

  def test_results_match_solo_with_queueing(self, setup):
    s, vocab = setup
    fe = _frontend(_batcher(s))
    try:
      prompts = ["alpha beta", "gamma delta eps", "theta eta"]  # 3 > slots
      subs = [fe.submit(p) for p in prompts]
      for p, sub in zip(prompts, subs):
        tokens, text = sub.result(timeout=120)
        _check(tokens, _solo(s, p, 8), 8, vocab.eos_id())
        assert text == vocab.DecodeIds(tokens)
    finally:
      fe.close()

  def test_streaming_deltas_cover_all_tokens(self, setup):
    s, vocab = setup
    fe = _frontend(_batcher(s, num_slots=1, steps=9))
    try:
      sub = fe.submit("delta eps")
      assembled, final = [], None
      while final is None:
        kind, payload = sub.events.get(timeout=120)
        if kind == "tokens":
          assembled.extend(payload)
        elif kind == "done":
          final = payload[0]
        else:
          raise AssertionError(payload)
      assert assembled == final
      _check(final, _solo(s, "delta eps", 9), 9, vocab.eos_id())
    finally:
      fe.close()

  def test_cancel_mid_stream(self, setup):
    s, vocab = setup
    fe = _frontend(_batcher(s, num_slots=1, steps=512), step_size=1)
    try:
      sub = fe.submit("delta eps")
      kind, _ = sub.events.get(timeout=120)  # wait for the first delta
      assert kind == "tokens"
      assert fe.cancel(sub.request_id)
      with pytest.raises(RuntimeError, match="cancelled"):
        sub.result(timeout=120)
      nxt = fe.submit("gamma delta", max_tokens=6)
      tokens, _ = nxt.result(timeout=120)
      _check(tokens, _solo(s, "gamma delta", 6), 6, vocab.eos_id())
    finally:
      fe.close()

  def test_submit_error_reports_not_hangs(self, setup):
    s, _ = setup
    fe = _frontend(_batcher(s, num_slots=1, steps=4))
    try:
      sub = fe.submit("alpha", image_path="/nonexistent.jpg")
      with pytest.raises(RuntimeError, match="generation failed"):
        sub.result(timeout=120)
    finally:
      fe.close()


class TestHTTP:

  @pytest.fixture(scope="class")
  def httpd(self, setup):
    s, vocab = setup
    srv = _server(s)
    yield srv, s, vocab
    srv.close()

  def test_generate_and_health(self, httpd):
    srv, s, vocab = httpd
    status, out = _post(srv.port, "/v1/generate", {"prompt": "alpha beta"})
    assert status == 200
    _check(out["tokens"], _solo(s, "alpha beta", 8), 8, vocab.eos_id())
    assert out["text"] == vocab.DecodeIds(out["tokens"])
    with urllib.request.urlopen(
        f"http://127.0.0.1:{srv.port}/v1/health", timeout=30) as resp:
      health = json.loads(resp.read())
    assert health["ok"] and health["slots"] == 2

  def test_streaming_assembles_to_nonstream(self, httpd):
    srv, s, vocab = httpd
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/v1/generate",
        data=json.dumps({"prompt": "delta eps", "stream": True}).encode(),
        headers={"Content-Type": "application/json"},
    )
    assembled, final = [], None
    with urllib.request.urlopen(req, timeout=120) as resp:
      for line in resp:
        evt = json.loads(line)
        assembled.extend(evt.get("tokens", []))
        if evt.get("done"):
          final = evt
    assert final and "text" in final
    _check(assembled, _solo(s, "delta eps", 8), 8, vocab.eos_id())
    assert final["text"] == vocab.DecodeIds(assembled)

  def test_concurrent_requests_isolated(self, httpd):
    srv, s, vocab = httpd
    results = {}

    def go(prompt):
      results[prompt] = _post(srv.port, "/v1/generate", {"prompt": prompt})[1]

    threads = [threading.Thread(target=go, args=(p,))
               for p in ("alpha beta", "zeta eta theta")]
    for t in threads:
      t.start()
    for t in threads:
      t.join(timeout=180)
      assert not t.is_alive()
    assert len(results) == 2
    for p, out in results.items():
      _check(out["tokens"], _solo(s, p, 8), 8, vocab.eos_id())

  def test_bad_requests(self, httpd):
    srv, _, _ = httpd
    _post_error(srv.port, "/v1/generate", {"prompt": ""})
    _post_error(srv.port, "/v1/nope", {}, code=404)


class TestChatSessions:

  @pytest.fixture(scope="class")
  def chat_httpd(self, setup):
    s, vocab = setup
    srv = _server(s, steps=6, preserve_states=True)
    yield srv, s, vocab
    srv.close()

  def test_session_turns_match_solo_chat(self, chat_httpd):
    srv, s, vocab = chat_httpd
    solo1 = s(["alpha beta"], total_generation_steps=6, return_state=True)
    solo2 = s(["gamma"], total_generation_steps=6, prefix_state=solo1.state)
    _, out1 = _post(srv.port, "/v1/generate",
                    {"prompt": "alpha beta", "session": "u1"})
    _check(out1["tokens"], solo1.tokens[0].tolist(), 6, vocab.eos_id())
    _, out2 = _post(srv.port, "/v1/generate",
                    {"prompt": "gamma", "session": "u1"})
    _check(out2["tokens"], solo2.tokens[0].tolist(), 6, vocab.eos_id())

  def test_sessions_isolated_and_resettable(self, chat_httpd):
    srv, s, vocab = chat_httpd
    _, fresh = _post(srv.port, "/v1/generate",
                     {"prompt": "delta eps", "session": "u2"})
    _check(fresh["tokens"], _solo(s, "delta eps", 6), 6, vocab.eos_id())
    _, r = _post(srv.port, "/v1/reset", {"session": "u2"})
    assert r["reset"] is True
    _, again = _post(srv.port, "/v1/generate",
                     {"prompt": "delta eps", "session": "u2"})
    assert again["tokens"] == fresh["tokens"]
    _, r2 = _post(srv.port, "/v1/reset", {"session": "nope"})
    assert r2["reset"] is False

  def test_busy_session_409(self, chat_httpd):
    srv, _, _ = chat_httpd
    sub = srv.frontend.submit("alpha beta gamma", max_tokens=64,
                              session="busy1")
    try:
      _post_error(srv.port, "/v1/generate",
                  {"prompt": "x", "session": "busy1"}, code=409)
    finally:
      sub.result(timeout=120)

  def test_session_requires_preserve_states(self, setup):
    fe = _frontend(_batcher(setup[0], num_slots=1, steps=4))
    try:
      with pytest.raises(ValueError, match="preserve_states"):
        fe.submit("alpha", session="s")
    finally:
      fe.close()


class TestReviewHardening:

  def test_driver_death_fails_inflight_and_health(self, setup):
    b = _batcher(setup[0], num_slots=1, steps=64)
    fe = _frontend(b)
    try:
      def dying_step(n):
        raise RuntimeError("synthetic device OOM")

      b.step = dying_step
      sub = fe.submit("alpha beta")
      with pytest.raises(RuntimeError, match="driver died"):
        sub.result(timeout=120)
      assert fe.stats["ok"] is False
      assert "synthetic device OOM" in fe.stats["error"]
      with pytest.raises(server_lib.FrontendDead):
        fe.submit("gamma")
    finally:
      fe.close()

  def test_reset_mid_turn_is_epoch_fenced(self, setup):
    s, vocab = setup
    fe = _frontend(_batcher(s, num_slots=1, steps=6, preserve_states=True),
                   step_size=1)
    try:
      sub = fe.submit("alpha beta", session="u")
      fe.reset_session("u")  # lands while the turn is in flight
      sub.result(timeout=120)
      tokens, _ = fe.submit("gamma delta", session="u").result(timeout=120)
      _check(tokens, _solo(s, "gamma delta", 6), 6, vocab.eos_id())
    finally:
      fe.close()

  def test_max_tokens_zero_is_an_error_not_default(self, setup):
    fe = _frontend(_batcher(setup[0], num_slots=1))
    try:
      sub = fe.submit("alpha", max_tokens=0)
      with pytest.raises(RuntimeError, match="max_steps must be >= 1"):
        sub.result(timeout=120)
    finally:
      fe.close()

  def test_default_prefix_applies_and_chains_into_sessions(self, setup):
    s, vocab = setup
    prefix = s.prefill_prefix("alpha beta gamma")
    solo1 = s(["delta"], total_generation_steps=6, prefix_state=prefix,
              return_state=True)
    solo2 = s(["eps"], total_generation_steps=6, prefix_state=solo1.state)
    fe = _frontend(_batcher(s, steps=6, preserve_states=True),
                   default_prefix_state=prefix)
    try:
      t1, _ = fe.submit("delta", session="u").result(timeout=120)
      _check(t1, solo1.tokens[0].tolist(), 6, vocab.eos_id())
      t2, _ = fe.submit("eps", session="u").result(timeout=120)
      _check(t2, solo2.tokens[0].tolist(), 6, vocab.eos_id())
      t3, _ = fe.submit("delta").result(timeout=120)
      _check(t3, solo1.tokens[0].tolist(), 6, vocab.eos_id())
    finally:
      fe.close()

  def test_seed_makes_a_categorical_request_reproducible(self, setup):
    s, _ = setup
    cat = sampler_lib.Sampler(s.model, s.vocab, device="cpu",
                              deterministic_sampling=False)
    fe = _frontend(_batcher(cat))
    try:
      a, b = (fe.submit("alpha beta", seed=7).result(timeout=120)[0]
              for _ in range(2))
      want = _solo(cat, "alpha beta", 8,
                   generator=torch.Generator().manual_seed(7))
      assert a == b
      _check(a, want, 8, s.vocab.eos_id())
    finally:
      fe.close()


class TestMetrics:

  def test_counters_and_latency_percentiles(self, setup):
    s, _ = setup
    fe = _frontend(_batcher(s, steps=6))
    try:
      subs = [fe.submit(p) for p in ("alpha beta", "gamma delta",
                                     "theta eta")]
      for sub in subs:
        sub.result(timeout=120)
        m = sub.metrics
        assert 0 <= m["ttft_s"] <= m["wall_s"]
      stats = fe.stats
      assert stats["completed"] == 3
      assert stats["cancelled"] == 0 and stats["errors"] == 0
      assert stats["tokens_out"] >= 3
      assert 0 <= stats["ttft_s_p50"] <= stats["wall_s_p90"]
      # "delta eps" decodes until its budget: cancelled mid-flight.
      long = fe.submit("delta eps", max_tokens=512)
      long.events.get(timeout=120)  # admitted and decoding
      fe.cancel(long.request_id)
      with pytest.raises(RuntimeError):
        long.result(timeout=120)
      with pytest.raises(RuntimeError):
        fe.submit("alpha", max_tokens=0).result(timeout=120)
      stats = fe.stats
      assert stats["cancelled"] == 1 and stats["errors"] == 1
      assert stats["completed"] == 3
    finally:
      fe.close()


class TestSessionLRU:

  def test_eviction_is_least_recently_used(self, setup):
    s, vocab = setup
    fe = _frontend(_batcher(s, num_slots=1, steps=5, preserve_states=True),
                   max_sessions=2)
    try:
      for name in ("a", "b", "c"):  # the third store evicts session "a"
        fe.submit("alpha beta", session=name).result(timeout=120)
      assert fe.stats["sessions"] == 2
      assert set(fe._sessions) == {"b", "c"}
      fe.submit("gamma", session="b").result(timeout=120)
      fe.submit("alpha beta", session="d").result(timeout=120)
      assert set(fe._sessions) == {"b", "d"}
      tokens, _ = fe.submit("delta eps", session="c").result(timeout=120)
      _check(tokens, _solo(s, "delta eps", 5), 5, vocab.eos_id())
    finally:
      fe.close()


class TestOpenAICompat:

  @pytest.fixture()
  def httpd(self, setup):
    s, vocab = setup
    srv = _server(s, model_name="test-2b")
    yield srv, s, vocab
    srv.close()

  def test_models_route(self, httpd):
    srv, _, _ = httpd
    with urllib.request.urlopen(
        f"http://127.0.0.1:{srv.port}/v1/models", timeout=30) as resp:
      out = json.loads(resp.read())
    assert out["object"] == "list" and out["data"][0]["id"] == "test-2b"

  def test_completions_matches_solo(self, httpd):
    srv, s, vocab = httpd
    status, out = _post(srv.port, "/v1/completions",
                        {"prompt": "alpha beta", "max_tokens": 8})
    assert status == 200
    assert out["object"] == "text_completion" and out["model"] == "test-2b"
    choice = out["choices"][0]
    assert choice["text"] == vocab.DecodeIds(_solo(s, "alpha beta", 8))
    assert choice["finish_reason"] in ("stop", "length")
    usage = out["usage"]
    assert usage["prompt_tokens"] == 1 + len(vocab.EncodeAsIds("alpha beta"))
    assert usage["total_tokens"] == (usage["prompt_tokens"]
                                     + usage["completion_tokens"])

  def test_completions_stream_assembles_to_nonstream(self, httpd):
    srv, s, vocab = httpd
    events = _sse_events(srv.port, "/v1/completions",
                         {"prompt": "delta eps", "stream": True})
    text = "".join(e["choices"][0]["text"] for e in events)
    assert text == vocab.DecodeIds(_solo(s, "delta eps", 8))
    assert events[-1]["choices"][0]["finish_reason"] in ("stop", "length")
    assert all(e["object"] == "text_completion.chunk" for e in events)

  def test_chat_completions_multiturn_matches_solo_it(self, setup):
    s, vocab = setup
    it_sampler = sampler_lib.Sampler(s.model, vocab, device="cpu",
                                     is_it_model=True)
    srv = _server(it_sampler, model_name="test-it")
    try:
      msgs = [{"role": "user", "content": "alpha beta"},
              {"role": "assistant", "content": "gamma"},
              {"role": "user", "content": "delta eps"}]
      status, out = _post(srv.port, "/v1/chat/completions",
                          {"messages": msgs, "max_tokens": 8})
      assert status == 200 and out["object"] == "chat.completion"
      msg = out["choices"][0]["message"]
      assert msg["role"] == "assistant"
      rendered, _ = server_lib.render_chat_messages(msgs, is_it_model=True)
      assert msg["content"] == vocab.DecodeIds(_solo(it_sampler, rendered, 8))
    finally:
      srv.close()

  def test_chat_stream_roles_and_content(self, httpd):
    srv, s, vocab = httpd
    events = _sse_events(
        srv.port, "/v1/chat/completions",
        {"messages": [{"role": "user", "content": "delta eps"}],
         "stream": True})
    assert events[0]["choices"][0]["delta"].get("role") == "assistant"
    text = "".join(e["choices"][0]["delta"].get("content", "")
                   for e in events)
    assert text == vocab.DecodeIds(_solo(s, "delta eps", 8))
    assert events[-1]["choices"][0]["finish_reason"] in ("stop", "length")

  @pytest.mark.parametrize("body", [
      {"prompt": "alpha", "n": 0},
      {"prompt": "alpha", "echo": True},
      {"prompt": "alpha", "logprobs": 1},
      {"prompt": ["a", "b"]},
      {"prompt": "alpha", "response_format": {"type": "yaml"}},
  ])
  def test_unsupported_shapes_rejected(self, httpd, body):
    err = _post_error(httpd[0].port, "/v1/completions", body)
    assert err["type"] == "invalid_request_error"

  def test_ignored_sampling_knobs_do_not_change_tokens(self, httpd):
    srv, s, vocab = httpd
    _, out = _post(srv.port, "/v1/completions",
                   {"prompt": "alpha beta", "max_tokens": 8,
                    "temperature": 0.2, "top_p": 0.9, "stop": ["###"],
                    "presence_penalty": 0.5,
                    "response_format": {"type": "text"}})
    assert out["choices"][0]["text"] == vocab.DecodeIds(
        _solo(s, "alpha beta", 8))


class TestConstrainedSurfacesAnswer400:
  """On a server whose batcher has no grammar registry, every constrained
  surface answers 400 naming what it needs (a named grammar, the
  ``json_object`` grammar, dynamic grammar slots), as JAX's does."""

  @pytest.fixture(scope="class")
  def httpd(self, setup):
    srv = _server(setup[0])
    yield srv
    srv.close()

  @pytest.mark.parametrize("path,body", [
      ("/v1/generate", {"prompt": "gamma", "constraint": "json_object"}),
      ("/v1/completions", {"prompt": "gamma",
                           "response_format": {"type": "json_object"}}),
      ("/v1/completions", {"prompt": "gamma", "response_format": {
          "type": "json_schema",
          "json_schema": {"schema": {"type": "integer"}}}}),
      ("/v1/chat/completions", {
          "messages": [{"role": "user", "content": "x"}],
          "response_format": {"type": "json_object"}}),
      ("/v1/chat/completions", {
          "messages": [{"role": "user", "content": "x"}], "tools": TOOLS,
          "tool_choice": "required"}),
      ("/v1/chat/completions", {
          "messages": [{"role": "user", "content": "x"}], "tools": TOOLS,
          "tool_choice": {"type": "function", "function": {"name": "g"}}}),
  ])
  def test_constrained_request_is_400(self, httpd, path, body):
    err = _post_error(httpd.port, path, body)
    if path == "/v1/generate":  # the native route's plain error
      assert "unknown constraint 'json_object'" in err, err
      return
    assert err["type"] == "invalid_request_error"
    rf = body.get("response_format", {}).get("type")
    want = ("JSON grammar" if rf == "json_object"
            else "dynamic_grammar_slots")
    assert want in err["message"], err

  def test_library_surfaces_refuse(self, setup):
    with pytest.raises(ValueError, match="registered no grammars"):
      _frontend(_batcher(setup[0]), constraint_names={"json_object": 0})
    fe = _frontend(_batcher(setup[0]))
    try:
      with pytest.raises(ValueError, match="dynamic_grammar_slots"):
        fe.submit("alpha", constraint={"type": "integer"})
      with pytest.raises(ValueError, match="unknown constraint"):
        fe.submit("alpha", constraint="json_object")
    finally:
      fe.close()


def _char_sampler(pieces, seed):
  """A port Sampler over a character vocabulary that can spell JSON
  (``tests/test_constrain.py``'s ``CharVocab``), random weights."""
  from tests.test_torch_port_constrain import CharVocab

  vocab = CharVocab(pieces)
  config = common.GriffinConfig(
      vocab_size=vocab.GetPieceSize(), width=16, mlp_expanded_width=32,
      num_heads=2, block_types=(common.TemporalBlockType.RECURRENT,),
      embeddings_scale_by_sqrt_dim=True, attention_window_size=8,
      logits_soft_cap=30.0, lru_width=16,
      scan_type=common.ScanType.LINEAR_NATIVE)
  torch.manual_seed(seed)
  model = griffin.Griffin(config, device="cpu", dtype=torch.float32)
  return sampler_lib.Sampler(model, vocab, device="cpu"), vocab


class TestConstrainedServing:
  """JAX's ``TestConstrainedServing``: named grammars through the frontend
  and the OpenAI ``response_format``."""

  @pytest.fixture(scope="class")
  def httpd(self, setup):
    sampler, vocab = setup
    dfa = constrain.TokenDFA(
        constrain.choice_regex(["alpha", "beta"]),
        constrain.token_strings_from_vocab(vocab, vocab.GetPieceSize()),
        eos_id=vocab.eos_id())
    # "json_object" maps to the same grammar: these tests exercise the
    # response_format routing; the grammars are test_torch_port_constrain's.
    srv = _server(sampler, steps=8, constraints=[dfa],
                  frontend_kw=dict(constraint_names={"choice": 0,
                                                     "json_object": 0}))
    yield srv, sampler, vocab
    srv.close()

  def test_generate_with_named_constraint(self, httpd):
    srv, sampler, vocab = httpd
    status, out = _post(srv.port, "/v1/generate",
                        {"prompt": "gamma delta", "constraint": "choice"})
    assert status == 200
    assert out["text"] in ("alpha", "beta"), out
    dfa = srv.frontend.batcher._constraints  # the registry's grammar 1
    solo = sampler(["gamma delta"], 8, constraint=dfa.single(1))
    assert out["tokens"] == [t for t in solo.tokens[0].tolist()
                             if t != vocab.pad_id()][:len(out["tokens"])]

  def test_unknown_constraint_is_400(self, httpd):
    err = _post_error(httpd[0].port, "/v1/generate",
                      {"prompt": "gamma", "constraint": "nope"})
    assert "unknown constraint" in err

  def test_response_format_json_object_routes_to_grammar(self, httpd):
    status, out = _post(httpd[0].port, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "gamma delta"}],
        "response_format": {"type": "json_object"}})
    assert status == 200
    assert out["choices"][0]["message"]["content"] in ("alpha", "beta")

  def test_response_format_text_is_free(self, httpd):
    srv, sampler, vocab = httpd
    _, out = _post(srv.port, "/v1/completions", {
        "prompt": "gamma delta", "max_tokens": 8,
        "response_format": {"type": "text"}})
    assert out["choices"][0]["text"] == vocab.DecodeIds(
        _solo(sampler, "gamma delta", 8))

  def test_unsupported_and_bad_formats_rejected(self, httpd):
    for rf in ({"type": "json_schema"}, {"type": "yaml"}):
      _post_error(httpd[0].port, "/v1/completions",
                  {"prompt": "gamma", "response_format": rf})

  @pytest.fixture(scope="class")
  def schema_httpd(self):
    pieces = list('{}[]:,"0123456789') + ["name", "a", "b", "-", "true",
                                          "false", "null"]
    sampler, vocab = _char_sampler(pieces, seed=2)
    srv = _server(sampler, steps=48, dynamic_grammar_slots=2,
                  dynamic_grammar_budget=(128, 24, 6),
                  frontend_kw=dict(step_size=4))
    yield srv, vocab
    srv.close()

  def test_response_format_json_schema_end_to_end(self, schema_httpd):
    srv, _ = schema_httpd
    schema = {"type": "object",
              "properties": {"name": {"enum": ["a", "b"]},
                             "b": {"type": "integer"}},
              "required": ["name", "b"]}
    status, out = _post(srv.port, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "a b"}], "max_tokens": 48,
        "response_format": {"type": "json_schema",
                            "json_schema": {"name": "row",
                                            "schema": schema}}})
    assert status == 200
    content = out["choices"][0]["message"]["content"]
    if out["choices"][0]["finish_reason"] == "stop":
      doc = json.loads(content)
      assert doc["name"] in ("a", "b") and isinstance(doc["b"], int)
    else:  # the budget cut it: a live prefix of the grammar
      assert out["choices"][0]["finish_reason"] == "length"
      assert re.match(r'\{"name":"[ab]"', content), content
    # The schema compiled once, on the handler thread, and is cached.
    assert len(srv.frontend._schema_cache) == 1

  def test_bad_json_schema_rejected(self, schema_httpd):
    srv, _ = schema_httpd
    for rf in ({"type": "json_schema"},
               {"type": "json_schema", "json_schema": {"schema": {
                   "type": "object", "properties": {"a": {"type": "null"}},
                   "required": []}}}):  # not strict
      _post_error(srv.port, "/v1/completions",
                  {"prompt": "a", "response_format": rf})


class TestStopSequences:

  @pytest.fixture()
  def httpd(self, setup):
    srv = _server(setup[0])  # plain greedy batcher
    yield srv, setup[1]
    srv.close()

  def test_stop_truncates_nonstreaming(self, httpd):
    srv, _ = httpd
    _, free = _post(srv.port, "/v1/completions",
                    {"prompt": "delta eps", "max_tokens": 8})
    full = free["choices"][0]["text"]
    words = full.split()
    assert len(words) >= 2, full
    stop = words[1]
    _, out = _post(srv.port, "/v1/completions",
                   {"prompt": "delta eps", "max_tokens": 8, "stop": stop})
    choice = out["choices"][0]
    assert choice["text"] == full[:full.find(stop)]
    assert stop not in choice["text"] and choice["finish_reason"] == "stop"

  def test_stop_streaming_matches_nonstreaming(self, httpd):
    srv, _ = httpd
    _, free = _post(srv.port, "/v1/completions",
                    {"prompt": "delta eps", "max_tokens": 8})
    words = free["choices"][0]["text"].split()
    body = {"prompt": "delta eps", "max_tokens": 8, "stop": [words[1]]}
    _, solo = _post(srv.port, "/v1/completions", body)
    events = _sse_events(srv.port, "/v1/completions", {**body, "stream": True})
    text = "".join(e["choices"][0]["text"] for e in events
                   if e["choices"][0].get("text"))
    finishes = [e["choices"][0]["finish_reason"] for e in events
                if e["choices"][0]["finish_reason"]]
    assert text == solo["choices"][0]["text"] and finishes == ["stop"]

  def test_stop_absent_leaves_output_unchanged(self, httpd):
    srv, _ = httpd
    body = {"prompt": "alpha beta gamma", "max_tokens": 6}
    _, free = _post(srv.port, "/v1/completions", body)
    _, stopped = _post(srv.port, "/v1/completions",
                       {**body, "stop": ["<never-matches>"]})
    assert stopped["choices"][0]["text"] == free["choices"][0]["text"]
    assert stopped["choices"][0]["finish_reason"] in ("stop", "length")


class TestHonoredSamplingKnobs:

  @pytest.fixture()
  def httpd(self, setup):
    base, vocab = setup
    cat = sampler_lib.Sampler(base.model, vocab, device="cpu",
                              deterministic_sampling=False)
    srv = _server(cat, per_request_sampling=True)
    yield srv, base, vocab
    srv.close()

  def test_temperature_top_p_seed_match_solo(self, httpd):
    srv, base, vocab = httpd
    _, out = _post(srv.port, "/v1/completions",
                   {"prompt": "alpha beta", "max_tokens": 8, "seed": 5,
                    "temperature": 0.7, "top_p": 0.9})
    solo = sampler_lib.Sampler(
        base.model, vocab, device="cpu", deterministic_sampling=False,
        temperature=0.7, top_p=0.9,
    )(["alpha beta"], total_generation_steps=8,
      generator=torch.Generator().manual_seed(5))
    assert out["choices"][0]["text"] == vocab.DecodeIds(
        solo.tokens[0].tolist())

  def test_temperature_zero_is_deterministic(self, httpd):
    srv, base, vocab = httpd
    texts = {
        _post(srv.port, "/v1/completions",
              {"prompt": "delta eps", "max_tokens": 6, "seed": seed,
               "temperature": 0})[1]["choices"][0]["text"]
        for seed in (1, 2, 3)
    }
    assert texts == {vocab.DecodeIds(_solo(base, "delta eps", 6))}

  def test_n_parallel_samples(self, httpd):
    srv, base, vocab = httpd
    _, out = _post(srv.port, "/v1/completions",
                   {"prompt": "alpha beta", "max_tokens": 6, "seed": 11,
                    "n": 3})
    assert [c["index"] for c in out["choices"]] == [0, 1, 2]
    cat = sampler_lib.Sampler(base.model, vocab, device="cpu",
                              deterministic_sampling=False)
    for i, choice in enumerate(out["choices"]):  # seeds are seed + i
      want = _solo(cat, "alpha beta", 6,
                   generator=torch.Generator().manual_seed(11 + i))
      assert choice["text"] == vocab.DecodeIds(want)
    usage = out["usage"]
    assert usage["completion_tokens"] > 0
    assert usage["total_tokens"] == (usage["prompt_tokens"]
                                     + usage["completion_tokens"])

  def test_n_parallel_samples_streaming(self, httpd):
    srv, _, _ = httpd
    body = {"prompt": "alpha beta", "max_tokens": 6, "seed": 11, "n": 3}
    _, solo = _post(srv.port, "/v1/completions", body)
    want = {c["index"]: c["text"] for c in solo["choices"]}
    events = _sse_events(srv.port, "/v1/completions", {**body, "stream": True})
    got, finishes = {}, {}
    for e in events:
      (choice,) = e["choices"]
      got[choice["index"]] = got.get(choice["index"], "") + choice["text"]
      if choice["finish_reason"]:
        finishes[choice["index"]] = choice["finish_reason"]
    assert got == want and set(finishes) == {0, 1, 2}

  def test_logit_bias_forces_a_token(self, httpd):
    srv, _, vocab = httpd
    tok = vocab.EncodeAsIds("zeta")[0]
    _, out = _post(srv.port, "/v1/completions",
                   {"prompt": "alpha beta", "max_tokens": 5, "seed": 3,
                    "logit_bias": {str(tok): 100}})
    assert out["choices"][0]["text"] == vocab.DecodeIds([tok] * 5)

  def test_logit_bias_bans_a_token(self, httpd):
    srv, _, vocab = httpd
    body = {"prompt": "delta eps", "max_tokens": 6, "seed": 7,
            "temperature": 0}
    _, free = _post(srv.port, "/v1/completions", body)
    banned = vocab.EncodeAsIds(free["choices"][0]["text"])[0]
    _, out = _post(srv.port, "/v1/completions",
                   {**body, "logit_bias": {str(banned): -100}})
    assert banned not in vocab.EncodeAsIds(out["choices"][0]["text"])

  def test_logit_bias_rejects_bad_input(self, httpd):
    srv, _, vocab = httpd
    err = _post_error(srv.port, "/v1/completions",
                      {"prompt": "alpha", "max_tokens": 2,
                       "logit_bias": {"zeta": "much"}})
    assert "logit_bias" in err["message"]
    err = _post_error(srv.port, "/v1/completions",
                      {"prompt": "alpha", "max_tokens": 2,
                       "logit_bias": {str(vocab.GetPieceSize() + 5): 1}})
    assert "vocabulary" in err["message"]

  def test_stream_options_include_usage(self, httpd):
    srv, _, _ = httpd
    events = _sse_events(srv.port, "/v1/completions",
                         {"prompt": "alpha beta", "max_tokens": 5, "seed": 1,
                          "stream": True,
                          "stream_options": {"include_usage": True}})
    (final,) = [e for e in events if "usage" in e]
    assert final is events[-1] and final["choices"] == []
    n_tokens = sum(1 for e in events
                   if e["choices"] and e["choices"][0]["text"])
    assert final["usage"]["completion_tokens"] >= max(1, n_tokens)
    _post_error(srv.port, "/v1/completions",
                {"prompt": "alpha", "stream_options": {"include_usage": True}})

  def test_seedless_categorical_auto_seeds(self, httpd):
    srv, _, _ = httpd
    status, out = _post(srv.port, "/v1/completions",
                        {"prompt": "delta eps", "max_tokens": 4})
    assert status == 200 and isinstance(out["choices"][0]["text"], str)

  def test_stop_string_halts_generation(self, httpd):
    srv, base, vocab = httpd
    toks = _solo(base, "delta eps", 8)
    stop_word = vocab.DecodeIds([toks[0]])
    assert vocab.EncodeAsIds(stop_word) == [toks[0]]  # one token
    _, out = _post(srv.port, "/v1/completions",
                   {"prompt": "delta eps", "max_tokens": 8, "seed": 1,
                    "temperature": 0, "stop": stop_word})
    assert out["choices"][0]["text"] == ""
    assert out["choices"][0]["finish_reason"] == "stop"


class TestLogprobs:

  @pytest.fixture()
  def httpd(self, setup):
    srv = _server(setup[0], steps=6, record_logprobs=3)
    yield srv, setup[0], setup[1]
    srv.close()

  def test_batcher_logprobs_match_solo_distribution(self, setup):
    s, _ = setup
    b = _batcher(s, steps=6, record_logprobs=3)
    rid = b.add_request("delta eps")
    tokens = {r: t for r, t, _ in b.run_until_drained(2)}[rid]
    record = b.take_logprobs(rid)
    assert len(record["token_logprobs"]) == len(tokens)
    solo = s(["delta eps"], total_generation_steps=6, return_logits=True)
    solo_lp = torch.log_softmax(solo.logits[0].float(), dim=-1)
    for i, tok in enumerate(tokens):
      np.testing.assert_allclose(record["token_logprobs"][i],
                                 float(solo_lp[i, tok]), atol=1e-5)
      assert record["top_ids"][i] == torch.argsort(
          solo_lp[i], descending=True)[:3].tolist()
    with pytest.raises(KeyError):
      b.take_logprobs(rid)  # handed over once

  def test_completions_legacy_logprobs_shape(self, httpd):
    srv, _, _ = httpd
    _, out = _post(srv.port, "/v1/completions",
                   {"prompt": "delta eps", "max_tokens": 5, "logprobs": 2})
    lp = out["choices"][0]["logprobs"]
    assert set(lp) == {"tokens", "token_logprobs", "top_logprobs",
                       "text_offset"}
    assert len(lp["tokens"]) == len(lp["token_logprobs"])
    assert all(len(d) <= 2 for d in lp["top_logprobs"])
    assert lp["text_offset"] == [sum(len(t) for t in lp["tokens"][:i])
                                 for i in range(len(lp["tokens"]))]

  def test_chat_logprobs_shape(self, httpd):
    srv, _, _ = httpd
    _, out = _post(srv.port, "/v1/chat/completions",
                   {"messages": [{"role": "user", "content": "delta eps"}],
                    "max_tokens": 4, "logprobs": True, "top_logprobs": 2})
    content = out["choices"][0]["logprobs"]["content"]
    assert len(content) >= 1
    for entry in content:
      assert {"token", "logprob", "top_logprobs"} <= set(entry)
      assert len(entry["top_logprobs"]) == 2

  def test_streaming_logprobs_final_chunk(self, httpd):
    srv, _, _ = httpd
    body = {"messages": [{"role": "user", "content": "delta eps"}],
            "max_tokens": 4, "logprobs": True, "top_logprobs": 2}
    _, solo = _post(srv.port, "/v1/chat/completions", body)
    events = _sse_events(srv.port, "/v1/chat/completions",
                         {**body, "stream": True})
    (final,) = [e for e in events if e["choices"][0].get("logprobs")]
    assert final["choices"][0]["finish_reason"] in ("stop", "length")
    assert (final["choices"][0]["logprobs"]
            == solo["choices"][0]["logprobs"])

  def test_logprob_rejections(self, httpd, setup):
    srv, _, _ = httpd
    _post_error(srv.port, "/v1/completions",
                {"prompt": "alpha", "logprobs": 5})  # > recorded k
    plain = _server(setup[0], num_slots=1)
    try:
      _post_error(plain.port, "/v1/completions",
                  {"prompt": "alpha", "logprobs": 1})
    finally:
      plain.close()


class TestProductionHardening:

  @staticmethod
  def _block_slots(fe, n, prompt="delta eps", steps=100_000):
    """Occupies all ``n`` slots with long requests ("delta eps" never
    emits a stop token) and waits until they are admitted."""
    blockers = [fe.submit(prompt, max_tokens=steps) for _ in range(n)]
    deadline = time.monotonic() + 120
    while fe.batcher.active_count < n:
      assert time.monotonic() < deadline, "blockers never admitted"
      time.sleep(0.02)
    return blockers

  def test_queue_full_backpressure(self, setup):
    s, vocab = setup
    fe = _frontend(_batcher(s, num_slots=1), max_queue=2)
    try:
      blockers = self._block_slots(fe, 1)
      queued = [fe.submit("alpha beta") for _ in range(2)]
      with pytest.raises(server_lib.QueueFull):
        fe.submit("gamma")
      fe.cancel(blockers[0].request_id)
      for sub in queued:
        tokens, _ = sub.result(timeout=120)
        _check(tokens, _solo(s, "alpha beta", 8), 8, vocab.eos_id())
      tokens, _ = fe.submit("gamma").result(timeout=120)
      _check(tokens, _solo(s, "gamma", 8), 8, vocab.eos_id())
    finally:
      fe.close()

  def test_http_429_and_metrics_endpoint(self, setup):
    srv = _server(setup[0], num_slots=1, frontend_kw=dict(max_queue=1))
    fe = srv.frontend
    try:
      blockers = self._block_slots(fe, 1)
      fe.submit("alpha beta")  # fills the queue
      for path in ("/v1/generate", "/v1/completions"):
        err = _post_error(srv.port, path,
                          {"prompt": "gamma", "max_tokens": 4}, code=429)
        if path == "/v1/completions":
          assert err["type"] == "overloaded_error"
      fe.cancel(blockers[0].request_id)
      deadline = time.monotonic() + 120
      while fe.stats["completed"] < 1:
        assert time.monotonic() < deadline
        time.sleep(0.05)
      with urllib.request.urlopen(
          f"http://127.0.0.1:{srv.port}/metrics", timeout=30) as resp:
        assert resp.headers["Content-Type"].startswith("text/plain")
        text = resp.read().decode()
      assert "cadence_up 1" in text
      m = re.search(r"cadence_completed_total (\d+)", text)
      assert m is not None and int(m.group(1)) >= 1, text
      assert "# TYPE cadence_tokens_out_total counter" in text
      assert 'cadence_ttft_seconds{quantile="0.5"}' in text
    finally:
      srv.close()

  def test_close_drain_finishes_inflight(self, setup):
    s, vocab = setup
    fe = _frontend(_batcher(s))
    prompts = ("alpha beta", "gamma delta", "eps")
    subs = [fe.submit(p) for p in prompts]
    fe.close(drain=True)
    for sub, prompt in zip(subs, prompts):
      tokens, _ = sub.result(timeout=5)  # already delivered
      _check(tokens, _solo(s, prompt, 8), 8, vocab.eos_id())

  def test_close_without_drain_cancels_inflight(self, setup):
    fe = _frontend(_batcher(setup[0], num_slots=1, steps=200), step_size=1)
    sub = fe.submit("delta eps")
    fe.close()
    with pytest.raises(RuntimeError, match="cancelled"):
      sub.result(timeout=30)


class TestToolCalling:
  """``tool_choice`` auto and none: free generation, envelope recognized
  after the fact; forced choices are the constrained surfaces above."""

  def test_tool_choice_auto_free_text_is_content(self, setup):
    srv = _server(setup[0], num_slots=1, steps=6)
    try:
      status, out = _post(srv.port, "/v1/chat/completions", {
          "messages": [{"role": "user", "content": "delta eps"}],
          "tools": TOOLS})  # tool_choice defaults to auto
      assert status == 200
      choice = out["choices"][0]
      assert "tool_calls" not in choice["message"]
      assert isinstance(choice["message"]["content"], str)
      assert choice["finish_reason"] in ("stop", "length")
    finally:
      srv.close()

  def test_tool_choice_none_matches_tool_free_request(self, setup):
    srv = _server(setup[0], num_slots=1, steps=6)
    try:
      msgs = [{"role": "user", "content": "delta eps"}]
      _, with_none = _post(srv.port, "/v1/chat/completions", {
          "messages": msgs, "tools": TOOLS, "tool_choice": "none"})
      _, without = _post(srv.port, "/v1/chat/completions",
                         {"messages": msgs})
      assert (with_none["choices"][0]["message"]
              == without["choices"][0]["message"])
    finally:
      srv.close()

  def test_bad_tools_and_modes_rejected(self, setup):
    srv = _server(setup[0], num_slots=1, steps=6)
    msgs = [{"role": "user", "content": "x"}]
    try:
      for body, want in (
          ({"tools": [{"type": "retrieval"}]}, "function"),
          ({"tools": TOOLS, "tool_choice": {
              "type": "function", "function": {"name": "zzz"}}},
           "not in tools"),
          ({"tools": TOOLS, "tool_choice": "frobnicate"}, "tool_choice"),
      ):
        err = _post_error(srv.port, "/v1/chat/completions",
                          {"messages": msgs, **body})
        assert want in err["message"]
    finally:
      srv.close()

  # JAX's forced cases: the completion is constrained to
  # constrain.tool_call_schema(tools), so it is a well-formed call whose
  # arguments match the declared parameters.

  @pytest.fixture(scope="class")
  def tool_httpd(self):
    pieces = list('{}:,"0123456789-') + ["name", "argu", "ment", "s", "f",
                                         "g", "x"]
    sampler, vocab = _char_sampler(pieces, seed=5)
    srv = _server(sampler, steps=64, dynamic_grammar_slots=2,
                  dynamic_grammar_budget=(320, 48, 8),
                  frontend_kw=dict(step_size=4))
    yield srv
    srv.close()

  def test_tool_choice_required_yields_valid_call(self, tool_httpd):
    status, out = _post(tool_httpd.port, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "x"}], "tools": TOOLS,
        "tool_choice": "required", "max_tokens": 64})
    assert status == 200
    choice = out["choices"][0]
    if choice["finish_reason"] == "tool_calls":
      assert choice["message"]["content"] is None
      (call,) = choice["message"]["tool_calls"]
      fn = call["function"]
      args = json.loads(fn["arguments"])
      assert (isinstance(args["x"], int) if fn["name"] == "f"
              else fn["name"] == "g" and args == {})
    else:  # the budget cut it: a live prefix of the envelope
      assert choice["finish_reason"] == "length"
      assert choice["message"]["content"].startswith('{"name":"')

  def test_named_tool_choice_forces_that_tool(self, tool_httpd):
    status, out = _post(tool_httpd.port, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "x"}], "tools": TOOLS,
        "tool_choice": {"type": "function", "function": {"name": "g"}},
        "max_tokens": 64})
    assert status == 200
    choice = out["choices"][0]
    if choice["finish_reason"] == "tool_calls":
      (call,) = choice["message"]["tool_calls"]
      assert call["function"]["name"] == "g"
      assert json.loads(call["function"]["arguments"]) == {}
    else:
      assert choice["message"]["content"].startswith('{"name":"g"')

  def test_forced_tool_choice_conflicts_with_response_format(self,
                                                             tool_httpd):
    err = _post_error(tool_httpd.port, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "x"}], "tools": TOOLS,
        "tool_choice": "required", "response_format": {
            "type": "json_schema",
            "json_schema": {"schema": {"type": "integer"}}}})
    assert "response_format" in err["message"]

  def test_streaming_forced_tool_call(self, tool_httpd):
    events = _sse_events(tool_httpd.port, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "x"}], "tools": TOOLS,
        "tool_choice": {"type": "function", "function": {"name": "f"}},
        "max_tokens": 64, "stream": True})
    finish = events[-1]["choices"][0]["finish_reason"]
    headers = [e for e in events
               if e["choices"][0]["delta"].get("tool_calls")
               and "id" in e["choices"][0]["delta"]["tool_calls"][0]]
    if finish == "tool_calls":
      # One header naming the forced tool, then argument fragments that
      # join into arguments valid under f's schema; no content deltas.
      (header,) = headers
      call = header["choices"][0]["delta"]["tool_calls"][0]
      assert call["function"] == {"name": "f", "arguments": ""}
      assert call["id"].startswith("call_")
      args = "".join(tc["function"].get("arguments", "")
                     for e in events
                     for tc in e["choices"][0]["delta"].get("tool_calls", []))
      assert isinstance(json.loads(args)["x"], int)
      assert not any(e["choices"][0]["delta"].get("content") for e in events)
    else:
      assert finish == "length" and len(headers) <= 1

  def test_streaming_auto_free_text_matches_nonstreaming(self, setup):
    # A word-vocab model cannot spell the envelope: auto + stream delivers
    # as content exactly what the non-streaming request returns, which is
    # the solo run of the prompt with the tool preamble rendered in.
    s, vocab = setup
    srv = _server(s, steps=6)
    msgs = [{"role": "user", "content": "delta eps"}]
    try:
      events = _sse_events(srv.port, "/v1/chat/completions", {
          "messages": msgs, "tools": TOOLS, "stream": True})
      assert not any("tool_calls" in e["choices"][0]["delta"]
                     for e in events)
      text = "".join(e["choices"][0]["delta"].get("content", "")
                     for e in events)
      _, whole = _post(srv.port, "/v1/chat/completions",
                       {"messages": msgs, "tools": TOOLS})
      assert text and text == whole["choices"][0]["message"]["content"]
      prompt, _ = server_lib.render_chat_messages(msgs, False, tools=TOOLS)
      assert text == vocab.DecodeIds(_solo(s, prompt, 6))
    finally:
      srv.close()


class TestIdleStepSize:

  def test_idle_boost_matches_solo(self, setup):
    s, vocab = setup
    fe = _frontend(_batcher(s), step_size_idle=8)
    try:
      prompts = ["alpha beta", "gamma delta eps", "theta eta"]
      subs = [fe.submit(p) for p in prompts]
      for p, sub in zip(prompts, subs):
        tokens, _ = sub.result(timeout=120)
        _check(tokens, _solo(s, p, 8), 8, vocab.eos_id())
    finally:
      fe.close()


def test_frontend_needs_a_card_unless_asked(setup, monkeypatch):
  b = _batcher(setup[0])
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    server_lib.ServingFrontend(b)
  assert b.stream_callback is None  # refused before it was installed


# -- the host helpers against the JAX package's -----------------------


MESSAGES = {
    "it_multiturn": [{"role": "user", "content": "hi"},
                     {"role": "assistant", "content": "hello"},
                     {"role": "user", "content": "bye"}],
    "system": [{"role": "system", "content": "be brief"},
               {"role": "user", "content": "hi"}],
    "parts_and_image": [{"role": "user", "content": [
        {"type": "text", "text": "what is"},
        {"type": "image_url",
         "image_url": {"url": "data:image/jpeg;base64,QUJD"}},
        {"type": "text", "text": "this"}]}],
    "tool_history": [
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": "weather?"},
        {"role": "assistant", "tool_calls": [{
            "id": "call_1", "type": "function",
            "function": {"name": "f", "arguments": '{"x": 3}'}}]},
        {"role": "tool", "tool_call_id": "call_1",
         "content": '{"temp": 9}'}],
    "merged_tool_results": [
        {"role": "user", "content": "go"},
        {"role": "assistant", "tool_calls": [
            {"id": "a", "type": "function",
             "function": {"name": "f", "arguments": "{}"}},
            {"id": "b", "type": "function",
             "function": {"name": "g", "arguments": "not json"}}]},
        {"role": "tool", "tool_call_id": "a", "content": "1"},
        {"role": "tool", "tool_call_id": "b", "content": "plain"}],
    "empty": [],
    "starts_assistant": [{"role": "assistant", "content": "x"}],
    "ends_assistant": [{"role": "user", "content": "a"},
                       {"role": "assistant", "content": "b"}],
    "no_alternation": [{"role": "user", "content": "a"},
                       {"role": "user", "content": "b"}],
    "late_system": [{"role": "user", "content": "a"},
                    {"role": "system", "content": "late"}],
    "orphan_tool": [{"role": "tool", "content": "x"}],
    "bad_role": [{"role": "robot", "content": "x"}],
    "remote_image": [{"role": "user", "content": [
        {"type": "image_url",
         "image_url": {"url": "http://example.com/x.jpg"}}]}],
    "two_images": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": "data:a;base64,QQ"}},
        {"type": "image_url", "image_url": {"url": "data:a;base64,Qg"}}]}],
}


def _outcome(fn, *args, **kwargs):
  try:
    return ("ok", fn(*args, **kwargs))
  except ValueError as e:
    return ("ValueError", str(e))


@pytest.mark.parametrize("it", [True, False])
@pytest.mark.parametrize("tools", [None, TOOLS])
@pytest.mark.parametrize("case", list(MESSAGES))
def test_render_chat_messages_matches_jax(jserver, case, tools, it):
  got = _outcome(server_lib.render_chat_messages, MESSAGES[case], it,
                 tools=tools)
  assert got == _outcome(jserver.render_chat_messages, MESSAGES[case], it,
                         tools=tools)
  if case == "it_multiturn" and it and tools is None:
    # The sampler's wrap of the rendered interior is the canonical
    # alternating multi-turn template.
    assert common.apply_it_formatter(got[1][0]) == (
        f"{common.IT_USER_OPEN}hi{common.IT_TURN_CLOSE}"
        f"{common.IT_MODEL_OPEN}hello{common.IT_TURN_CLOSE}"
        f"{common.IT_USER_OPEN}bye{common.IT_TURN_CLOSE}"
        f"{common.IT_MODEL_OPEN}")


def test_render_tool_preamble_matches_jax(jserver):
  assert (server_lib.render_tool_preamble(TOOLS)
          == jserver.render_tool_preamble(TOOLS))


@pytest.mark.parametrize("text", [
    '{"name":"f","arguments":{"x":1}}', "hello",
    '{"name":"zzz","arguments":{}}', '{"name":"f","arguments":3}',
    '{"name":"f"}', '  {"name": "g", "arguments": {}}  ', "[1, 2]",
])
def test_parse_tool_call_matches_jax(jserver, text):
  names = {"f", "g"}
  assert (server_lib.parse_tool_call(text, names)
          == jserver.parse_tool_call(text, names))


def _drive_stop_gate(module, stops, text, chunk):
  gate = module.StopStringGate(stops)
  events = []
  for i in range(chunk, len(text) + 1, chunk):
    events.append(gate.feed(text[:i]))
    if events[-1][1]:
      break
  events.append(gate.finish(text))
  return events, module.StopStringGate(stops).truncate(text)


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("stops,text", [
    (["XY"], "aXbXYc"), (["END"], "fooENx"), (["ZZ"], "abZ"),
    (["b", "c"], "abc"), (["", "never"], "nothing to stop"),
])
def test_stop_string_gate_matches_jax(jserver, stops, text, chunk):
  assert (_drive_stop_gate(server_lib, stops, text, chunk)
          == _drive_stop_gate(jserver, stops, text, chunk))


def _drive_tool_gate(module, text, forced, chunk, flush_at=None):
  gate = module.ToolStreamGate({"f", "get_weather"}, forced)
  events = []
  for i in range(chunk, len(text) + 1, chunk):
    events.append(gate.feed(text[:i]))
    if flush_at is not None and i >= flush_at:
      return events + [gate.flush_content()]
  return events + [gate.finish(text)]


@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("chunk", [1, 3, 1000])
@pytest.mark.parametrize("text", [
    '{"name":"get_weather","arguments":{"city":"Oslo","n":3}}',
    '{ "name" : "f" ,\n "arguments" : { "x" : 1 } }',
    "hi there!", '{"name":"zzz","arguments":{}}', '{"name":"f","arguments":5}',
    '{"name":"f","arguments":{"x":1}} and then some',
    '{"name":"f","arguments":{oops:1}}', '{"name":"f","arguments":{"x":1}',
    '{"name":"f","argu', '{"name":"f","arguments":{"x":',
    '{"name":"f","arguments":{"a":{"b":[1,{"c":2}]},"s":"}"}}',
])
def test_tool_stream_gate_matches_jax(jserver, text, chunk, forced):
  assert (_drive_tool_gate(server_lib, text, forced, chunk)
          == _drive_tool_gate(jserver, text, forced, chunk))
  flush_at = len(text) // 2
  assert (_drive_tool_gate(server_lib, text, forced, 1, flush_at)
          == _drive_tool_gate(jserver, text, forced, 1, flush_at))


def test_tool_call_schema_matches_jax():
  from cadence_gemma_tpu.inference import constrain as jconstrain

  for tools, name in ((TOOLS, None), (TOOLS, "g"), (TOOLS[:1], None)):
    assert (constrain.tool_call_schema(tools, name)
            == jconstrain.tool_call_schema(tools, name))
  for tools, name in (([], None), (TOOLS, "zzz"), ([{"type": "x"}], None),
                      ([TOOLS[0], TOOLS[0]], None)):
    with pytest.raises(ValueError) as want:
      jconstrain.tool_call_schema(tools, name)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
      constrain.tool_call_schema(tools, name)


def test_small_helpers_match_jax(jserver):
  assert server_lib._openai_error("m", "k") == jserver._openai_error("m", "k")
  vocab = SimpleVocab(["a", "bb"])
  record = {"token_logprobs": [-0.5, -1.0], "top_ids": [[4, 5], [5, 4]],
            "top_logprobs": [[-0.5, -1.2], [-1.0, -2.0]]}
  for chat in (True, False):
    for k in (0, 1, 2):
      assert (server_lib._format_logprobs(record, [4, 5], vocab, chat, k)
              == jserver._format_logprobs(record, [4, 5], vocab, chat, k))


# -- the captured tick on the card -------------------------------------


@requires_cuda
@pytest.mark.parametrize("mode", ["greedy", "categorical", "per_request"])
def test_captured_tick_matches_eager_tick(mode):
  """At one slot width, the tick captured as a CUDA graph and the eager
  tick give identical tokens and leave the request generators alike."""
  vocab = SimpleVocab([f"w{i}" for i in range(508)])
  config = common.GriffinConfig(
      vocab_size=512, width=128, mlp_expanded_width=256, num_heads=2,
      block_types=(common.TemporalBlockType.RECURRENT,
                   common.TemporalBlockType.ATTENTION,
                   common.TemporalBlockType.RECURRENT),
      embeddings_scale_by_sqrt_dim=True, attention_window_size=16,
      logits_soft_cap=30.0, lru_width=128,
  )
  dev = torch.device("cuda")
  model = griffin.Griffin(config, device=dev, dtype=torch.float32,
                          generator=torch.Generator(dev).manual_seed(0))
  rng = np.random.default_rng(3)
  prompts = [" ".join(f"w{i}" for i in rng.integers(0, 508, n))
             for n in (40, 27, 9, 33)]
  sampler_kw = dict(greedy={}, categorical=dict(
      deterministic_sampling=False, temperature=0.8, top_k=50, top_p=0.95),
                    per_request=dict(deterministic_sampling=False))[mode]
  results = []
  for jit in (True, False):
    s = sampler_lib.Sampler(model, vocab, jit_compile=jit, **sampler_kw)
    b = serving.ContinuousBatcher(s, num_slots=3, max_steps_default=24,
                                  per_request_sampling=mode == "per_request",
                                  reuse_programs=False)
    gens = [torch.Generator(dev).manual_seed(i) for i in range(len(prompts))]
    kw = [dict(generator=g) if mode != "greedy" else {} for g in gens]
    if mode == "per_request":
      kw[0].update(temperature=0.7, repetition_penalty=1.3)
      kw[1].update(top_k=5, logit_bias={7: 2.0})
    rids = [b.add_request(prompts[i], **kw[i]) for i in range(3)]
    b.step(5)
    got = {r: t for r, t, _ in b.pop_finished()}
    rids.append(None)
    while b.active_count or rids[-1] is None:
      if rids[-1] is None and b.has_capacity:
        rids[-1] = b.add_request(prompts[3], **kw[3])
      b.step(4)
      got.update({r: t for r, t, _ in b.pop_finished()})
    assert b._captures is jit and (not jit or len(b._programs) == 1)
    results.append(([got[r] for r in rids],
                    [g.get_state() for g in gens]))
  (tokens_c, gens_c), (tokens_e, gens_e) = results
  assert tokens_c == tokens_e
  assert all(torch.equal(a, c) for a, c in zip(gens_c, gens_e))
