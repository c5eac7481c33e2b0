"""HTTP serving front end over the port's :class:`ContinuousBatcher`.

Counterpart of the JAX package's ``cadence_gemma_tpu/inference/server.py``,
the deployment shape the system serves in: one slot-based continuous batcher
advanced by ONE driver thread, behind a threaded HTTP server whose handlers
never touch torch.

Threading model: every torch call -- admission prefill, decode ticks (and
the capture of the tick's CUDA graph), host fetches -- runs on the single
driver thread, which owns the card (``torch.cuda.set_device`` at its start).
HTTP handler threads only enqueue submissions and block on per-request
queues; cancellation flips a host-side flag that the driver honors on its
next tick.

Endpoints (JSON over stdlib ``http.server``; no third-party deps):

  POST /v1/generate   {"prompt": str, "max_tokens": int?, "stream": bool?,
                       "seed": int?, "image_path": str?, "image_b64": str?,
                       "session": str?, "adapter": any?}
      stream=false -> one body: {"id", "tokens", "text"}
      stream=true  -> chunked NDJSON: {"id", "tokens": [...]} lines as the
                     request emits tokens, then {"id", "done": true,
                     "tokens": [], "text": full_text}
      "session" names a conversation: turns chain through per-request
      PrefixStates (batcher built with preserve_states=True), so each turn
      prefills only the new message. One turn in flight per session (409
      otherwise). "adapter" is an opaque reference the frontend's
      adapter_resolver maps to a LoRA tree (a multi_lora batcher); without
      a resolver, or for a reference it cannot resolve, the answer is 400.
  POST /v1/cancel     {"id": int} -> {"cancelled": bool}
  POST /v1/reset      {"session": str} -> {"reset": bool} (drop context;
                      epoch-fenced against a turn finishing mid-reset)
  GET  /v1/health     -> {"ok", "slots", "active", "queued", "completed",
                      "cancelled", "errors", "tokens_out", and over the last
                      512 completions "ttft_s_p50/p90", "wall_s_p50/p90"
                      measured from submit}; 503 with "error" once the
                      driver thread has died (every in-flight request is
                      failed rather than stranded)
  GET  /metrics       -> Prometheus text exposition of the same counters,
                      gauges and latency quantiles
  429 (QueueFull) once ``max_queue`` submissions are waiting; ``close
  (drain=True)`` finishes queued and in-flight requests before stopping.

OpenAI-compatible surface (same frontend):

  GET  /v1/models           -> {"object": "list", "data": [{"id": ...}]}
  POST /v1/completions      {"prompt": str|[str], "max_tokens": int?,
                             "stream": bool?, "seed": int?}
  POST /v1/chat/completions {"messages": [{"role", "content"}], ...}
      ``content`` may be a string or OpenAI content-part lists; image parts
      must be ``data:`` URLs. System messages prepend to the first user turn
      (Gemma has no system role); multi-turn histories render through the
      samplers' IT template fragments. ``stream=true`` emits SSE ``data:``
      chunks, then ``data: [DONE]``. With a ``per_request_sampling``
      batcher, temperature / top_p / top_k / min_tokens /
      repetition_penalty / logit_bias are honored per request (temperature
      0 maps to top_k=1); otherwise they are ignored. ``stop`` sequences
      work on any batcher (matched host-side by :class:`StopStringGate`;
      single-token stops also end generation on the device with
      ``per_request_sampling``). ``n > 1`` streams choices one after the
      other; requested ``logprobs`` arrive in one final chunk per choice;
      ``stream_options: {"include_usage": true}`` appends the usage chunk.
      ``echo`` is refused (400).

      ``response_format: {"type": "json_object"}`` masks the generation
      with the grammar the frontend names ``"json_object"``
      (``constrain.json_mode_dfa`` registered on the batcher and named in
      ``constraint_names``); ``{"type": "json_schema", "json_schema":
      {"schema": ...}}`` compiles the schema (the strict structured-outputs
      subset) on the handler thread into a dynamic grammar slot.

      Tool calling (``tools`` + ``tool_choice``): declared functions render
      as an in-prompt preamble (``render_tool_preamble``). ``tool_choice:
      "required"`` or a named function constrains the completion to
      ``constrain.tool_call_schema(tools)`` through the dynamic grammar
      slots, so the arguments match the tool's ``parameters`` schema;
      ``"auto"`` (or ``"none"``) leaves generation free and recognizes
      envelope output after the fact (``parse_tool_call``). Tool calls come
      back as OpenAI ``message.tool_calls`` with ``finish_reason:
      "tool_calls"``. Streaming composes: a forced call streams
      ``delta.tool_calls`` chunks (name header, then argument fragments);
      auto mode streams through :class:`ToolStreamGate`.

``/v1/generate`` takes ``constraint``: a name from ``constraint_names`` or a
JSON schema.

``ServingFrontend`` is usable without HTTP (library callers submit and
wait); ``ServingHTTPServer`` wraps it for the wire.
"""

from __future__ import annotations

import base64
import collections
import json
import queue
import secrets
import statistics
import tempfile
import threading
import time
from http import server as http_server
from typing import Any

import torch

from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch.inference import constrain
from cadence_gemma_tpu_torch.inference import serving as serving_lib
from cadence_gemma_tpu_torch.models import griffin


def _message_parts(content: Any) -> tuple[str, str | None]:
  """Extracts (text, image_b64) from an OpenAI message ``content``.

  ``content`` is a plain string or a list of typed parts. Image parts
  must be ``data:`` URLs — the server never fetches remote URLs.
  """
  if isinstance(content, str):
    return content, None
  if not isinstance(content, list):
    raise ValueError("message content must be a string or a list of parts")
  texts: list[str] = []
  image_b64 = None
  for part in content:
    kind = part.get("type") if isinstance(part, dict) else None
    if kind == "text":
      texts.append(part.get("text", ""))
    elif kind == "image_url":
      url = (part.get("image_url") or {}).get("url", "")
      if not url.startswith("data:"):
        raise ValueError(
            "image_url must be a data: URL (the server does not fetch "
            "remote images)"
        )
      header, _, payload = url.partition(",")
      if "base64" not in header or not payload:
        raise ValueError("image data: URL must be base64-encoded")
      if image_b64 is not None:
        raise ValueError("at most one image per request")
      image_b64 = payload
    else:
      raise ValueError(f"unsupported content part type: {kind!r}")
  return "\n".join(t for t in texts if t), image_b64


def render_tool_preamble(tools: list) -> str:
  """The in-prompt tool declaration block (Gemma has no tool role).

  Declares the available functions and the calling convention — reply
  with ONLY the envelope JSON ``{"name": ..., "arguments": {...}}`` —
  matching :func:`constrain.tool_call_schema`, so a forced ``tool_choice``
  constrains generation to exactly what the preamble asks for.
  """
  decls = []
  for tool in tools:
    fn = tool.get("function") or {}
    decl = {"name": fn.get("name")}
    if fn.get("description"):
      decl["description"] = fn["description"]
    decl["parameters"] = fn.get(
        "parameters", {"type": "object", "properties": {}, "required": []}
    )
    decls.append(decl)
  return (
      "You can call functions. To call one, reply with ONLY a JSON "
      'object {"name": <function-name>, "arguments": <arguments-object>} '
      "and nothing else.\n"
      "Available functions:\n" + json.dumps(decls)
  )


def render_chat_messages(
    messages: list, is_it_model: bool, tools: list | None = None
) -> tuple[str, str | None]:
  """Renders an OpenAI ``messages`` list to one submit()-able prompt.

  Gemma has no system role, so system content prepends to the first user
  turn. For IT models the history renders through the same template
  fragments the samplers use: the sampler's own ``apply_it_formatter``
  wrap (the reference's ``apply_it_formatter`` semantics)
  supplies the outer ``<start_of_turn>user`` … ``<start_of_turn>model``
  shell, and this function joins the interior turns with
  ``IT_TURN_CLOSE``/``IT_MODEL_OPEN``/``IT_USER_OPEN`` transitions — so a
  stateless chat request tokenizes exactly like the canonical multi-turn
  template (and like the equivalent chained-session conversation).

  Tool use (Gemma has no tool tokens; the convention is in-band JSON,
  shared with :func:`constrain.tool_call_schema`):

  * ``tools``, when given, render as a declaration preamble ahead of the
    first user turn (after any system text).
  * assistant messages may carry ``tool_calls``; each call renders as the
    envelope JSON inside the model turn (after any content text).
  * ``role: "tool"`` results render as ``{"name": ..., "response": ...}``
    JSON on the user side of the dialogue; consecutive tool results merge
    into one user turn, and the name resolves through ``tool_call_id``.

  Returns (prompt, image_b64). At most one image across all messages.
  """
  if not isinstance(messages, list) or not messages:
    raise ValueError("messages must be a non-empty list")
  system_texts: list[str] = []
  turns: list[list] = []  # [role, text, from_tool]
  call_names: dict[str, str] = {}  # tool_call_id -> function name
  image_b64 = None

  def append_turn(role: str, text: str, from_tool: bool = False) -> None:
    if turns and turns[-1][0] == role and (from_tool or turns[-1][2]):
      prev = turns[-1][1]
      turns[-1][1] = f"{prev}\n{text}" if prev and text else (prev or text)
      turns[-1][2] = turns[-1][2] and from_tool
    else:
      turns.append([role, text, from_tool])

  for msg in messages:
    if not isinstance(msg, dict):
      raise ValueError("each message must be an object")
    role = msg.get("role")
    if role == "tool":
      if not any(t[0] == "assistant" for t in turns):
        raise ValueError(
            "tool result without a preceding assistant tool call"
        )
      text, _ = _message_parts(msg.get("content"))
      name = call_names.get(msg.get("tool_call_id", ""), "tool")
      payload: Any = text
      try:  # structured results pass through as JSON, not double-quoted
        payload = json.loads(text)
      except ValueError:
        pass
      append_turn(
          "user", json.dumps({"name": name, "response": payload}),
          from_tool=True,
      )
      continue
    text, img = _message_parts(msg.get("content") or "")
    if img is not None:
      if image_b64 is not None:
        raise ValueError("at most one image per request")
      image_b64 = img
    if role == "system":
      if turns:
        raise ValueError("system messages must precede the conversation")
      system_texts.append(text)
    elif role == "assistant" and msg.get("tool_calls"):
      parts = [text] if text else []
      for call in msg["tool_calls"]:
        fn = (call or {}).get("function") or {}
        args = fn.get("arguments", {})
        if isinstance(args, str):
          try:
            args = json.loads(args)
          except ValueError:
            pass  # keep the raw string — garbage in, garbage rendered
        parts.append(json.dumps({"name": fn.get("name"), "arguments": args}))
        if call.get("id"):
          call_names[call["id"]] = fn.get("name", "tool")
      append_turn("assistant", "\n".join(parts))
    elif role in ("user", "assistant"):
      append_turn(role, text)
    else:
      raise ValueError(f"unsupported role: {role!r}")
  if not turns or turns[0][0] != "user":
    raise ValueError("the conversation must start with a user message")
  if turns[-1][0] != "user":
    raise ValueError(
        "the conversation must end with a user or tool message "
        "(assistant continuation is not supported)"
    )
  for (role_a, _, _), (role_b, _, _) in zip(turns, turns[1:]):
    if role_a == role_b:
      raise ValueError("user/assistant messages must alternate")
  lead = list(system_texts)
  if tools:
    lead.append(render_tool_preamble(tools))
  if lead:
    lead_text = "\n\n".join(lead)
    turns[0][1] = (f"{lead_text}\n\n{turns[0][1]}" if turns[0][1]
                   else lead_text)
  if not is_it_model:
    return "\n".join(t for _, t, _ in turns), image_b64
  rendered = [turns[0][1]]
  for role, text, _ in turns[1:]:
    opener = (common.IT_MODEL_OPEN if role == "assistant"
              else common.IT_USER_OPEN)
    rendered.append(f"{common.IT_TURN_CLOSE}{opener}{text}")
  return "".join(rendered), image_b64


def parse_tool_call(text: str, valid_names: set[str]) -> dict | None:
  """Recognizes a generated tool-call envelope; None if it's plain text.

  The envelope is the whole completion (the preamble demands "ONLY a
  JSON object"): ``{"name": <declared tool>, "arguments": <object>}``.
  Returns ``{"name": ..., "arguments": <json string>}`` ready for the
  OpenAI ``tool_calls`` wire shape.
  """
  try:
    doc = json.loads(text)
  except ValueError:
    return None
  if (not isinstance(doc, dict) or doc.get("name") not in valid_names
      or not isinstance(doc.get("arguments"), dict)):
    return None
  return {"name": doc["name"], "arguments": json.dumps(doc["arguments"])}


class ToolStreamGate:
  """Incremental tool-call vs plain-text classifier for SSE streaming.

  Feed it the CUMULATIVE decoded completion text; it returns SSE-ready
  events as they become unambiguous:

  * forced mode (generation is constrained to the envelope grammar, so a
    committed tool call can never turn out malformed): the ``header``
    event fires as soon as the ``arguments`` value opens, and the raw
    value streams as ``args`` fragments (an incremental depth/string
    scanner bounds it, so the envelope's outer ``}`` never reaches a
    fragment). Budget truncation mid-arguments ends the stream with the
    fragments emitted so far and ``complete=False`` — the caller's
    ``finish_reason: "length"`` is the truncation signal, mirroring the
    non-streaming path's refusal to return a truncated call.
  * auto mode (unconstrained generation): content streams live from the
    first character that deviates from a plausible envelope lead
    (``{"name": "<declared tool>", "arguments": {``,
    whitespace-tolerant); while the text stays envelope-plausible it is
    buffered, and classification happens only at ``finish`` via
    :func:`parse_tool_call` — EXACTLY the non-streaming recognition, so
    a streamed auto request never commits to a tool call that
    non-streaming would have returned as content (malformed arguments,
    trailing text, truncation).

  Events: ``("header", name)``, ``("args", fragment)``,
  ``("content", text)``. ``finish(full_text)`` returns the final events
  plus whether a complete, parseable tool call was delivered;
  ``flush_content()`` surfaces any buffered-but-unclassified text when
  the stream dies before ``finish`` (cancellation, server error).
  """

  def __init__(self, tool_names: set[str], forced: bool):
    self._names = tool_names
    self._forced = forced
    self._mode = "undecided"  # undecided | content | tool
    self._name: str | None = None
    self._args_start: int | None = None
    self._last_text = ""  # latest cumulative text (for flush_content)
    self._sent = 0  # chars emitted (content offset, or args offset)
    # Incremental bounds of the arguments JSON value (tool mode): a
    # depth/string scanner marks where the object closes so fragments
    # never include the envelope's outer "}" or trailing text.
    self._scanned = 0       # chars of the value consumed so far
    self._depth = 0
    self._in_str = False
    self._esc = False
    self._val_end: int | None = None  # absolute index one past the value

  def _scan(self, text: str):
    """Parses the envelope lead. Returns one of
    ("partial",) / ("no",) / ("name", name) / ("args", name, value_pos).
    """
    i, n = 0, len(text)

    def ws(i: int) -> int:
      while i < n and text[i] in " \t\r\n":
        i += 1
      return i

    def lit(i: int, s: str):
      for j, ch in enumerate(s):
        if i + j >= n:
          return "partial", i
        if text[i + j] != ch:
          return "no", i
      return "ok", i + len(s)

    i = ws(i)
    for piece in ("{", '"name"', ":", '"'):
      st, i = lit(i, piece)
      if st != "ok":
        return (st if st == "no" else "partial",)
      i = ws(i) if piece != '"' else i
    start = i
    while i < n and text[i] not in '"\\\n':
      i += 1
    if i >= n:
      return ("partial",)
    if text[i] != '"':
      return ("no",)  # escapes/control in a name: not our envelope
    name = text[start:i]
    if name not in self._names:
      return ("no",)
    i = ws(i + 1)
    for piece in (",", '"arguments"', ":"):
      st, i = lit(i, piece)
      if st != "ok":
        return (("no",) if st == "no" else ("name", name))
      i = ws(i)
    if i >= n:
      return ("name", name)
    if text[i] != "{":
      return ("no",)  # non-object arguments: not a tool call
    return ("args", name, i)

  def feed(self, text: str) -> list[tuple[str, str]]:
    events: list[tuple[str, str]] = []
    self._last_text = text
    if self._mode == "content":
      if len(text) > self._sent:
        events.append(("content", text[self._sent:]))
        self._sent = len(text)
      return events
    if self._mode == "undecided":
      got = self._scan(text)
      if got[0] == "no" and not self._forced:
        self._mode = "content"
        if text:
          events.append(("content", text))
          self._sent = len(text)
        return events
      if got[0] == "args" and self._forced:
        # Only the grammar-constrained mode commits incrementally: a
        # committed header is irrevocable, and only the grammar
        # guarantees the envelope cannot turn out malformed. Auto mode
        # keeps buffering and classifies at finish().
        self._mode = "tool"
        self._name, self._args_start = got[1], got[2]
        self._sent = 0
        events.append(("header", self._name))
      else:
        return events  # plausible lead (or forced scan noise): buffer
    # tool mode: stream exactly the raw arguments value. The scanner
    # tracks brace depth and string state so emission stops at the
    # object's own closing "}" — the envelope's outer "}" (and any
    # trailing text) never reaches a fragment.
    i = self._args_start + self._scanned
    while self._val_end is None and i < len(text):
      ch = text[i]
      if self._in_str:
        if self._esc:
          self._esc = False
        elif ch == "\\":
          self._esc = True
        elif ch == '"':
          self._in_str = False
      elif ch == '"':
        self._in_str = True
      elif ch in "{[":
        self._depth += 1
      elif ch in "}]":
        self._depth -= 1
        if self._depth == 0:
          self._val_end = i + 1
      i += 1
      self._scanned += 1
    emit_to = ((self._val_end if self._val_end is not None
                else self._args_start + self._scanned)
               - self._args_start)
    if emit_to > self._sent:
      events.append(("args",
                     text[self._args_start + self._sent:
                          self._args_start + emit_to]))
      self._sent = emit_to
    return events

  def finish(self, text: str) -> tuple[list[tuple[str, str]], bool]:
    """Final events for the complete text, and tool-call completeness."""
    if self._mode == "content":
      return self.feed(text), False
    if self._mode == "undecided":
      call = parse_tool_call(text, self._names)
      if call is not None:
        return ([("header", call["name"]),
                 ("args", call["arguments"])], True)
      # Not an envelope — or (forced mode) truncated before the
      # arguments began: surface the buffered text as content, matching
      # the non-streaming path's budget-truncation behavior.
      return ([("content", text)] if text else [], False)
    # tool mode (forced only): emit the exact remainder of the raw
    # arguments value. Complete only if the whole envelope closed —
    # raw_decode succeeding on the arguments but the outer "}" missing
    # is still a budget truncation (the non-streaming path refuses such
    # text too, via whole-completion json.loads).
    try:
      _, end = json.JSONDecoder().raw_decode(text, self._args_start)
    except ValueError:
      return [], False  # budget-truncated mid-arguments
    raw_args = text[self._args_start:end]
    events = []
    if len(raw_args) > self._sent:
      events.append(("args", raw_args[self._sent:]))
    return events, text[end:].strip() == "}"

  def flush_content(self) -> list[tuple[str, str]]:
    """Buffered-but-unclassified text, for streams that die mid-flight.

    Cancellation / driver errors end a stream without ``finish``; in
    auto mode the gate may hold an envelope-plausible buffer the client
    has never seen — surface it as content (the tool-free path streamed
    it live). Forced tool mode has nothing sensible to flush: emitted
    fragments already cover the scanned arguments.
    """
    if self._mode == "undecided" and self._last_text:
      self._mode = "content"
      self._sent = len(self._last_text)
      return [("content", self._last_text)]
    return []


class StopStringGate:
  """Incremental multi-token stop-sequence matcher for generated text.

  OpenAI semantics for ``stop``: generation halts at the first occurrence
  of any stop sequence, and the matched text is NOT returned. Stops that
  tokenize to a single id end generation on-device (``stop_token_ids``);
  every stop — single-token or not — is ALSO matched host-side here, so
  multi-token sequences work and the matched text never reaches the
  client.

  Streaming drives :meth:`feed` with the CUMULATIVE decoded text; it
  returns the newly safe-to-emit increment, holding back any suffix that
  could still grow into a stop match (so clients never see text that a
  later delta retroactively truncates). :meth:`finish` resolves the
  held-back tail when the stream ends without a live match.
  """

  def __init__(self, stops: list[str]):
    self._stops = [s for s in stops if s]
    self._sent = 0  # chars already emitted

  def _earliest(self, text: str) -> int:
    cut = -1
    for s in self._stops:
      i = text.find(s)
      if i != -1 and (cut == -1 or i < cut):
        cut = i
    return cut

  def truncate(self, text: str) -> tuple[str, bool]:
    """One-shot (non-streaming): text before the first stop match."""
    cut = self._earliest(text)
    return (text, False) if cut == -1 else (text[:cut], True)

  def feed(self, text: str) -> tuple[str, bool]:
    cut = self._earliest(text)
    if cut != -1:
      out = text[self._sent:cut]
      self._sent = cut
      return out, True
    hold = 0
    for s in self._stops:
      # Longest suffix of the text that is a proper prefix of this stop:
      # emitting it now could require retroactive truncation later.
      for k in range(min(len(s) - 1, len(text)), 0, -1):
        if text.endswith(s[:k]):
          hold = max(hold, k)
          break
    safe = len(text) - hold
    if safe <= self._sent:
      return "", False
    out = text[self._sent:safe]
    self._sent = safe
    return out, False

  def finish(self, text: str) -> tuple[str, bool]:
    """Final text: flushes held-back tail (truncated at a match, if any)."""
    cut = self._earliest(text)
    if cut != -1:
      out = text[self._sent:cut]
      self._sent = cut
      return out, True
    out = text[self._sent:]
    self._sent = len(text)
    return out, False


def _openai_error(message: str, kind: str = "invalid_request_error") -> dict:
  """OpenAI error envelope: {"error": {"message", "type"}}."""
  return {"error": {"message": message, "type": kind}}


class SessionBusy(RuntimeError):
  """A chat session already has a turn in flight (HTTP maps this to 409)."""


class QueueFull(RuntimeError):
  """The submission queue is at max_queue (HTTP maps this to 429)."""


class FrontendDead(RuntimeError):
  """The driver thread died on a device error (HTTP maps this to 503)."""


class Submission:
  """One queued generation; handlers wait on :attr:`events`.

  ``events`` receives ``("tokens", [ids])`` deltas (streaming), then
  exactly one terminal event: ``("done", (tokens, text))``,
  ``("cancelled", None)``, or ``("error", message)``.
  """

  def __init__(self, prompt: str, max_steps: int, seed: int | None,
               image_path: str | None, image_b64: str | None,
               session: str | None = None, adapter: Any | None = None,
               session_epoch: int = 0, constraint: int | None = None,
               sampling: dict | None = None):
    self.prompt = prompt
    self.max_steps = max_steps
    self.seed = seed
    self.image_path = image_path
    self.image_b64 = image_b64
    self.session = session
    self.adapter = adapter               # opaque ref; adapter_resolver maps it
    self.session_epoch = session_epoch   # reset_session() generation at submit
    self.constraint = constraint         # grammar index or compiled TokenDFA
    self.sampling = sampling or {}       # per-request sampling overrides
    self.logprobs: dict | None = None    # filled at finish (record_logprobs)
    self.events: queue.Queue = queue.Queue()
    self.request_id: int | None = None   # set once admitted
    self.cancelled = False               # host-side flag, driver honors
    # Latency bookkeeping (time.monotonic, driver-side except submit).
    self.t_submit = time.monotonic()
    self.t_first_token: float | None = None
    self.t_done: float | None = None

  @property
  def metrics(self) -> dict[str, float]:
    """Per-request latency: time-to-first-token and wall time (seconds,
    from submit — queueing included, which is what a client experiences)."""
    out = {}
    if self.t_first_token is not None:
      out["ttft_s"] = self.t_first_token - self.t_submit
    if self.t_done is not None:
      out["wall_s"] = self.t_done - self.t_submit
    return out

  def result(self, timeout: float | None = None) -> tuple[list[int], str]:
    """Blocks until the terminal event; drains token deltas."""
    while True:
      kind, payload = self.events.get(timeout=timeout)
      if kind == "tokens":
        continue
      if kind == "done":
        return payload
      if kind == "cancelled":
        raise RuntimeError("request cancelled")
      raise RuntimeError(f"generation failed: {payload}")


class ServingFrontend:
  """Single-driver-thread loop around a :class:`ContinuousBatcher`.

  Args:
    batcher: The batcher to drive. Built WITHOUT a ``stream_callback`` --
      the frontend installs its own to route per-request token deltas.
    step_size: Decode steps per tick. Smaller = lower streaming latency,
      larger = fewer host round trips per token.
    idle_wait_s: How long the driver sleeps waiting for work when no
      request is live (new submissions wake it immediately).
    step_size_idle: Optional larger tick size used whenever the submission
      queue is empty at tick start (a new arrival waits at most one such
      tick before its admission). ``None`` always uses ``step_size``.
    default_prefix_state: Optional shared context (e.g. a system prompt
      from ``Sampler.prefill_prefix``) applied to every request that has no
      session history and no image; a session's first turn starts from it,
      later turns from their own stored state.
    adapter_resolver: Optional ``f(adapter_ref) -> adapter leaves`` mapping
      the opaque ``adapter=`` field of a submission (the HTTP body's
      ``"adapter"``) to a LoRA tree for a ``multi_lora`` batcher (e.g. a
      name of preloaded adapters). A reference it cannot resolve fails the
      submission (HTTP 400).
    max_sessions: Stored session contexts are cache copies on the device,
      so they are LRU-capped: storing the ``max_sessions + 1``-th context
      evicts the least recently used one, whose session restarts from
      scratch (or the default prefix) on its next turn.
    max_queue: Admission backpressure: ``submit`` raises :class:`QueueFull`
      (HTTP 429) once this many submissions wait for a slot. ``None`` =
      unbounded (library use).
    constraint_names: Maps public grammar names to the batcher's registered
      constraint indices (``ContinuousBatcher(constraints=[...])``), e.g.
      ``{"json_object": 0}``. ``submit(..., constraint="json_object")``
      then masks that request with it; the OpenAI routes map
      ``response_format: {"type": "json_object"}`` to that name.
    device: Where the driver thread runs torch: the batcher's device.
      ``None`` means CUDA and raises without a card; pass ``device="cpu"``
      for a CPU batcher.
  """

  def __init__(self, batcher: serving_lib.ContinuousBatcher,
               step_size: int = 8, idle_wait_s: float = 0.05,
               step_size_idle: int | None = None,
               default_prefix_state: Any | None = None,
               adapter_resolver: Any | None = None,
               max_sessions: int = 64,
               max_queue: int | None = None,
               constraint_names: dict[str, int] | None = None,
               device=None):
    self.device = serving_lib._check_device(
        griffin.resolve_device(device), batcher.device, "frontend",
        "batcher")
    if batcher.stream_callback is not None:
      raise ValueError(
          "Build the batcher without stream_callback; the frontend "
          "installs its own to route tokens to submissions."
      )
    batcher.stream_callback = self._on_tokens
    self.batcher = batcher
    self.step_size = step_size
    self.step_size_idle = step_size_idle
    self.idle_wait_s = idle_wait_s
    self.default_prefix_state = default_prefix_state
    self.adapter_resolver = adapter_resolver
    self.max_sessions = max_sessions
    self.max_queue = max_queue
    self.constraint_names = dict(constraint_names or {})
    if self.constraint_names and batcher._constraints is None:
      raise ValueError(
          "constraint_names given but the batcher registered no grammars "
          "(build it with ContinuousBatcher(constraints=[...]))."
      )
    # Per-request JSON-schema grammars (response_format json_schema):
    # compiled on the handler thread (host numpy and C++, never in the
    # driver's ticks), LRU-cached by canonical schema JSON, installed into
    # the batcher's dynamic slots at admission.
    self._schema_cache: collections.OrderedDict[str, Any] = (
        collections.OrderedDict()
    )
    self._schema_cache_size = 32
    self._schema_lock = threading.Lock()
    self._token_strings: list[str] | None = None
    self._inbox: queue.Queue[Submission] = queue.Queue()
    # Accepted-but-unfinished submissions; close(drain=True) waits on this
    # (the inbox and _by_id are briefly both empty while an admission is in
    # flight).
    self._open = 0
    self._open_lock = threading.Lock()
    self._by_id: dict[int, Submission] = {}
    # session -> PrefixState, insertion-ordered for LRU eviction.
    self._sessions: collections.OrderedDict[str, Any] = (
        collections.OrderedDict()
    )
    self._busy_sessions: set[str] = set()
    self._session_epoch: dict[str, int] = {}  # bumped by reset_session
    self._session_lock = threading.Lock()
    self._error: str | None = None       # set if the driver thread died
    # Aggregate serving metrics (driver-thread writes, stats reads).
    self._completed = 0
    self._cancelled = 0
    self._errors = 0
    self._tokens_out = 0
    self._recent: collections.deque = collections.deque(maxlen=512)
    self._stop = threading.Event()
    self._wake = threading.Event()
    self._driver = threading.Thread(target=self._run, daemon=True)
    self._driver.start()

  # -- handler-thread API ------------------------------------------------------

  def submit(self, prompt: str, max_tokens: int | None = None,
             seed: int | None = None, image_path: str | None = None,
             image_b64: str | None = None,
             session: str | None = None,
             adapter: Any | None = None,
             constraint: str | dict | None = None,
             temperature: float | None = None,
             top_k: int | None = None,
             top_p: float | None = None,
             min_tokens: int | None = None,
             stop_token_ids: Any | None = None,
             repetition_penalty: float | None = None,
             logit_bias: dict | None = None) -> Submission:
    """Queues one generation. ``session`` names a conversation: its turns
    chain through the batcher's per-request PrefixState (requires
    ``preserve_states=True`` on the batcher), so each turn prefills only the
    new message. One in-flight turn per session (raises ``SessionBusy``
    otherwise); turns of different sessions and plain requests batch
    together freely. ``temperature`` / ``top_k`` / ``top_p`` /
    ``min_tokens`` / ``stop_token_ids`` / ``repetition_penalty`` /
    ``logit_bias`` (token id -> additive offset in [-100, 100]) override the
    sampler per request (a ``per_request_sampling`` batcher). ``seed``
    seeds the request's ``torch.Generator`` on a categorical batcher (one is
    drawn from ``secrets`` when absent). ``adapter`` is resolved by the
    frontend's ``adapter_resolver`` into the request's LoRA tree (a
    ``multi_lora`` batcher); without a resolver it raises ``ValueError``.
    ``constraint`` names a grammar of ``constraint_names``, or is a
    JSON-Schema dict (the strict subset), compiled here on the handler
    thread and installed into a dynamic grammar slot at admission."""
    if self._error is not None:
      raise FrontendDead(f"serving driver died: {self._error}")
    constraint_index = None
    if isinstance(constraint, dict):
      # A JSON schema: compile (cached) to a grammar for a dynamic slot.
      constraint_index = self._compile_schema(constraint)
    elif constraint is not None:
      try:
        constraint_index = self.constraint_names[constraint]
      except KeyError:
        raise ValueError(
            f"unknown constraint {constraint!r}; this server offers "
            f"{sorted(self.constraint_names) or 'none'}"
        ) from None
    if self.max_queue is not None and self._inbox.qsize() >= self.max_queue:
      raise QueueFull(
          f"submission queue is full ({self.max_queue} waiting); retry "
          "later"
      )
    if adapter is not None and self.adapter_resolver is None:
      raise ValueError(
          "adapter= needs ServingFrontend(adapter_resolver=...) to map "
          "it to a LoRA tree."
      )
    epoch = 0
    if session is not None:
      if not self.batcher.preserve_states:
        raise ValueError(
            "Chat sessions need ContinuousBatcher(preserve_states=True)."
        )
      with self._session_lock:
        if session in self._busy_sessions:
          raise SessionBusy(f"session {session!r} has a turn in flight")
        self._busy_sessions.add(session)
        epoch = self._session_epoch.get(session, 0)
    sampling = {
        k: v for k, v in (
            ("temperature", temperature), ("top_k", top_k),
            ("top_p", top_p), ("min_tokens", min_tokens),
            ("stop_token_ids", stop_token_ids),
            ("repetition_penalty", repetition_penalty),
            ("logit_bias", logit_bias),
        ) if v is not None
    }
    sub = Submission(
        prompt,
        self.batcher.max_steps_default if max_tokens is None
        else max_tokens,
        seed, image_path, image_b64, session=session, adapter=adapter,
        session_epoch=epoch, constraint=constraint_index,
        sampling=sampling,
    )
    with self._open_lock:
      self._open += 1
    self._inbox.put(sub)
    self._wake.set()
    return sub

  def _compile_schema(self, schema: dict):
    """JSON schema -> ``TokenDFA`` (the strict subset), LRU-cached.

    Raises ValueError for a schema outside the strict subset, or when the
    batcher has no dynamic grammar slots. Host work only, so it is safe on
    handler threads.
    """
    if not self.batcher.dynamic_grammar_slots:
      raise ValueError(
          "per-request JSON schemas need ContinuousBatcher("
          "dynamic_grammar_slots=k); this server has none"
      )
    key = json.dumps(schema, sort_keys=True)
    sampler = self.batcher.sampler
    with self._schema_lock:
      dfa = self._schema_cache.get(key)
      if dfa is not None:
        self._schema_cache.move_to_end(key)
        return dfa
      if self._token_strings is None:
        self._token_strings = constrain.token_strings_from_vocab(
            sampler.vocab, sampler.vocab_size
        )
    eos = int(sampler.vocab.eos_id())
    dfa = constrain.TokenDFA(
        constrain.schema_regex(schema),
        self._token_strings,
        eos_id=eos,
        extra_stop_ids=[i for i in sampler._stop_ids_host if i != eos],
    )
    with self._schema_lock:
      self._schema_cache[key] = dfa
      while len(self._schema_cache) > self._schema_cache_size:
        self._schema_cache.popitem(last=False)
    return dfa

  def reset_session(self, session: str) -> bool:
    """Drops a session's stored context; its next turn starts fresh.

    A turn in flight when the reset lands is epoch-fenced: its extracted
    state is discarded instead of re-installing the context the caller was
    just told was dropped."""
    with self._session_lock:
      self._session_epoch[session] = self._session_epoch.get(session, 0) + 1
      return self._sessions.pop(session, None) is not None

  def cancel(self, request_id: int) -> bool:
    """Marks a request cancelled; the driver frees its slot next tick."""
    sub = self._by_id.get(request_id)
    if sub is None or sub.cancelled:
      return False
    sub.cancelled = True
    self._wake.set()
    return True

  @property
  def stats(self) -> dict[str, Any]:
    """Liveness + aggregate serving metrics (served on /v1/health).

    Latency percentiles cover the last 512 completions and are measured
    from submit -- queueing included, the latency a client experiences."""
    out: dict[str, Any] = {
        "ok": self._error is None,
        "slots": self.batcher.num_slots,
        "active": self.batcher.active_count,
        "queued": self._inbox.qsize(),
        "completed": self._completed,
        "cancelled": self._cancelled,
        "errors": self._errors,
        "tokens_out": self._tokens_out,
        "sessions": len(self._sessions),
    }
    recent = list(self._recent)
    if recent:
      ttfts = sorted(t for t, _, _ in recent)
      walls = sorted(w for _, w, _ in recent)
      q = lambda xs, p: xs[min(len(xs) - 1, int(p * len(xs)))]  # noqa: E731
      out["ttft_s_p50"] = round(statistics.median(ttfts), 4)
      out["ttft_s_p90"] = round(q(ttfts, 0.9), 4)
      out["ttft_s_p99"] = round(q(ttfts, 0.99), 4)
      out["wall_s_p50"] = round(statistics.median(walls), 4)
      out["wall_s_p90"] = round(q(walls, 0.9), 4)
      out["wall_s_p99"] = round(q(walls, 0.99), 4)
    if self._error is not None:
      out["error"] = self._error
    return out

  def prometheus_metrics(self) -> str:
    """Serving metrics in Prometheus text exposition format."""
    stats = self.stats
    lines = [
        "# HELP cadence_up 1 while the serving driver thread is alive.",
        "# TYPE cadence_up gauge",
        f"cadence_up {int(stats['ok'])}",
    ]
    gauges = ("slots", "active", "queued", "sessions")
    counters = ("completed", "cancelled", "errors", "tokens_out")
    for name in gauges + counters:
      kind = "gauge" if name in gauges else "counter"
      metric = f"cadence_{name}" + ("_total" if kind == "counter" else "")
      lines += [f"# TYPE {metric} {kind}", f"{metric} {stats[name]}"]
    for stem in ("ttft_s", "wall_s"):
      if f"{stem}_p50" in stats:
        metric = f"cadence_{stem.replace('_s', '_seconds')}"
        lines.append(f"# TYPE {metric} summary")
        for q, key in (("0.5", f"{stem}_p50"), ("0.9", f"{stem}_p90"),
                       ("0.99", f"{stem}_p99")):
          lines.append(f'{metric}{{quantile="{q}"}} {stats[key]}')
    return "\n".join(lines) + "\n"

  def close(self, drain: bool = False, drain_timeout_s: float = 600) -> None:
    """Stops the driver thread.

    ``drain=True`` first waits (up to ``drain_timeout_s``) for every queued
    and in-flight request to finish; callers must have stopped submitting.
    Without it, in-flight requests receive a terminal ``cancelled`` event.
    """
    if drain:
      deadline = time.monotonic() + drain_timeout_s
      while (self._error is None and time.monotonic() < deadline
             and self._open > 0):
        time.sleep(0.02)
    self._stop.set()
    self._wake.set()
    self._driver.join(timeout=60)

  # -- driver thread -----------------------------------------------------------

  def _on_tokens(self, request_id: int, token_ids: list[int],
                 done: bool) -> None:
    # Runs on the driver thread (inside batcher.step / pop_finished /
    # cancel). The tail tokens that arrive with the finish flow as a delta
    # first, so streaming clients assembling from deltas see every token.
    sub = self._by_id.get(request_id)
    if sub is not None and token_ids:
      if sub.t_first_token is None:
        sub.t_first_token = time.monotonic()
      sub.events.put(("tokens", list(token_ids)))

  def _terminal(self, sub: Submission, kind: str, payload) -> None:
    """Delivers a submission's single terminal event and closes it out of
    the drain count. Every submission gets exactly one."""
    sub.events.put((kind, payload))
    with self._open_lock:
      self._open -= 1

  def _admit(self, sub: Submission) -> None:
    if sub.cancelled:
      self._release_session(sub)
      self._cancelled += 1
      self._terminal(sub, "cancelled", None)
      return
    kwargs: dict[str, Any] = {}
    try:
      has_image = sub.image_b64 is not None or sub.image_path is not None
      if sub.session is not None:
        with self._session_lock:
          state = self._sessions.get(sub.session)
          if state is not None:
            self._sessions.move_to_end(sub.session)  # LRU touch
        if state is not None:
          kwargs["prefix_state"] = state
        elif self.default_prefix_state is not None and not has_image:
          # A session's first turn starts from the shared context.
          kwargs["prefix_state"] = self.default_prefix_state
        kwargs["return_state"] = True
      elif self.default_prefix_state is not None and not has_image:
        kwargs["prefix_state"] = self.default_prefix_state
      if sub.adapter is not None:
        kwargs["adapters"] = self.adapter_resolver(sub.adapter)
      if sub.constraint is not None:
        kwargs["constraint"] = sub.constraint
      kwargs.update(sub.sampling)
      if sub.seed is None and not self.batcher.sampler.deterministic_sampling:
        # Categorical serving without a client seed: draw one here (and
        # record it: a request's tokens are a function of its seed).
        sub.seed = secrets.randbits(63)
      if sub.seed is not None:
        kwargs["generator"] = torch.Generator(self.device).manual_seed(
            sub.seed)
      if sub.image_b64 is not None:
        raw = base64.b64decode(sub.image_b64)
        with tempfile.NamedTemporaryFile(suffix=".jpg") as f:
          f.write(raw)
          f.flush()
          kwargs["img_embed"] = self.batcher.sampler.encode_image(f.name)
      elif sub.image_path is not None:
        kwargs["img_path"] = sub.image_path
      rid = self.batcher.add_request(
          sub.prompt, max_steps=sub.max_steps, **kwargs
      )
    except Exception as e:  # bad image, ragged batch rules, OOM, ...
      self._release_session(sub)
      self._errors += 1
      self._terminal(sub, "error", f"{type(e).__name__}: {e}")
      return
    sub.request_id = rid
    self._by_id[rid] = sub

  def _release_session(self, sub: Submission) -> None:
    if sub.session is not None:
      with self._session_lock:
        self._busy_sessions.discard(sub.session)

  def _store_session_state(self, sub: Submission, rid: int) -> None:
    """Stores the finished turn's context unless a reset fenced it out."""
    state = self.batcher.take_state(rid)
    with self._session_lock:
      if self._session_epoch.get(sub.session, 0) == sub.session_epoch:
        self._sessions[sub.session] = state
        self._sessions.move_to_end(sub.session)
        while len(self._sessions) > self.max_sessions:
          self._sessions.popitem(last=False)  # evict least-recently-used
      self._busy_sessions.discard(sub.session)

  def _run(self) -> None:
    try:
      if self.device.type == "cuda":
        # This thread makes every torch call, and captures the tick's graph.
        torch.cuda.set_device(self.device)
      while not self._stop.is_set():
        self._tick()
    except Exception as e:  # device OOM, failed capture, ...
      # A wedged driver must not strand handlers in events.get() forever
      # or let /v1/health keep reporting ok: record the failure, fail every
      # in-flight and queued submission, and refuse new ones.
      self._error = f"{type(e).__name__}: {e}"
    terminal = (
        ("cancelled", None) if self._error is None
        else ("error", f"serving driver died: {self._error}")
    )
    for sub in self._by_id.values():
      self._release_session(sub)
      self._terminal(sub, *terminal)
    self._by_id.clear()
    while True:
      try:
        sub = self._inbox.get_nowait()
      except queue.Empty:
        break
      self._release_session(sub)
      self._terminal(sub, *terminal)

  def _tick(self) -> None:
    # Admit while there is capacity (admission is device work, so it stays
    # on this thread).
    while self.batcher.has_capacity:
      try:
        self._admit(self._inbox.get_nowait())
      except queue.Empty:
        break
    # Honor cancellations before spending decode steps on them. A cancelled
    # session turn keeps the previous turn's context.
    for rid, sub in list(self._by_id.items()):
      if sub.cancelled:
        self.batcher.cancel(rid)
        del self._by_id[rid]
        self._release_session(sub)
        self._cancelled += 1
        self._terminal(sub, "cancelled", None)
    if not self.batcher.active_count:
      self._wake.wait(timeout=self.idle_wait_s)
      self._wake.clear()
      return
    n = self.step_size
    if self.step_size_idle is not None and self._inbox.empty():
      n = self.step_size_idle
    self.batcher.step(n)
    for rid, tokens, text in self.batcher.pop_finished():
      sub = self._by_id.pop(rid, None)
      if sub is not None:
        if self.batcher.record_logprobs:
          sub.logprobs = self.batcher.take_logprobs(rid)
        if sub.session is not None:
          self._store_session_state(sub, rid)
        sub.t_done = time.monotonic()
        if sub.t_first_token is None:
          sub.t_first_token = sub.t_done
        self._completed += 1
        self._tokens_out += len(tokens)
        self._recent.append(
            (sub.t_first_token - sub.t_submit,
             sub.t_done - sub.t_submit, len(tokens))
        )
        self._terminal(sub, "done", (tokens, text))


def _format_logprobs(record: dict, tokens: list, vocab, chat: bool,
                     top_k: int) -> dict:
  """Shapes a batcher logprob record as the OpenAI response form.

  Chat: ``{"content": [{token, logprob, top_logprobs: [...]}, ...]}``;
  legacy completions: ``{"tokens", "token_logprobs", "top_logprobs",
  "text_offset"}``. ``top_k`` bounds the alternatives per position
  (0 = chosen-token logprobs only).
  """
  piece_of = lambda tid: vocab.DecodeIds([int(tid)])  # noqa: E731
  chosen = record["token_logprobs"]
  tops = [
      [
          (piece_of(tid), lp)
          for tid, lp in zip(ids[:top_k], lps[:top_k])
      ]
      for ids, lps in zip(record["top_ids"], record["top_logprobs"])
  ]
  if chat:
    return {
        "content": [
            {
                "token": piece_of(tok),
                "logprob": lp,
                "top_logprobs": [
                    {"token": t, "logprob": v} for t, v in alts
                ],
            }
            for tok, lp, alts in zip(tokens, chosen, tops)
        ]
    }
  pieces = [piece_of(t) for t in tokens]
  offsets, pos = [], 0
  for piece in pieces:
    offsets.append(pos)
    pos += len(piece)
  return {
      "tokens": pieces,
      "token_logprobs": chosen,
      "top_logprobs": [dict(alts) for alts in tops],
      "text_offset": offsets,
  }


def _make_handler(frontend: ServingFrontend, model_name: str):
  vocab = frontend.batcher.sampler.vocab
  is_it_model = getattr(frontend.batcher.sampler, "_is_it_model", False)

  def prompt_token_count(prompt: str, has_image: bool) -> int:
    text = common.apply_it_formatter(prompt) if is_it_model else prompt
    n = 1 + len(vocab.EncodeAsIds(text))  # +1: BOS
    if has_image:
      n += frontend.batcher.sampler.model.config.vision_tokens or 0
    return n

  class Handler(http_server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):  # quiet by default
      pass

    def _json(self, code: int, obj: dict) -> None:
      body = json.dumps(obj).encode()
      self.send_response(code)
      self.send_header("Content-Type", "application/json")
      self.send_header("Content-Length", str(len(body)))
      self.end_headers()
      self.wfile.write(body)

    def do_GET(self):
      if self.path == "/v1/models":
        return self._json(200, {
            "object": "list",
            "data": [{"id": model_name, "object": "model",
                      "owned_by": "cadence-gemma-tpu"}],
        })
      if self.path == "/metrics":
        body = frontend.prometheus_metrics().encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        return
      if self.path != "/v1/health":
        return self._json(404, {"error": f"no route {self.path}"})
      stats = frontend.stats
      self._json(200 if stats["ok"] else 503, stats)

    # -- OpenAI-compatible routes ---------------------------------------------

    def _openai_reject_unsupported(self, req: dict) -> bool:
      """400s result shapes we cannot produce; returns True if rejected.

      Sampling knobs are honored per request on ``per_request_sampling``
      batchers; on other batchers they are deliberately IGNORED rather
      than rejected — clients send them unconditionally; configure them
      on the sampler there.
      """
      n = req.get("n")
      if n is not None and (not isinstance(n, int) or not 1 <= n <= 16):
        self._json(400, _openai_error("n must be an int in [1, 16]"))
        return True
      if req.get("echo"):
        self._json(400, _openai_error("echo is not supported"))
        return True
      if req.get("stream_options") and not req.get("stream"):
        self._json(400, _openai_error(
            "stream_options requires stream: true"
        ))
        return True
      want_lp = req.get("logprobs") or req.get("top_logprobs")
      if want_lp:
        recorded = getattr(frontend.batcher, "record_logprobs", 0)
        if not recorded:
          self._json(400, _openai_error(
              "logprobs need ContinuousBatcher(record_logprobs=k) on "
              "this server"
          ))
          return True
        k = want_lp if isinstance(want_lp, int) else 0
        if k > recorded:
          self._json(400, _openai_error(
              f"this server records top-{recorded} logprobs "
              f"(requested {k})"
          ))
          return True
      return False

    def _openai_constraint(self, req: dict):
      """Maps ``response_format`` to a constraint.

      Returns (constraint, rejected): the named grammar ``"json_object"``
      for ``json_object`` (registered with ``constrain.json_mode_dfa`` and
      ``constraint_names``), or the schema dict for ``json_schema`` (a
      batcher with ``dynamic_grammar_slots``; the strict structured-outputs
      subset).
      """
      rf = req.get("response_format")
      kind = rf.get("type") if isinstance(rf, dict) else rf
      if kind in (None, "text"):
        return None, False
      if kind == "json_object":
        if "json_object" not in frontend.constraint_names:
          self._json(400, _openai_error(
              "this server has no JSON grammar registered; build the "
              "batcher with constrain.json_mode_dfa and pass "
              "constraint_names={'json_object': index}"
          ))
          return None, True
        return "json_object", False
      if kind == "json_schema":
        spec = rf.get("json_schema")
        schema = spec.get("schema") if isinstance(spec, dict) else None
        if not isinstance(schema, dict):
          self._json(400, _openai_error(
              "response_format json_schema needs "
              "{'json_schema': {'schema': {...}}}"
          ))
          return None, True
        return schema, False
      self._json(400, _openai_error(
          f"response_format type {kind!r} is not supported "
          "(use 'text', 'json_object', or 'json_schema')"
      ))
      return None, True

    def _openai_generate(self, req: dict, prompt: str,
                         image_b64: str | None, chat: bool,
                         tool_names: set[str] | None = None,
                         tool_constraint: dict | None = None) -> None:
      """Shared tail of /v1/completions and /v1/chat/completions."""
      max_tokens = req.get("max_tokens")
      if max_tokens is None:
        max_tokens = req.get("max_completion_tokens")
      # OpenAI "stop": sequence(s) that halt generation and are not
      # returned. Single-token stops also end generation on-device (below,
      # per_request_sampling batchers); EVERY stop is matched host-side by
      # a StopStringGate, so multi-token sequences work on any batcher and
      # the matched text never reaches the client. Tool requests skip the
      # host-side match (a stop inside a constrained envelope would break
      # the guaranteed-parseable contract).
      stop_req = req.get("stop")
      stop_strings = (
          [stop_req] if isinstance(stop_req, str)
          else [str(s) for s in stop_req] if stop_req else []
      )
      constraint, rejected = self._openai_constraint(req)
      if rejected:
        return
      if tool_constraint is not None:
        if constraint is not None:
          return self._json(400, _openai_error(
              "response_format cannot combine with a forced tool_choice"
          ))
        constraint = tool_constraint
      sampling: dict[str, Any] = {}
      if getattr(frontend.batcher, "per_request_sampling", False):
        # Honor the standard knobs (a per_request_sampling batcher
        # evaluates them per slot); otherwise they stay ignored, as
        # documented.
        if req.get("temperature") is not None:
          if float(req["temperature"]) == 0.0:
            # OpenAI temperature 0 = deterministic; top_k=1 makes the
            # categorical draw an argmax without a greedy sampler.
            sampling["top_k"] = 1
          else:
            sampling["temperature"] = float(req["temperature"])
        if req.get("top_p") is not None:
          sampling["top_p"] = float(req["top_p"])
        if req.get("top_k") is not None:  # common extension
          sampling["top_k"] = int(req["top_k"])
        if req.get("min_tokens") is not None:  # vLLM-style extension
          sampling["min_tokens"] = int(req["min_tokens"])
        if req.get("repetition_penalty") is not None:  # HF extension
          sampling["repetition_penalty"] = float(req["repetition_penalty"])
        if req.get("logit_bias"):
          # OpenAI wire shape: {"<token id>": bias}; JSON object keys
          # are strings. Validation (range, vocab bounds, entry cap)
          # happens in the batcher and surfaces as 400.
          try:
            sampling["logit_bias"] = {
                int(t): float(b) for t, b in req["logit_bias"].items()
            }
          except (TypeError, ValueError, AttributeError):
            return self._json(400, _openai_error(
                "logit_bias must map token ids to numbers"
            ))
        ids = []
        for text in stop_strings:
          enc = vocab.EncodeAsIds(text)
          if len(enc) == 1:
            ids.append(enc[0])  # ends on-device; host match trims the text
        if ids:
          sampling["stop_token_ids"] = ids
      n = int(req.get("n") or 1)
      base_seed = req.get("seed")
      try:
        subs = []
        for i in range(n):
          # Distinct deterministic seeds per sample when one was given
          # (seedless categorical requests auto-seed independently).
          seed_i = base_seed + i if base_seed is not None else None
          subs.append(frontend.submit(
              prompt, max_tokens=max_tokens, seed=seed_i,
              image_b64=image_b64, constraint=constraint, **sampling,
          ))
      except QueueFull as e:
        return self._json(429, _openai_error(str(e), "overloaded_error"))
      except FrontendDead as e:
        return self._json(503, _openai_error(str(e)))
      except ValueError as e:
        return self._json(400, _openai_error(str(e)))
      sub = subs[0]
      created = int(time.time())
      oid = f"{'chatcmpl' if chat else 'cmpl'}-{id(sub):x}-{created}"
      obj = "chat.completion" if chat else "text_completion"

      def finish_reason(tokens: list[int]) -> str:
        return "length" if len(tokens) >= sub.max_steps else "stop"

      if not req.get("stream"):
        choices = []
        total_completion = 0
        for i, sub_i in enumerate(subs):
          try:
            tokens, text = sub_i.result()
          except RuntimeError as e:
            return self._json(400, _openai_error(str(e)))
          total_completion += len(tokens)
          fr = finish_reason(tokens)
          if stop_strings and not tool_names:
            text, matched = StopStringGate(stop_strings).truncate(text)
            if matched:
              fr = "stop"
          choice: dict[str, Any] = {
              "index": i, "logprobs": None,
              "finish_reason": fr,
          }
          if sub_i.logprobs is not None and (
              req.get("logprobs") or req.get("top_logprobs")
          ):
            choice["logprobs"] = _format_logprobs(
                sub_i.logprobs, tokens, vocab, chat,
                req.get("top_logprobs") or (
                    req["logprobs"]
                    if isinstance(req.get("logprobs"), int)
                    and not isinstance(req.get("logprobs"), bool)
                    else 0
                ),
            )
          if chat:
            call = (parse_tool_call(text, tool_names)
                    if tool_names else None)
            if call is not None:
              choice["message"] = {
                  "role": "assistant", "content": None,
                  "tool_calls": [{
                      "id": f"call_{id(sub_i):x}{i}",
                      "type": "function",
                      "function": call,
                  }],
              }
              choice["finish_reason"] = "tool_calls"
            else:
              choice["message"] = {"role": "assistant", "content": text}
          else:
            choice["text"] = text
          choices.append(choice)
        n_prompt = prompt_token_count(prompt, image_b64 is not None)
        return self._json(200, {
            "id": oid, "object": obj, "created": created,
            "model": model_name, "choices": choices,
            "usage": {
                "prompt_tokens": n_prompt,
                "completion_tokens": total_completion,
                "total_tokens": n_prompt + total_completion,
            },
        })
      # Streaming: SSE data: chunks, then data: [DONE]. With n > 1 the
      # choices stream sequentially (drain choice 0's queue, then 1's,
      # ...): every chunk carries its choice index, so accumulating
      # clients reassemble identically, and the driver advances all n
      # requests concurrently regardless of the drain order. Requested
      # logprobs arrive in one final chunk per choice (they are fetched
      # from device at finish; per-delta fetches would stall the batch).
      self.send_response(200)
      self.send_header("Content-Type", "text/event-stream")
      self.send_header("Cache-Control", "no-cache")
      self.send_header("Transfer-Encoding", "chunked")
      self.end_headers()

      def sse(payload: str) -> None:
        frame = f"data: {payload}\n\n".encode()
        self.wfile.write(f"{len(frame):x}\r\n".encode() + frame + b"\r\n")

      want_lp = req.get("logprobs") or req.get("top_logprobs")
      top_k_lp = req.get("top_logprobs") or (
          req["logprobs"]
          if isinstance(req.get("logprobs"), int)
          and not isinstance(req.get("logprobs"), bool) else 0
      )

      def stream_choice(idx: int, sub_i) -> int:
        """Streams one choice's chunks; returns its completion tokens."""
        def sse_choice(choice: dict) -> None:
          choice["index"] = idx
          sse(json.dumps({
              "id": oid, "object": obj + ".chunk", "created": created,
              "model": model_name, "choices": [choice],
          }))

        first = True

        def sse_chunk(delta_text: str | None, reason: str | None,
                      logprobs: dict | None = None) -> None:
          nonlocal first
          if chat:
            delta: dict[str, Any] = {}
            if first:
              delta["role"] = "assistant"
            if delta_text:
              delta["content"] = delta_text
            choice = {"delta": delta, "finish_reason": reason}
          else:
            choice = {"text": delta_text or "", "finish_reason": reason}
          if logprobs is not None:
            choice["logprobs"] = logprobs
          sse_choice(choice)
          first = False

        def sse_tool(kind: str, payload: str) -> None:
          nonlocal first
          delta: dict[str, Any] = {"role": "assistant"} if first else {}
          if kind == "header":
            delta["tool_calls"] = [{
                "index": 0, "id": f"{call_id}{idx}", "type": "function",
                "function": {"name": payload, "arguments": ""},
            }]
          else:
            delta["tool_calls"] = [{
                "index": 0, "function": {"arguments": payload},
            }]
          sse_choice({"delta": delta, "finish_reason": None})
          first = False

        def emit_events(events) -> None:
          for kind_e, payload_e in events:
            if kind_e == "content":
              sse_chunk(payload_e, None)
            else:
              sse_tool(kind_e, payload_e)

        def final_logprobs(tokens: list[int]) -> dict | None:
          if not (want_lp and sub_i.logprobs is not None):
            return None
          return _format_logprobs(
              sub_i.logprobs, tokens, vocab, chat, top_k_lp)

        # Tool requests route deltas through a ToolStreamGate: a forced
        # tool_choice streams the call as it comes (name header, then raw
        # argument fragments: the grammar guarantees the envelope); auto
        # mode streams content from the first envelope-implausible
        # character and classifies envelope-plausible text at finish.
        gate = (ToolStreamGate(tool_names, tool_constraint is not None)
                if chat and tool_names else None)
        sgate = (StopStringGate(stop_strings)
                 if stop_strings and gate is None else None)
        all_ids: list[int] = []
        emitted = ""
        while True:
          kind, payload = sub_i.events.get()
          if kind == "tokens":
            all_ids.extend(payload)
            text_now = vocab.DecodeIds(all_ids)
            if gate is not None:
              emit_events(gate.feed(text_now))
            elif sgate is not None:
              out, stopped = sgate.feed(text_now)
              if out:
                sse_chunk(out, None)
              if stopped:
                # The client-visible stream is complete: free the slot
                # (neighbors are untouched) and close this choice out.
                if sub_i.request_id is not None:
                  frontend.cancel(sub_i.request_id)
                else:
                  sub_i.cancelled = True
                sse_chunk(None, "stop")
                return len(all_ids)
            elif len(text_now) > len(emitted):
              sse_chunk(text_now[len(emitted):], None)
              emitted = text_now
            continue
          if kind == "done":
            tokens, text = payload
            if gate is not None:
              events, complete = gate.finish(text)
              emit_events(events)
              sse_chunk(None, "tool_calls" if complete
                        else finish_reason(tokens),
                        logprobs=final_logprobs(tokens))
            elif sgate is not None:
              out, matched = sgate.finish(text)
              sse_chunk(out or None,
                        "stop" if matched else finish_reason(tokens),
                        logprobs=final_logprobs(tokens))
            else:
              tail = (text[len(emitted):] if text.startswith(emitted)
                      else "")
              sse_chunk(tail or None, finish_reason(tokens),
                        logprobs=final_logprobs(tokens))
            return len(tokens)
          elif kind == "cancelled":
            if gate is not None:  # surface any envelope-plausible buffer
              emit_events(gate.flush_content())
            sse_chunk(None, "stop")
          else:  # error mid-stream: terminate the stream with a reason
            if gate is not None:
              emit_events(gate.flush_content())
            sse_chunk(None, "error")
          return 0

      call_id = f"call_{oid.rsplit('-', 2)[-2]}"
      total_completion = 0
      for idx, sub_i in enumerate(subs):
        total_completion += stream_choice(idx, sub_i)
      if (req.get("stream_options") or {}).get("include_usage"):
        # OpenAI stream_options: one final usage chunk with no choices.
        n_prompt = prompt_token_count(prompt, image_b64 is not None)
        sse(json.dumps({
            "id": oid, "object": obj + ".chunk", "created": created,
            "model": model_name, "choices": [],
            "usage": {
                "prompt_tokens": n_prompt,
                "completion_tokens": total_completion,
                "total_tokens": n_prompt + total_completion,
            },
        }))
      sse("[DONE]")
      self.wfile.write(b"0\r\n\r\n")

    def _openai_completions(self, req: dict) -> None:
      prompt = req.get("prompt")
      if isinstance(prompt, list):
        if len(prompt) != 1 or not isinstance(prompt[0], str):
          return self._json(
              400, _openai_error("prompt must be one string")
          )
        prompt = prompt[0]
      if not isinstance(prompt, str) or not prompt:
        return self._json(
            400, _openai_error("prompt (non-empty string) required")
        )
      if self._openai_reject_unsupported(req):
        return
      self._openai_generate(req, prompt, None, chat=False)

    def _openai_chat(self, req: dict) -> None:
      if self._openai_reject_unsupported(req):
        return
      tools = req.get("tools")
      tool_choice = req.get("tool_choice")
      tool_names: set[str] | None = None
      tool_constraint: dict | None = None
      if tools is not None and tool_choice != "none":
        try:
          envelope = constrain.tool_call_schema(tools)  # also validates
        except ValueError as e:
          return self._json(400, _openai_error(str(e)))
        if isinstance(tool_choice, dict):
          name = (tool_choice.get("function") or {}).get("name")
          try:
            tool_constraint = constrain.tool_call_schema(tools, name)
          except ValueError as e:
            return self._json(400, _openai_error(str(e)))
        elif tool_choice == "required":
          # A forced call constrains generation to the envelope grammar.
          tool_constraint = envelope
        elif tool_choice not in (None, "auto"):
          return self._json(400, _openai_error(
              f"tool_choice {tool_choice!r} is not supported (use "
              "'auto', 'none', 'required', or a named function)"
          ))
        tool_names = {
            t["function"]["name"] for t in tools
        }
      else:
        tools = None  # tool_choice "none": render and behave as tool-free
      try:
        prompt, image_b64 = render_chat_messages(
            req.get("messages"), is_it_model, tools=tools
        )
      except ValueError as e:
        return self._json(400, _openai_error(str(e)))
      if not prompt:
        return self._json(400, _openai_error("empty conversation"))
      self._openai_generate(req, prompt, image_b64, chat=True,
                            tool_names=tool_names,
                            tool_constraint=tool_constraint)

    def do_POST(self):
      try:
        length = int(self.headers.get("Content-Length", 0))
        req = json.loads(self.rfile.read(length) or b"{}")
      except (ValueError, json.JSONDecodeError) as e:
        return self._json(400, {"error": f"bad JSON: {e}"})
      if self.path == "/v1/completions":
        return self._openai_completions(req)
      if self.path == "/v1/chat/completions":
        return self._openai_chat(req)
      if self.path == "/v1/cancel":
        rid = req.get("id")
        if not isinstance(rid, int):
          return self._json(400, {"error": "id (int) required"})
        return self._json(200, {"cancelled": frontend.cancel(rid)})
      if self.path == "/v1/reset":
        session = req.get("session")
        if not isinstance(session, str):
          return self._json(400, {"error": "session (str) required"})
        return self._json(200, {"reset": frontend.reset_session(session)})
      if self.path != "/v1/generate":
        return self._json(404, {"error": f"no route {self.path}"})
      prompt = req.get("prompt")
      if not isinstance(prompt, str) or not prompt:
        return self._json(400, {"error": "prompt (non-empty str) required"})
      try:
        sub = frontend.submit(
            prompt,
            max_tokens=req.get("max_tokens"),
            seed=req.get("seed"),
            image_path=req.get("image_path"),
            image_b64=req.get("image_b64"),
            session=req.get("session"),
            adapter=req.get("adapter"),
            constraint=req.get("constraint"),
            temperature=req.get("temperature"),
            top_k=req.get("top_k"),
            top_p=req.get("top_p"),
            min_tokens=req.get("min_tokens"),
            stop_token_ids=req.get("stop_token_ids"),
            repetition_penalty=req.get("repetition_penalty"),
            logit_bias=(
                {int(t): float(b) for t, b in req["logit_bias"].items()}
                if req.get("logit_bias") else None
            ),
        )
      except SessionBusy as e:
        return self._json(409, {"error": str(e)})
      except QueueFull as e:
        return self._json(429, {"error": str(e)})
      except FrontendDead as e:
        return self._json(503, {"error": str(e)})
      except ValueError as e:
        return self._json(400, {"error": str(e)})
      if not req.get("stream"):
        try:
          tokens, text = sub.result()
        except RuntimeError as e:
          return self._json(400, {"error": str(e)})
        return self._json(
            200, {"id": sub.request_id, "tokens": tokens, "text": text}
        )
      # Streaming: chunked NDJSON, one line per event.
      self.send_response(200)
      self.send_header("Content-Type", "application/x-ndjson")
      self.send_header("Transfer-Encoding", "chunked")
      self.end_headers()

      def chunk(obj: dict) -> None:
        line = (json.dumps(obj) + "\n").encode()
        self.wfile.write(f"{len(line):x}\r\n".encode() + line + b"\r\n")

      while True:
        kind, payload = sub.events.get()
        if kind == "tokens":
          chunk({"id": sub.request_id, "tokens": payload})
          continue
        if kind == "done":
          tokens, text = payload
          chunk({"id": sub.request_id, "done": True, "tokens": [],
                 "text": text})
        elif kind == "cancelled":
          chunk({"id": sub.request_id, "done": True, "cancelled": True})
        else:
          chunk({"id": sub.request_id, "done": True, "error": payload})
        self.wfile.write(b"0\r\n\r\n")
        return

  return Handler


class ServingHTTPServer:
  """Threaded HTTP server over a :class:`ServingFrontend`.

  ``port=0`` binds an ephemeral port (read :attr:`port`). The server
  thread pool handles connections; all model work stays on the
  frontend's driver thread.
  """

  def __init__(self, frontend: ServingFrontend, host: str = "127.0.0.1",
               port: int = 0, model_name: str = "cadence-gemma-tpu"):
    self.frontend = frontend
    self._httpd = http_server.ThreadingHTTPServer(
        (host, port), _make_handler(frontend, model_name)
    )
    self._thread = threading.Thread(
        target=self._httpd.serve_forever, daemon=True
    )
    self._thread.start()

  @property
  def port(self) -> int:
    return self._httpd.server_address[1]

  def close(self, drain: bool = False) -> None:
    """Shuts down: stop accepting connections, then close the frontend
    (``drain=True`` = finish queued + in-flight requests first)."""
    self._httpd.shutdown()
    self._httpd.server_close()
    self._thread.join(timeout=30)
    self.frontend.close(drain=drain)
