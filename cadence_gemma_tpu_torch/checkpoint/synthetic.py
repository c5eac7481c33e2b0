"""Synthetic checkpoints with trained-like per-tensor statistics.

Counterpart of the JAX package's ``cadence_gemma_tpu/checkpoint/synthetic.py``.
The int8 accuracy figures must not rest on small uniform random weights:
they understate logit magnitudes and overstate relative error. Without a
trained checkpoint, the closest stand-in is the model's own initializers
(ring-initialized RG-LRU ``a_param``, fan-in-scaled projections, the
``2 / num_layers`` output projections) plus the two places training moves
weights far from their init:

  * RMSNorm ``scale`` leaves are zero at init (the ``scale + 1`` gain
    starts at identity); trained norms deviate per channel. Drawn
    N(0, 0.35).
  * The embedding table is also the tied LM head; an extra 0.3 N(0, 1) on
    top of its initializer puts the 2B's first-token logits in a trained
    model's range (|logits| ~ 5-30 under the 30.0 soft cap).

The draws come from an explicit ``torch.Generator``, so the bits differ
from JAX's; the statistics are the same.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


@torch.no_grad()
def realistic_params(
    model: torch.nn.Module,
    generator: torch.Generator,
    *,
    norm_scale_std: float = 0.35,
    embed_extra_std: float = 0.3,
) -> dict[str, torch.Tensor]:
  """Redraws ``model``'s weights toward trained-like statistics, in place.

  Args:
    model: A bfloat16 or float32 ``Griffin`` (any module with an
      ``init_weights(generator)``).
    generator: The ``torch.Generator``, on the model's device, for the
      initializers and the perturbations.
    norm_scale_std: Std of the N(0, std) draw for RMSNorm ``scale`` leaves.
    embed_extra_std: Extra std added to the embedding table.

  Returns:
    ``model.state_dict()`` (its tensors are the model's parameters), ready
    for :func:`cadence_gemma_tpu_torch.ops.quantization.quantize_params`.
  """
  model.init_weights(generator)
  for name, p in model.named_parameters():
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "scale":
      noise = torch.randn(p.shape, generator=generator, device=p.device)
      p.copy_(norm_scale_std * noise)
    elif leaf == "input_embedding":
      noise = torch.randn(p.shape, generator=generator, device=p.device)
      p.add_((embed_extra_std * noise).to(p.dtype))
  return model.state_dict()


def greedy_token_agreement(tokens_a: Any, tokens_b: Any) -> dict[str, Any]:
  """Agreement metrics between two greedy token streams.

  ``match_fraction`` is per-position equality over the whole buffer;
  ``prefix_match`` the fraction of the stream before the first divergence
  (after one divergent token the streams are different generations);
  ``first_divergence`` its index, -1 when none.
  """
  a = np.asarray(_host(tokens_a)).reshape(-1)
  b = np.asarray(_host(tokens_b)).reshape(-1)
  n = min(a.size, b.size)
  a, b = a[:n], b[:n]
  eq = a == b
  match_fraction = float(eq.mean()) if n else 1.0
  first_div = int(np.argmax(~eq)) if not eq.all() else n
  return {
      "match_fraction": round(match_fraction, 4),
      "prefix_match": round(first_div / n, 4) if n else 1.0,
      "first_divergence": first_div if first_div < n else -1,
      "length": n,
  }


def _host(tokens: Any) -> Any:
  if isinstance(tokens, torch.Tensor):
    return tokens.detach().cpu().numpy()
  return tokens
