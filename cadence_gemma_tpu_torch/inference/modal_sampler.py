"""Image + text sampler: the vision encoder in front of the Sampler's prefill.

Counterpart of the JAX package's ``ModalSampler``
(``cadence_gemma_tpu/inference/modal_sampler.py``). An image comes as a
file path, as raw pixels, or as fused features: a path is decoded on the
host, pixels are resized, normalized and encoded on the device, and the
features are cast to bfloat16 (whatever the model's dtype, as in JAX) before
the model's connector projects them and splices them in after BOS. From
pixels to the first sampled token nothing returns to the host.

``return_state`` and ``prefix_state`` follow the :class:`Sampler`: an
image-grounded first turn with ``return_state=True`` encodes and prefills
the image once, and follow-up turns continue text-only from its state.
``constraint=`` masks the generation with a grammar on the image path (path,
pixels or features) as on the text path, as the :class:`Sampler` does (JAX
``modal_sampler.py:116-132, 159-241``).

With ``mesh=`` the model is tensor-parallel (:class:`Sampler`'s placement)
and so are the towers: ``tensor_parallel.tensor_parallel_encoder`` places
them by ``partitioning.param_shardings_or_replicated`` over the same mesh
(JAX ``modal_sampler.py:67-85``), so ``encode``, ``encode_image``,
``pixels=`` and ``img_path=`` run sharded.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from cadence_gemma_tpu_torch.inference import sampler as sampler_lib
from cadence_gemma_tpu_torch.parallel import tensor_parallel

SamplerOutput = sampler_lib.SamplerOutput


class ModalSampler(sampler_lib.Sampler):
  """Sampler that also takes an image path, pixels or features.

  Args:
    model: A ``Griffin`` on ``device``.
    vocab: Tokenizer implementing the ``Vocabulary`` protocol.
    vision_encoder: A module mapping ``[b, 3, h, w]`` pixels in [0, 1] to
      ``[b, vision_tokens, vision_width]`` features, with a
      ``preprocess_path(img_path)`` helper (a ``DinoSigLIPEncoder``); needed
      only for ``img_path`` and ``pixels``. With ``mesh=`` a
      ``DinoSigLIPEncoder`` is placed over the mesh's ``model_axis`` as a
      ``tensor_parallel.TensorParallelEncoder``.
    device: Where sampling runs; ``None`` means CUDA and raises when there is
      none. Must be the model's and the encoder's device (with ``mesh=``,
      the first device of the model axis).
    **kwargs: The :class:`Sampler`'s options, ``mesh`` and ``model_axis``
      among them.
  """

  def __init__(self, model: torch.nn.Module, vocab: Any,
               vision_encoder: torch.nn.Module | None = None, device=None,
               **kwargs):
    super().__init__(model, vocab, device=device, **kwargs)
    if vision_encoder is not None and self.mesh is not None:
      vision_encoder = tensor_parallel.tensor_parallel_encoder(
          vision_encoder, self.mesh, self.model_axis)
    if vision_encoder is not None:
      param = next(vision_encoder.parameters())
      if param.device.type != self.device.type:
        raise ValueError(f"The vision encoder lives on {param.device}, the "
                         f"sampler on {self.device}.")
    self.vision_encoder = vision_encoder

  def _encoder(self) -> torch.nn.Module:
    if self.vision_encoder is None:
      raise ValueError(
          "ModalSampler needs a vision_encoder to take image paths or "
          "pixels; pass img_embed directly otherwise."
      )
    return self.vision_encoder

  @torch.inference_mode()
  def encode(self, pixels: torch.Tensor) -> torch.Tensor:
    """Raw [b, 3, h, w] pixels in [0, 1] -> bfloat16 fused features."""
    pixels = torch.as_tensor(pixels, device=self.device)
    return self._encoder()(pixels).to(torch.bfloat16)

  def encode_image(self, img_path: str) -> torch.Tensor:
    """Decodes, preprocesses and encodes an image file to fused features."""
    return self.encode(self._encoder().preprocess_path(img_path))

  def __call__(
      self,
      input_strings: Sequence[str],
      total_generation_steps: int,
      generator: torch.Generator | None = None,
      echo: bool = False,
      return_logits: bool = False,
      end_sampling_at_eos_token: bool = True,
      img_path: str = "",
      pixels: torch.Tensor | None = None,
      img_embed: torch.Tensor | None = None,
      prefix_state=None,
      return_state: bool = False,
      constraint=None,
  ) -> SamplerOutput:
    """Samples completions, optionally conditioned on one image per batch.

    At most one of ``img_path``, ``pixels`` and ``img_embed`` may be given;
    an empty ``img_path`` means text only. ``prefix_state`` continues a
    cached context and takes no image argument. The other arguments,
    ``constraint`` included, are the :class:`Sampler`'s.
    """
    given = [img_path != "", pixels is not None, img_embed is not None]
    if sum(given) > 1:
      raise ValueError("Pass at most one of img_path, pixels, or img_embed.")
    if prefix_state is not None and any(given):
      raise ValueError(
          "prefix_state cannot be combined with an image argument: the "
          "image splices in after the BOS token, which lives in the "
          "cached context."
      )
    # Validate before the encoder runs, as the Sampler does before any
    # device work.
    self._validate_sampling_args(total_generation_steps, generator)
    self._resolve_constraint(constraint)
    if return_state and total_generation_steps < 1:
      raise ValueError("return_state requires total_generation_steps >= 1.")
    if img_path:
      img_embed = self.encode_image(img_path)
    elif pixels is not None:
      img_embed = self.encode(pixels)
    return super().__call__(
        input_strings, total_generation_steps, generator=generator, echo=echo,
        return_logits=return_logits,
        end_sampling_at_eos_token=end_sampling_at_eos_token,
        img_embed=img_embed, prefix_state=prefix_state,
        return_state=return_state, constraint=constraint,
    )
