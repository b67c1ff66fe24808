"""Stub modality frontends (``repro.models.frontends``).

The audio and vision architectures specify the transformer backbone only;
the modality frontend is a stub that provides precomputed frame / patch
embeddings with the right shapes and statistics:

  * audio (whisper): mel frames -> conv-downsampled frame embeddings, unit
    variance, (B, S_frames, d_model);
  * vision (internvl2): ViT patch embeddings projected to the LM width,
    (B, S_patches, d_model).

Both draw f32 normals from an explicit ``torch.Generator`` on its device
(the numbers differ from the reference's ``jax.random`` draws; parity
tests feed both packages the same arrays).
"""
from __future__ import annotations

import torch


def audio_frames_stub(generator: torch.Generator, batch: int, n_frames: int,
                      d_model: int) -> torch.Tensor:
    """Whisper-style frame embeddings (post conv-stem, the stride-2
    downsample already applied: ``n_frames`` is the backbone's length)."""
    return torch.randn((batch, n_frames, d_model), generator=generator,
                       dtype=torch.float32, device=generator.device)


def vision_patches_stub(generator: torch.Generator, batch: int,
                        n_patches: int, d_model: int) -> torch.Tensor:
    """InternViT-style patch embeddings projected to the LM width."""
    return torch.randn((batch, n_patches, d_model), generator=generator,
                       dtype=torch.float32, device=generator.device)


STUBS = {"audio_stub": audio_frames_stub, "embeds": vision_patches_stub}
