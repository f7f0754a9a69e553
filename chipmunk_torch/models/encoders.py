"""The FLUX prompt encoders behind one holder (torch), the counterpart of
``chipmunk_tpu/models/encoders.py`` with its ``'pure'`` backend: the
T5-v1.1-XXL and CLIP-L of ``flux_encoders.py`` read straight from the
checkpoints' safetensors, their tokenizers from ``transformers`` (imported
when first needed).  The encoders run outside the denoise loop, and
``release`` drops their weights before it, as the reference offloads them
after use.  Checkpoints and tokenizers are local paths.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device


@dataclass
class TextEncoders:
    """Lazy holder for the two prompt encoders.  t5_path / clip_path:
    local checkpoint directories holding the HF safetensors and the
    matching tokenizer."""
    t5_path: Optional[str] = None
    clip_path: Optional[str] = None
    max_length: int = 512          # FLUX-dev T5 context (schnell: 256)
    dtype: torch.dtype = torch.bfloat16
    device: DeviceLike = 'cuda'

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._t5_tok = self._clip_tok = None
        self._pure = None          # (t5_params, t5_cfg, clip_params, ccfg)

    def _load(self):
        from .flux_encoders import (ClipTextConfig, T5Config,
                                    load_clip_safetensors,
                                    load_t5_safetensors)
        if self._t5_tok is None or self._clip_tok is None:
            from transformers import AutoTokenizer
            if self._t5_tok is None and self.t5_path:
                self._t5_tok = AutoTokenizer.from_pretrained(self.t5_path)
            if self._clip_tok is None and self.clip_path:
                self._clip_tok = AutoTokenizer.from_pretrained(self.clip_path)
        if self._pure is None:
            t5_cfg = T5Config(dtype=self.dtype)
            ccfg = ClipTextConfig(dtype=self.dtype)
            self._pure = (
                load_t5_safetensors(self.t5_path, t5_cfg, self.device),
                t5_cfg,
                load_clip_safetensors(self.clip_path, ccfg, self.device),
                ccfg)

    def available(self) -> bool:
        return bool(self.t5_path and self.clip_path)

    def embed(self, prompts) -> Tuple[torch.Tensor, torch.Tensor]:
        """prompts: list[str] -> (txt [B, max_length, 4096], y [B, 768]
        pooled CLIP) in self.dtype on self.device: the (txt, vec) pair
        flux_forward takes."""
        from .flux_encoders import clip_text_encode, t5_encode
        self._load()
        tt = self._t5_tok(prompts, max_length=self.max_length,
                          padding='max_length', truncation=True,
                          return_tensors='np')
        ct = self._clip_tok(prompts, max_length=77, padding='max_length',
                            truncation=True, return_tensors='np')
        t5p, t5_cfg, clipp, ccfg = self._pure

        def ids(a):
            return torch.as_tensor(a, dtype=torch.long, device=self.device)

        txt = t5_encode(t5p, ids(tt['input_ids']), ids(tt['attention_mask']),
                        t5_cfg)
        _, y = clip_text_encode(clipp, ids(ct['input_ids']), ccfg)
        return txt, y

    def release(self) -> None:
        """Drop the encoder weights (the tokenizers stay)."""
        self._pure = None
